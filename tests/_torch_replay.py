"""Replay of the JAX package's random draws for the port's parity tests.

The port asks a draws object for every random number it needs
(``repro_torch.federated.draws``). ``JaxReplayDraws`` answers with the
numbers the reference draws: it walks the reference's key chain
(``driver.run_fedssl``: init split, cohort split, one split per participant,
calibration split; ``client.local_train``: epoch and step splits; the step's
augmentation / depth-dropout split; ``two_views`` and ``augment_one`` with
each augmentation's own ``split``/``uniform``/``randint`` calls), so both
packages consume the same draws. The privacy draws are the reference's
per-round keys off its dedicated stream (``PrivacyEngine.fork_stream`` of
the run key, then ``round_keys``): the noise is its own ``normal`` draw,
the mask seed its own tuple of ints.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import ssl as jssl
from repro.privacy import PrivacyEngine
from repro_torch import convert

H = W = 32


def _aug_one(key):
    """The raw draws ``augment.augment_one`` makes for one image."""
    ks = jax.random.split(key, 6)
    k1, k2, k3 = jax.random.split(ks[0], 3)
    kb, kc, ksat, kh = jax.random.split(ks[1], 4)
    kbl1, kbl2 = jax.random.split(ks[4])
    u = jax.random.uniform
    return {
        "area": u(k1, (), minval=0.2, maxval=1.0),
        "y0": jax.random.randint(k2, (), 0, H),
        "x0": jax.random.randint(k3, (), 0, W),
        "bright": u(kb, (), minval=-0.4, maxval=0.4),
        "contrast": u(kc, (), minval=-0.4, maxval=0.4),
        "sat": u(ksat, (), minval=-0.4, maxval=0.4),
        "hue": u(kh, (), minval=-0.1, maxval=0.1),
        "gray": u(ks[2]),
        "flip": u(ks[3]),
        "sigma": u(kbl1, (), minval=0.1, maxval=2.0),
        "blur": u(kbl2),
        "solar": u(ks[5]),
    }


_aug_batch = jax.jit(jax.vmap(_aug_one))


def view_draws(key, batch):
    """The two views' draws of ``augment.two_views(key, images)``."""
    k1, k2 = jax.random.split(key)
    return tuple({k: torch.from_numpy(np.array(v))
                  for k, v in _aug_batch(jax.random.split(kk, batch)).items()}
                 for kk in (k1, k2))


class JaxReplayDraws:
    def __init__(self, key, jax_encoder):
        self.key = key
        self.jax_encoder = jax_encoder
        self.privacy_stream = PrivacyEngine.fork_stream(key)

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def init_state(self, encoder, ssl_cfg):
        k_init, self.key = jax.random.split(self.key)
        state = jssl.ssl_init(k_init, self.jax_encoder, ssl_cfg)
        return convert.state_from_numpy(jax.device_get(state))

    def cohort(self, num_clients, n):
        ks = self._next()
        if n >= num_clients:
            return list(range(num_clients))
        idx = jax.random.choice(ks, num_clients, (n,), replace=False)
        return [int(i) for i in idx]

    def batch_plan(self, n, epochs, batch_size, calibration=False):
        key = self._next()
        plan = []
        for _ in range(epochs):
            key, kp = jax.random.split(key)
            perm = np.asarray(jax.random.permutation(kp, n))
            for b in range(n // batch_size):
                key, kb = jax.random.split(key)
                sel = torch.from_numpy(
                    perm[b * batch_size:(b + 1) * batch_size].astype(
                        np.int64))
                plan.append((sel, (calibration, kb)))
        return plan

    def views(self, handle, batch, height, width):
        calibration, kb = handle
        k_aug = kb if calibration else jax.random.split(kb)[0]
        return view_draws(k_aug, batch)

    def gate_uniforms(self, handle, num_stages):
        _, kb = handle
        k_dd = jax.random.split(kb)[1]
        return torch.from_numpy(np.array(
            jax.random.uniform(k_dd, (num_stages,))))

    def privacy_noise(self, round_idx, n):
        k_noise, _ = PrivacyEngine.round_keys(self.privacy_stream, round_idx)
        return torch.from_numpy(np.array(
            jax.random.normal(k_noise, (n,), jnp.float32)))

    def mask_seed(self, round_idx):
        return PrivacyEngine.round_keys(self.privacy_stream, round_idx)[1]
