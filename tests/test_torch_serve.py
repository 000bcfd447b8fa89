"""The port's serving driver (``repro_torch.launch.serve``) against the
reference's (``repro.launch.serve``): the same greedy tokens on every arch
at ``reduced()``, with the reference's parameters, prompts and frames
(its key chain ``split(PRNGKey(seed))``) converted into the port's loop;
the reference's zero-block serve of zamba2 and xLSTM at plain
``reduced()``, pinned; and the CLI on the CPU and its refusal to fall back
to it."""
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models.layers.norms import rmsnorm as jrmsnorm
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.launch.steps import is_encdec
from repro_torch.launch.train import LM_ARCHS
from repro_torch.models import lm

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = sorted(set(LM_ARCHS) | {"seamless-m4t-medium"})
BATCH, PROMPT, GEN, SEED = 2, 4, 6, 0


def _reference_overrides(arch):
    """The launcher's overrides of ``arch`` as reference config values."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(jbase, type(v).__name__)(**vars(v))
        return v
    return {k: conv(v) for k, v in LM_ARCHS.get(arch, {}).items()}


def _quiet(*_args):
    pass


def _reference_inputs(cfg, seed=SEED):
    """The reference serve's parameters and prompts (or encoder memory),
    rebuilt from its key chain, on the host."""
    ki, kp = jax.random.split(jax.random.PRNGKey(seed))
    if is_encdec(cfg):
        params = jencdec.init_encdec(ki, cfg)
        frames = jax.random.normal(kp, (BATCH, cfg.frontend_embed_len,
                                        cfg.d_model))
        return params, jencdec.encode(params, frames, cfg)
    params = jlm.init_lm(ki, cfg)
    return params, jax.random.randint(kp, (BATCH, PROMPT), 0, cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_serve(arch, monkeypatch):
    """``serve.generate`` on the reference's converted parameters and
    prompts gives the tokens the reference's ``serve`` prints, step by
    step (its ``reduced`` patched with the launcher's overrides, as the
    port's ``serve_config`` applies them)."""
    over = _reference_overrides(arch)
    monkeypatch.setattr(jserve, "reduced",
                        lambda cfg, **kw: jbase.reduced(cfg, **over, **kw))
    want, _ = jserve.serve(arch, BATCH, PROMPT, GEN, SEED, log=_quiet)
    jcfg = jbase.reduced(jbase.load_arch(arch), **over)
    tcfg = serve.serve_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jparams, source = _reference_inputs(jcfg)
    tparams = convert.from_numpy_tree(jax.device_get(jparams))
    src = convert.to_tensor(jax.device_get(source), "cpu")
    tokens, secs = serve.generate(tcfg, tparams, src.long() if src.dtype ==
                                  torch.int32 else src, GEN)
    assert tokens.shape == (GEN, BATCH) and secs > 0
    np.testing.assert_array_equal(tokens.numpy(), np.stack(want))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_reference_serves_no_blocks_at_plain_reduced(arch):
    """The reference's ``serve`` of zamba2 and xLSTM at plain ``reduced()``
    (2 layers, ``attn_every`` / ``slstm_every`` kept at 6) serves a model
    with no block: every cache and block stack has a leading dim of 0
    (zamba2's shared block has weights but no group to follow), and its
    tokens are what the embedding, the final norm and the head alone give,
    each token a function of the one before. The port's ``serve``
    adds the launcher's overrides, so its model has two stage groups."""
    cfg = jbase.reduced(jbase.load_arch(arch))
    assert jlm.num_stages(cfg) == 0
    params, prompts = _reference_inputs(cfg)
    for tree in (jlm.init_caches(cfg, BATCH, PROMPT + GEN),
                 {k: v for k, v in params.items()
                  if k not in ("embed", "final_ln", "lm_head",
                               "shared_attn")}):
        leaves = jax.tree.leaves(tree)
        assert leaves and all(a.shape[0] == 0 for a in leaves)
    got, _ = jserve.serve(arch, BATCH, PROMPT, GEN, SEED, log=_quiet)

    def head(tok):
        x = jrmsnorm(params["final_ln"], jlm.embed(params, tok, cfg),
                     cfg.norm_eps)
        return jax.numpy.argmax(x @ jlm._head_matrix(params, cfg), -1)

    # the loop decodes the prefill's argmax and records the token after it
    want, tok = [], head(prompts[:, -1:])
    for _ in range(GEN):
        tok = head(tok)
        want.append(np.asarray(tok)[:, 0])
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert lm.num_stages(serve.serve_config(arch)) == 2


def test_serve_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "zamba2-2.7b", "--batch", "2", "--prompt-len", "4",
         "--gen", "3"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    assert "zamba2-2.7b: generated 3 tokens x 2 seqs" in out.stdout
    assert "tok/s on cpu" in out.stdout


def test_serve_defaults_to_the_card_and_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "internlm2-1.8b", "--gen", "1"])
    tokens, tps = serve.main(["--arch", "internlm2-1.8b", "--batch", "1",
                              "--prompt-len", "2", "--gen", "2",
                              "--device", "cpu"])
    assert tokens.shape == (2, 1) and tps > 0
