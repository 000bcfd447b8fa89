"""Traffic driver of the ViT FL mixes: the paper's experiment through the
port's ``run_fedssl``.

The benchmark makes the image pool (procedural textures), the clients'
IID shards, the server's auxiliary images (the pool's first
``aux_fraction``), the initial model and every draw of the run from the
seed, and hands them to ``run_fedssl`` with the mix's engine, codec and a
schedule whose rounds all lie in the mix's stage. A round's work is the
clients' images, each counted once for its two views.
"""
from __future__ import annotations

import torch

from portbench.counts import vit as counts
from portbench.lib.data import iid_partition, synthetic_images
from portbench.lib.draws import BenchDraws
from portbench.lib.fl import FLRun, rounds_per_stage
from portbench.lib.init import generator, init_tree
from portbench.reference import vit as ref


class Run(FLRun):
    model_var, agg_var = "state", "new_online"

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        self.num_stages = self.cfg["model"]["num_layers"]
        mix, B = self.mix, self.cfg["train"]["batch_size"]
        n = mix["clients"] * mix["images_per_client"]
        self.images, _ = synthetic_images(
            generator(self.device, self.seed, "images"), n)
        self.shards = [torch.as_tensor(ix, device=self.device) for ix in
                       iid_partition(n, mix["clients"], self.seed)]
        self.aux = self.images[:int(n * mix["aux_fraction"])]
        steps = mix["local_epochs"] * (mix["images_per_client"] // B)
        self.work_per_round = mix["clients"] * steps * B
        self.rate_metric = "vit_images_per_s"

    def layout(self):
        return ref.layout(self.cfg["model"], self.cfg["ssl"])

    def initial_state(self):
        return ref.init_state(self.layout(), self.seed, self.device,
                              init_tree)

    @staticmethod
    def flat(state):
        return ref.flat(state)

    @staticmethod
    def flat_agg(online):
        return {f"online/{k}": v for k, v in online.items()}

    @staticmethod
    def transfer(tree, stage):
        out = {}
        for br in ("online", "target"):
            part = {k: v for k, v in tree.items() if k.startswith(br + "/")}
            out.update(ref.transfer(part, stage, br + "/enc/"))
        return out

    def program(self, log, obs):
        """``run_fedssl`` on the benchmark's inputs; returns only if the
        plan ran out."""
        from repro_torch.configs.base import (FLConfig, ModelConfig,
                                              SSLConfig, TrainConfig)
        from repro_torch.federated.driver import run_fedssl

        mix = self.mix
        fl = FLConfig(num_clients=mix["clients"],
                      clients_per_round=mix.get("clients_per_round", 0),
                      rounds=mix["stage_rounds"],
                      local_epochs=mix["local_epochs"],
                      schedule=mix["schedule"],
                      rounds_per_stage=rounds_per_stage(
                          self.num_stages, mix["stage"], mix["stage_rounds"])
                      if mix["schedule"] != "e2e" else (),
                      weight_transfer=mix["weight_transfer"],
                      server_epochs=mix["server_epochs"],
                      aux_fraction=mix["aux_fraction"], seed=self.seed)
        state = self.initial_state()
        _check_layout(ref.flat(state), self.cfg)
        run_fedssl(ModelConfig(**self.cfg["model"]),
                   SSLConfig(**self.cfg["ssl"]),
                   fl, TrainConfig(**self.cfg["train"]),
                   images=self.images, client_indices=self.shards,
                   aux_images=self.aux,
                   draws=BenchDraws(self.seed, self.device, state),
                   log=log, device=self.device, engine=mix["engine"],
                   codec=mix["codec"], obs=obs)

    def reference_rounds(self, num, fault=None, grads=None):
        state = self.initial_state()
        out = ref.follow({"images": self.images, "shards": self.shards,
                          "aux": self.aux}, self.plan_for, self.check_rounds,
                         self.cfg["model"], self.cfg["ssl"],
                         self.cfg["train"], self.fl_settings(), num=num,
                         seed=self.seed, state=state, fault=fault, grads=grads)
        return out

    def round_work(self):
        return counts.round_work(self.cfg, self.mix, self.plan_for(0))


def _check_layout(flat, cfg) -> None:
    """The program's parameter layout has to be the reference's: the
    benchmark's weights are drawn for it."""
    from repro_torch.configs.base import ModelConfig, SSLConfig
    from repro_torch.core import ssl as ssl_mod

    enc = ssl_mod.make_vit_encoder(ModelConfig(**cfg["model"]))
    prog = ssl_mod.ssl_init(enc, SSLConfig(**cfg["ssl"]), None, "meta")
    have = {f"{br}/{k}": tuple(v.shape) for br, t in prog.items()
            for k, v in t.items()}
    want = {k: tuple(v.shape) for k, v in flat.items()}
    if have != want:
        raise RuntimeError(f"the program's ViT layout differs from the "
                           f"benchmark's: {sorted(set(have.items()) ^ set(want.items()))[:6]}")

