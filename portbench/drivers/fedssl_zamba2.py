"""Traffic driver of the Zamba2 LM FL mixes: layer-wise FedSSL of Zamba2 at
its published layout through the port's ``run_lm_fedssl`` (its
``zamba2`` topology, sequential engine).

As ``fedssl_lm`` does for the JAX-layout zamba2: the benchmark makes the
token pool (Zipf marginals with Markov mixing over the full vocabulary),
the clients' IID shards of whole sequences and the initial model from the
seed, and hands them to ``run_lm_fedssl`` with the mix's engine, codec and
a schedule whose rounds all lie in the mix's stage. A stage is the
configuration's ``stage_layers`` layers. A round's work is the clients'
trained tokens.
"""
from __future__ import annotations

import torch

from portbench.counts import zamba2 as counts
from portbench.lib.data import iid_partition, synthetic_tokens
from portbench.lib.fl import FLRun, rounds_per_stage
from portbench.lib.init import generator, init_tree
from portbench.reference import zamba2 as ref


class Run(FLRun):
    model_var = agg_var = "params"

    def __init__(self, cell, seed: int, device):
        super().__init__(cell, seed, device)
        m = self.cfg["model"]
        self.num_stages = ref.num_stages(m)
        mix, B = self.mix, self.cfg["train"]["batch_size"]
        n = mix["clients"] * mix["seqs_per_client"]
        self.tokens, self.labels = synthetic_tokens(
            generator(self.device, self.seed, "tokens"), n, mix["seq_len"],
            m["vocab_size"])
        self.shards = [torch.as_tensor(ix, device=self.device) for ix in
                       iid_partition(n, mix["clients"], self.seed)]
        steps = mix["local_epochs"] * max(1, mix["seqs_per_client"] // B)
        self.work_per_round = mix["clients"] * steps * B * mix["seq_len"]
        self.rate_metric = "lm_tokens_per_s"

    def layout(self):
        return ref.layout(self.cfg["model"])

    def initial_state(self):
        return init_tree(self.layout(), self.seed, self.device)

    @staticmethod
    def flat(params):
        return params

    flat_agg = flat

    def transfer(self, tree, stage):
        return ref.transfer(self.cfg["model"], tree, stage)

    def model_config(self):
        from repro_torch.configs.base import GroupedSSMConfig, Zamba2Config
        m = dict(self.cfg["model"])
        return Zamba2Config(**{**m, "ssm": GroupedSSMConfig(**m["ssm"]),
                               "hybrid_layer_ids":
                               tuple(m["hybrid_layer_ids"])})

    def program(self, log, obs):
        """``run_lm_fedssl`` on the benchmark's inputs; returns only if
        the plan ran out."""
        from repro_torch.configs.base import FLConfig, TrainConfig
        from repro_torch.federated.driver import run_lm_fedssl
        from repro_torch.models import lm as lm_mod

        mix, cfg = self.mix, self.model_config()
        # the initial model goes to the program without a reference kept
        # here: its 9 GB would otherwise outlive the leaves it replaces
        params = [self.initial_state()]
        have = {k: tuple(v) for k, v in lm_mod.lm_shapes(cfg).items()}
        want = {k: tuple(v.shape) for k, v in params[0].items()}
        if have != want:
            raise RuntimeError(
                f"the program's LM layout differs from the benchmark's: "
                f"{sorted(set(have.items()) ^ set(want.items()))[:6]}")
        fl = FLConfig(num_clients=mix["clients"], rounds=mix["stage_rounds"],
                      local_epochs=mix["local_epochs"],
                      schedule=mix["schedule"],
                      rounds_per_stage=rounds_per_stage(
                          self.num_stages, mix["stage"], mix["stage_rounds"]),
                      weight_transfer=mix["weight_transfer"], seed=self.seed)
        run_lm_fedssl(cfg, fl, TrainConfig(**self.cfg["train"]),
                      tokens=self.tokens, labels=self.labels,
                      shards=self.shards, params=params.pop(),
                      device=self.device,
                      codec=mix["codec"], log=log, obs=obs,
                      engine=mix["engine"])

    def reference_rounds(self, num, fault=None, grads=None):
        return ref.follow({"tokens": self.tokens, "labels": self.labels,
                           "shards": self.shards}, self.plan_for,
                          self.check_rounds, self.cfg["model"],
                          self.cfg["train"], self.fl_settings(), num=num,
                          params=self.initial_state(), fault=fault, grads=grads)

    def round_work(self):
        return counts.round_work(self.cfg, self.mix, self.plan_for(0))
