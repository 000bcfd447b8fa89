"""Three-term roofline of a measured step (``repro.roofline.analysis``),
priced with the H100 constants of ``repro_torch.launch.mesh``:

  compute term    = FLOPs / peak bf16 FLOP/s     (989 TF)
  memory term     = bytes / HBM bandwidth        (3.35 TB/s)
  collective term = collective bytes / NVLink    (450 GB/s a direction)

The reference reads its FLOPs and bytes off compiled XLA artifacts
(``cost_analysis``, ``memory_analysis``, collectives parsed from the HLO
text). The port runs eagerly: ``flop_dict`` reads a
``torch.utils.flop_counter.FlopCounterMode`` that was held around the
step, and ``memory_dict`` the CUDA caching allocator's statistics. One
card has no collectives to parse.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.layers.xlstm import MLSTM_CHUNK


def model_flops(cfg, shape, mode: str) -> float:
    """Useful-work floor: 6·N_active·D train, 2·N_active·D forward-only."""
    n = cfg.active_param_count()
    if mode in ("train", "train_lw"):
        tokens = shape.global_batch * shape.seq_len
        f = 6.0 * n * tokens
        if mode == "train_lw":
            # full forward + (1/S) backward + alignment forward (global model)
            S = max(1, cfg.num_layers)
            f = 2.0 * n * tokens * (1 + 1) + 4.0 * n * tokens / S
        return f
    if mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    if mode == "decode":
        return 2.0 * n * shape.global_batch
    raise ValueError(mode)


def chunk_loop_correction(cfg, shape, mode: str, n_devices: int) -> float:
    """Per-device FLOPs of the chunk and time loops that the reference's
    rolled XLA loops hide from ``cost_analysis``.

    SSD intra-chunk terms per layer per sequence (fwd):
        2*S*Q*N  (C·B)  +  2*S*Q*H*P  (mask·x)  +  4*S*N*H*P  (state I/O)
    mLSTM chunked core:  4*S*Q*d_inner + 4*S*d_inner*P
    sLSTM recurrence:    S * 8 * d * P_head
    Train multiplies by 3 (fwd + 2x bwd); decode steps have no chunk loops.
    """
    if mode == "decode":
        return 0.0
    mult = 3.0 if mode in ("train", "train_lw") else 1.0
    B, S = shape.global_batch, shape.seq_len
    extra = 0.0
    if cfg.ssm is not None and cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        Q = min(s.chunk_size, S)
        d_in = s.expand * cfg.d_model
        H = d_in // s.head_dim
        N, P = s.state_dim, s.head_dim
        per_seq = 2 * S * Q * N + 2 * S * Q * H * P + 4 * S * N * H * P
        extra += cfg.num_layers * B * per_seq * mult
    if cfg.xlstm is not None:
        d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
        P = d_in // cfg.num_heads
        Q = min(MLSTM_CHUNK, S)
        per = cfg.xlstm.slstm_every or cfg.num_layers
        n_mlstm = cfg.num_layers - cfg.num_layers // per
        n_slstm = cfg.num_layers // per
        extra += n_mlstm * B * (4 * S * Q * d_in + 4 * S * d_in * P) * mult
        d = cfg.d_model
        extra += n_slstm * B * S * 8 * d * (d // cfg.num_heads) * mult
    return extra / n_devices


@dataclass
class RooflineResult:
    arch: str
    shape: str
    mode: str
    mesh: str
    n_devices: int
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    coll_detail: dict
    mem_per_device: dict
    model_flops_total: float

    @property
    def compute_s(self):
        return self.flops_dev / PEAK_FLOPS_BF16

    @property
    def memory_s(self):
        return self.bytes_dev / HBM_BW

    @property
    def collective_s(self):
        return self.coll_bytes_dev / NVLINK_BW

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self):
        total = self.flops_dev * self.n_devices
        return self.model_flops_total / total if total else 0.0

    def to_dict(self):
        return {
            "arch": self.arch, "shape": self.shape, "mode": self.mode,
            "mesh": self.mesh, "n_devices": self.n_devices,
            "flops_dev": self.flops_dev, "bytes_dev": self.bytes_dev,
            "coll_bytes_dev": self.coll_bytes_dev,
            "coll_detail": self.coll_detail,
            "mem_per_device": self.mem_per_device,
            "model_flops_total": self.model_flops_total,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


def flop_dict(counter) -> dict:
    """A finished ``FlopCounterMode`` as one flat dict: ``flops`` (the
    total) and the count of each op by name."""
    counts = counter.get_flop_counts().get("Global", {})
    out = {str(op): int(n) for op, n in counts.items()}
    out["flops"] = int(counter.get_total_flops())
    return out


def memory_dict(device=None) -> dict:
    """The CUDA caching allocator's statistics of ``device`` (default: the
    current card) as current and peak bytes, allocated and reserved. Read
    from the allocator on the host: no device synchronisation."""
    import torch
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current", 0)),
            "peak_reserved_bytes": int(stats.get("reserved_bytes.all.peak",
                                                 0))}


def roofline_report(res: RooflineResult) -> str:
    t = res.to_dict()
    mem = t["mem_per_device"]
    return (
        f"{res.arch:28s} {res.shape:12s} {res.mode:9s} {res.mesh:9s} "
        f"comp {t['compute_s']*1e3:9.3f}ms  mem {t['memory_s']*1e3:9.3f}ms  "
        f"coll {t['collective_s']*1e3:9.3f}ms  -> {t['dominant']:10s} "
        f"useful {t['useful_ratio']*100:5.1f}%  "
        f"in use {mem.get('bytes_in_use', 0)/2**30:6.2f}GiB "
        f"peak {mem.get('peak_bytes', 0)/2**30:6.2f}GiB")
