"""Three-term roofline of a step (``repro.roofline.analysis``), priced
with the H100 constants of ``repro_torch.launch.mesh``:

  compute term    = FLOPs / peak bf16 FLOP/s     (989 TF)
  memory term     = bytes / HBM bandwidth        (3.35 TB/s)
  collective term = collective bytes / link      (per mesh axis: NVLink
                    450 GB/s inside a node, the NIC's 50 GB/s across)

The reference reads its FLOPs and bytes off compiled XLA artifacts
(``cost_analysis``, ``memory_analysis``, collectives parsed from the
partitioned HLO text). The port runs eagerly. On one card ``flop_dict``
reads a ``torch.utils.flop_counter.FlopCounterMode`` held around the
step and ``memory_dict`` the CUDA caching allocator's statistics. A
sharded step (DTensors on a ``DeviceMesh``, ``launch.dryrun``) runs under
``StepRecorder``, one dispatch mode that sees each device's own work: it
steps aside (``NotImplemented``) for every op on DTensors, so that DTensor
runs the op on the local shards, and those local ops, the collectives of
DTensor's redistributions among them, come back to it. It counts

  - FLOPs by ``FlopCounterMode``'s formulas (the kernels' custom ops by
    theirs), on the local shapes: FLOPs per device;
  - the result bytes of each ``_c10d_functional`` collective, by the
    reference's kind names, by mesh axis and by the code that issued it
    (``sharding.aten.collective_source``: DTensor carrying the rules'
    layouts, or one of the port's own reshards; ``collective_bytes``);
  - bytes accessed: the operand and result bytes of every local op but
    views and allocations, an eager upper bound of the memory traffic
    (XLA's count, over fused ops, is lower);
  - the live bytes of the tensors the step makes, and their peak (a
    storage counts from the op that makes it until it is freed).

On ``meta`` tensors (the dry run) nothing is computed: the counts come
from shapes alone, and a fake process group's collectives move nothing,
so no time is measured and no collective is checked. ``analyze_step``
makes the ``RooflineResult``.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     MeshShape, axis_link_bw, mesh_name)
from repro_torch.models.layers.xlstm import MLSTM_CHUNK
from repro_torch.sharding.aten import current_source

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

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
    # the collectives priced axis by axis (``analyze_step``); None: all of
    # ``coll_bytes_dev`` at NVLink's rate
    coll_seconds: Optional[float] = field(default=None)

    @property
    def compute_s(self):
        return self.flops_dev / PEAK_FLOPS_BF16

    @property
    def memory_s(self):
        return self.bytes_dev / HBM_BW

    @property
    def collective_s(self):
        if self.coll_seconds is not None:
            return self.coll_seconds
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
    held = (f"args {mem['argument_bytes']/2**30:6.2f}GiB"
            if "argument_bytes" in mem else
            f"in use {mem.get('bytes_in_use', 0)/2**30:6.2f}GiB")
    return (
        f"{res.arch:28s} {res.shape:12s} {res.mode:9s} {res.mesh:9s} "
        f"comp {t['compute_s']*1e3:9.3f}ms  mem {t['memory_s']*1e3:9.3f}ms  "
        f"coll {t['collective_s']*1e3:9.3f}ms  -> {t['dominant']:10s} "
        f"useful {t['useful_ratio']*100:5.1f}%  "
        f"{held} peak {mem.get('peak_bytes', 0)/2**30:6.2f}GiB")


# ---------------------------------------------------------------------------
# sharded steps: one device's FLOPs, bytes, collectives and memory
# ---------------------------------------------------------------------------
_METADATA_OPS = {
    torch.ops.aten.sym_is_contiguous.default,
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default, torch.ops.prim.layout.default}
_ALLOC_OPS = {"empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided"}


def collective_kind(op_name: str) -> Optional[str]:
    """The reference's HLO kind of a ``_c10d_functional`` op, None for
    the ops that move nothing (``wait_tensor``, the autograd wrapper)."""
    name = op_name.split(".")[1] if "." in op_name else op_name
    for stem, kind in (("all_gather", "all-gather"),
                       ("reduce_scatter", "reduce-scatter"),
                       ("all_reduce", "all-reduce"),
                       ("all_to_all", "all-to-all"),
                       ("broadcast", "collective-permute")):
        if name.startswith(stem):
            return kind
    return None


def _is_plain(t) -> bool:
    return type(t) in (torch.Tensor, torch.nn.Parameter)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepRecorder(TorchDispatchMode):
    """One device's work in a step, seen op by op (the module docstring).
    ``mesh`` names the axis of each collective's process group."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes_accessed = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVE_OPS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.coll_by_axis: Dict[str, int] = {}
        self.coll_by_source: Dict[str, dict] = {}
        self.live = self.peak = 0
        self._seen = weakref.WeakSet()
        self._groups = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._groups[mesh.get_group(i).group_name] = name

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not (isinstance(t, torch.Tensor) and _is_plain(t)):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [t for t in tree_flatten((args, kwargs))[0]
                if isinstance(t, torch.Tensor)]
        if func in _METADATA_OPS:
            return NotImplemented
        if any(not _is_plain(t) for t in flat):
            from torch.distributed.tensor import DTensor
            if any(isinstance(t, DTensor) for t in flat):
                return NotImplemented   # DTensor runs the local ops
            return func(*args, **kwargs)  # DTensor's shape propagation
        packet = func._overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = str(func)
        if name.startswith("_c10d_functional"):
            kind = collective_kind(name)
            if kind is not None:
                n = sum(_nbytes(t) for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor))
                self.coll_bytes[kind] += n
                self.coll_counts[kind] += 1
                group = next((a for a in tree_flatten((args, kwargs))[0]
                              if isinstance(a, str) and a in self._groups),
                             None)
                axis = self._groups.get(group, "other")
                self.coll_by_axis[axis] = self.coll_by_axis.get(axis, 0) + n
                src = self.coll_by_source.setdefault(
                    current_source(), {"bytes": {}, "counts": {}})
                src["bytes"][kind] = src["bytes"].get(kind, 0) + n
                src["counts"][kind] = src["counts"].get(kind, 0) + 1
        else:
            if packet in flop_registry:
                f = int(flop_registry[packet](*args, **kwargs, out_val=out))
                self.flops += f
                self.flops_by_op[str(packet)] = \
                    self.flops_by_op.get(str(packet), 0) + f
            if not getattr(func, "is_view", False) and \
                    packet.__name__ not in _ALLOC_OPS:
                self.bytes_accessed += sum(_nbytes(t) for t in flat) + sum(
                    _nbytes(t) for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor))
        self._track(out)
        return out


def collective_bytes(rec: StepRecorder) -> dict:
    """The recorded collectives as the reference's dict: result bytes and
    counts per kind and their total, plus the bytes per mesh axis and, per
    issuing source, the bytes and counts per kind (``by_source``)."""
    return {"bytes": dict(rec.coll_bytes), "counts": dict(rec.coll_counts),
            "total": sum(rec.coll_bytes.values()),
            "by_axis": dict(rec.coll_by_axis),
            "by_source": {k: {"bytes": dict(v["bytes"]),
                              "counts": dict(v["counts"])}
                          for k, v in rec.coll_by_source.items()}}


def sources_report(res: RooflineResult) -> str:
    """The row's collective bytes per issuing source and kind, in GB (the
    rules' layouts apart from the port's own reshards)."""
    parts = []
    for src, v in sorted(res.coll_detail.get("by_source", {}).items()):
        kinds = ", ".join(f"{k} {n / 1e9:.4f}GB x{v['counts'][k]}"
                          for k, n in sorted(v["bytes"].items()))
        parts.append(f"{src}: {kinds}")
    return "  collectives by source: " + ("; ".join(parts) or "none")


def cost_dict(rec: StepRecorder) -> dict:
    """The recorder's counts under ``cost_analysis()``'s keys."""
    return {"flops": float(rec.flops),
            "bytes accessed": float(rec.bytes_accessed)}


def local_bytes(tree) -> int:
    """Bytes of one device's shards of the tensors in ``tree`` (DTensors'
    local tensors, plain tensors whole), each storage once."""
    from torch.distributed.tensor import DTensor
    seen, n = set(), 0
    for t in tree_flatten(tree)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        st = (t.to_local() if isinstance(t, DTensor) else t) \
            .untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def analyze_step(rec: StepRecorder, *, arch, shape, mode, mesh, cfg,
                 shape_cfg, args, out) -> RooflineResult:
    """The ``RooflineResult`` of one recorded sharded step: FLOPs and bytes
    per device, collectives priced per mesh axis by its link
    (``launch.mesh.axis_link_bw``), memory from the local shards of the
    arguments and the outputs, and the recorder's peak of the live bytes
    the step made (temporaries and outputs) on top of the arguments."""
    coll, cost = collective_bytes(rec), cost_dict(rec)
    secs = sum(n / (axis_link_bw(mesh, a) if a in MeshShape.of(mesh)
                    .axis_names else NVLINK_BW)
               for a, n in coll["by_axis"].items())
    arg_b, out_b = local_bytes(args), local_bytes(out)
    mem = {"argument_bytes": arg_b, "output_bytes": out_b,
           "temp_bytes": max(rec.peak - out_b, 0),
           "peak_bytes": arg_b + rec.peak}
    return RooflineResult(
        arch=arch, shape=shape, mode=mode, mesh=mesh_name(mesh),
        n_devices=MeshShape.of(mesh).size, flops_dev=cost["flops"],
        bytes_dev=cost["bytes accessed"],
        coll_bytes_dev=float(coll["total"]), coll_detail=coll,
        mem_per_device=mem,
        model_flops_total=model_flops(cfg, shape_cfg, mode),
        coll_seconds=secs)
