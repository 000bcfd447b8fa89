"""Wire-level transport of stage payloads, fp32 codec
(``repro.federated.transport``, its ``PayloadSpec`` layout and pack /
unpack path).

A round plan's stage range is cut out of every stacked / embed / head
leaf into one flat fp32 buffer (``pack_stage_payload``) and scattered back
into a model tree (``unpack_stage_payload``). Both directions of the FL
loop go through here: the download (server tree -> payload -> the tree
clients train from) and each client's upload (trained tree -> payload ->
the tree FedAvg consumes). The layout is the reference's: slots in
``jax.tree_util`` leaf order, so the flat buffers are bit-identical to the
reference's ``pack_stage_payload``.

The fp32 codec is the identity and both reference engines (``xla``,
``pallas``) give the same bits for it, so the port has one wire path: the
slot-table kernels (``kernels.ops.wire_pack`` / ``wire_unpack``) on the
card, their plain versions on the CPU. Compressing codecs (fp16, bf16,
int8, top-k) come with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.federated import aggregate, comm
from repro_torch.federated.leaves import classify_leaf, path_keys
from repro_torch.kernels import ops

WIRE_DTYPE = torch.float32
Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class LeafSlot:
    path: Tuple[str, ...]     # key path into the params tree
    kind: str                 # stacked | embed | head | extra
    lo: int                   # stacked: first stage row shipped
    hi: int                   # stacked: one past the last stage row
    shape: Tuple[int, ...]    # shape of the shipped piece
    offset: int               # start element in the flat payload
    size: int                 # element count of the shipped piece

    @property
    def src_offset(self) -> int:
        """Element offset of the slot inside its raveled leaf: stacked
        slots start at row ``lo``, whole-tensor slots at 0."""
        if self.kind != "stacked":
            return 0
        return self.lo * (self.size // (self.hi - self.lo))


@dataclass(frozen=True)
class PayloadSpec:
    slots: Tuple[LeafSlot, ...]
    total: int                # flat payload length in elements

    @property
    def payload_bytes(self) -> int:
        return self.total * 4

    @property
    def layout(self) -> Tuple[Tuple[int, int, int], ...]:
        """``((src_off, dst_off, size), ...)`` slot table of the kernels."""
        return tuple((s.src_offset, s.offset, s.size) for s in self.slots)


def build_payload_spec(params: Tree, stage_range, *, include_embed: bool,
                       include_heads: bool) -> PayloadSpec:
    """Lay out the payload over ``params`` (a flat dict in tree order):
    stacked leaves contribute their ``[lo, hi)`` rows, embed and head
    leaves whole tensors per the flags, extra leaves always."""
    lo_req, hi_req = int(stage_range[0]), int(stage_range[1])
    slots: List[LeafSlot] = []
    offset = 0
    for path, a in params.items():
        kind = classify_leaf(path)
        if kind == "stacked":
            lo, hi = max(0, lo_req), min(a.shape[0], hi_req)
            if hi <= lo:
                continue
            shape = (hi - lo,) + tuple(a.shape[1:])
        elif (kind == "embed" and not include_embed) or \
                (kind == "head" and not include_heads):
            continue
        else:
            lo, hi = 0, 0
            shape = tuple(a.shape)
        size = 1
        for n in shape:
            size *= n
        slots.append(LeafSlot(path_keys(path), kind, lo, hi, shape, offset,
                              size))
        offset += size
    return PayloadSpec(tuple(slots), offset)


def _key(slot: LeafSlot) -> str:
    return "/".join(slot.path)


def pack_stage_payload(params: Tree, spec: PayloadSpec) -> torch.Tensor:
    """The spec'd pieces of ``params`` in one flat fp32 buffer."""
    if not spec.slots:
        return torch.zeros(0, dtype=WIRE_DTYPE,
                           device=next(iter(params.values())).device)
    leaves = [params[_key(s)].to(WIRE_DTYPE).contiguous()
              for s in spec.slots]
    return ops.wire_pack(leaves, spec.layout, spec.total)


def unpack_stage_payload(base: Tree, flat: torch.Tensor,
                         spec: PayloadSpec) -> Tree:
    """Scatter ``flat`` into copies of ``base``'s spec'd leaves: stacked
    rows land in their stage range, whole-tensor slots replace the leaf,
    and leaves outside the spec are ``base``'s own tensors.

    The unpack writes fresh leaves and never into ``base``: the transport
    uses the server's tree as the base of every client's upload, so an
    in-place unpack would corrupt the next client's payload. In place would
    be safe only into a tree that no later unpack reads, such as a client's
    private copy of a broadcast."""
    if not spec.slots:
        return dict(base)
    bases = [base[_key(s)] for s in spec.slots]
    if any(b.dtype != WIRE_DTYPE for b in bases):
        raise ValueError("unpack_stage_payload: the fp32 wire scatters into "
                         "float32 leaves only")
    outs = ops.wire_unpack(flat, [b.contiguous() for b in bases],
                           spec.layout)
    new = {_key(s): o.reshape(b.shape)
           for s, o, b in zip(spec.slots, outs, bases)}
    return {k: new.get(k, v) for k, v in base.items()}


class Transport:
    """One per FL run: the per-direction payload specs and the measured
    wire bytes the driver records in ``FLHistory``."""

    def __init__(self, *, include_heads: bool = True):
        self.include_heads = include_heads
        self._specs: Dict[Tuple, PayloadSpec] = {}

    def spec(self, params: Tree, stage_range, include_embed: bool
             ) -> PayloadSpec:
        key = (tuple((k, tuple(v.shape)) for k, v in params.items()),
               (int(stage_range[0]), int(stage_range[1])), include_embed)
        if key not in self._specs:
            self._specs[key] = build_payload_spec(
                params, stage_range, include_embed=include_embed,
                include_heads=self.include_heads)
        return self._specs[key]

    def plan_specs(self, params: Tree, plan) -> Dict[str, PayloadSpec]:
        """Download/upload specs of a RoundPlan, with the membership rules
        of the analytic accounting (``comm.plan_payloads``)."""
        return {d: self.spec(params, rng, include_embed=emb)
                for d, (rng, emb) in comm.plan_payloads(plan).items()}

    @staticmethod
    def wire_bytes(spec: PayloadSpec) -> int:
        """Bytes on the wire: the fp32 buffer itself."""
        return spec.payload_bytes

    def stats(self, spec: PayloadSpec) -> Dict[str, int]:
        return {"wire_bytes": self.wire_bytes(spec),
                "payload_bytes": spec.payload_bytes}

    def broadcast(self, online: Tree, plan):
        """Server -> clients: (the tree clients train from, stats). Leaves
        outside the payload keep the server's tensors; they stand in for
        the client's cached copy, which the plan says is current."""
        spec = self.plan_specs(online, plan)["download"]
        view = unpack_stage_payload(online, pack_stage_payload(online, spec),
                                    spec)
        return view, self.stats(spec)

    def decode_uploads(self, server_online: Tree, outs: Sequence[Tree],
                       plan) -> Tuple[List[Tree], Dict[str, int]]:
        """Clients -> server, without aggregation: each client's payload
        scattered onto the server's tree."""
        spec = self.plan_specs(server_online, plan)["upload"]
        trees = [unpack_stage_payload(server_online,
                                      pack_stage_payload(out, spec), spec)
                 for out in outs]
        return trees, self.stats(spec)

    def aggregate_uploads(self, server_online: Tree, outs: Sequence[Tree],
                          plan, weights: torch.Tensor):
        """Clients -> server: FedAvg over the decoded uploads. Returns
        (aggregated tree, per-client upload stats)."""
        trees, stats = self.decode_uploads(server_online, outs, plan)
        return aggregate.fedavg(trees, weights), stats
