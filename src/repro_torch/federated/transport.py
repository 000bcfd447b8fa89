"""Wire-level transport of stage payloads through a compression codec
(``repro.federated.transport``: its ``PayloadSpec`` layout, codecs,
error-feedback residuals and download mirror).

A round plan's stage range is cut out of every stacked / embed / head
leaf into one flat fp32 buffer (``pack_stage_payload``), pushed through a
codec (encode, decode) and scattered back into a model tree
(``unpack_stage_payload``). Both directions of the FL loop go through
here: the download (server tree -> payload -> wire -> the tree clients
train from, so codec error reaches training) and each client's upload
(trained tree -> payload -> wire -> the tree FedAvg consumes, never the
in-memory original). The layout is the reference's: slots in
``jax.tree_util`` leaf order, so the flat buffers are bit-identical to the
reference's ``pack_stage_payload``.

Codecs (``make_codec``), with the reference's semantics and wire bytes:

  fp32       identity; wire bytes equal ``comm.round_comm_bytes``.
  fp16/bf16  cast on the wire, 2 bytes an element.
  int8       per-channel symmetric quantization (``_int8_channels``), one
             byte an element plus one fp32 scale per channel.
  topk[:f]   top-k of *deltas* against a reference both ends hold, as
             (int32 index, fp32 value) pairs: uploads against the
             downloaded model, with a per-client error-feedback residual
             that resets when the payload layout changes; downloads
             against the server's mirror of what clients hold, with a dense
             fp32 re-sync in the first round under a layout.

The reference has two wire engines (``xla``, ``pallas``) that agree within
the parity contract (``docs/kernels.md``). The port has one wire path: the
kernels of ``kernels.ops`` (slot-table pack / unpack, int8 quant / dequant
over a segment table, compensate and the top-k EF update) on the card,
their plain versions on the CPU. Casts and the top-k decode are plain
PyTorch on both, as in the reference. ``kernels`` keeps the reference's
wire-engine name as a label of the spans.

Privacy (``privacy=``, a ``repro_torch.privacy.PrivacyEngine``; off by
default): with clipping on, every upload's payload is clipped against the
downloaded payload before the codec, for every codec (DP-FedAvg's clip,
the reference's ``_upload_one``), and the upload stats carry the round's
``clip_fraction``, read once a round.

Observability (``obs=``, off by default): the reference's spans
``wire.download`` (codec, kernels, wire and payload bytes, ``dense_sync``
in a top-k re-sync round), ``wire.upload`` (codec, kernels, clients, wire
and payload bytes) and one ``wire.upload.client`` per upload; and the
port's own ``fedavg`` (clients) around ``aggregate_uploads``' mean.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.federated import aggregate, comm
from repro_torch.federated.leaves import classify_leaf, path_keys
from repro_torch.federated.masks import stage_piece
from repro_torch.kernels import ops
from repro_torch.obs import NOOP_OBS

WIRE_DTYPE = torch.float32
CODECS = ("fp32", "fp16", "bf16", "int8", "topk")
Tree = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class LeafSlot:
    path: Tuple[str, ...]     # key path into the params tree
    kind: str                 # stacked | embed | head | extra | staged
    lo: int                   # stacked, staged: first row shipped
    hi: int                   # stacked, staged: one past the last row
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
                       include_heads: bool, stages=None) -> PayloadSpec:
    """Lay out the payload over ``params`` (a flat dict in tree order):
    stacked leaves contribute their ``[lo, hi)`` rows, embed and head
    leaves whole tensors per the flags, extra leaves always; a leaf that
    ``stages`` maps to its stages (the zamba2 topology's rows) travels
    whole when one of them is in the range."""
    lo_req, hi_req = int(stage_range[0]), int(stage_range[1])
    slots: List[LeafSlot] = []
    offset = 0
    for path, a in params.items():
        piece = stage_piece(path, a, lo_req, hi_req, stages)
        if piece is not None:
            kind, lo, hi = piece
            if hi <= lo:
                continue
            shape = tuple(a.shape) if kind == "staged" else \
                (hi - lo,) + tuple(a.shape[1:])
        else:
            kind = classify_leaf(path)
            if (kind == "embed" and not include_embed) or \
                    (kind == "head" and not include_heads):
                continue
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


# -- codecs: encode / decode over the flat payload --------------------------
class Fp32Codec:
    """Identity codec: the uncompressed wire format."""

    name = "fp32"
    error_feedback = False
    delta = False

    def encode(self, flat, spec):
        return {"q": flat}

    def decode(self, wire, spec):
        return wire["q"]

    def wire_bytes(self, spec: PayloadSpec) -> int:
        return 4 * spec.total


class CastCodec:
    """Cast on the wire: an fp16 or bf16 payload, decoded back to fp32."""

    error_feedback = False
    delta = False

    def __init__(self, name: str):
        self.name = name
        self.dtype = torch.float16 if name == "fp16" else torch.bfloat16

    def encode(self, flat, spec):
        return {"q": ops.wire_cast_encode(flat, self.dtype)}

    def decode(self, wire, spec):
        return ops.wire_cast_decode(wire["q"])

    def wire_bytes(self, spec: PayloadSpec) -> int:
        return 2 * spec.total


def _int8_channels(slot: LeafSlot) -> int:
    """Channels of a slot for per-channel scales: the last axis when the
    slot is a proper matrix or stack (>= 4 rows), else one per-tensor
    scale."""
    if len(slot.shape) >= 2:
        ch = slot.shape[-1]
        if slot.size // max(1, ch) >= 4:
            return ch
    return 1


def int8_segs(spec: PayloadSpec) -> Tuple[Tuple[Tuple[int, int, int, int],
                                                ...], int]:
    """(((offset, size, channels, scale_offset), ...), n_scales): the
    segment table of ``ops.wire_int8_encode`` / ``wire_int8_decode``."""
    segs, soff = [], 0
    for s in spec.slots:
        ch = _int8_channels(s)
        segs.append((s.offset, s.size, ch, soff))
        soff += ch
    return tuple(segs), soff


class Int8Codec:
    """Symmetric per-channel int8: q = round(x / s), s = amax_channel / 127.
    The wire carries the int8 payload and one fp32 scale per channel."""

    name = "int8"
    error_feedback = False
    delta = False

    def encode(self, flat, spec):
        q, scales = ops.wire_int8_encode(flat, *int8_segs(spec))
        return {"q": q, "scale": scales}

    def decode(self, wire, spec):
        return ops.wire_int8_decode(wire["q"], wire["scale"],
                                    int8_segs(spec)[0], spec.total)

    def wire_bytes(self, spec: PayloadSpec) -> int:
        return spec.total + 4 * int8_segs(spec)[1]


class TopKCodec:
    """Magnitude top-k of deltas with error feedback: keeps the
    ``fraction`` largest |x| as (int32 index, fp32 value) pairs. The
    transport applies it to differences against a reference both ends hold
    (``delta``), adding each client's dropped mass back into its next
    upload (``error_feedback``)."""

    error_feedback = True
    delta = True

    def __init__(self, fraction: float = 0.1):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1]: {fraction}")
        self.fraction = fraction
        self.name = f"topk:{fraction:g}"

    def k_for(self, spec: PayloadSpec) -> int:
        return max(1, min(spec.total, int(round(spec.total * self.fraction))))

    def encode_delta(self, flat, ref_flat, res, spec):
        """(wire {"idx", "val"}, new residual) of ``flat - ref_flat (+
        res)``."""
        idx, val, new_res = ops.wire_topk_encode_ef(flat, ref_flat, res,
                                                    self.k_for(spec))
        return {"idx": idx, "val": val}, new_res

    def decode(self, wire, spec):
        return ops.wire_topk_decode(wire["idx"], wire["val"], spec.total)

    def wire_bytes(self, spec: PayloadSpec) -> int:
        return 8 * self.k_for(spec)


def make_codec(name: str):
    """Codec registry. ``topk`` takes an optional fraction: ``topk:0.05``."""
    if name == "fp32":
        return Fp32Codec()
    if name in ("fp16", "bf16"):
        return CastCodec(name)
    if name == "int8":
        return Int8Codec()
    if name == "topk" or name.startswith("topk:"):
        return TopKCodec(float(name.split(":", 1)[1]) if ":" in name
                         else 0.1)
    raise ValueError(f"unknown codec '{name}'; one of {CODECS} "
                     f"(topk takes an optional fraction, e.g. topk:0.05)")


def _sparse_add(base_flat: torch.Tensor, wire) -> torch.Tensor:
    """base + scatter(idx, val), without the dense decoded delta: each
    selected entry gets one fp32 add, as ``base + decode(wire)`` does."""
    out = base_flat.clone()
    out.index_add_(0, wire["idx"].long(), wire["val"])
    return out


# -- the transport --------------------------------------------------------------
class Transport:
    """One per FL run: the codec, the per-direction payload specs, the
    per-client error-feedback residuals, the server's download mirror and
    the wire bytes ``run_fedssl`` records in ``FLHistory``."""

    def __init__(self, codec="fp32", *, include_heads: bool = True,
                 kernels: str = "xla", obs=None, privacy=None, stages=None):
        self.codec = make_codec(codec) if isinstance(codec, str) else codec
        self.include_heads = include_heads
        # leaf -> its stages (``lm.leaf_stages``), for the zamba2 topology
        self.stages = stages or {}
        self.kernels = kernels
        self.privacy = privacy
        self.obs = obs if obs is not None else NOOP_OBS
        self._specs: Dict[Tuple, PayloadSpec] = {}
        # client id -> (spec the residual was made under, residual)
        self._resid: Dict[object, Tuple[PayloadSpec, torch.Tensor]] = {}
        self._mirror: Optional[Tuple[PayloadSpec, torch.Tensor]] = None

    def spec(self, params: Tree, stage_range, include_embed: bool
             ) -> PayloadSpec:
        key = (tuple((k, tuple(v.shape)) for k, v in params.items()),
               (int(stage_range[0]), int(stage_range[1])), include_embed)
        if key not in self._specs:
            self._specs[key] = build_payload_spec(
                params, stage_range, include_embed=include_embed,
                include_heads=self.include_heads, stages=self.stages)
        return self._specs[key]

    def plan_specs(self, params: Tree, plan) -> Dict[str, PayloadSpec]:
        """Download/upload specs of a RoundPlan, with the membership rules
        of the analytic accounting (``comm.plan_payloads``)."""
        return {d: self.spec(params, rng, include_embed=emb)
                for d, (rng, emb) in comm.plan_payloads(plan).items()}

    def wire_bytes(self, spec: PayloadSpec) -> int:
        """Bytes of the arrays the codec puts on the wire for ``spec``."""
        return self.codec.wire_bytes(spec)

    def stats(self, spec: PayloadSpec, wire_bytes=None) -> Dict[str, int]:
        return {"wire_bytes": self.wire_bytes(spec) if wire_bytes is None
                else wire_bytes,
                "payload_bytes": spec.payload_bytes}

    def _roundtrip(self, flat: torch.Tensor, spec: PayloadSpec):
        codec = self.codec
        return codec.decode(codec.encode(flat, spec), spec)

    # -- error-feedback residuals -------------------------------------------
    def gather_residuals(self, client_ids, spec: PayloadSpec, device
                         ) -> List[Optional[torch.Tensor]]:
        """Each client's residual under ``spec``: zeros for a new client or
        after the payload layout changed (a stage transition resets error
        feedback); None for codecs without error feedback."""
        if not self.codec.error_feedback:
            return [None] * len(client_ids)
        rows = []
        for cid in client_ids:
            held = self._resid.get(cid)
            rows.append(held[1] if held is not None and held[0] == spec
                        else torch.zeros(spec.total, dtype=WIRE_DTYPE,
                                         device=device))
        return rows

    def store_residuals(self, client_ids, spec: PayloadSpec,
                        residuals) -> None:
        if not self.codec.error_feedback:
            return
        for cid, r in zip(client_ids, residuals):
            self._resid[cid] = (spec, r)

    # -- driver-facing operations -------------------------------------------
    def broadcast(self, online: Tree, plan):
        """Server -> clients: (the tree clients train from, stats). Leaves
        outside the payload keep the server's tensors; they stand in for
        the client's cached copy, which the plan says is current.

        Delta codecs (topk) need a shared reference: the first round under
        a payload layout (run start, stage transition) is a dense fp32
        re-sync that seeds the mirror, and its wire bytes are the payload's;
        later rounds ship the top-k of (model - mirror) and advance the
        mirror by what was sent, so what a round drops stays in the next
        round's delta."""
        spec = self.plan_specs(online, plan)["download"]
        with self.obs.tracer.span("wire.download", cat="transport",
                                  codec=self.codec.name,
                                  kernels=self.kernels) as sp:
            flat = pack_stage_payload(online, spec)
            wire_bytes = None
            if not self.codec.delta:
                dec = self._roundtrip(flat, spec)
            else:
                held = self._mirror
                if held is None or held[0] != spec:
                    dec, wire_bytes = flat, spec.payload_bytes
                    sp.set(dense_sync=True)
                else:
                    wire, _ = self.codec.encode_delta(flat, held[1], None,
                                                      spec)
                    dec = _sparse_add(held[1], wire)
                self._mirror = (spec, dec)
            view = unpack_stage_payload(online, dec, spec)
            stats = self.stats(spec, wire_bytes)
            sp.set(**stats)
        return view, stats

    def decode_uploads(self, server_online: Tree, outs: Sequence[Tree],
                       client_ids, plan, ref_online: Optional[Tree] = None
                       ) -> Tuple[List[Tree], Dict[str, int]]:
        """Clients -> server, without aggregation: each client's payload
        through the wire (and its error-feedback residual), scattered onto
        the server's tree. ``ref_online`` is the downloaded tree the
        clients started from, the reference delta codecs subtract (default:
        the server's tree). With clipping on, each payload is clipped
        against the same reference first, and the stats carry the share of
        clients clipped (``clip_fraction``)."""
        spec = self.plan_specs(server_online, plan)["upload"]
        ref_online = server_online if ref_online is None else ref_online
        codec = self.codec
        tracer = self.obs.tracer
        clip = self.privacy is not None and self.privacy.dp
        with tracer.span("wire.upload", cat="transport", codec=codec.name,
                         kernels=self.kernels, clients=len(client_ids),
                         **self.stats(spec)):
            ref_flat = (pack_stage_payload(ref_online, spec)
                        if codec.delta or clip else None)
            device = next(iter(server_online.values())).device
            residuals = self.gather_residuals(client_ids, spec, device)
            trees, new_res, scales = [], [], []
            for cid, out, res in zip(client_ids, outs, residuals):
                # client ids are ints in the drivers but any hashable in
                # direct use: strings stay strings in the span
                with tracer.span("wire.upload.client", cat="transport",
                                 client=cid if isinstance(cid, str)
                                 else int(cid), codec=codec.name):
                    flat = pack_stage_payload(out, spec)
                    if clip:
                        flat, scale = self.privacy.clip(flat, ref_flat)
                        scales.append(scale)
                    if codec.delta:
                        wire, res = codec.encode_delta(flat, ref_flat, res,
                                                       spec)
                        full = _sparse_add(ref_flat, wire)
                    else:
                        full = self._roundtrip(flat, spec)
                    trees.append(unpack_stage_payload(server_online, full,
                                                      spec))
                new_res.append(res)
            self.store_residuals(client_ids, spec, new_res)
        stats = self.stats(spec)
        if scales:
            # one host read a round, after every client's upload
            clipped = int((torch.stack(scales) < 1.0).sum())
            stats["clip_fraction"] = clipped / len(scales)
        return trees, stats

    def aggregate_uploads(self, server_online: Tree, outs: Sequence[Tree],
                          client_ids, plan, weights: torch.Tensor,
                          ref_online: Optional[Tree] = None):
        """Clients -> server: FedAvg over the decoded uploads. Returns
        (aggregated tree, per-client upload stats). With a leaf stage map
        (the zamba2 topology) only the upload's leaves are averaged and
        every other leaf is the server's own tensor, which each decoded
        tree holds as it is: no copy of a frozen stage is made."""
        trees, stats = self.decode_uploads(server_online, outs, client_ids,
                                           plan, ref_online=ref_online)
        with self.obs.tracer.span("fedavg", cat="transport",
                                  clients=len(trees)):
            if not self.stages:
                return aggregate.fedavg(trees, weights), stats
            keys = {_key(s) for s in
                    self.plan_specs(server_online, plan)["upload"].slots}
            avg = aggregate.fedavg([{k: t[k] for k in keys} for t in trees],
                                   weights)
            return {k: avg.get(k, v) for k, v in server_online.items()}, \
                stats
