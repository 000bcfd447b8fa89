"""Hopper wire codecs: int8 quant / dequant over a device-side segment
table, and top-k with error feedback.

Replaces ``src/repro/kernels/wire_codecs.py::int8_quant_matrix``
(``pallas_call`` at :80), ``::int8_dequant_matrix`` (:110),
``::compensate`` (:152) and ``::topk_ef_update`` (:209). The kernels are in
``csrc/wire_codecs.cu``; its header says what bounds them on the H100
(bytes) and how the TPU's sequential grids became Hopper designs: the int8
absmax carried from phase 0 to phase 1 is a pass with one ``atomicMax`` per
column and block, then a quantize pass that walks the tiles backwards to
find pass 1's last lines in L2 (4n bytes read twice, n written); the
running tie count of the EF update is a single-pass chained scan with
decoupled look-back (4n read, 4n written, 8 bytes per selected entry).

The TPU quantizer takes one (R, C) matrix per call; this one takes the
whole payload and its segment table, so an upload of 24 slots is two
launches, not 48. The TPU EF update returns the residual only; this one
also writes the selected (index, value) pairs, in position order.

These functions take CUDA tensors only and are called through
``repro_torch.kernels.ops``, which counts launches and sends CPU tensors to
the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
# (device, segments, scales, alignment) -> (quantizer table on the card,
# tile count)
_QUANT_TABLES: dict = {}


def _declare(lib) -> None:
    lib.int8_quant_plan.argtypes = [_c, ctypes.c_int, ctypes.c_int, _c]
    lib.int8_quant_plan.restype = _ll
    lib.int8_quant_launch.argtypes = [_c, ctypes.c_int, _ll, _c, _c, _ll, _c,
                                      _c, _c]
    lib.int8_quant_launch.restype = ctypes.c_int
    lib.int8_dequant_launch.argtypes = [_c, ctypes.c_int, _ll, _c, _c, _c,
                                        _c]
    lib.int8_dequant_launch.restype = ctypes.c_int
    lib.compensate_launch.argtypes = [_c, _c, _c, _c, _c, _ll, _c]
    lib.compensate_launch.restype = ctypes.c_int
    lib.topk_ef_update_launch.argtypes = [_c, _ll, _c, _c, _c, _c, _c, _c,
                                          _ll, _c, _c]
    lib.topk_ef_update_launch.restype = ctypes.c_int
    lib.wire_codecs_error_string.argtypes = [ctypes.c_int]
    lib.wire_codecs_error_string.restype = ctypes.c_char_p
    lib.int8_chunk_rows.argtypes = [_ll]
    lib.int8_chunk_rows.restype = _ll
    lib.ef_tile_elems.argtypes = []
    lib.ef_tile_elems.restype = _ll


def _lib():
    return build.load("wire_codecs", _declare)


def _check(t: torch.Tensor, dtype, what: str, numel=None) -> None:
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what}: the wire codec kernels take contiguous "
                         f"{dtype} CUDA tensors, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{what}: {t.numel()} elements, expected {numel}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_segs(segs, total: int, nscales: int) -> None:
    """``segs`` rows are ``(offset, size, channels, scale_offset)``."""
    for off, size, ch, soff in segs:
        if ch < 1 or size % ch or off < 0 or off + size > total \
                or soff < 0 or soff + ch > nscales:
            raise ValueError(f"int8 segment {(off, size, ch, soff)} does not "
                             f"fit a payload of {total} and {nscales} scales")


def _seg_table(lib, segs: Sequence[Tuple[int, int, int, int]], total: int,
               nscales: int, device) -> Tuple[torch.Tensor, int]:
    """The dequant chunk table on the card and its chunk count."""
    _check_segs(segs, total, nscales)
    rows, nchunks = [], 0
    for off, size, ch, soff in segs:
        nrows = size // ch
        rpc = lib.int8_chunk_rows(ch)
        rows.append((off, nrows, ch, soff, rpc, nchunks))
        nchunks += -(-nrows // rpc)
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True), nchunks


def _quant_table(lib, flat: torch.Tensor, segs, nscales: int
                 ) -> Tuple[torch.Tensor, int]:
    """The quantizer's table on the card (``int8_quant_plan``: float4 tiles
    where the slot's offset and width allow, then each tile's row) and its
    tile count. Kept per layout: an upload of one stage reuses it, so a
    call moves nothing from the host."""
    aligned = int(flat.data_ptr() % 16 == 0)
    key = (flat.device, tuple(map(tuple, segs)), nscales, aligned)
    if key not in _QUANT_TABLES:
        _check_segs(segs, flat.numel(), nscales)
        spec = torch.tensor(segs, dtype=torch.int64).reshape(-1, 4)
        ntiles = lib.int8_quant_plan(spec.data_ptr(), len(segs), aligned,
                                     None)
        host = torch.empty(10 * len(segs) + ntiles, dtype=torch.int64)
        lib.int8_quant_plan(spec.data_ptr(), len(segs), aligned,
                            host.data_ptr())
        if len(_QUANT_TABLES) >= 16:
            _QUANT_TABLES.clear()
        # a blocking copy: the table is ready for any stream that reads it
        _QUANT_TABLES[key] = (host.to(flat.device), ntiles)
    return _QUANT_TABLES[key]


def int8_quant(flat: torch.Tensor, segs, nscales: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-segment, per-column int8 of the (total,) fp32 payload ``flat``.
    Returns (q int8 (total,), scales fp32 (nscales,)). Every element of
    ``flat`` must lie in one segment."""
    _check(flat, torch.float32, "int8_quant")
    if sum(s[1] for s in segs) != flat.numel() or \
            sum(s[2] for s in segs) != nscales:
        raise ValueError("int8_quant: the segments must cover the payload "
                         "and its scales")
    lib = _lib()
    device = flat.device
    table, ntiles = _quant_table(lib, flat, segs, nscales)
    amax = torch.empty(nscales, dtype=torch.int32, device=device)
    q = torch.empty(flat.numel(), dtype=torch.int8, device=device)
    scales = torch.empty(nscales, dtype=torch.float32, device=device)
    build.check(lib.int8_quant_launch(table.data_ptr(), len(segs), ntiles,
                                      flat.data_ptr(), amax.data_ptr(),
                                      nscales, q.data_ptr(),
                                      scales.data_ptr(), _stream(device)),
                lib.wire_codecs_error_string, "int8_quant")
    return q, scales


def int8_dequant(q: torch.Tensor, scales: torch.Tensor, segs,
                 total: int) -> torch.Tensor:
    """Inverse of ``int8_quant``: (total,) fp32 = q * scale[column]."""
    _check(q, torch.int8, "int8_dequant", total)
    _check(scales, torch.float32, "int8_dequant")
    if sum(s[1] for s in segs) != total:
        raise ValueError("int8_dequant: the segments must cover the payload")
    lib = _lib()
    device = q.device
    table, nchunks = _seg_table(lib, segs, total, scales.numel(), device)
    out = torch.empty(total, dtype=torch.float32, device=device)
    build.check(lib.int8_dequant_launch(table.data_ptr(), len(segs), nchunks,
                                        q.data_ptr(), scales.data_ptr(),
                                        out.data_ptr(), _stream(device)),
                lib.wire_codecs_error_string, "int8_dequant")
    return out


def compensate(flat: torch.Tensor, ref: torch.Tensor, res
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c, |c|) with c = (flat - ref) + res over (n,) fp32 buffers; ``res``
    None adds zeros."""
    n = flat.numel()
    _check(flat, torch.float32, "compensate")
    _check(ref, torch.float32, "compensate", n)
    if res is not None:
        _check(res, torch.float32, "compensate", n)
    lib = _lib()
    c = torch.empty_like(flat)
    a = torch.empty_like(flat)
    build.check(lib.compensate_launch(
        flat.data_ptr(), ref.data_ptr(), 0 if res is None else res.data_ptr(),
        c.data_ptr(), a.data_ptr(), n, _stream(flat.device)),
        lib.wire_codecs_error_string, "compensate")
    return c, a


def topk_ef_update(comp: torch.Tensor, thresh: torch.Tensor,
                   needed: torch.Tensor, k: int, *, selected=None):
    """Top-k selection by threshold and tie rank, and the EF update.
    ``thresh``: the k-th magnitude (one fp32 on the card); ``needed``: the
    number of ``== thresh`` entries kept (one int64 on the card). Returns
    (new residual (n,), idx int32 (k,), val fp32 (k,)), the pairs in
    position order. ``selected``, a one-element int64 CUDA tensor, receives
    the number of entries the kernel selected (k when the threshold is
    right). ``n`` must be below 2**31: the indices are int32 and the
    look-back packs 31-bit counts."""
    n = comp.numel()
    _check(comp, torch.float32, "topk_ef_update")
    _check(thresh, torch.float32, "topk_ef_update", 1)
    _check(needed, torch.int64, "topk_ef_update", 1)
    if n >= 2 ** 31:
        raise ValueError(f"topk_ef_update: {n} entries; int32 indices and "
                         f"31-bit counts take fewer than 2**31")
    if not 1 <= k <= n:
        raise ValueError(f"topk_ef_update: k={k} for {n} entries")
    lib = _lib()
    device = comp.device
    state = torch.empty(-(-n // lib.ef_tile_elems()) + 1, dtype=torch.int64,
                        device=device)
    if selected is None:
        selected = torch.empty(1, dtype=torch.int64, device=device)
    _check(selected, torch.int64, "topk_ef_update", 1)
    new_res = torch.empty_like(comp)
    idx = torch.empty(k, dtype=torch.int32, device=device)
    val = torch.empty(k, dtype=torch.float32, device=device)
    build.check(lib.topk_ef_update_launch(
        comp.data_ptr(), n, thresh.data_ptr(), needed.data_ptr(),
        state.data_ptr(), new_res.data_ptr(), idx.data_ptr(), val.data_ptr(),
        k, selected.data_ptr(), _stream(device)),
        lib.wire_codecs_error_string, "topk_ef_update")
    return new_res, idx, val
