"""Hopper wire pack / unpack: one launch each over a device-side slot table.

Replaces ``src/repro/kernels/pack.py::gather_pack`` (``pallas_call`` at
:60) and ``::scatter_unpack`` (``pallas_call`` at :95). The kernels are in
``csrc/pack.cu``; its header says what bounds them on the H100 (bytes:
2 x payload / 3.35 TB/s) and how the chunked slot table deals with slots
from 192 to 16.7M elements in one launch.

The TPU ``scatter_unpack`` aliases its base leaves. This one writes fresh
output leaves: the transport hands the server's ``online`` tree as the base
of every client's upload, so writing into it would corrupt the next
client's payload. Unpacking in place would be safe only into a tree that
no later unpack reads as its base, such as a client's private copy of a
broadcast.

These functions take CUDA tensors only and are called through
``repro_torch.kernels.ops``, which counts launches and sends CPU tensors to
the plain versions in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

_c = ctypes.c_void_p


def _declare(lib) -> None:
    lib.gather_pack_launch.argtypes = [_c, ctypes.c_int, ctypes.c_longlong,
                                       _c, _c]
    lib.gather_pack_launch.restype = ctypes.c_int
    lib.scatter_unpack_launch.argtypes = [_c, _c, ctypes.c_int,
                                          ctypes.c_longlong, _c]
    lib.scatter_unpack_launch.restype = ctypes.c_int
    lib.wire_error_string.argtypes = [ctypes.c_int]
    lib.wire_error_string.restype = ctypes.c_char_p
    lib.wire_chunk_elems.argtypes = []
    lib.wire_chunk_elems.restype = ctypes.c_longlong


def _lib():
    return build.load("pack", _declare)


def _check_leaf(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 \
            or not t.is_contiguous():
        raise ValueError(f"{what}: the wire kernels take contiguous float32 "
                         f"CUDA tensors, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _device_table(rows, device) -> torch.Tensor:
    """The slot table on the card, copied from pinned memory without
    blocking the host (a copy from pageable memory would synchronise the
    stream on every pack). The caching host allocator keeps the pinned
    buffer until the copy has run."""
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def gather_pack(srcs: Sequence[torch.Tensor],
                layout: Sequence[Tuple[int, int, int]],
                total: int) -> torch.Tensor:
    """``srcs``: one contiguous fp32 leaf per layout row (any shape, read
    raveled); ``layout``: ``((src_off, dst_off, size), ...)``. Returns the
    (total,) fp32 wire buffer."""
    if len(srcs) != len(layout) or not layout:
        raise ValueError("gather_pack needs one leaf per layout row")
    lib = _lib()
    chunk = lib.wire_chunk_elems()
    device = srcs[0].device
    rows, nchunks, covered = [], 0, []
    for src, (src_off, dst_off, size) in zip(srcs, layout):
        _check_leaf(src, "gather_pack")
        if src.device != device:
            raise ValueError("gather_pack: leaves on different devices")
        if src_off < 0 or src_off + size > src.numel() or dst_off < 0 \
                or dst_off + size > total:
            raise ValueError(f"gather_pack: slot {(src_off, dst_off, size)} "
                             f"out of range")
        rows.append((src.data_ptr(), src_off, dst_off, size, nchunks))
        nchunks += -(-size // chunk)
        covered.append((dst_off, size))
    # slots that tile [0, total) leave nothing to clear
    tiled = sorted(covered)
    pos = 0
    for off, size in tiled:
        if off != pos:
            break
        pos += size
    flat = (torch.empty if pos == total else torch.zeros)(
        total, dtype=torch.float32, device=device)
    table = _device_table(rows, device)
    build.check(lib.gather_pack_launch(table.data_ptr(), len(rows), nchunks,
                                       flat.data_ptr(), _stream(device)),
                lib.wire_error_string, "gather_pack")
    return flat


def scatter_unpack(flat: torch.Tensor, bases: Sequence[torch.Tensor],
                   layout: Sequence[Tuple[int, int, int]]
                   ) -> List[torch.Tensor]:
    """Inverse of ``gather_pack``: for each layout row, a new leaf equal to
    its base with ``[src_off, src_off + size)`` taken from
    ``flat[dst_off, dst_off + size)``. Bases are read, never written."""
    if len(bases) != len(layout) or not layout:
        raise ValueError("scatter_unpack needs one base per layout row")
    _check_leaf(flat, "scatter_unpack")
    lib = _lib()
    chunk = lib.wire_chunk_elems()
    device = flat.device
    rows, outs, nchunks = [], [], 0
    for base, (src_off, dst_off, size) in zip(bases, layout):
        _check_leaf(base, "scatter_unpack")
        if base.device != device:
            raise ValueError("scatter_unpack: leaves on different devices")
        n = base.numel()
        if src_off < 0 or src_off + size > n or dst_off < 0 \
                or dst_off + size > flat.numel():
            raise ValueError(f"scatter_unpack: slot "
                             f"{(src_off, dst_off, size)} out of range")
        out = torch.empty_like(base)
        # a slot that covers the whole leaf never reads its base
        base_ptr = 0 if size == n else base.data_ptr()
        rows.append((base_ptr, out.data_ptr(), n, src_off, dst_off, size,
                     nchunks))
        nchunks += -(-n // chunk)
        outs.append(out)
    table = _device_table(rows, device)
    build.check(lib.scatter_unpack_launch(flat.data_ptr(), table.data_ptr(),
                                          len(rows), nchunks,
                                          _stream(device)),
                lib.wire_error_string, "scatter_unpack")
    return outs
