"""Operations and bytes of one call of the port's hand-written forward
kernels, from shapes (the counts ``chip_smoke.py`` holds its kernel table
to). Bytes count each input read once and each output written once."""
from __future__ import annotations


def attention_fwd(B: int, S: int, T: int, H: int, hd: int, dv: int,
                  causal: bool, elem: int = 2):
    """(flops, bytes) of attention over (B, S, H, hd) queries and (B, T, H,
    hd / dv) keys and values: q.k^T and p.v, the causal half where causal;
    q, k, v read and the output written in ``elem``-byte elements."""
    flops = 2 * B * H * S * T * (hd + dv)
    if causal:
        flops //= 2
    nbytes = elem * B * H * (S * hd + T * hd + T * dv + S * dv)
    return flops, nbytes


def ssd_scan_fwd(B: int, S: int, H: int, P: int, N: int, chunk: int):
    """(flops, bytes) of the chunked SSD scan: C.B^T over each chunk's
    causal half (Q (Q + 1) / 2 entries, 2 N operations each) once per
    sequence and chunk, since B and C are shared by the heads; per head and
    chunk the masked products with x over the causal half and the state's
    way in and out (4 Q N P). fp32 xh, dt, dt A, B, C read; y and the final
    state written."""
    Q = chunk
    nc = S // Q
    flops = B * nc * Q * (Q + 1) * N \
        + B * H * nc * (Q * (Q + 1) * P + 4 * Q * N * P)
    nbytes = 4 * (2 * B * S * H * P + 2 * B * S * H + 2 * B * S * N
                  + B * H * P * N)
    return flops, nbytes
