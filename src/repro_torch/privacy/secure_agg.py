"""Pairwise-mask additive secure aggregation over the flat wire payload
(``repro.privacy.secure_agg``), on the payload's device.

Bonawitz et al. 2017 shape: every surviving client pair (a, b), a < b,
derives the same mask vector ``m_ab`` from a shared per-round seed; the
lower id adds it to its (weighted, fixed-point) payload, the higher id
subtracts it. Each masked message is uniformly random, but the masks
telescope out of the sum, so the server recovers exactly

  Σ_i  fix(w_i · x_i)

and nothing else. Cancellation must be bit-exact, which floats cannot
promise, so payloads ride the wire as two's-complement fixed point:

  q = round(w · x · 2^f)   (mod 2^64),   f = ``fraction_bits``

The reference holds them in numpy uint64. ``torch.uint64`` has no add, so
the port holds the same bits in int64 tensors, whose add wraps mod 2^64
(two's complement) on the CPU and the card alike: masked and unmasked sums
agree to the bit, and both equal the reference's. ``w·x`` is computed in
float64 from the fp32 payload and the weight as given (the fp32 FedAvg
weight, or the buffered-async policy's float64 staleness weight), clamped
to ±R, rounded half to even (``torch.round``, as ``np.rint``), so every
quantized element is the reference's.

Masks are the port's own PRG (a ``torch.Generator`` on the payload's
device, ``random_`` over the full int64 range), not numpy's: only the
aggregate has to match the reference, and the masks cancel out of it.
They are generated over chunks of ``chunk`` elements, each chunk's mask
derived from (round seed, low id, high id, chunk index), so a client's
masking never holds more than a chunk of mask: the LM's payload is 747 M
floats, one whole mask would be 5.98 GB. Every client forms its own masked
message (deriving each pair's mask itself, as the protocol does), and the
server adds it to its int64 accumulator; the clients' fp32 payloads are
visited one at a time.

Dropouts: as in the reference, survivor-set re-masking (masks are
derived over exactly the set of updates entering the sum), in place of
the protocol's secret-shared mask recovery.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import torch

from repro_torch.federated.draws import derive_seed

MASK_DTYPE = torch.int64
MASK_ITEMSIZE = 8                  # bytes per element on the wire
# elements per mask chunk: 32 MiB of int64 a chunk
MASK_CHUNK = 1 << 22
_INT64_MIN = -(1 << 63)


def _chunk_mask(seed: Sequence[int], lo: int, hi: int, chunk: int,
                size: int, device) -> torch.Tensor:
    """The pair's mask over one chunk: ``size`` int64 values uniform over
    all 2^64 bit patterns."""
    g = torch.Generator(device).manual_seed(derive_seed(*seed, lo, hi, chunk))
    return torch.empty(size, dtype=MASK_DTYPE, device=device).random_(
        _INT64_MIN, None, generator=g)


def check_round(n: int, weights, client_ids):
    """(ids, weights) as ints and floats for ``n`` payloads; raises on
    duplicate ids, mismatched lengths or an empty round."""
    ids = [int(c) for c in client_ids]
    weights = [float(w) for w in weights]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate client ids in survivor set: {ids}")
    if n != len(ids) or len(weights) != len(ids):
        raise ValueError("flats / weights / client_ids length mismatch")
    if not ids:
        raise ValueError("nothing to aggregate")
    return ids, weights


class SecureAggregator:
    """Fixed-point pairwise masking over flat fp32 payloads.

    ``fraction_bits`` sets the quantization step 2^-f; ``value_range``
    clamps |w·x| before quantization: with f = 40 and R = 256 each term is
    < 2^48, room for ~2^15 clients in the int64 sum. ``chunk`` is the mask
    chunk in elements; both ends of a pair must use the same one.
    """

    def __init__(self, fraction_bits: int = 40, value_range: float = 256.0,
                 chunk: int = MASK_CHUNK):
        if not (1 <= fraction_bits <= 52):
            # 2^f must stay exactly representable in the float64 staging
            raise ValueError(
                f"fraction_bits must be in [1, 52]: {fraction_bits}")
        if value_range <= 0:
            raise ValueError(f"value_range must be > 0: {value_range}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1: {chunk}")
        self.fraction_bits = int(fraction_bits)
        self.value_range = float(value_range)
        self.chunk = int(chunk)
        self._scale = float(2 ** fraction_bits)

    def _chunks(self, n: int) -> Iterable[tuple]:
        """(chunk index, slice) over ``n`` elements."""
        for c, start in enumerate(range(0, n, self.chunk)):
            yield c, slice(start, min(n, start + self.chunk))

    # -- fixed point --------------------------------------------------------
    def quantize(self, flat: torch.Tensor, weight: float) -> torch.Tensor:
        """fp32 payload -> weighted two's-complement fixed point (int64)."""
        x = flat.to(torch.float64) * float(weight)
        x = torch.clamp(x, -self.value_range, self.value_range)
        return torch.round(x * self._scale).to(MASK_DTYPE)

    def dequantize(self, acc: torch.Tensor) -> torch.Tensor:
        """int64 modular sum -> fp32, a chunk at a time."""
        out = torch.empty(acc.shape[0], dtype=torch.float32,
                          device=acc.device)
        for _, s in self._chunks(acc.shape[0]):
            out[s] = (acc[s].to(torch.float64) / self._scale).to(
                torch.float32)
        return out

    # -- masks --------------------------------------------------------------
    def pair_mask(self, seed: Sequence[int], a: int, b: int, n: int,
                  device="cpu") -> torch.Tensor:
        """The shared mask for client pair (a, b) over ``n`` elements, chunk
        by chunk from (round seed, min id, max id, chunk): both endpoints
        derive the identical vector."""
        if a == b:
            raise ValueError("a client does not mask against itself")
        lo, hi = min(int(a), int(b)), max(int(a), int(b))
        return torch.cat([_chunk_mask(seed, lo, hi, c, s.stop - s.start,
                                      device)
                          for c, s in self._chunks(n)])

    def _mask_chunk(self, y: torch.Tensor, c: int, client_id: int,
                    survivors: Sequence[int], seed: Sequence[int]) -> None:
        """Add (lower id) or subtract (higher id) chunk ``c`` of the pair
        mask against every other survivor into ``y``, in place."""
        for other in survivors:
            o = int(other)
            if o == client_id:
                continue
            lo, hi = min(client_id, o), max(client_id, o)
            m = _chunk_mask(seed, lo, hi, c, y.shape[0], y.device)
            if client_id < o:
                y.add_(m)
            else:
                y.sub_(m)

    def mask_payload(self, q: torch.Tensor, client_id: int,
                     survivors: Sequence[int], seed: Sequence[int]
                     ) -> torch.Tensor:
        """One client's wire message: fixed-point payload plus/minus the
        pairwise masks against every other survivor (mod 2^64)."""
        y = q.clone()
        for c, s in self._chunks(q.shape[0]):
            self._mask_chunk(y[s], c, int(client_id), survivors, seed)
        return y

    # -- aggregation --------------------------------------------------------
    def accumulate(self, acc: torch.Tensor, flat: torch.Tensor,
                   weight: float, client_id: int,
                   survivors: Sequence[int], seed: Sequence[int], *,
                   mask: bool = True) -> None:
        """Add one client's (masked) fixed-point message into ``acc``,
        chunk by chunk: the client's quantized chunk, its masks, the sum."""
        for c, s in self._chunks(flat.shape[0]):
            y = self.quantize(flat[s], weight)
            if mask:
                self._mask_chunk(y, c, int(client_id), survivors, seed)
            acc[s] += y

    def aggregate(self, flats, weights, client_ids, seed: Sequence[int],
                  *, mask: bool = True) -> torch.Tensor:
        """Weighted FedAvg sum through the masked fixed-point pipeline.

        ``mask=False`` runs the identical fixed-point path without masks:
        the reference the bit-identity tests compare against. Returns the
        fp32 flat aggregate Σ_i w_i · x_i on the payloads' device.
        """
        ids, weights = check_round(len(flats), weights, client_ids)
        acc = torch.zeros(flats[0].shape[0], dtype=MASK_DTYPE,
                          device=flats[0].device)
        for flat, w, cid in zip(flats, weights, ids):
            self.accumulate(acc, flat, w, cid, ids, seed, mask=mask)
        return self.dequantize(acc)

    def masked_bytes(self, total: int) -> int:
        """Wire size of one client's masked payload: 8 bytes per element."""
        return int(total) * MASK_ITEMSIZE
