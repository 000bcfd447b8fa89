// Slot-table wire pack / unpack for the fp32 transport payload.
//
// Replaces src/repro/kernels/pack.py::gather_pack (pallas_call at :60,
// body _pack_kernel :39) and ::scatter_unpack (pallas_call at :95, body
// _unpack_kernel :71).
//
// gather_pack     every slot copies leaf[src_off, src_off + size) into
//                 flat[dst_off, dst_off + size).
// scatter_unpack  every slot writes a complete output leaf: the slot range
//                 [src_off, src_off + size) comes from flat[dst_off, ...),
//                 the rest of the leaf from its base. The output is a fresh
//                 buffer, never the base (the transport reuses one base
//                 tree for every client's upload).
//
// Bound on the H100: bytes. Each payload element is read once and written
// once, so the least time is 2 * 4 * total / 3.35 TB/s (about 51 us for an
// 85 MB upload). The TPU kernel issued one DMA per slot; here the slots are
// cut into fixed chunks of CHUNK elements, and one block copies one chunk,
// so a 64 MB head leaf and a 768 B norm scale share one launch without
// idle blocks. A block moves 16-byte vectors where source and destination
// have the same alignment modulo 16 bytes, with scalar head and tail; the
// copy is bit-exact by construction.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 8192;  // elements per block: 256 threads x 4 x 8

struct PackSlot {          // one row of the gather table (all int64)
  long long src;           // device address of the raveled leaf
  long long src_off;       // first element of the leaf that travels
  long long dst_off;       // its element offset in the flat buffer
  long long size;          // element count
  long long chunk_begin;   // first chunk index of this slot
};

struct UnpackSlot {        // one row of the scatter table (all int64)
  long long base;          // device address of the base leaf (0: unused)
  long long out;           // device address of the output leaf
  long long numel;         // elements of the whole leaf
  long long src_off;       // slot range inside the leaf
  long long dst_off;       // slot range inside the flat buffer
  long long size;
  long long chunk_begin;
};

__device__ __forceinline__ void copy_range(const float* __restrict__ src,
                                           float* __restrict__ dst,
                                           long long n) {
  if (n <= 0) return;
  const int t = threadIdx.x;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src) & 15;
  const uintptr_t da = reinterpret_cast<uintptr_t>(dst) & 15;
  if (sa != da) {          // relative misalignment: scalar copy
    for (long long i = t; i < n; i += THREADS) dst[i] = src[i];
    return;
  }
  long long head = ((16 - da) & 15) / 4;
  if (head > n) head = n;
  for (long long i = t; i < head; i += THREADS) dst[i] = src[i];
  const long long nvec = (n - head) / 4;
  const float4* __restrict__ s4 = reinterpret_cast<const float4*>(src + head);
  float4* __restrict__ d4 = reinterpret_cast<float4*>(dst + head);
#pragma unroll 4
  for (long long i = t; i < nvec; i += THREADS) d4[i] = s4[i];
  for (long long i = head + nvec * 4 + t; i < n; i += THREADS) dst[i] = src[i];
}

template <typename Slot>
__device__ __forceinline__ int find_slot(const Slot* slots, int nslots,
                                         long long chunk) {
  int s = 0;
  while (s + 1 < nslots && slots[s + 1].chunk_begin <= chunk) ++s;
  return s;
}

__global__ void __launch_bounds__(THREADS)
gather_pack_kernel(const PackSlot* __restrict__ slots, int nslots,
                   float* __restrict__ flat) {
  const long long chunk = blockIdx.x;
  const PackSlot s = slots[find_slot(slots, nslots, chunk)];
  const long long a = (chunk - s.chunk_begin) * CHUNK;
  long long n = s.size - a;
  if (n > CHUNK) n = CHUNK;
  const float* src = reinterpret_cast<const float*>(s.src) + s.src_off + a;
  copy_range(src, flat + s.dst_off + a, n);
}

__global__ void __launch_bounds__(THREADS)
scatter_unpack_kernel(const float* __restrict__ flat,
                      const UnpackSlot* __restrict__ slots, int nslots) {
  const long long chunk = blockIdx.x;
  const UnpackSlot s = slots[find_slot(slots, nslots, chunk)];
  const long long a = (chunk - s.chunk_begin) * CHUNK;
  long long b = a + CHUNK;
  if (b > s.numel) b = s.numel;
  const float* base = reinterpret_cast<const float*>(s.base);
  float* out = reinterpret_cast<float*>(s.out);
  const long long lo = s.src_off, hi = s.src_off + s.size;
  // [a, b) intersected with the three ranges of the leaf
  const long long h1 = b < lo ? b : lo;
  if (h1 > a) copy_range(base + a, out + a, h1 - a);
  const long long m0 = a > lo ? a : lo, m1 = b < hi ? b : hi;
  if (m1 > m0) copy_range(flat + s.dst_off + (m0 - lo), out + m0, m1 - m0);
  const long long t0 = a > hi ? a : hi;
  if (b > t0) copy_range(base + t0, out + t0, b - t0);
}

}  // namespace

extern "C" {

const char* wire_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

long long wire_chunk_elems() { return CHUNK; }

// table: device array of nslots PackSlot rows; nchunks: total chunk count.
int gather_pack_launch(const void* table, int nslots, long long nchunks,
                       void* flat, void* stream) {
  if (nchunks <= 0) return 0;
  gather_pack_kernel<<<static_cast<unsigned>(nchunks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const PackSlot*>(table), nslots,
      static_cast<float*>(flat));
  return static_cast<int>(cudaGetLastError());
}

int scatter_unpack_launch(const void* flat, const void* table, int nslots,
                          long long nchunks, void* stream) {
  if (nchunks <= 0) return 0;
  scatter_unpack_kernel<<<static_cast<unsigned>(nchunks), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(flat),
      static_cast<const UnpackSlot*>(table), nslots);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
