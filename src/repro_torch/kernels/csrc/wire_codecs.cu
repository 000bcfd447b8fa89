// Compressing wire codecs: int8 per-channel quantization and top-k delta
// sparsification with error feedback, over the flat fp32 transport payload.
//
// Replaces src/repro/kernels/wire_codecs.py:
//   int8_quant_matrix    (pallas_call at :80, body _int8_quant_kernel :52)
//   int8_dequant_matrix  (pallas_call at :110, body _int8_dequant_kernel :100)
//   compensate           (pallas_call at :152, body _compensate_kernel :129)
//   topk_ef_update       (pallas_call at :209, body _ef_update_kernel :165)
//
// Every function here is bound by bytes on the H100 (3.35 TB/s), so each
// design aims at copy bandwidth: 16-byte accesses, neighbouring threads on
// neighbouring addresses, and as few passes over the payload as the
// dependencies allow.
//
// int8 quant  Every payload slot is a (rows, ch) matrix with one scale per
//       column (ch == 1: one scale for the whole slot). The TPU kernel ran a
//       two-phase sequential grid per slot and carried the column absmax in
//       VMEM from phase 0 to phase 1. A single read here would have to hold
//       the 67 MB head matrix on chip until its column maxima are known, and
//       132 SMs hold 30 MB of shared memory, so it stays two launches over
//       one tile table (int8_quant_plan, made once per layout by the
//       wrapper, with each tile's table row beside it): a tile is up to
//       QCOLS columns of float4 vectors (scalars where the slot's offset or
//       width is not a multiple of 4) by enough rows for about QTILE
//       elements, the rows split among row groups so that all 256 threads
//       load. Narrow tiles keep the atomics few: pass 1 keeps each thread's
//       column maxima in registers with QUNROLL rows of loads in flight,
//       folds the row groups in shared memory (ch == 1: a warp, then a block
//       reduction) and does one atomicMax per column per block, on the bit
//       pattern of the non-negative |x| (exact, independent of order), into
//       a scratch the launcher zeroes. Pass 2 forms
//       scale = max(amax, 1e-12f) / 127.0f once per block and writes
//       q = clamp(rintf(x / scale), -127, 127) as char4 stores; it walks the
//       tiles in the reverse order of pass 1, so the lines pass 1 read last,
//       still in the 50 MB L2, are read first. The division is IEEE (no
//       fast-math flags; a multiply by the reciprocal is not bit-identical)
//       and rintf rounds half to even, so q and the scales are
//       bit-identical to the plain PyTorch version and to Int8Codec.
//       Bytes: 4n read twice (the second partly from L2), n written, against
//       the least of 4n read and n written (plus 4 per scale).
// int8 dequant  One launch over its own chunk table (int8_chunk_rows):
//       out = float(q) * scale[col]. n in, 4n out.
// compensate  c = (flat - ref) + res and |c| in one pass (res null: adds
//       +0.0f, exactly what a residual of zeros gives). 12n in, 8n out.
// top-k EF update  Given the k-th magnitude thresh and needed, the number
//       of |c| == thresh entries top-k keeps, select every |c| > thresh and
//       the `needed` lowest-index ties (lax.top_k's order), zero them in the
//       new residual, and write the selected (index, value) pairs in
//       position order. The TPU grid was sequential and carried a running
//       tie count in SMEM; here one launch reads c once, as a single-pass
//       chained scan with decoupled look-back (Merrill & Garland). Tiles of
//       EF_TILE elements are taken in order from an atomic ticket, so every
//       tile's predecessors are already running. A tile is copied into
//       shared memory with cp.async (each warp a contiguous 512-element
//       stretch a 16-byte instruction), so it waits out its look-back
//       holding few registers and many tiles fit on an SM. It ranks its >
//       and == entries with warp scans of one packed (gt << 16 | eq) count,
//       publishes its (gt, eq) counts in a 64-bit status word (a 2-bit flag
//       and two 31-bit counts, n < 2^31) as an aggregate, writes the
//       residual of every vector without a tie (it does not depend on the
//       prefix), reads its predecessors' words for its exclusive prefixes
//       and publishes its inclusive prefix. Only two plain sums are
//       scanned: the ties the earlier tiles keep are min(needed,
//       tie_prefix), so a tile's first output slot is gt_prefix +
//       min(needed, tie_prefix). Its selected entries are gathered in slot
//       order in shared memory and written as runs. The sums are integers,
//       so the result does not depend on the order blocks run in.
//       Bytes: 4n read, 4n of residual written and 8 per selected entry.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long QCHUNK = 8192;    // target elements per dequant chunk
constexpr long long MIN_ROWS = 16;    // rows per dequant chunk at least
constexpr long long QTILE = 16384;    // target elements per quant tile
constexpr int QUNROLL = 4;            // quant rows of loads in flight
constexpr int QCOLS = 64;             // vector columns a quant tile spans
constexpr int EF_THREADS = 256;
constexpr int EF_VECS = 8;            // float4 loads per thread
constexpr int EF_WARP_ELEMS = 32 * 4 * EF_VECS;
constexpr int EF_TILE = EF_THREADS * 4 * EF_VECS;

struct QuantSeg {          // one row of the dequant chunk table (all int64)
  long long off;           // first element of the segment in the payload
  long long rows;          // size / ch
  long long ch;            // columns, one scale each
  long long soff;          // first scale of the segment
  long long rpc;           // rows per chunk
  long long chunk_begin;   // first chunk index of this segment
};

long long chunk_rows(long long ch) {
  long long r = (QCHUNK + ch - 1) / ch;
  return r < MIN_ROWS ? MIN_ROWS : r;
}

__device__ __forceinline__ int find_seg(const QuantSeg* segs, int nsegs,
                                        long long chunk) {
  int s = 0;
  while (s + 1 < nsegs && segs[s + 1].chunk_begin <= chunk) ++s;
  return s;
}

// The (rows x columns) work of one chunk for this thread. Columns narrower
// than the block are repeated in G row groups: thread t takes column t % ch
// of rows r0 + t / ch, r0 + t / ch + G, ... (consecutive threads read
// consecutive elements). Wider segments give every thread the columns
// t, t + THREADS, ... of every row of the chunk.
struct ChunkWork {
  long long r0, r1;   // row range of the chunk
  int g, G;           // this thread's first row offset and the row step
  int c0, cstep;      // first column and column step
  bool active;
};

__device__ __forceinline__ ChunkWork chunk_work(const QuantSeg& s,
                                                long long chunk) {
  ChunkWork w;
  const long long j = chunk - s.chunk_begin;
  w.r0 = j * s.rpc;
  w.r1 = w.r0 + s.rpc < s.rows ? w.r0 + s.rpc : s.rows;
  const int ch = static_cast<int>(s.ch);
  const int t = threadIdx.x;
  if (ch >= THREADS) {
    w.G = 1; w.g = 0; w.c0 = t; w.cstep = THREADS; w.active = true;
  } else {
    w.G = THREADS / ch; w.g = t / ch; w.c0 = t % ch; w.cstep = ch;
    w.active = t < w.G * ch;
  }
  return w;
}

// One row of the quantizer's table (all int64), made on the host by
// int8_quant_plan, which appends each tile's row index. A matrix slot
// (ch > 1) is cut into row blocks of `rpt` rows and column slabs of `cols`
// (at most QCOLS) vectors of `vec` floats; thread t takes vector column
// t % cols of rows t / cols, t / cols + groups, ... (narrow slabs and more
// row groups: fewer atomics for the same tile). A vector slot (ch == 1) is
// cut into runs of `rpt` vectors, thread t taking the vectors t,
// t + THREADS, ...; its last tile also takes the size % vec elements after
// the last whole vector.
struct QuantTile {
  long long off, rows, ch, soff;
  long long vec;           // 4: float4 loads and char4 stores; 1: scalars
  long long cols;          // vector columns a tile spans (1 for ch == 1)
  long long groups;        // row groups, THREADS / cols
  long long rpt;           // rows (ch == 1: vectors) a tile spans
  long long slabs;         // column slabs of a row block
  long long tile_begin;    // first tile of the slot
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float v = rintf(x / scale);                   // IEEE division
  return static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
}

template <int V>
__device__ __forceinline__ void store_q(int8_t* p, const float (&x)[V],
                                        const float (&sc)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<char4*>(p) = make_char4(
        quantize(x[0], sc[0]), quantize(x[1], sc[1]),
        quantize(x[2], sc[2]), quantize(x[3], sc[3]));
  } else {
    *p = quantize(x[0], sc[0]);
  }
}

template <int V>
__device__ __forceinline__ void fold_abs(float (&m)[V], const float (&x)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) m[e] = fmaxf(m[e], fabsf(x[e]));
}

// The rows of a matrix tile that this thread loads: [r, r1) step G.
struct MatrixTile {
  long long c;        // this thread's vector column (valid if < cv)
  long long cv;       // vector columns of the slot
  long long r0, r1;   // the tile's rows
  int g, G;           // this thread's row group and the group count
  bool first_rows;    // the tile holds row 0 (its block writes the scales)
  bool active;
};

__device__ __forceinline__ MatrixTile matrix_tile(const QuantTile& s, int j) {
  MatrixTile w;
  const int slabs = static_cast<int>(s.slabs);
  const int rb = j / slabs;
  const int cols = static_cast<int>(s.cols);
  w.G = static_cast<int>(s.groups);
  w.g = threadIdx.x / cols;
  w.cv = s.ch / s.vec;
  w.c = static_cast<long long>(j - rb * slabs) * cols
      + (threadIdx.x - w.g * cols);
  w.r0 = rb * s.rpt;
  w.r1 = w.r0 + s.rpt < s.rows ? w.r0 + s.rpt : s.rows;
  w.first_rows = rb == 0;
  w.active = w.g < w.G && w.c < w.cv;
  return w;
}

// The largest of one value per thread (thread 0 gets it); every thread
// must call it.
__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <int V>
__device__ __forceinline__ void absmax_tile(const QuantTile& s, int j,
                                            const float* __restrict__ flat,
                                            int* __restrict__ amax,
                                            float* red) {
  const float* x = flat + s.off;
  if (s.ch == 1) {
    const long long units = s.rows / V;
    const long long u1 = (j + 1) * s.rpt < units ? (j + 1) * s.rpt : units;
    float m[V] = {};
    long long u = j * s.rpt + threadIdx.x;
    for (; u + (QUNROLL - 1) * THREADS < u1; u += QUNROLL * THREADS) {
      float a[QUNROLL][V];
#pragma unroll
      for (int k = 0; k < QUNROLL; ++k)
        load_vec<V>(x + (u + k * THREADS) * V, a[k]);
#pragma unroll
      for (int k = 0; k < QUNROLL; ++k) fold_abs<V>(m, a[k]);
    }
    for (; u < u1; u += THREADS) {
      float a[V];
      load_vec<V>(x + u * V, a);
      fold_abs<V>(m, a);
    }
    float mm = m[0];
#pragma unroll
    for (int e = 1; e < V; ++e) mm = fmaxf(mm, m[e]);
    if ((j + 1) * s.rpt * V >= s.rows)      // the last tile: the tail
      for (long long i = units * V + threadIdx.x; i < s.rows; i += THREADS)
        mm = fmaxf(mm, fabsf(x[i]));
    mm = block_max(mm, red);
    // non-negative floats order like their bit patterns as ints
    if (threadIdx.x == 0) atomicMax(amax + s.soff, __float_as_int(mm));
    return;
  }
  const MatrixTile w = matrix_tile(s, j);
  float m[V] = {};
  if (w.active) {
    const float* p = x + w.c * V;
    const long long G = w.G;
    long long r = w.r0 + w.g;
    for (; r + (QUNROLL - 1) * G < w.r1; r += QUNROLL * G) {
      float a[QUNROLL][V];
#pragma unroll
      for (int k = 0; k < QUNROLL; ++k)
        load_vec<V>(p + (r + k * G) * s.ch, a[k]);
#pragma unroll
      for (int k = 0; k < QUNROLL; ++k) fold_abs<V>(m, a[k]);
    }
    for (; r < w.r1; r += G) {
      float a[V];
      load_vec<V>(p + r * s.ch, a);
      fold_abs<V>(m, a);
    }
  }
  if (w.G > 1) {                  // fold the row groups (uniform branch)
    if (w.g < w.G) {
#pragma unroll
      for (int e = 0; e < V; ++e) red[threadIdx.x * V + e] = m[e];
    }
    __syncthreads();
    if (w.g == 0) {
      const int cols = static_cast<int>(s.cols);
      for (int g = 1; g < w.G; ++g) {
#pragma unroll
        for (int e = 0; e < V; ++e)
          m[e] = fmaxf(m[e], red[(g * cols + threadIdx.x) * V + e]);
      }
    }
  }
  if (w.g == 0 && w.c < w.cv) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      atomicMax(amax + s.soff + w.c * V + e, __float_as_int(m[e]));
  }
}

template <int V>
__device__ __forceinline__ void quant_tile(const QuantTile& s, int j,
                                           const float* __restrict__ flat,
                                           const int* __restrict__ amax,
                                           int8_t* __restrict__ q,
                                           float* __restrict__ scales) {
  const float* x = flat + s.off;
  int8_t* qs = q + s.off;
  if (s.ch == 1) {
    const float scale = fmaxf(__int_as_float(amax[s.soff]), 1e-12f)
        / 127.0f;
    if (j == 0 && threadIdx.x == 0) scales[s.soff] = scale;
    float sc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) sc[e] = scale;
    const long long units = s.rows / V;
    const long long u1 = (j + 1) * s.rpt < units ? (j + 1) * s.rpt : units;
    long long u = j * s.rpt + threadIdx.x;
    for (; u + (QUNROLL - 1) * THREADS < u1; u += QUNROLL * THREADS) {
      float a[QUNROLL][V];
#pragma unroll
      for (int k = 0; k < QUNROLL; ++k)
        load_vec<V>(x + (u + k * THREADS) * V, a[k]);
#pragma unroll
      for (int k = 0; k < QUNROLL; ++k)
        store_q<V>(qs + (u + k * THREADS) * V, a[k], sc);
    }
    for (; u < u1; u += THREADS) {
      float a[V];
      load_vec<V>(x + u * V, a);
      store_q<V>(qs + u * V, a, sc);
    }
    if ((j + 1) * s.rpt * V >= s.rows)
      for (long long i = units * V + threadIdx.x; i < s.rows; i += THREADS)
        qs[i] = quantize(x[i], scale);
    return;
  }
  const MatrixTile w = matrix_tile(s, j);
  if (!w.active) return;
  float sc[V];
#pragma unroll
  for (int e = 0; e < V; ++e)
    sc[e] = fmaxf(__int_as_float(amax[s.soff + w.c * V + e]), 1e-12f)
        / 127.0f;
  if (w.first_rows && w.g == 0) {
#pragma unroll
    for (int e = 0; e < V; ++e) scales[s.soff + w.c * V + e] = sc[e];
  }
  const float* p = x + w.c * V;
  int8_t* o = qs + w.c * V;
  const long long G = w.G;
  long long r = w.r0 + w.g;
  for (; r + (QUNROLL - 1) * G < w.r1; r += QUNROLL * G) {
    float a[QUNROLL][V];
#pragma unroll
    for (int k = 0; k < QUNROLL; ++k)
      load_vec<V>(p + (r + k * G) * s.ch, a[k]);
#pragma unroll
    for (int k = 0; k < QUNROLL; ++k)
      store_q<V>(o + (r + k * G) * s.ch, a[k], sc);
  }
  for (; r < w.r1; r += G) {
    float a[V];
    load_vec<V>(p + r * s.ch, a);
    store_q<V>(o + r * s.ch, a, sc);
  }
}

// One block per tile; tile_seg: the table row of each tile.
__global__ void __launch_bounds__(THREADS)
int8_absmax_kernel(const QuantTile* __restrict__ segs,
                   const long long* __restrict__ tile_seg,
                   const float* __restrict__ flat, int* __restrict__ amax) {
  __shared__ float red[THREADS * 4];
  const int tile = blockIdx.x;
  const QuantTile s = segs[tile_seg[tile]];
  const int j = tile - static_cast<int>(s.tile_begin);
  if (s.vec == 4)
    absmax_tile<4>(s, j, flat, amax, red);
  else
    absmax_tile<1>(s, j, flat, amax, red);
}

// Walks the tiles last to first: pass 1's last tiles are still in L2.
__global__ void __launch_bounds__(THREADS)
int8_quant_kernel(const QuantTile* __restrict__ segs,
                  const long long* __restrict__ tile_seg,
                  const float* __restrict__ flat,
                  const int* __restrict__ amax, int8_t* __restrict__ q,
                  float* __restrict__ scales) {
  const int tile = gridDim.x - 1 - blockIdx.x;
  const QuantTile s = segs[tile_seg[tile]];
  const int j = tile - static_cast<int>(s.tile_begin);
  if (s.vec == 4)
    quant_tile<4>(s, j, flat, amax, q, scales);
  else
    quant_tile<1>(s, j, flat, amax, q, scales);
}

__global__ void __launch_bounds__(THREADS)
int8_dequant_kernel(const QuantSeg* __restrict__ segs, int nsegs,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    float* __restrict__ out) {
  const long long chunk = blockIdx.x;
  const QuantSeg s = segs[find_seg(segs, nsegs, chunk)];
  const ChunkWork w = chunk_work(s, chunk);
  if (!w.active) return;
  const int8_t* qs = q + s.off;
  float* o = out + s.off;
  for (long long c = w.c0; c < s.ch; c += w.cstep) {
    const float scale = scales[s.soff + c];
    for (long long r = w.r0 + w.g; r < w.r1; r += w.G) {
      const long long i = r * s.ch + c;
      o[i] = static_cast<float>(qs[i]) * scale;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
compensate_kernel(const float* __restrict__ f, const float* __restrict__ r,
                  const float* __restrict__ e, float* __restrict__ c,
                  float* __restrict__ a, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (VEC) {                 // all five pointers 16-byte aligned
    const long long n4 = n / 4;
    for (long long v = i; v < n4; v += stride) {
      const float4 fv = reinterpret_cast<const float4*>(f)[v];
      const float4 rv = reinterpret_cast<const float4*>(r)[v];
      const float4 ev = e ? reinterpret_cast<const float4*>(e)[v]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 cv;
      cv.x = (fv.x - rv.x) + ev.x;
      cv.y = (fv.y - rv.y) + ev.y;
      cv.z = (fv.z - rv.z) + ev.z;
      cv.w = (fv.w - rv.w) + ev.w;
      reinterpret_cast<float4*>(c)[v] = cv;
      reinterpret_cast<float4*>(a)[v] =
          make_float4(fabsf(cv.x), fabsf(cv.y), fabsf(cv.z), fabsf(cv.w));
    }
    i += n4 * 4;             // the (at most 3) tail elements: threads 0-2
    if (i >= n) return;
  }
  for (; i < n; i += stride) {
    const float v = (f[i] - r[i]) + (e ? e[i] : 0.0f);
    c[i] = v;
    a[i] = fabsf(v);
  }
}

// The top-k look-back status word of a tile: a flag in the top 2 bits, the
// count of |c| > thresh in the next 31 and of |c| == thresh in the low 31.
constexpr unsigned long long EF_AGGREGATE = 1ull << 62;   // the tile's own
constexpr unsigned long long EF_PREFIX = 2ull << 62;      // tiles 0..i
constexpr unsigned long long EF_COUNT = (1ull << 31) - 1;

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes from device memory into shared memory, not through registers
__device__ __forceinline__ void copy16_async(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(gmem) : "memory");
}

// Tile `tile`'s elements into s_c: lane l of warp w copies the float4 at
// w * EF_WARP_ELEMS + l * 4 + v * 128 for v < EF_VECS (cp.async, not
// through registers), so each warp's loads cover 512 contiguous bytes an
// instruction; a lane later reads back only what it copied. VEC: comp is
// 16-byte aligned (else scalar loads).
template <bool VEC>
__device__ __forceinline__ void ef_stage(float* s_c, unsigned tile,
                                         const float* __restrict__ comp,
                                         unsigned n, unsigned ntiles) {
  if (tile >= ntiles) return;
  const int own = (threadIdx.x >> 5) * EF_WARP_ELEMS + (threadIdx.x & 31) * 4;
  const unsigned base = tile * EF_TILE + own;        // below 2^31 + EF_TILE
#pragma unroll
  for (int v = 0; v < EF_VECS; ++v) {
    const unsigned i = base + v * 128;
    float* dst = s_c + own + v * 128;
    if (VEC && i + 3 < n) {
      copy16_async(dst, comp + i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = i + e < n ? comp[i + e] : 0.0f;
    }
  }
}

// Four residual entries from i on: one float4 store where VEC allows.
template <bool VEC>
__device__ __forceinline__ void store_residual(float* __restrict__ new_res,
                                               unsigned i, unsigned n,
                                               const float (&r)[4]) {
  if (VEC && i + 3 < n) {
    *reinterpret_cast<float4*>(new_res + i) =
        make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i + e < n) new_res[i + e] = r[e];
  }
}

// Ranks, look-back and outputs of tile `tile`, whose elements this lane
// copied into s_c. Every thread of the block calls it. The loops over a
// lane's vectors are not unrolled and each vector's rank is scanned again
// for the output, so few registers stay live across the look-back.
template <bool VEC>
__device__ __forceinline__ void ef_tile(
    const float* s_c, unsigned tile, unsigned n, unsigned ntiles, float th,
    unsigned needed, unsigned long long* __restrict__ status,
    float* __restrict__ new_res, int* __restrict__ idx,
    float* __restrict__ val, int k, long long* __restrict__ selected_total,
    unsigned short* s_sel, unsigned* s_warp, unsigned* s_prefix) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int own = warp * EF_WARP_ELEMS + lane * 4;
  const unsigned base = tile * EF_TILE + own;
  // bit v * 4 + e: element e of vector v is > thresh (gtm) or == (eqm)
  unsigned gtm = 0, eqm = 0;
#pragma unroll 2
  for (int v = 0; v < EF_VECS; ++v) {
    const float4 x = *reinterpret_cast<const float4*>(s_c + own + v * 128);
    const float c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = base + v * 128 + e < n;
      const float a = fabsf(c[e]);
      gtm |= static_cast<unsigned>(in && a > th) << (v * 4 + e);
      eqm |= static_cast<unsigned>(in && a == th) << (v * 4 + e);
    }
  }
  // (gt << 16 | eq) counts: a tile holds 8192 elements, so neither half
  // overflows
  unsigned wcount = __popc(gtm) << 16 | __popc(eqm);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wcount += __shfl_xor_sync(0xffffffffu, wcount, o);
  if (lane == 0) s_warp[warp] = wcount;
  __syncthreads();
  unsigned woff = 0, tcount = 0;
#pragma unroll
  for (int w = 0; w < EF_THREADS / 32; ++w) {
    const unsigned x = s_warp[w];
    woff += w < warp ? x : 0u;
    tcount += x;
  }

  const unsigned long long tile_gt = tcount >> 16, tile_eq = tcount & 0xffffu;
  if (warp == 0 && lane == 0 && tile != 0)
    store_status(status + tile, EF_AGGREGATE | tile_gt << 31 | tile_eq);
  // a vector without ties has the same residual whatever the prefix: write
  // it now, while warp 0 waits out the look-back
#pragma unroll 2
  for (int v = 0; v < EF_VECS; ++v) {
    if (eqm >> (v * 4) & 0xfu) continue;
    const float4 x = *reinterpret_cast<const float4*>(s_c + own + v * 128);
    const float c[4] = {x.x, x.y, x.z, x.w};
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] = gtm >> (v * 4 + e) & 1u ? 0.0f : c[e];
    store_residual<VEC>(new_res, base + v * 128, n, r);
  }

  if (warp == 0) {                       // the look-back
    unsigned pre_gt = 0, pre_eq = 0;     // exact prefixes, at most n
    if (tile == 0) {
      if (lane == 0)
        store_status(status, EF_PREFIX | tile_gt << 31 | tile_eq);
    } else {
      for (int look = static_cast<int>(tile) - 1;; look -= 32) {
        // lane l reads tile look - l; a tile before 0 counts as a prefix 0
        const int p = look - lane;
        unsigned long long w = p >= 0 ? load_status(status + p) : EF_PREFIX;
        while (__any_sync(0xffffffffu, (w >> 62) == 0))
          if ((w >> 62) == 0) w = load_status(status + p);
        // sum the words up to the nearest inclusive prefix
        const unsigned prefixes = __ballot_sync(0xffffffffu,
                                                (w >> 62) == 2);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        pre_gt += warp_sum(lane <= stop
                           ? static_cast<unsigned>(w >> 31 & EF_COUNT) : 0u);
        pre_eq += warp_sum(lane <= stop
                           ? static_cast<unsigned>(w & EF_COUNT) : 0u);
        if (prefixes) break;
      }
      if (lane == 0)
        store_status(status + tile, EF_PREFIX | (pre_gt + tile_gt) << 31
                     | (pre_eq + tile_eq));
    }
    if (lane == 0) {
      s_prefix[0] = pre_gt;
      s_prefix[1] = pre_eq;
      if (tile == ntiles - 1) {
        const unsigned eq_all = pre_eq + static_cast<unsigned>(tile_eq);
        *selected_total = pre_gt + static_cast<long long>(tile_gt)
            + (needed < eq_all ? needed : eq_all);
      }
    }
  }
  __syncthreads();
  // ties kept by the earlier tiles: min(needed, tie prefix); this tile keeps
  // its ties of local rank < budget
  const unsigned pre_eq = s_prefix[1];
  const unsigned budget = needed > pre_eq ? needed - pre_eq : 0u;
  const unsigned out0 = s_prefix[0] + (needed < pre_eq ? needed : pre_eq);
  unsigned run = woff;                   // packed counts before vector v
#pragma unroll 2
  for (int v = 0; v < EF_VECS; ++v) {
    const unsigned p = __popc(gtm >> (v * 4) & 0xfu) << 16
        | __popc(eqm >> (v * 4) & 0xfu);
    unsigned x = p;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    const unsigned before = run + x - p;
    run += __shfl_sync(0xffffffffu, x, 31);
    const unsigned i = base + v * 128;
    const float4 xv = *reinterpret_cast<const float4*>(s_c + own + v * 128);
    const float c[4] = {xv.x, xv.y, xv.z, xv.w};
    unsigned gt_before = before >> 16, eq_before = before & 0xffffu;
    float r[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool gt = gtm >> (v * 4 + e) & 1u;
      const bool eq = eqm >> (v * 4 + e) & 1u;
      const bool sel = gt || (eq && eq_before < budget);
      r[e] = sel ? 0.0f : c[e];
      if (sel)                           // its output slot in the tile
        s_sel[gt_before + (eq_before < budget ? eq_before : budget)] =
            static_cast<unsigned short>(own + v * 128 + e);
      gt_before += gt;
      eq_before += eq;
    }
    if (eqm >> (v * 4) & 0xfu) store_residual<VEC>(new_res, i, n, r);
  }
  // the tile's selected entries fill output slots out0, out0 + 1, ...:
  // write them as runs, consecutive threads on consecutive slots
  __syncthreads();
  const unsigned count = static_cast<unsigned>(tile_gt)
      + (budget < tile_eq ? budget : static_cast<unsigned>(tile_eq));
  for (unsigned j = threadIdx.x; j < count; j += EF_THREADS) {
    const unsigned o = s_sel[j];
    if (out0 + j < static_cast<unsigned>(k)) {
      idx[out0 + j] = static_cast<int>(tile * EF_TILE + o);
      val[out0 + j] = s_c[o];
    }
  }
}

// The EF update, one tile of EF_TILE elements per block, the tiles taken
// in order from an atomic ticket (so every tile's predecessors are already
// running). n < 2^31, so indices, counts and output slots are 32-bit.
// VEC: comp and new_res are 16-byte aligned (else every access is a
// scalar one). state: one status word per tile, then the ticket; zeroed
// by the launcher.
template <bool VEC>
__global__ void __launch_bounds__(EF_THREADS)
ef_update_kernel(const float* __restrict__ comp, unsigned n,
                 const float* __restrict__ thresh_p,
                 const long long* __restrict__ needed_p,
                 unsigned long long* __restrict__ state,
                 float* __restrict__ new_res, int* __restrict__ idx,
                 float* __restrict__ val, int k,
                 long long* __restrict__ selected_total) {
  // the tile, then its selected entries' offsets in slot order
  extern __shared__ __align__(16) float s_c[];
  __shared__ unsigned s_tile;
  __shared__ unsigned s_warp[EF_THREADS / 32];       // packed warp counts
  __shared__ unsigned s_prefix[2];                   // gt, eq before the tile
  const unsigned ntiles = (n - 1) / EF_TILE + 1;
  if (threadIdx.x == 0)
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(state + ntiles), 1u);
  const float th = *thresh_p;
  // ties beyond n cannot be kept: needed in [0, n] selects the same entries
  const long long needed_ll = *needed_p;
  const unsigned needed = needed_ll < 0 ? 0u
      : needed_ll > n ? n : static_cast<unsigned>(needed_ll);
  __syncthreads();
  const unsigned tile = s_tile;
  ef_stage<VEC>(s_c, tile, comp, n, ntiles);
  asm volatile("cp.async.wait_all;" ::: "memory");
  ef_tile<VEC>(s_c, tile, n, ntiles, th, needed, state, new_res, idx, val,
               k, selected_total,
               reinterpret_cast<unsigned short*>(s_c + EF_TILE), s_warp,
               s_prefix);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

const char* wire_codecs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

long long int8_chunk_rows(long long ch) { return chunk_rows(ch); }

long long ef_tile_elems() { return EF_TILE; }

// Host side: the quantizer's table. segs: nsegs rows of (offset, size,
// channels, scale_offset); flat_aligned: the payload's first element is
// 16-byte aligned. Returns the number of tiles; unless out is null, writes
// there nsegs QuantTile rows (10 int64 each), then each tile's row index.
long long int8_quant_plan(const long long* segs, int nsegs, int flat_aligned,
                          long long* out) {
  long long tiles = 0;
  for (int i = 0; i < nsegs; ++i) {
    const long long off = segs[4 * i], size = segs[4 * i + 1];
    const long long ch = segs[4 * i + 2];
    QuantTile t;
    t.off = off;
    t.rows = size / ch;
    t.ch = ch;
    t.soff = segs[4 * i + 3];
    t.vec = flat_aligned && off % 4 == 0 && (ch == 1 || ch % 4 == 0) ? 4 : 1;
    long long n_tiles;
    if (ch == 1) {
      t.cols = 1;
      t.groups = THREADS;
      t.rpt = QTILE / t.vec;
      t.slabs = 1;
      n_tiles = (t.rows + t.rpt * t.vec - 1) / (t.rpt * t.vec);
    } else {
      const long long cv = ch / t.vec;
      t.cols = cv < QCOLS ? cv : QCOLS;
      t.groups = THREADS / t.cols;
      const long long r = QTILE / (t.cols * t.vec) / t.groups * t.groups;
      t.rpt = r > t.groups ? r : t.groups;
      t.slabs = (cv + t.cols - 1) / t.cols;
      n_tiles = (t.rows + t.rpt - 1) / t.rpt * t.slabs;
    }
    t.tile_begin = tiles;
    tiles += n_tiles;
    if (!out) continue;
    const long long row[10] = {t.off, t.rows, t.ch, t.soff, t.vec, t.cols,
                               t.groups, t.rpt, t.slabs, t.tile_begin};
    for (int f = 0; f < 10; ++f) out[10 * i + f] = row[f];
    for (long long j = t.tile_begin; j < tiles; ++j) out[10 * nsegs + j] = i;
  }
  return tiles;
}

// table: int8_quant_plan's output for nsegs rows and ntiles tiles, on the
// device; amax: nscales ints of scratch (zeroed here).
int int8_quant_launch(const void* table, int nsegs, long long ntiles,
                      const float* flat, int* amax, long long nscales,
                      int8_t* q, float* scales, void* stream) {
  if (ntiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantTile* segs = static_cast<const QuantTile*>(table);
  const long long* tile_seg = static_cast<const long long*>(table)
      + 10LL * nsegs;
  const unsigned grid = static_cast<unsigned>(ntiles);
  int err = static_cast<int>(cudaMemsetAsync(amax, 0, 4 * nscales, st));
  if (err) return err;
  int8_absmax_kernel<<<grid, THREADS, 0, st>>>(segs, tile_seg, flat, amax);
  err = last_error();
  if (err) return err;
  int8_quant_kernel<<<grid, THREADS, 0, st>>>(segs, tile_seg, flat, amax, q,
                                              scales);
  return last_error();
}

int int8_dequant_launch(const void* table, int nsegs, long long nchunks,
                        const int8_t* q, const float* scales, float* out,
                        void* stream) {
  if (nchunks <= 0) return 0;
  int8_dequant_kernel<<<static_cast<unsigned>(nchunks), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const QuantSeg*>(table), nsegs, q, scales, out);
  return last_error();
}

// res may be null: a residual of zeros.
int compensate_launch(const float* flat, const float* ref, const float* res,
                      float* c, float* a, long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n + 4LL * THREADS - 1) / (4LL * THREADS);
  if (blocks > 132LL * 32) blocks = 132LL * 32;     // grid-stride beyond
  const bool vec = aligned16(flat) && aligned16(ref) && aligned16(c) &&
                   aligned16(a) && (res == nullptr || aligned16(res));
  if (vec)
    compensate_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0,
                              st>>>(flat, ref, res, c, a, n);
  else
    compensate_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0,
                               st>>>(flat, ref, res, c, a, n);
  return last_error();
}

// thresh: 1 float, needed: 1 int64, both on the device; 0 < n < 2^31,
// 1 <= k <= n. state: ceil(n / ef_tile_elems()) + 1 int64 of scratch
// (zeroed here). Outputs: new_res (n), idx and val (k, in position order),
// selected_total (1 int64: the number of entries selected, which is k when
// thresh and needed are those of top-k).
int topk_ef_update_launch(const float* comp, long long n, const float* thresh,
                          const long long* needed, void* state,
                          float* new_res, int* idx, float* val, long long k,
                          long long* selected_total, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + EF_TILE - 1) / EF_TILE;
  int err = static_cast<int>(cudaMemsetAsync(state, 0, 8 * (ntiles + 1),
                                             st));
  if (err) return err;
  unsigned long long* words = static_cast<unsigned long long*>(state);
  const unsigned n32 = static_cast<unsigned>(n);
  const int k32 = static_cast<int>(k);
  const unsigned grid = static_cast<unsigned>(ntiles);
  const int smem = EF_TILE * static_cast<int>(sizeof(float)
                                             + sizeof(unsigned short));
  const bool vec = aligned16(comp) && aligned16(new_res);
  // above 48 KB with the static part: the kernel must be allowed it
  err = static_cast<int>(cudaFuncSetAttribute(
      vec ? ef_update_kernel<true> : ef_update_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  if (vec)
    ef_update_kernel<true><<<grid, EF_THREADS, smem, st>>>(
        comp, n32, thresh, needed, words, new_res, idx, val, k32,
        selected_total);
  else
    ef_update_kernel<false><<<grid, EF_THREADS, smem, st>>>(
        comp, n32, thresh, needed, words, new_res, idx, val, k32,
        selected_total);
  return last_error();
}

}  // extern "C"
