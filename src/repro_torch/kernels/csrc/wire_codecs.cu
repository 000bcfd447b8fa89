// Compressing wire codecs: int8 per-channel quantization and top-k delta
// sparsification with error feedback, over the flat fp32 transport payload.
//
// Replaces src/repro/kernels/wire_codecs.py:
//   int8_quant_matrix    (pallas_call at :80, body _int8_quant_kernel :52)
//   int8_dequant_matrix  (pallas_call at :110, body _int8_dequant_kernel :100)
//   compensate           (pallas_call at :152, body _compensate_kernel :129)
//   topk_ef_update       (pallas_call at :209, body _ef_update_kernel :165)
//
// int8  Every payload slot is a (rows, ch) matrix with one scale per column
//       (ch == 1: one scale for the whole slot). The TPU kernel ran a
//       two-phase sequential grid per slot and carried the column absmax in
//       VMEM from phase 0 to phase 1. Hopper blocks run in no order, so here
//       it is two launches over one device-side segment table: the first
//       reduces each chunk of rows to a column max and folds it into the
//       absmax scratch with atomicMax on the bit pattern of the non-negative
//       |x| (exact, and independent of order); the second turns the absmax
//       into scale = max(amax, 1e-12f) / 127.0f and writes
//       q = clamp(rintf(x / scale), -127, 127). The division is IEEE (no
//       fast-math flags), and rintf rounds half to even, so q and the scales
//       are bit-identical to the plain PyTorch version and to Int8Codec.
//       The scratch is zeroed by the caller on every call. Dequant is one
//       launch over the same table: out = float(q) * scale[col].
//       Segments range from 192-element vectors (ch == 1) to the 4096 x 4096
//       head matrix, so every segment is cut into chunks of rows
//       (int8_chunk_rows), one block per chunk, found by a scan of the table
//       as in pack.cu; no block idles on a small segment.
// top-k compensate: c = (flat - ref) + res and |c| in one pass (res null:
//       adds +0.0f, exactly what a residual of zeros gives).
//       topk_ef_update: given the k-th magnitude thresh and needed, the
//       number of |c| == thresh entries top-k keeps, select every
//       |c| > thresh and the `needed` lowest-index ties (lax.top_k's order),
//       zero them in the new residual, and write the selected (index, value)
//       pairs in position order. The TPU grid was sequential and carried a
//       running tie count in SMEM; here it takes three launches: per-block
//       counts of > and == thresh, one block that scans them into each
//       block's tie rank and output offset, and a pass in which each block
//       ranks its own ties and selected entries with block-wide scans.
//
// Bound on the H100: bytes. For n payload floats: quant reads 4n and writes
// n (+ scales); it reads x twice (one read per pass), so it moves 9n bytes
// against the 5n least. Dequant n in, 4n out. Compensate 12n in, 8n out.
// The EF update reads c twice (count pass and select pass) and writes 4n of
// residual plus 8 bytes per selected entry.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long QCHUNK = 8192;    // target elements per int8 chunk
constexpr long long MIN_ROWS = 16;    // rows per chunk at least
constexpr int EF_ITEMS = 8;           // consecutive elements per thread
constexpr long long EF_CHUNK = THREADS * EF_ITEMS;
constexpr int SCAN_THREADS = 1024;

struct QuantSeg {          // one row of the int8 segment table (all int64)
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

__global__ void __launch_bounds__(THREADS)
int8_absmax_kernel(const QuantSeg* __restrict__ segs, int nsegs,
                   const float* __restrict__ flat, int* __restrict__ amax) {
  const long long chunk = blockIdx.x;
  const QuantSeg s = segs[find_seg(segs, nsegs, chunk)];
  const ChunkWork w = chunk_work(s, chunk);
  if (!w.active) return;
  const float* x = flat + s.off;
  for (long long c = w.c0; c < s.ch; c += w.cstep) {
    float m = 0.0f;
    for (long long r = w.r0 + w.g; r < w.r1; r += w.G)
      m = fmaxf(m, fabsf(x[r * s.ch + c]));
    // non-negative floats order like their bit patterns as ints
    atomicMax(amax + s.soff + c, __float_as_int(m));
  }
}

__global__ void __launch_bounds__(THREADS)
int8_quant_kernel(const QuantSeg* __restrict__ segs, int nsegs,
                  const float* __restrict__ flat,
                  const int* __restrict__ amax, int8_t* __restrict__ q,
                  float* __restrict__ scales) {
  const long long chunk = blockIdx.x;
  const QuantSeg s = segs[find_seg(segs, nsegs, chunk)];
  const ChunkWork w = chunk_work(s, chunk);
  if (!w.active) return;
  const float* x = flat + s.off;
  int8_t* qs = q + s.off;
  const bool writes_scale = chunk == s.chunk_begin && w.g == 0;
  for (long long c = w.c0; c < s.ch; c += w.cstep) {
    const float scale = fmaxf(__int_as_float(amax[s.soff + c]), 1e-12f)
        / 127.0f;
    if (writes_scale) scales[s.soff + c] = scale;
    for (long long r = w.r0 + w.g; r < w.r1; r += w.G) {
      const long long i = r * s.ch + c;
      const float v = rintf(x[i] / scale);            // IEEE division
      qs[i] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
    }
  }
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

// Exclusive scan over the block of one value per thread; `total` gets the
// block's sum. `smem` holds 32 values; every thread must call it.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* smem, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? smem[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    smem[lane] = w;          // inclusive prefix of the warp totals
  }
  __syncthreads();
  const T before = warp ? smem[warp - 1] : T(0);
  total = smem[nwarps - 1];
  __syncthreads();           // smem may be reused right after
  return before + x - v;
}

__global__ void __launch_bounds__(THREADS)
ef_count_kernel(const float* __restrict__ comp, long long n,
                const float* __restrict__ thresh_p, int* __restrict__ gt_cnt,
                int* __restrict__ eq_cnt) {
  __shared__ int smem[32];
  const float th = *thresh_p;
  const long long base = blockIdx.x * EF_CHUNK
      + static_cast<long long>(threadIdx.x) * EF_ITEMS;
  int gt = 0, eq = 0;
#pragma unroll
  for (int j = 0; j < EF_ITEMS; ++j) {
    const long long i = base + j;
    if (i < n) {
      const float a = fabsf(comp[i]);
      gt += a > th;
      eq += a == th;
    }
  }
  int gt_total, eq_total;
  block_exclusive_scan(gt, smem, gt_total);
  block_exclusive_scan(eq, smem, eq_total);
  if (threadIdx.x == 0) {
    gt_cnt[blockIdx.x] = gt_total;
    eq_cnt[blockIdx.x] = eq_total;
  }
}

// One block: each count block's tie rank (ties in earlier blocks) and the
// offset of its first selected entry in the output.
__global__ void __launch_bounds__(SCAN_THREADS)
ef_scan_kernel(const int* __restrict__ gt_cnt, const int* __restrict__ eq_cnt,
               int nblocks, const long long* __restrict__ needed_p,
               long long* __restrict__ tie_prefix,
               long long* __restrict__ sel_prefix,
               long long* __restrict__ selected_total) {
  __shared__ long long smem[32];
  const long long needed = *needed_p;
  long long tie_carry = 0, sel_carry = 0;
  for (int b0 = 0; b0 < nblocks; b0 += SCAN_THREADS) {
    const int b = b0 + threadIdx.x;
    const long long eq = b < nblocks ? eq_cnt[b] : 0;
    const long long gt = b < nblocks ? gt_cnt[b] : 0;
    long long tie_total, sel_total;
    const long long tp = tie_carry + block_exclusive_scan(eq, smem,
                                                          tie_total);
    long long take = needed - tp;           // ties of this block kept
    take = take < 0 ? 0 : (take > eq ? eq : take);
    const long long sp = sel_carry + block_exclusive_scan(gt + take, smem,
                                                          sel_total);
    if (b < nblocks) {
      tie_prefix[b] = tp;
      sel_prefix[b] = sp;
    }
    tie_carry += tie_total;
    sel_carry += sel_total;
  }
  if (threadIdx.x == 0) *selected_total = sel_carry;
}

__global__ void __launch_bounds__(THREADS)
ef_select_kernel(const float* __restrict__ comp, long long n,
                 const float* __restrict__ thresh_p,
                 const long long* __restrict__ needed_p,
                 const long long* __restrict__ tie_prefix,
                 const long long* __restrict__ sel_prefix,
                 float* __restrict__ new_res, int* __restrict__ idx,
                 float* __restrict__ val, long long k) {
  __shared__ int smem[32];
  const float th = *thresh_p;
  const long long needed = *needed_p;
  const long long base = blockIdx.x * EF_CHUNK
      + static_cast<long long>(threadIdx.x) * EF_ITEMS;
  float c[EF_ITEMS];
  unsigned gtm = 0, eqm = 0;
#pragma unroll
  for (int j = 0; j < EF_ITEMS; ++j) {
    const long long i = base + j;
    c[j] = i < n ? comp[i] : 0.0f;
    const float a = fabsf(c[j]);
    if (i < n && a > th) gtm |= 1u << j;
    if (i < n && a == th) eqm |= 1u << j;
  }
  int eq_total;
  long long rank = tie_prefix[blockIdx.x]        // 0-based rank of the
      + block_exclusive_scan(__popc(eqm), smem, eq_total);  // first tie
  unsigned selm = gtm;
#pragma unroll
  for (int j = 0; j < EF_ITEMS; ++j) {
    if (eqm >> j & 1u) {
      if (rank < needed) selm |= 1u << j;
      ++rank;
    }
  }
  int sel_total;
  long long pos = sel_prefix[blockIdx.x]
      + block_exclusive_scan(__popc(selm), smem, sel_total);
#pragma unroll
  for (int j = 0; j < EF_ITEMS; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    if (selm >> j & 1u) {
      new_res[i] = 0.0f;
      if (pos < k) {
        idx[pos] = static_cast<int>(i);
        val[pos] = c[j];
      }
      ++pos;
    } else {
      new_res[i] = c[j];
    }
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

const char* wire_codecs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

long long int8_chunk_rows(long long ch) { return chunk_rows(ch); }

long long ef_chunk_elems() { return EF_CHUNK; }

// table: device array of nsegs QuantSeg rows; amax: nscales zeroed ints.
int int8_quant_launch(const void* table, int nsegs, long long nchunks,
                      const float* flat, int* amax, int8_t* q, float* scales,
                      void* stream) {
  if (nchunks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const QuantSeg* segs = static_cast<const QuantSeg*>(table);
  const unsigned grid = static_cast<unsigned>(nchunks);
  int8_absmax_kernel<<<grid, THREADS, 0, st>>>(segs, nsegs, flat, amax);
  int err = last_error();
  if (err) return err;
  int8_quant_kernel<<<grid, THREADS, 0, st>>>(segs, nsegs, flat, amax, q,
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
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = aligned(flat) && aligned(ref) && aligned(c) &&
                   aligned(a) && (res == nullptr || aligned(res));
  if (vec)
    compensate_kernel<true><<<static_cast<unsigned>(blocks), THREADS, 0,
                              st>>>(flat, ref, res, c, a, n);
  else
    compensate_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0,
                               st>>>(flat, ref, res, c, a, n);
  return last_error();
}

// thresh: 1 float, needed: 1 int64, both on the device. Scratch: gt_cnt,
// eq_cnt (int), tie_prefix, sel_prefix (int64), each of
// ceil(n / ef_chunk_elems()) entries. Outputs: new_res (n), idx and val
// (k, in position order), selected_total (1 int64: the number of entries
// selected, which is k when thresh and needed are those of top-k).
int topk_ef_update_launch(const float* comp, long long n, const float* thresh,
                          const long long* needed, int* gt_cnt, int* eq_cnt,
                          long long* tie_prefix, long long* sel_prefix,
                          float* new_res, int* idx, float* val, long long k,
                          long long* selected_total, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nblocks = (n + EF_CHUNK - 1) / EF_CHUNK;
  const unsigned grid = static_cast<unsigned>(nblocks);
  ef_count_kernel<<<grid, THREADS, 0, st>>>(comp, n, thresh, gt_cnt, eq_cnt);
  int err = last_error();
  if (err) return err;
  ef_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
      gt_cnt, eq_cnt, static_cast<int>(nblocks), needed, tie_prefix,
      sel_prefix, selected_total);
  err = last_error();
  if (err) return err;
  ef_select_kernel<<<grid, THREADS, 0, st>>>(comp, n, thresh, needed,
                                             tie_prefix, sel_prefix, new_res,
                                             idx, val, k);
  return last_error();
}

}  // extern "C"
