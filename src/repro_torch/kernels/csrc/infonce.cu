// InfoNCE with in-batch negatives, per client: forward (per-row loss and
// log-sum-exp) and the two gradients (dq, dk).
//
// Replaces src/repro/kernels/infonce.py::info_nce_rows (pallas_call at :72,
// body _infonce_kernel :29; wrapper src/repro/kernels/ops.py:88
// fused_info_nce). The TPU kernel has no backward; the port's loss needs
// the gradient with respect to q (and, when asked, k), so the backward
// here recomputes the probabilities from the saved log-sum-exp.
//
// q and k are (C, n, d) fp32, contiguous, already L2-normalised; C is a
// client axis (the vectorised engine's), and row i of client c is scored
// against the n rows of that client's k only. With s_ij = q_i.k_j / tau:
//   forward  lse_i = logsumexp_j s_ij, loss_i = lse_i - s_ii
//   dq_i = (g_i / tau) (sum_j p_ij k_j - k_i),        p_ij = exp(s_ij - lse_i)
//   dk_j = (1 / tau) (sum_i g_i p_ij q_i - g_j q_j)
//
// Design. Each call is two kernels. The first, info_nce_logits_kernel,
// spreads q.k^T over (32 x 32 tile) x (256-wide slice of d) x client
// blocks, so even the LM's alignment term (n = 4, d = 2560) gets ten
// blocks and the MoCo term (n = 256, d = 256) 64 a client. Inside a block
// the slice comes in as four 64-wide chunks by cp.async, double-buffered;
// each of the 8 warps takes 8 of a chunk's 64 columns and builds the whole
// 32 x 32 tile from them (a lane: 8 rows x 4 columns, 12 shared loads per
// 32 FMAs), and the 8 partial tiles are summed in warp order. The block
// writes its slice's partial dot products to a (C, d slices, n, n) scratch
// that stays in L2. The second kernel reads them and sums the slices in
// slice order:
//   forward  info_nce_rows_kernel: a warp a row, max, sum of exp and the
//            gold logit by fixed butterfly reductions;
//   dq / dk  info_nce_grad_kernel: a block per (16 output rows, 64-wide d
//            chunk, client) forms the weights p_ab (dq) or g_b p_ba (dk)
//            from the scratch, 128 walked rows at a time while those rows
//            come in by cp.async, and multiplies them into the rows. The
//            logits are never recomputed per d chunk: only exp of them is.
// No atomics: every sum runs in an order fixed by the shapes, so two calls
// give the same bits, and a client's results do not depend on C (the
// split depends on n and d alone). n and d are masked, never padded (the
// TPU wrapper pads d to 128 and needs n % 128 == 0 or a single tile). The
// logits kernel is instantiated once per caller (forward, dq, dk) so that
// a profile can tell their time apart.
//
// Bound on the H100: operations. At the main path's n = 256, d = 256 the
// forward does 2 n^2 d = 33.6 MFLOP (0.50 us at 67 TFLOP/s fp32) and moves
// 0.53 MB (0.16 us at 3.35 TB/s); each gradient does twice that. At these
// sizes launch latency and the chain of dependent loads set the time.
#include "common.cuh"

namespace {

constexpr int TILE = 32;      // rows and columns of an s tile
constexpr int DCH = 64;       // d columns a stage brings in
constexpr int DSL = 256;      // d columns a logits block sums
constexpr int LDS = DCH + 4;  // padded, 16-byte aligned shared rows
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

// Rows [r0, r0 + ROWS) x columns [c0, c0 + DCH) of the (n, d) matrix m
// into dst (rows of LD floats), asynchronously; zeros outside rows < n and
// columns < c_end. vec: 16-byte copies (d % 4 == 0, m 16-byte aligned).
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ m, int r0,
                                          int c0, int c_end, int n, int d,
                                          bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < ROWS * DCH / 4; e += THREADS) {
      const int r = e / (DCH / 4), c = (e % (DCH / 4)) * 4;
      const bool ok = r0 + r < n && c0 + c < c_end;
      common::cp_async16(
          dst + r * LD + c,
          ok ? m + static_cast<long long>(r0 + r) * d + c0 + c : m, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * DCH; e += THREADS) {
      const int r = e / DCH, c = e % DCH;
      const bool ok = r0 + r < n && c0 + c < c_end;
      common::cp_async4(
          dst + r * LD + c,
          ok ? m + static_cast<long long>(r0 + r) * d + c0 + c : m, ok);
    }
  }
}

// grid (ceil(n / 32)^2, ceil(d / DSL), C): part[c][slice][i][j] = the sum
// over the slice's columns of A_i B_j, for the 32 x 32 tile of (i, j). USE
// names the caller (0 forward, 1 dq, 2 dk); the code is the same, but the
// three names let a profile give each its own device time.
template <int USE>
__global__ void __launch_bounds__(THREADS)
info_nce_logits_kernel(const float* __restrict__ q,
                       const float* __restrict__ k, float* __restrict__ part,
                       int n, int d, bool vec) {
  __shared__ __align__(16) float sm[2 * 2 * TILE * LDS];  // [stage][q, k]
  const int ct_n = (n + TILE - 1) / TILE;
  const int i0 = (blockIdx.x / ct_n) * TILE, j0 = (blockIdx.x % ct_n) * TILE;
  const long long base = static_cast<long long>(blockIdx.z) * n;
  const float* qc = q + base * d;
  const float* kc = k + base * d;
  const int c_lo = blockIdx.y * DSL, c_end = min(d, c_lo + DSL);
  const int nch = (c_end - c_lo + DCH - 1) / DCH;
  auto issue = [&](int s) {
    float* st = sm + (s & 1) * 2 * TILE * LDS;
    load_rows<TILE, LDS>(st, qc, i0, c_lo + s * DCH, c_end, n, d, vec);
    load_rows<TILE, LDS>(st + TILE * LDS, kc, j0, c_lo + s * DCH, c_end, n,
                         d, vec);
    common::cp_async_commit();
  };
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 3, cc = lane & 7;  // rows r + 4i, columns cc + 8j
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  issue(0);
  for (int s = 0; s < nch; ++s) {
    if (s + 1 < nch) {
      issue(s + 1);
      common::cp_async_wait<1>();
    } else {
      common::cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = sm + (s & 1) * 2 * TILE * LDS;
    const float* ks = qs + TILE * LDS;
#pragma unroll
    for (int col = 8 * w; col < 8 * w + 8; ++col) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = qs[(r + 4 * i) * LDS + col];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cc + 8 * j) * LDS + col];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
    __syncthreads();  // the stage is free for chunk s + 2
  }
  // the 8 warps' partial tiles, summed in warp order (over the stages)
  float* red = sm;  // [warp][32][32]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[w * TILE * TILE + (r + 4 * i) * TILE + cc + 8 * j] = acc[i][j];
  __syncthreads();
  float* out = part + (static_cast<long long>(blockIdx.z) * gridDim.y +
                       blockIdx.y) * n * n;
  for (int o = threadIdx.x; o < TILE * TILE; o += THREADS) {
    const int i = i0 + o / TILE, j = j0 + o % TILE;
    if (i >= n || j >= n) continue;
    float v = 0.f;
#pragma unroll
    for (int ww = 0; ww < THREADS / 32; ++ww) v += red[ww * TILE * TILE + o];
    out[static_cast<long long>(i) * n + j] = v;
  }
}

// s_ij / tau from the partial dot products of the nsl d slices of one
// client (part: that client's (nsl, n, n) block), summed in slice order.
__device__ __forceinline__ float logit(const float* __restrict__ part,
                                       int nsl, int n, int i, int j,
                                       float tau) {
  const long long nn = static_cast<long long>(n) * n;
  const long long ij = static_cast<long long>(i) * n + j;
  float v = 0.f;
  for (int s = 0; s < nsl; ++s) v += part[s * nn + ij];
  return v / tau;
}

// grid (ceil(n / 8), C): a warp per row i: lse_i and loss_i.
__global__ void __launch_bounds__(THREADS)
info_nce_rows_kernel(const float* __restrict__ part, float* __restrict__ loss,
                     float* __restrict__ lse, int n, int nsl, float tau) {
  const int i = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const float* pc = part + base * nsl * n;
  float m = NEG_INF, gold = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float s = logit(pc, nsl, n, i, j, tau);
    m = fmaxf(m, s);
    if (j == i) gold = s;
  }
  m = common::warp_max(m);
  float l = 0.f;
  for (int j = lane; j < n; j += 32)
    l += expf(logit(pc, nsl, n, i, j, tau) - m);
  l = common::warp_sum(l);
  gold = __shfl_sync(0xffffffffu, gold, i & 31);
  if (lane == 0) {
    const float z = m + logf(l);
    lse[base + i] = z;
    loss[base + i] = z - gold;
  }
}

// grid (ceil(n / 16), ceil(d / 64), C). DK = false: out = dq, the output
// side is q and the walked side k; DK = true: out = dk, the output side is
// k and the walked side q. part holds the logits kernel's partial q.k^T.
// The walked side goes by in chunks of NB rows: the chunk's rows come in by
// cp.async while the block forms the chunk's 16 x NB weights from part
// (eight independent loads a thread, so one L2 latency a chunk); then
// each thread adds weights x rows for one output row and four columns
// (one weight and one float4 of shared memory per four FMAs).
constexpr int GROWS = 16;  // output rows a gradient block
constexpr int NB = 128;    // walked rows a chunk

template <bool DK>
__global__ void __launch_bounds__(THREADS)
info_nce_grad_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ part,
                     const float* __restrict__ lse,
                     const float* __restrict__ g, float* __restrict__ out,
                     int n, int d, int nsl, float tau, bool vec) {
  __shared__ __align__(16) float bs[NB * DCH];       // walked rows, d chunk
  __shared__ float ws[GROWS][NB + 1];                 // the weights
  const long long base = static_cast<long long>(blockIdx.z) * n;
  const float* B = (DK ? q : k) + base * d;
  const float* pc = part + base * nsl * n;
  const float* lc = lse + base;
  const float* gc = g + base;
  const int a0 = blockIdx.x * GROWS, d0 = blockIdx.y * DCH;
  const int ra = threadIdx.x >> 4, c4 = (threadIdx.x & 15) * 4;
  const int a = a0 + ra;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b0 = 0; b0 < n; b0 += NB) {
    // rows [b0, b0 + NB) x columns [d0, d0 + 64) of the walked side
    load_rows<NB, DCH>(bs, B, b0, d0, d, n, d, vec);
    common::cp_async_commit();
    // weights p_ab (dq) or g_b p_ba (dk); zero past n
    for (int e = threadIdx.x; e < GROWS * NB; e += THREADS) {
      const int x = e / NB, y = e % NB;
      const int ax = a0 + x, b = b0 + y;
      float wv = 0.f;
      if (ax < n && b < n)
        wv = DK ? gc[b] * expf(logit(pc, nsl, n, b, ax, tau) - lc[b])
                : expf(logit(pc, nsl, n, ax, b, tau) - lc[ax]);
      ws[x][y] = wv;
    }
    common::cp_async_wait_all();
    __syncthreads();  // the chunk's rows and weights are visible
    const int nb = min(NB, n - b0);
#pragma unroll 4
    for (int y = 0; y < nb; ++y) {
      const float wv = ws[ra][y];
      const float4 bv = *reinterpret_cast<const float4*>(bs + y * DCH + c4);
      acc.x = fmaf(wv, bv.x, acc.x);
      acc.y = fmaf(wv, bv.y, acc.y);
      acc.z = fmaf(wv, bv.z, acc.z);
      acc.w = fmaf(wv, bv.w, acc.w);
    }
    __syncthreads();  // the buffers are free for the next chunk
  }
  if (a >= n) return;
  const float ga = gc[a];
  const float* own = B + static_cast<long long>(a) * d;  // k_i or q_j
  float* o = out + (base + a) * d;
  const float av[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int col = d0 + c4 + u;
    if (col < d)
      o[col] = DK ? (av[u] - ga * own[col]) / tau
                  : (ga / tau) * (av[u] - own[col]);
  }
}

template <int USE>
void logits(const float* q, const float* k, float* part, int C, int n, int d,
            cudaStream_t st) {
  const int tiles = (n + TILE - 1) / TILE;
  const dim3 grid(tiles * tiles, (d + DSL - 1) / DSL, C);
  info_nce_logits_kernel<USE><<<grid, THREADS, 0, st>>>(
      q, k, part, n, d,
      d % 4 == 0 && common::aligned16(q) && common::aligned16(k));
}

}  // namespace

extern "C" {

const char* infonce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k: (C, n, d) fp32; loss, lse: (C, n) fp32; part: (C, ceil(d / 256),
// n, n) fp32 scratch.
int info_nce_fwd_launch(const void* q, const void* k, void* loss, void* lse,
                        void* part, int C, int n, int d, float tau,
                        void* stream) {
  if (C <= 0 || n <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  logits<0>(static_cast<const float*>(q), static_cast<const float*>(k), pp,
            C, n, d, st);
  const dim3 grid((n + THREADS / 32 - 1) / (THREADS / 32), C);
  info_nce_rows_kernel<<<grid, THREADS, 0, st>>>(
      pp, static_cast<float*>(loss), static_cast<float*>(lse), n,
      (d + DSL - 1) / DSL, tau);
  return static_cast<int>(cudaGetLastError());
}

// lse, g: (C, n) fp32; out: (C, n, d) fp32, dq (dk = 0) or dk (dk = 1);
// part: as for the forward.
int info_nce_bwd_launch(const void* q, const void* k, const void* lse,
                        const void* g, void* out, void* part, int C, int n,
                        int d, float tau, int dk, void* stream) {
  if (C <= 0 || n <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* lp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  const int nsl = (d + DSL - 1) / DSL;
  const dim3 grid((n + GROWS - 1) / GROWS, (d + DCH - 1) / DCH, C);
  const bool vec =
      d % 4 == 0 && common::aligned16(qp) && common::aligned16(kp);
  if (dk) {
    logits<2>(qp, kp, pp, C, n, d, st);
    info_nce_grad_kernel<true><<<grid, THREADS, 0, st>>>(
        qp, kp, pp, lp, gp, op, n, d, nsl, tau, vec);
  } else {
    logits<1>(qp, kp, pp, C, n, d, st);
    info_nce_grad_kernel<false><<<grid, THREADS, 0, st>>>(
        qp, kp, pp, lp, gp, op, n, d, nsl, tau, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
