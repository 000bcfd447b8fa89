// InfoNCE with in-batch negatives, per client: forward (per-row loss and
// log-sum-exp) and the two gradients (dq, dk).
//
// Replaces src/repro/kernels/infonce.py::info_nce_rows (pallas_call at :72,
// body _infonce_kernel :29; wrapper src/repro/kernels/ops.py:88
// fused_info_nce). The TPU kernel has no backward; the port's loss needs
// the gradient with respect to q (and, when asked, k), so the two backward
// kernels here recompute the probabilities from the saved log-sum-exp.
//
// q and k are (C, n, d) fp32, contiguous, already L2-normalised; C is a
// client axis (the vectorised engine's), and row i of client c is scored
// against the n rows of that client's k only. With s_ij = q_i.k_j / tau:
//   forward  lse_i = logsumexp_j s_ij, loss_i = lse_i - s_ii
//   dq_i = (g_i / tau) (sum_j p_ij k_j - k_i),        p_ij = exp(s_ij - lse_i)
//   dk_j = (1 / tau) (sum_i g_i p_ij q_i - g_j q_j)
//
// Design. All three kernels are built on one 32 x 32 tile of s: a block of
// 256 threads stages 64-wide d chunks of 32 rows of each side in shared
// memory and accumulates the tile with fp32 FMAs on the CUDA cores (8
// threads per tile row, 4 columns each). The forward walks the column
// tiles of its 32 q rows with the TPU kernel's online max and sum, so the
// (n, n) logits never reach device memory. The gradient kernels walk the
// other side's tiles, turn each s tile into weights in shared memory and
// accumulate weights x rows for one 64-wide d chunk of their 32 output rows
// (grid: row tiles x d chunks x clients), recomputing s for each d chunk.
// n and d are masked, never padded (the TPU wrapper pads d to 128 and
// needs n % 128 == 0 or a single tile).
//
// Bound on the H100: operations. At the main path's n = 256, d = 256 the
// forward does 2 n^2 d = 33.6 MFLOP (0.50 us at 67 TFLOP/s fp32) and moves
// 0.53 MB (0.16 us at 3.35 TB/s); each gradient kernel does twice that.
// With 8 (forward) or 32 (gradient) blocks on 132 SMs per client, launch
// latency and the serial tile loop dominate at this size.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int DCH = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct Smem {
  float a[TILE][DCH + 1];   // 32 rows of the output side, one d chunk
  float b[TILE][DCH + 1];   // 32 rows of the other side, one d chunk
  float s[TILE][TILE + 1];  // the s tile, then its weights
};

// Load rows [r0, r0 + TILE) x columns [c0, c0 + DCH) of the (n, d) matrix m
// into dst, zeros outside.
__device__ __forceinline__ void stage(float (*dst)[DCH + 1],
                                      const float* __restrict__ m, int r0,
                                      int c0, int n, int d) {
  for (int e = threadIdx.x; e < TILE * DCH; e += THREADS) {
    const int r = e / DCH, c = e % DCH;
    const int row = r0 + r, col = c0 + c;
    dst[r][c] = (row < n && col < d)
                    ? m[static_cast<long long>(row) * d + col]
                    : 0.f;
  }
}

// sm.s[x][y] = A[a0 + x] . B[b0 + y] / tau for the 32 x 32 tile. Ends with
// a barrier, so the tile is visible to every thread.
__device__ void s_tile(const float* __restrict__ A,
                       const float* __restrict__ B, int a0, int b0, int n,
                       int d, float tau, Smem& sm) {
  const int ra = threadIdx.x >> 3, cb = threadIdx.x & 7;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = 0; c0 < d; c0 += DCH) {
    stage(sm.a, A, a0, c0, n, d);
    stage(sm.b, B, b0, c0, n, d);
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < DCH; ++c) {
      const float av = sm.a[ra][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = fmaf(av, sm.b[cb + 8 * i][c], acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sm.s[ra][cb + 8 * i] = acc[i] / tau;
  __syncthreads();
}

// Reductions over the 8 lanes that share a tile row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// grid (ceil(n / 32), C): one block per 32 q rows of one client.
__global__ void __launch_bounds__(THREADS)
info_nce_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    float* __restrict__ loss, float* __restrict__ lse, int n,
                    int d, float tau) {
  __shared__ Smem sm;
  const long long base = static_cast<long long>(blockIdx.y) * n;
  const float* qc = q + base * d;
  const float* kc = k + base * d;
  const int i0 = blockIdx.x * TILE;
  const int ra = threadIdx.x >> 3, cb = threadIdx.x & 7;
  const int i = i0 + ra;
  float m = NEG_INF, l = 0.f, gold = 0.f;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    s_tile(qc, kc, i0, j0, n, d, tau, sm);
    float v[4];
    float mx = NEG_INF;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int y = cb + 8 * t;
      v[t] = (j0 + y < n) ? sm.s[ra][y] : NEG_INF;
      mx = fmaxf(mx, v[t]);
    }
    const float m_new = fmaxf(m, row_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (j0 + cb + 8 * t < n) sum += expf(v[t] - m_new);
    l = l * expf(m - m_new) + row_sum(sum);
    m = m_new;
    if (i >= j0 && i < j0 + TILE) gold = sm.s[ra][i - j0];
    __syncthreads();  // the next tile overwrites sm.s
  }
  if (cb == 0 && i < n) {
    const float z = m + logf(l);
    lse[base + i] = z;
    loss[base + i] = z - gold;
  }
}

// grid (ceil(n / 32), ceil(d / 64), C). DK = false: out = dq, the output
// side is q and the walked side k; DK = true: out = dk, the output side is
// k and the walked side q.
template <bool DK>
__global__ void __launch_bounds__(THREADS)
info_nce_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, float* __restrict__ out,
                    int n, int d, float tau) {
  __shared__ Smem sm;
  const long long base = static_cast<long long>(blockIdx.z) * n;
  const float* A = (DK ? k : q) + base * d;
  const float* B = (DK ? q : k) + base * d;
  const float* lc = lse + base;
  const float* gc = g + base;
  const int a0 = blockIdx.x * TILE;
  const int d0 = blockIdx.y * DCH;
  const int ra = threadIdx.x >> 3, cb = threadIdx.x & 7;
  const int a = a0 + ra;
  const float lse_a = (!DK && a < n) ? lc[a] : 0.f;
  float acc[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) acc[t] = 0.f;
  for (int b0 = 0; b0 < n; b0 += TILE) {
    s_tile(A, B, a0, b0, n, d, tau, sm);
    // weights: p_ab (dq) or g_b p_ba (dk); zero past n
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int y = cb + 8 * t;
      const int b = b0 + y;
      float w = 0.f;
      if (b < n)
        w = DK ? gc[b] * expf(sm.s[ra][y] - lc[b])
               : expf(sm.s[ra][y] - lse_a);
      sm.s[ra][y] = w;
    }
    stage(sm.b, B, b0, d0, n, d);
    __syncthreads();
#pragma unroll 4
    for (int y = 0; y < TILE; ++y) {
      const float w = sm.s[ra][y];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        acc[t] = fmaf(w, sm.b[y][cb + 8 * t], acc[t]);
    }
    __syncthreads();
  }
  if (a >= n) return;
  const float ga = gc[a];
  const float* own = B + static_cast<long long>(a) * d;  // k_i or q_j
  float* o = out + (base + a) * d;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = d0 + cb + 8 * t;
    if (col < d)
      o[col] = DK ? (acc[t] - ga * own[col]) / tau
                  : (ga / tau) * (acc[t] - own[col]);
  }
}

}  // namespace

extern "C" {

const char* infonce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k: (C, n, d) fp32; loss, lse: (C, n) fp32.
int info_nce_fwd_launch(const void* q, const void* k, void* loss, void* lse,
                        int C, int n, int d, float tau, void* stream) {
  if (C <= 0 || n <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + TILE - 1) / TILE, C);
  info_nce_fwd_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(loss), static_cast<float*>(lse), n, d, tau);
  return static_cast<int>(cudaGetLastError());
}

// lse, g: (C, n) fp32; out: (C, n, d) fp32, dq (dk = 0) or dk (dk = 1).
int info_nce_bwd_launch(const void* q, const void* k, const void* lse,
                        const void* g, void* out, int C, int n, int d,
                        float tau, int dk, void* stream) {
  if (C <= 0 || n <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + TILE - 1) / TILE, (d + DCH - 1) / DCH, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* lp = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  float* op = static_cast<float*>(out);
  if (dk)
    info_nce_bwd_kernel<true><<<grid, THREADS, 0, st>>>(qp, kp, lp, gp, op,
                                                        n, d, tau);
  else
    info_nce_bwd_kernel<false><<<grid, THREADS, 0, st>>>(qp, kp, lp, gp, op,
                                                         n, d, tau);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
