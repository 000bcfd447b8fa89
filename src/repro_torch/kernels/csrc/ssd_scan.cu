// Mamba2 chunked SSD scan with a resident (P, N) state.
//
// Replaces src/repro/kernels/mamba2_scan.py::ssd_scan_bshpn (pallas_call at
// :80, body _ssd_kernel :30; wrapper src/repro/kernels/ops.py:77 ssd_scan).
//
// Inputs xh (B, S, H, P), dt and a = dt * A (B, S, H), Bm and Cm (B, S, N)
// (one group, shared by the heads), all float32; output y (B, S, H, P)
// float32 (the LM path's Mamba2 blocks feed fp32 xh).
// Per (batch, head), chunk by chunk, with cum = cumsum(a) over the chunk:
//   intra-chunk  y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//   inter-chunk  y_i += exp(cum_i) C_i . h^T
//   state        h <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j
//                     x_j B_j^T            (h (P, N) fp32, zero at chunk 0)
// All math in fp32, as the TPU kernel does.
//
// Design. The TPU grid is (B, H, S / chunk) with the chunk axis sequential
// and h in VMEM scratch; here one block of 256 threads per (b, h) loops
// over the chunks itself and keeps h in shared memory (and each thread's
// 16 entries of it in registers). The TPU kernel stages the whole (Q, Q)
// intra-chunk matrix, 256 KB in fp32 at Q = 256, more than a block's
// 227 KB of shared memory; here the chunk is cut into 64-row tiles: for an
// output tile i, each tile j <= i forms the 64 x 64 tile of C_i . B_j^T,
// applies the causal decay mask and dt_j as it writes it to shared memory,
// and multiplies it into the tile's x_j. The last output tile walks every
// j tile of the chunk, so the state's sum over j rides on its loads. cum
// is an inclusive scan of the chunk's a by one warp. Shared memory: five
// 64 x 65 fp32 tiles (C_i, B_j, x_j, the masked tile, h) plus three Q-long
// rows (cum, dt, the state weights), 86 KB at Q = 256: two blocks an SM.
// dt and a are read as they are (the TPU wrapper lane-pads them to 128).
// Any P, N <= 64 and chunk Q <= 1024 with Q | S; operands are read through
// their strides, with the last dim of xh, Bm and Cm contiguous.
//
// Bound on the H100, at the LM path's shapes (B 4, S 1024, H 80, P 64,
// N 64, Q 256, fp32): xh read and y written are 2 x 83.9 MB, dt, a, Bm
// and Cm 4.7 MB, so 0.051 ms at 3.35 TB/s. The function needs C.B^T over
// the causal half once per (batch, chunk), since Bm and Cm are shared by
// the heads, and per (batch, head, chunk) M.x over the causal half, C.h^T
// and the state: 10.83 GFLOP, 0.162 ms at 67 TFLOP/s fp32 on the CUDA
// cores. The bound is operations. This kernel does more, about 18.8 GFLOP:
// it recomputes C.B^T for each head and works on whole 64 x 64 tiles of
// the causal half. Sharing C.B^T across the heads, and wgmma / TF32 mma,
// are later work.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // chunk positions per tile
constexpr int DMAX = 64;      // largest P and N
constexpr int LD = DMAX + 1;  // padded row: lanes read distinct banks
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int QMAX = 1024;

struct SsdArgs {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  int B, S, H, P, N, Q;
};

// rows [r0, r0 + TILE) of the chunk starting at s0, columns [0, width) of
// an (S, width) slab with row stride `ss`, into dst (TILE x LD), zeros
// outside the chunk and past `width`.
__device__ __forceinline__ void stage(float* dst, const float* src, long long ss,
                                      int s0, int r0, int Q, int width) {
  for (int e = threadIdx.x; e < TILE * DMAX; e += THREADS) {
    const int r = e / DMAX, c = e - r * DMAX;
    const int row = r0 + r;
    dst[r * LD + c] = (row < Q && c < width)
                          ? src[(s0 + row) * ss + c]
                          : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const SsdArgs g) {
  extern __shared__ float smem[];
  float* Cs = smem;               // C_i tile       [i][n]
  float* Bs = Cs + TILE * LD;     // B_j tile       [j][n]
  float* Xs = Bs + TILE * LD;     // x_j tile       [j][p]
  float* Ms = Xs + TILE * LD;     // masked tile    [i][j]
  float* Hs = Ms + TILE * LD;     // state          [p][n]
  float* cum = Hs + DMAX * LD;    // [Q] cumsum(a) over the chunk
  float* dts = cum + g.Q;         // [Q] dt
  float* ws = dts + g.Q;          // [Q] exp(cum_last - cum_j) dt_j

  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x - b * g.H;
  const float* xp = g.x + b * g.x_sb + h * g.x_sh;
  const float* dtp = g.dt + b * g.dt_sb + h * g.dt_sh;
  const float* ap = g.a + b * g.a_sb + h * g.a_sh;
  const float* bp = g.bm + b * g.b_sb;
  const float* cp = g.cm + b * g.c_sb;
  float* yp = g.y +
          (static_cast<long long>(b) * g.S * g.H + h) * g.P;
  const long long y_ss = static_cast<long long>(g.H) * g.P;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int Q = g.Q;
  const int nt = (Q + TILE - 1) / TILE;

  // this thread's h[p][n], p = ty + 16 r, n = tx + 16 c
  float hreg[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) hreg[r][c] = 0.f;
  for (int e = tid; e < DMAX * LD; e += THREADS) Hs[e] = 0.f;

  for (int s0 = 0; s0 < g.S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with cum, dts, ws
    for (int q = tid; q < Q; q += THREADS) {
      cum[q] = ap[(s0 + q) * g.a_ss];
      dts[q] = dtp[(s0 + q) * g.dt_ss];
    }
    __syncthreads();
    if (tid < 32) {  // inclusive scan of the chunk's a by one warp
      const int per = (Q + 31) / 32;
      const int lo = min(Q, tid * per), hi = min(Q, lo + per);
      float run = 0.f;
      for (int q = lo; q < hi; ++q) {
        run += cum[q];
        cum[q] = run;
      }
      float inc = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += v;
      }
      const float base = inc - run;  // sum of the lanes before this one
      for (int q = lo; q < hi; ++q) cum[q] += base;
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int q = tid; q < Q; q += THREADS)
      ws[q] = expf(cum_last - cum[q]) * dts[q];

    float hacc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[r][c] = 0.f;

    for (int ti = 0; ti < nt; ++ti) {
      const int i0 = ti * TILE;
      __syncthreads();  // Cs, Bs, Xs and Ms are free again; ws is visible
      stage(Cs, cp, g.c_ss, s0, i0, Q, g.N);
      __syncthreads();
      // inter-chunk: acc[i][p] = exp(cum_i) C_i . h_p
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < g.N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * LD + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) hv[c] = Hs[(tx + 16 * c) * LD + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], hv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }
      const bool last = ti == nt - 1;
      for (int tj = 0; tj <= ti; ++tj) {
        const int j0 = tj * TILE;
        __syncthreads();  // the previous j tile's Bs, Xs, Ms are read
        stage(Bs, bp, g.b_ss, s0, j0, Q, g.N);
        stage(Xs, xp, g.x_ss, s0, j0, Q, g.P);
        __syncthreads();
        // Ms[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i, else 0
        float sv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sv[r][c] = 0.f;
        for (int n = 0; n < g.N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * LD + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * LD + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sv[r][c] = fmaf(cv[r], bv[c], sv[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int il = ty + 16 * r, i = i0 + il;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = tx + 16 * c, j = j0 + jl;
            Ms[il * LD + jl] =
                (j <= i && i < Q) ? sv[r][c] * expf(cum[i] - cum[j]) * dts[j]
                                  : 0.f;
          }
        }
        __syncthreads();
        // y_i += sum_j Ms[i][j] x_j
        for (int jl = 0; jl < TILE; ++jl) {
          float mv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = Ms[(ty + 16 * r) * LD + jl];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = Xs[jl * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(mv[r], xv[c], acc[r][c]);
        }
        if (last) {
          // state: h[p][n] += sum_j w_j x_j[p] B_j[n] (zero rows past Q)
          const int jn = min(TILE, Q - j0);
          for (int jl = 0; jl < jn; ++jl) {
            const float w = ws[j0 + jl];
            float xv[4], bv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              xv[r] = w * Xs[jl * LD + ty + 16 * r];
#pragma unroll
            for (int c = 0; c < 4; ++c) bv[c] = Bs[jl * LD + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                hacc[r][c] = fmaf(xv[r], bv[c], hacc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p < g.P) yp[(s0 + i) * y_ss + p] = acc[r][c];
        }
      }
    }
    // h <- exp(cum_last) h + the chunk's sum, once every tile has read h
    __syncthreads();
    const float decay = expf(cum_last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        hreg[r][c] = hreg[r][c] * decay + hacc[r][c];
        Hs[(ty + 16 * r) * LD + tx + 16 * c] = hreg[r][c];
      }
  }
}

size_t smem_bytes(int Q) {
  return sizeof(float) * (4 * TILE * LD + DMAX * LD + 3 * Q);
}

int launch(const SsdArgs& g, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(QMAX)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long blocks = static_cast<long long>(g.B) * g.H;
  if (blocks <= 0 || g.S == 0) return 0;
  ssd_scan_kernel<<<static_cast<unsigned>(blocks), THREADS,
                    smem_bytes(g.Q), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All operands float32. strides: 13 element strides, (batch, seq, head) of xh, dt and a, then
// (batch, seq) of Bm and Cm; the last dim of xh, Bm and Cm is contiguous.
// y is a contiguous (B, S, H, P) tensor.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, void* y,
                    int B, int S, int H, int P, int N, int Q,
                    const long long* strides, void* stream) {
  if (P < 1 || P > DMAX || N < 1 || N > DMAX || Q < 1 || Q > QMAX ||
      S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs g;
  g.x = static_cast<const float*>(x);
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.bm = static_cast<const float*>(bm);
  g.cm = static_cast<const float*>(cm);
  g.y = static_cast<float*>(y);
  g.x_sb = strides[0]; g.x_ss = strides[1]; g.x_sh = strides[2];
  g.dt_sb = strides[3]; g.dt_ss = strides[4]; g.dt_sh = strides[5];
  g.a_sb = strides[6]; g.a_ss = strides[7]; g.a_sh = strides[8];
  g.b_sb = strides[9]; g.b_ss = strides[10];
  g.c_sb = strides[11]; g.c_ss = strides[12];
  g.B = B; g.S = S; g.H = H; g.P = P; g.N = N; g.Q = Q;
  return launch(g, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
