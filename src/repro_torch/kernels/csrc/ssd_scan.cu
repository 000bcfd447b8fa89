// Mamba2 chunked SSD scan, chunk-parallel, on the tensor cores at fp32
// accuracy.
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
//                     x_j B_j^T            (h (P, N) fp32)
// h enters chunk 0 as the optional h0 (B, H, P, N), zero without one (the
// prefill hand-off: a prompt scanned in two parts, the first part's final
// state entering the second), and the state after the last chunk is
// written to hT (B, H, P, N).
//
// Design. The TPU grid is (B, H, S / chunk) with the chunk axis sequential
// and h in VMEM. Here the scan is the standard SSD decomposition, four
// kernels on one stream, each parallel over the chunks:
//   1. ssd_chunk_cb_kernel: CB = C_c . B_c^T over the causal half, once per
//      (batch, chunk) and not per head (Bm and Cm are shared by the heads),
//      into a (B, nc, Qp, Qp) scratch (Qp = Q rounded up to 64) that stays
//      in L2; one block per 64 x 64 tile on or below the diagonal.
//   2. ssd_chunk_state_kernel: per (batch, head, chunk) the chunk's own
//      state st = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T, a 64 x 64 block
//      of a (B, H, nc, 64, 64) scratch, and cum itself into a (B, H, S)
//      scratch (an inclusive scan of the chunk's a by one warp).
//   3. ssd_state_pass_kernel: per (batch, head) the states entering each
//      chunk, h_0 = h0 (or zero), h_c = exp(cum_last(c-1)) h_{c-1} +
//      st_{c-1}, written over st in place, and the last carry into hT: the
//      only sequential step, elementwise over (P, N).
//   4. ssd_chunk_scan_kernel: per (batch, head, chunk, 64-row tile i) the
//      output y_i = exp(cum_i) C_i . h_c^T + sum_{j tiles <= i}
//      (CB_ij o L_ij o dt_j) x_j, the decay mask applied to the CB tile
//      in shared memory before its products: per element on the diagonal
//      tile, and as a row factor exp(cum_i - cum_r) times a column factor
//      exp(cum_r - cum_j) dt_j (r the j tile's last position, both
//      exponents <= 0) below it.
// Every product is mma.sync m16n8k8 TF32 with the 3xTF32 split (common.cuh),
// fp32 accumulators: 4 warps a block, each a 32 x 32 quarter of a 64 x 64
// output tile, so that each split fragment of A feeds 12 products and each
// of B 6. Operand tiles come in by cp.async (16-byte copies where rows
// are 16-byte aligned, 4-byte ones otherwise), double-buffered in the
// state and scan kernels. Shared rows are padded to 68 floats where the
// fragments read along a row and 72 where they read down a column, so the
// 32 lanes of a fragment load hit 32 banks. Padding past P, N or the chunk
// is zero-filled, never read from device memory.
// Any P, N <= 64 and chunk Q <= 1024 with Q | S; operands are read through
// their strides, with the last dim of xh, Bm and Cm contiguous.
//
// Bound on the H100, at the LM path's shapes (B 4, S 1024, H 80, P 64,
// N 64, Q 256, fp32): xh read and y written are 2 x 83.9 MB, dt, a, Bm
// and Cm 4.7 MB, so 0.051 ms at 3.35 TB/s. The function needs C.B^T over
// the causal half once per (batch, chunk), and per (batch, head, chunk)
// M.x over the causal half, C.h^T and the state: 10.83 GFLOP of products
// at fp32 accuracy. The card's fastest fp32-accurate products are 3xTF32
// on the tensor cores, three TF32 products each at the 495 TFLOP/s TF32
// peak, so 165 TFLOP/s: 0.066 ms. The bound is operations, 0.066 ms (the
// fp32 CUDA cores' 67 TFLOP/s would give 0.162 ms). These kernels do 11.5
// GFLOP of fp32-accurate products (whole 64 x 64 tiles on the diagonal,
// no C.h^T in a first chunk), as 34.5 GFLOP of TF32 work, 0.070 ms. With
// an h0 the first chunk's C.h^T runs too, and h0 is read and hT written
// (2 x 5.2 MB at that shape).
#include "common.cuh"

namespace {

constexpr int TILE = 64;      // chunk positions per tile
constexpr int DMAX = 64;      // largest P and N; scratch tiles are 64 x 64
constexpr int LDR = 68;       // fragments read along a row: 4g + t banks
constexpr int LDC = 72;       // fragments read down a column: 8t + g banks
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 quarter of a tile
constexpr int QMAX = 1024;
constexpr int TILE_R = TILE * LDR;  // floats of a row-read tile
constexpr int TILE_C = TILE * LDC;  // floats of a column-read tile

struct SsdArgs {
  const float* x;
  const float* dt;
  const float* a;
  const float* bm;
  const float* cm;
  float* y;
  float* cb;    // (B, nc, Qp, Qp) scratch: C_c . B_c^T
  float* st;    // (B, H, nc, 64, 64) scratch: chunk states, then h_c
  float* cum;   // (B, H, S) scratch: cumsum(a) over each chunk
  const float* h0;  // (B, H, P, N) state entering chunk 0, or null (zero)
  float* hT;        // (B, H, P, N) state after the last chunk
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  int B, S, H, P, N, Q, nc, Qp;
  bool vec_x, vec_bc;  // 16-byte copies allowed for xh / for Bm and Cm
};

// Rows [r0, r0 + 64) x columns [0, 64) of a matrix with row stride ss into
// dst (64 rows of LD floats), asynchronously; rows >= nrows and columns >=
// width are zero-filled. vec: 16-byte copies (width % 4 == 0, src and ss
// 16-byte aligned).
template <int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int nrows,
                                          int width, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < TILE * (DMAX / 4); e += THREADS) {
      const int r = e >> 4, c = (e & 15) * 4;
      const bool ok = r0 + r < nrows && c < width;
      common::cp_async16(dst + r * LD + c,
                         ok ? src + (r0 + r) * ss + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < TILE * DMAX; e += THREADS) {
      const int r = e >> 6, c = e & 63;
      const bool ok = r0 + r < nrows && c < width;
      common::cp_async4(dst + r * LD + c, ok ? src + (r0 + r) * ss + c : src,
                        ok);
    }
  }
}

// The warp's 32 x 32 quarter of a 64 x 64 tile: rows rw.., columns cw..
__device__ __forceinline__ int warp_row() {
  return 32 * ((threadIdx.x >> 5) & 1);
}
__device__ __forceinline__ int warp_col() { return 32 * (threadIdx.x >> 6); }

// acc (the warp's quarter) += A . B over k in [0, 64), with A(r, k) =
// fa(r, k) and B(k, c) = fb(k, c) for r, c relative to the quarter.
// acc[mt][nt] is the (m16, n8) tile (mt, nt) in the mma's d layout; each
// split fragment of A feeds four n8 tiles and each of B two m16 tiles.
template <class FA, class FB>
__device__ __forceinline__ void warp_tile_mma(float (&acc)[2][4][4], FA fa,
                                              FB fb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < TILE; k0 += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = 16 * mt + g;
      common::split_tf32(fa(r, k0 + t), ah[mt][0], al[mt][0]);
      common::split_tf32(fa(r + 8, k0 + t), ah[mt][1], al[mt][1]);
      common::split_tf32(fa(r, k0 + t + 4), ah[mt][2], al[mt][2]);
      common::split_tf32(fa(r + 8, k0 + t + 4), ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      common::split_tf32(fb(k0 + t, 8 * nt + g), bh0, bl0);
      common::split_tf32(fb(k0 + t + 4, 8 * nt + g), bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        common::mma_tf32_1688(acc[mt][nt], al[mt], bh0, bh1);
        common::mma_tf32_1688(acc[mt][nt], ah[mt], bl0, bl1);
        common::mma_tf32_1688(acc[mt][nt], ah[mt], bh0, bh1);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;
}

// The warp's quarter of a 64 x 64 tile into dst (row stride ld).
__device__ __forceinline__ void store_tile(float* dst, long long ld,
                                           const float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31;
  const int c = warp_col() + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = warp_row() + 16 * mt + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<float2*>(dst + r * ld + c + 8 * nt) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(dst + (r + 8) * ld + c + 8 * nt) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// grid (B * nc, tiles on or below the diagonal): CB tile (ti, tj) of chunk
// c of batch b, C_i . B_j^T over N, into the (Qp, Qp) block of cb.
__global__ void __launch_bounds__(THREADS)
ssd_chunk_cb_kernel(const SsdArgs g) {
  __shared__ __align__(16) float Cs[TILE_R];
  __shared__ __align__(16) float Bs[TILE_R];
  const int b = blockIdx.x / g.nc, c = blockIdx.x - b * g.nc;
  int ti = 0, rest = blockIdx.y;  // the (ti, tj) of the lower triangle
  while (rest > ti) rest -= ++ti;
  const int tj = rest;
  const long long s0 = static_cast<long long>(c) * g.Q;
  load_tile<LDR>(Cs, g.cm + b * g.c_sb + s0 * g.c_ss, g.c_ss, ti * TILE, g.Q,
                 g.N, g.vec_bc);
  load_tile<LDR>(Bs, g.bm + b * g.b_sb + s0 * g.b_ss, g.b_ss, tj * TILE, g.Q,
                 g.N, g.vec_bc);
  common::cp_async_commit();
  common::cp_async_wait_all();
  __syncthreads();
  const int rw = warp_row(), cw = warp_col();
  float acc[2][4][4];
  zero(acc);
  // A(i, n) = C[i][n]; B(n, j) = B[j][n]
  warp_tile_mma(
      acc, [&](int r, int k) { return Cs[(rw + r) * LDR + k]; },
      [&](int k, int col) { return Bs[(cw + col) * LDR + k]; });
  float* out = g.cb + (static_cast<long long>(b) * g.nc + c) * g.Qp * g.Qp +
               static_cast<long long>(ti) * TILE * g.Qp + tj * TILE;
  store_tile(out, g.Qp, acc);
}

// One warp's inclusive scan of v[0, n) in place (n <= 1024).
__device__ __forceinline__ void warp_scan(float* v, int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per), hi = min(n, lo + per);
  float run = 0.f;
  for (int q = lo; q < hi; ++q) {
    run += v[q];
    v[q] = run;
  }
  float inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  const float base = inc - run;  // the sum of the lanes before this one
  for (int q = lo; q < hi; ++q) v[q] += base;
}

// grid (B * H * nc): the chunk's state st = sum_j w_j x_j B_j^T, w_j =
// exp(cum_last - cum_j) dt_j, and cum into g.cum.
// Shared: two (x tile, B tile) pairs, then cum and w (Qp each).
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_state_kernel(const SsdArgs g) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem + 4 * TILE_C;
  float* ws = cum + g.Qp;
  const int bh = blockIdx.x / g.nc, c = blockIdx.x - bh * g.nc;
  const int b = bh / g.H, h = bh - b * g.H;
  const long long s0 = static_cast<long long>(c) * g.Q;
  const float* xp = g.x + b * g.x_sb + h * g.x_sh + s0 * g.x_ss;
  const float* bp = g.bm + b * g.b_sb + s0 * g.b_ss;
  const int nt = g.Qp / TILE;
  auto issue = [&](int t) {
    float* buf = smem + (t & 1) * 2 * TILE_C;
    load_tile<LDC>(buf, xp, g.x_ss, t * TILE, g.Q, g.P, g.vec_x);
    load_tile<LDC>(buf + TILE_C, bp, g.b_ss, t * TILE, g.Q, g.N, g.vec_bc);
    common::cp_async_commit();
  };
  issue(0);
  const float* ap = g.a + b * g.a_sb + h * g.a_sh + s0 * g.a_ss;
  const float* dp = g.dt + b * g.dt_sb + h * g.dt_sh + s0 * g.dt_ss;
  for (int q = threadIdx.x; q < g.Qp; q += THREADS) {
    cum[q] = q < g.Q ? ap[q * g.a_ss] : 0.f;
    ws[q] = q < g.Q ? dp[q * g.dt_ss] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_scan(cum, g.Q);
  __syncthreads();
  const float cum_last = cum[g.Q - 1];
  float* cum_out = g.cum + static_cast<long long>(bh) * g.S + s0;
  for (int q = threadIdx.x; q < g.Q; q += THREADS) {
    ws[q] *= expf(cum_last - cum[q]);  // zero past Q, where dt is zero
    cum_out[q] = cum[q];
  }
  const int rw = warp_row(), cw = warp_col();
  float acc[2][4][4];
  zero(acc);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      issue(t + 1);
      common::cp_async_wait<1>();
    } else {
      common::cp_async_wait<0>();
    }
    __syncthreads();  // tile t and ws are visible to every warp
    float* xs = smem + (t & 1) * 2 * TILE_C;
    const float* bs = xs + TILE_C;
    const float* wt = ws + t * TILE;
    // w_j x_j in place, once for the two warps that read each element
    for (int e = threadIdx.x; e < TILE * DMAX; e += THREADS) {
      const int j = e >> 6, p = e & 63;
      xs[j * LDC + p] = wt[j] * xs[j * LDC + p];
    }
    __syncthreads();
    // A(p, j) = w_j x[j][p]; B(j, n) = B[j][n]
    warp_tile_mma(
        acc, [&](int r, int k) { return xs[k * LDC + rw + r]; },
        [&](int k, int col) { return bs[k * LDC + cw + col]; });
    __syncthreads();  // the pair is free for tile t + 2
  }
  store_tile(g.st + static_cast<long long>(blockIdx.x) * DMAX * DMAX, DMAX,
             acc);
}

// grid (B * H): the states entering each chunk, over st in place:
// h_0 = h0 (zero when null), h_{c+1} = exp(cum_last(c)) h_c + st_c; the
// last carry into hT. Thread t holds float4s t + i * PASS_THREADS of the
// 64 x 64 state block: row p = e / 16, columns 4 (e % 16) .. + 3; entries
// past P or N stay zero (the chunk states are zero there too).
constexpr int PASS_THREADS = 256;
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(const SsdArgs g) {
  constexpr int PER = DMAX * DMAX / 4 / PASS_THREADS;  // float4s a thread
  float4* st = reinterpret_cast<float4*>(
      g.st + static_cast<long long>(blockIdx.x) * g.nc * DMAX * DMAX);
  const float* cum = g.cum + static_cast<long long>(blockIdx.x) * g.S;
  const long long pn = static_cast<long long>(blockIdx.x) * g.P * g.N;
  float4 hv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * PASS_THREADS;
    const int p = e >> 4, n0 = (e & 15) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (g.h0 != nullptr && p < g.P) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n0 + k < g.N) v[k] = g.h0[pn + p * g.N + n0 + k];
    }
    hv[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int c = 0; c < g.nc; ++c) {
    const float decay = expf(cum[static_cast<long long>(c) * g.Q + g.Q - 1]);
    float4* sc = st + static_cast<long long>(c) * DMAX * DMAX / 4;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * PASS_THREADS;
      const float4 v = sc[e];
      sc[e] = hv[i];
      hv[i] = make_float4(hv[i].x * decay + v.x, hv[i].y * decay + v.y,
                          hv[i].z * decay + v.z, hv[i].w * decay + v.w);
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = threadIdx.x + i * PASS_THREADS;
    const int p = e >> 4, n0 = (e & 15) * 4;
    if (p >= g.P) continue;
    const float v[4] = {hv[i].x, hv[i].y, hv[i].z, hv[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (n0 + k < g.N) g.hT[pn + p * g.N + n0 + k] = v[k];
  }
}

// grid (B * H * nc * Qp / 64): rows [64 ti, 64 ti + 64) of chunk c of
// (batch b, head h); a chunk's row tiles are neighbours in the grid, the
// last (longest) first. Shared: two (CB tile, x tile) pairs, the second
// pair holding C_i and h_c first; then cum and dt up to the tile's end,
// and the two j tiles' row and column factors.
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan_kernel(const SsdArgs g) {
  extern __shared__ __align__(16) float smem[];
  const int nti = g.Qp / TILE;
  const int bhc = blockIdx.x / nti;
  const int ti = nti - 1 - (blockIdx.x - bhc * nti);
  const int i0 = ti * TILE;
  const int npos = i0 + TILE;  // cum and dt are needed up to here
  float* cum = smem + 2 * (TILE_R + TILE_C);
  float* dts = cum + npos;
  float* fac = dts + npos;     // [2][rows 64, columns 64]
  const int bh = bhc / g.nc, c = bhc - bh * g.nc;
  const int b = bh / g.H, h = bh - b * g.H;
  const long long s0 = static_cast<long long>(c) * g.Q;
  const float* xp = g.x + b * g.x_sb + h * g.x_sh + s0 * g.x_ss;
  const float* cbp = g.cb + (static_cast<long long>(b) * g.nc + c) * g.Qp *
                                g.Qp + static_cast<long long>(i0) * g.Qp;
  auto pair = [&](int t) { return smem + (t & 1) * (TILE_R + TILE_C); };
  // C_i and h_c into the second pair, then CB_i0 and x_0 into the first
  // (chunk 0 has an entering state only with an h0)
  const bool has_h = c > 0 || g.h0 != nullptr;
  {
    float* p1 = pair(1);
    if (has_h) {
      load_tile<LDR>(p1, g.cm + b * g.c_sb + s0 * g.c_ss, g.c_ss, i0, g.Q,
                     g.N, g.vec_bc);
      load_tile<LDR>(p1 + TILE_R, g.st + static_cast<long long>(bhc) *
                     DMAX * DMAX, DMAX, 0, DMAX, DMAX, true);
    }
    common::cp_async_commit();
  }
  auto issue = [&](int t) {
    float* p = pair(t);
    load_tile<LDR>(p, cbp + t * TILE, g.Qp, 0, TILE, TILE, true);
    load_tile<LDC>(p + TILE_R, xp, g.x_ss, t * TILE, g.Q, g.P, g.vec_x);
    common::cp_async_commit();
  };
  issue(0);
  const float* cp = g.cum + static_cast<long long>(bh) * g.S + s0;
  const float* dp = g.dt + b * g.dt_sb + h * g.dt_sh + s0 * g.dt_ss;
  for (int q = threadIdx.x; q < npos; q += THREADS) {
    // past Q: cum stays at its last value and dt is zero
    cum[q] = cp[min(q, g.Q - 1)];
    dts[q] = q < g.Q ? dp[q * g.dt_ss] : 0.f;
  }
  __syncthreads();
  // j tile t < ti: rows exp(cum_i - cum_r), columns exp(cum_r - cum_j) dt_j,
  // r = the tile's last position (both exponents <= 0: no overflow, and
  // the product underflows only where the decay itself does)
  auto factors = [&](int t) {
    if (t == ti || threadIdx.x >= 2 * TILE) return;
    float* f = fac + (t & 1) * 2 * TILE;
    const float cr = cum[t * TILE + TILE - 1];
    const int e = threadIdx.x;
    if (e < TILE)
      f[e] = expf(cum[i0 + e] - cr);
    else
      f[e] = expf(cr - cum[t * TILE + e - TILE]) * dts[t * TILE + e - TILE];
  };
  factors(0);
  const int lane = threadIdx.x & 31;
  const int rw = warp_row(), cw = warp_col();
  float acc[2][4][4];
  zero(acc);
  common::cp_async_wait<1>();  // C_i and h_c
  __syncthreads();
  if (has_h) {
    const float* cs = pair(1);
    const float* hs = cs + TILE_R;
    // A(i, n) = C[i][n]; B(n, p) = h[p][n]; then the rows times exp(cum_i)
    warp_tile_mma(
        acc, [&](int r, int k) { return cs[(rw + r) * LDR + k]; },
        [&](int k, int col) { return hs[(cw + col) * LDR + k]; });
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = rw + 16 * mt + (lane >> 2);
      const float e0 = expf(cum[i0 + r]), e1 = expf(cum[i0 + r + 8]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][0] *= e0;
        acc[mt][nt][1] *= e0;
        acc[mt][nt][2] *= e1;
        acc[mt][nt][3] *= e1;
      }
    }
  }
  __syncthreads();  // the second pair is free
  for (int t = 0; t <= ti; ++t) {
    if (t < ti) {
      issue(t + 1);
      factors(t + 1);
      common::cp_async_wait<1>();
    } else {
      common::cp_async_wait<0>();
    }
    __syncthreads();  // tile t and its factors are visible
    float* cbs = pair(t);
    const float* xs = cbs + TILE_R;
    const int j0 = t * TILE;
    // CB o L o dt in place, once for the two warps that read each row: the
    // causal mask and the decay per element on the diagonal tile, the row
    // and column factors below it
    const float* f = fac + (t & 1) * 2 * TILE;
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e >> 6, k = e & 63;
      float* v = cbs + r * LDR + k;
      if (t == ti) {
        const int i = i0 + r, j = j0 + k;
        *v = j <= i ? *v * expf(cum[i] - cum[j]) * dts[j] : 0.f;
      } else {
        *v = *v * f[r] * f[TILE + k];
      }
    }
    __syncthreads();
    warp_tile_mma(
        acc, [&](int r, int k) { return cbs[(rw + r) * LDR + k]; },
        [&](int k, int col) { return xs[k * LDC + cw + col]; });
    __syncthreads();  // the pair is free for tile t + 2
  }
  // y rows past Q and columns past P are not written
  const long long y_ss = static_cast<long long>(g.H) * g.P;
  float* yp = g.y + ((b * static_cast<long long>(g.S) + s0) * g.H + h) * g.P;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = rw + 16 * mt + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int p = cw + 8 * nt + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + r + 8 * half;
        if (i >= g.Q) continue;
        float* o = yp + i * y_ss + p;
        if (p < g.P) o[0] = acc[mt][nt][2 * half];
        if (p + 1 < g.P) o[1] = acc[mt][nt][2 * half + 1];
      }
    }
  }
}

size_t state_smem(int Qp) { return sizeof(float) * (4 * TILE_C + 2 * Qp); }
size_t scan_smem(int Qp) {
  return sizeof(float) * (2 * (TILE_R + TILE_C) + 2 * Qp + 4 * TILE);
}

int launch(const SsdArgs& g, cudaStream_t st) {
  // set on every launch: the attribute is per device, and cheap to set
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(state_smem(QMAX)));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan_smem(QMAX)));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (g.B == 0 || g.H == 0 || g.S == 0) return 0;
  const int nt = g.Qp / TILE;
  const unsigned bc = static_cast<unsigned>(g.B) * g.nc;
  const unsigned bhc = bc * static_cast<unsigned>(g.H);
  ssd_chunk_cb_kernel<<<dim3(bc, nt * (nt + 1) / 2), THREADS, 0, st>>>(g);
  ssd_chunk_state_kernel<<<bhc, THREADS, state_smem(g.Qp), st>>>(g);
  ssd_state_pass_kernel<<<static_cast<unsigned>(g.B) * g.H, PASS_THREADS,
                          0, st>>>(g);
  ssd_chunk_scan_kernel<<<bhc * nt, THREADS, scan_smem(g.Qp), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// All operands float32. strides: 13 element strides, (batch, seq, head) of
// xh, dt and a, then (batch, seq) of Bm and Cm; the last dim of xh, Bm and
// Cm is contiguous. y is a contiguous (B, S, H, P) tensor; cb (B, nc, Qp,
// Qp), st (B, H, nc, 64, 64) and cum (B, H, S) are float32 scratch, Qp = Q
// rounded up to a multiple of 64, each 16-byte aligned. h0 (null: zero)
// and hT are contiguous (B, H, P, N).
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, const void* h0, void* y,
                    void* hT, void* cb, void* st, void* cum, int B, int S,
                    int H, int P, int N, int Q, const long long* strides,
                    void* stream) {
  if (P < 1 || P > DMAX || N < 1 || N > DMAX || Q < 1 || Q > QMAX ||
      S % Q != 0 || !common::aligned16(cb) || !common::aligned16(st))
    return static_cast<int>(cudaErrorInvalidValue);
  SsdArgs g;
  g.x = static_cast<const float*>(x);
  g.dt = static_cast<const float*>(dt);
  g.a = static_cast<const float*>(a);
  g.bm = static_cast<const float*>(bm);
  g.cm = static_cast<const float*>(cm);
  g.y = static_cast<float*>(y);
  g.cb = static_cast<float*>(cb);
  g.st = static_cast<float*>(st);
  g.cum = static_cast<float*>(cum);
  g.h0 = static_cast<const float*>(h0);
  g.hT = static_cast<float*>(hT);
  g.x_sb = strides[0]; g.x_ss = strides[1]; g.x_sh = strides[2];
  g.dt_sb = strides[3]; g.dt_ss = strides[4]; g.dt_sh = strides[5];
  g.a_sb = strides[6]; g.a_ss = strides[7]; g.a_sh = strides[8];
  g.b_sb = strides[9]; g.b_ss = strides[10];
  g.c_sb = strides[11]; g.c_ss = strides[12];
  g.B = B; g.S = S; g.H = H; g.P = P; g.N = N; g.Q = Q;
  g.nc = Q > 0 ? S / Q : 0;
  g.Qp = (Q + TILE - 1) / TILE * TILE;
  g.vec_x = common::aligned16(x) && P % 4 == 0 && g.x_sb % 4 == 0 &&
            g.x_ss % 4 == 0 && g.x_sh % 4 == 0;
  g.vec_bc = common::aligned16(bm) && common::aligned16(cm) && N % 4 == 0 &&
             g.b_sb % 4 == 0 && g.b_ss % 4 == 0 && g.c_sb % 4 == 0 &&
             g.c_ss % 4 == 0;
  return launch(g, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
