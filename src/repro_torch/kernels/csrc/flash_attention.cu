// Online-softmax (flash) attention forward with GQA, causal, sliding-window
// and kv_len masks: a bf16 kernel on the tensor cores and an fp32 kernel on
// the CUDA cores, chosen by the inputs' dtype.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_bhsd
// (pallas_call at :106, body _flash_kernel :32; wrapper
// src/repro/kernels/ops.py:54 flash_attention).
//
// Common to both: kv_head = q_head / (Hq / Hkv); masked logits get p = 0
// and a q row that sees no key writes zeros (the TPU kernel returns a mean
// of the visited values there); K/V tiles that no row of a q tile can see
// (causal, window, kv_len) are skipped, as the TPU kernel's pl.when does;
// ragged S and T are masked, never padded in memory; the running row max,
// row sum and accumulator stay in fp32 registers. Each block's output
// depends only on its own (batch, head, q tile): no split over keys and no
// atomics, so results do not depend on how callers fold batches. Both
// kernels take a q/k head dim DQ and a v head dim DV <= DQ (the output is
// DV wide): (64, 64), (80, 80) (zamba2), (128, 128), and MLA's (192, 128)
// (deepseek-v2's published widths: 128 + 64 q/k, 128 v) and (48, 32)
// (its reduced() widths). The wrapper passes the batch, sequence and head
// strides of each operand; the head dim is contiguous.
//
// Bound on the H100: for the ViT (B=256, S=T=65, 3 heads of 64, bf16) the
// four (B, S, H, hd) tensors are 25.6 MB, 7.6 us at 3.35 TB/s, against
// 0.83 GFLOP of q.k and p.v, 0.8 us at the bf16 tensor-core peak: bytes.
// For zamba2's causal (4, 1024, 32, 80) the bytes are 84 MB (25 us) and the
// causal half of the products 21.5 GFLOP (22 us): both about equal. For
// deepseek-v2's causal MLA (2, 1024, 128 heads, q/k 192, v 128) q, k, v
// and o are 335.5 MB (100 us) against 85.9 GFLOP (87 us).
//
// bf16 kernel (flash_fwd_bf16_kernel). Products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulator), the FlashAttention-2
// layout: each warp owns 16 q rows, keeps its q fragments in registers for
// the whole key loop, and reuses the fp32 score accumulator of q.k^T as the
// A operand of p.v after rounding p to bf16 (the JAX model's sdpa_dense
// rounds its probabilities to the compute dtype too, sdpa.py:42; the row
// sum uses the fp32 p). mma.sync rather than wgmma: wgmma needs 64-row
// warpgroup tiles, and at the ViT's S = 65 a 16-row granularity covers the
// 65 rows with 80 (five warps) where 64-row tiles need 128. Operands are
// staged with 16-byte cp.async copies (the base and the batch, sequence
// and head strides must be multiples of 16 bytes; the wrapper checks) into
// shared-memory rows padded by 16 bytes, so ldmatrix reads them without
// bank conflicts; rows past S or T are zero-filled in shared memory.
// A block covers 16 * q_warps q rows of one (batch, head): q_warps =
// ceil(S / 16) up to 8, so the ViT runs one block per (batch, head) that
// reads K and V once, and longer sequences take 128-row q tiles. K/V come
// in 64-key tiles through a two-stage ring: the next tile's copies are in
// flight while the current one is multiplied. A warp skips the 16-key
// chunks of a tile that none of its rows can see (the single key of the
// ViT's second tile; the causal diagonal) and evaluates masks only on
// tiles that cross a mask's edge; the last q tiles of a causal problem,
// the longest, are launched first. Registers are capped at 128 a thread
// up to DQ = 128 (two 256-thread blocks an SM) and at 255 beyond, where the
// q fragments alone take 48 registers at DQ = 192 (one block an SM, as its
// 137 KB of shared memory allows anyway); the exponential is the SFU's
// ex2.approx: each was faster on the card than the alternative (PERF.md).
// TMA was not used: the
// ViT's tiles are 8 KB, and a descriptor built on the host for each of
// the path's 8616 launches would add host time to a host-bound step.
//
// fp32 kernel (flash_fwd_kernel): fp32 on the CUDA cores, so fp32
// results stay within 2e-5 of the fp32 plain version (TF32 would not).
// One block per (batch, q head, 64-row q tile), four warps of 16 rows; K/V
// tiles staged in shared memory as fp32; p stays in fp32.
#include "common.cuh"

namespace {

using common::warp_max;
using common::warp_sum;

constexpr float NEG_INF = -1e30f;

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, Hq, Hkv, S, T;
  int causal, window, kv_len;
  float scale;
};

__device__ __forceinline__ bool visible(const AttnArgs& a, int qpos,
                                        int kpos) {
  bool ok = kpos < a.kv_len;
  if (a.causal) ok = ok && (kpos <= qpos);
  if (a.window > 0) ok = ok && (kpos > qpos - a.window);
  return ok;
}

// ---------------------------------------------------------------- fp32 ----
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;  // q rows per warp

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const AttnArgs a) {
  constexpr int KSTRIDE = DQ + 1;  // padded row: lanes read distinct banks
  constexpr int DPL = (DV + 31) / 32;  // output columns per lane
  constexpr bool FULL = DV % 32 == 0;  // else the last column is masked
  extern __shared__ float smem[];
  float* Qs = smem;                // BQ x DQ
  float* Ks = Qs + BQ * DQ;        // BK x (DQ + 1)
  float* Vs = Ks + BK * KSTRIDE;   // BK x DV
  float* Ps = Vs + BK * DV;        // BQ x BK

  const int nq = (a.S + BQ - 1) / BQ;
  int bid = blockIdx.x;
  const int qt = bid % nq;
  bid /= nq;
  const int h = bid % a.Hq;
  const int b = bid / a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp =
      static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vp =
      static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < BQ * DQ; i += THREADS) {
    const int r = i / DQ, d = i - r * DQ;
    const int s = q0 + r;
    Qs[i] = s < a.S ? qp[s * a.q_ss + d] : 0.f;
  }

  float acc[RPW][DPL];
  float m_run[RPW];
  float l_run[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m_run[rr] = NEG_INF;
    l_run[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[rr][j] = 0.f;
  }

  // K/V range some row of this q tile can see
  const int q_last = min(q0 + BQ, a.S) - 1;
  int k_end = a.kv_len;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * DQ; i += THREADS) {
      const int c = i / DQ, d = i - c * DQ;
      const int t = k0 + c;
      Ks[c * KSTRIDE + d] = t < a.T ? kp[t * a.k_ss + d] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int c = i / DV, d = i - c * DV;
      const int t = k0 + c;
      Vs[c * DV + d] = t < a.T ? vp[t * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    const float* k_lo = Ks + lane * KSTRIDE;
    const float* k_hi = Ks + (lane + 32) * KSTRIDE;
    const int kpos0 = k0 + lane, kpos1 = k0 + lane + 32;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int qpos = q0 + r;
      const float* qrow = Qs + r * DQ;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < DQ; ++d) {
        const float qv = qrow[d];
        s0 = fmaf(qv, k_lo[d], s0);
        s1 = fmaf(qv, k_hi[d], s1);
      }
      s0 *= a.scale;
      s1 *= a.scale;
      const bool v0 = visible(a, qpos, kpos0);
      const bool v1 = visible(a, qpos, kpos1);
      const float mx = warp_max(fmaxf(v0 ? s0 : NEG_INF, v1 ? s1 : NEG_INF));
      const float m_new = fmaxf(m_run[rr], mx);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      const float corr = expf(m_run[rr] - m_new);
      l_run[rr] = l_run[rr] * corr + warp_sum(p0 + p1);
      m_run[rr] = m_new;
      Ps[r * BK + lane] = p0;
      Ps[r * BK + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[rr][j] *= corr;
    }
    __syncwarp();
    const float* prow = Ps + warp * RPW * BK;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int col = lane + 32 * j;
        vv[j] = (FULL || col < DV) ? Vs[c * DV + col] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float p = prow[rr * BK + c];
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[rr][j] = fmaf(p, vv[j], acc[rr][j]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int s = q0 + warp * RPW + rr;
    if (s < a.S) {
      const float l = fmaxf(l_run[rr], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int col = lane + 32 * j;
        if (FULL || col < DV) op[s * a.o_ss + col] = acc[rr][j] / l;
      }
    }
  }
}

template <int DQ, int DV>
int launch_fp32(const AttnArgs& a, cudaStream_t st) {
  constexpr size_t smem =
      sizeof(float) * (BQ * DQ + BK * (DQ + 1) + BK * DV + BQ * BK);
  // set on every launch: the attribute is per device, and cheap to set
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>(a.B) * a.Hq * ((a.S + BQ - 1) / BQ);
  if (blocks <= 0) return 0;
  flash_fwd_kernel<DQ, DV>
      <<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 ----
using bf16 = __nv_bfloat16;
constexpr int TK = 64;        // keys per K/V tile
constexpr int MAX_WARPS = 8;  // q_warps <= 8: at most 128 q rows a block

// shared-memory row pitch, in bf16: the row plus 16 bytes, so the eight
// 16-byte rows one ldmatrix reads fall in distinct banks
template <int HD>
__host__ __device__ constexpr int pitch() {
  return HD + 8;
}

// q rows and a two-stage K ring at DQ's pitch, a two-stage V ring at DV's
template <int DQ, int DV>
constexpr size_t bf16_smem_bytes(int q_warps) {
  return sizeof(bf16) *
         (static_cast<size_t>(16 * q_warps + 2 * TK) * pitch<DQ>() +
          static_cast<size_t>(2 * TK) * pitch<DV>());
}

// two 256-thread blocks an SM (128 registers a thread) up to DQ = 128, one
// beyond (255 registers)
template <int DQ>
constexpr int bf16_min_blocks() {
  return DQ <= 128 ? 2 : 1;
}

// 2^x on the SFU (ex2.approx, flush to zero: exp2f's denormal handling
// costs instructions, and a p below 2^-126 adds nothing to a row)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows [row0, row0 + rows) of a (.., HD) operand into shared memory, 16
// bytes a copy; rows at or past ``limit`` are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g,
                                          long long row_stride, int row0,
                                          int rows, int limit) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = row0 + r < limit;
    const bf16* src = g + (ok ? (row0 + r) * row_stride : 0) + c * 8;
    common::cp_async16(sm + r * pitch<HD>() + c * 8, src, ok);
  }
}

// at most 128 registers a thread up to DQ = 128 (two 256-thread blocks an
// SM): more warps resident hide the latency of mma.sync chains better than
// the registers they would otherwise spend (measured, see PERF.md)
template <int DQ, int DV>
__global__ void __launch_bounds__(MAX_WARPS * 32, bf16_min_blocks<DQ>())
flash_fwd_bf16_kernel(const AttnArgs a) {
  static_assert(DQ % 16 == 0 && DV % 16 == 0 && DV <= DQ,
                "head dims: multiples of 16, v no wider than q");
  constexpr int PQ = pitch<DQ>();
  constexpr int PV = pitch<DV>();
  constexpr int KC = DQ / 16;   // k16 chunks of the q/k head dim (q.k^T)
  constexpr int DN = DV / 8;    // n8 tiles of the v head dim (p.v)
  constexpr int SN = TK / 8;    // n8 tiles of a key tile (scores)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q_warps = blockDim.x >> 5;
  const int bq = 16 * q_warps;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // bq x PQ, then o
  bf16* Ks = Qs + bq * PQ;                       // 2 stages x TK x PQ
  bf16* Vs = Ks + 2 * TK * PQ;                   // 2 stages x TK x PV

  const int bh_count = a.B * a.Hq;
  const int nq = (a.S + bq - 1) / bq;
  const int bh = blockIdx.x % bh_count;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int h = bh % a.Hq;
  const int b = bh / a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = qt * bq;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row, column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix matrix, row

  // keys some row of the block can see: [k_begin, k_end)
  const int q_last = min(q0 + bq, a.S) - 1;
  const int k_end = a.causal ? min(a.kv_len, q_last + 1) : a.kv_len;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_begin = (k_begin / TK) * TK;
  const int ntiles = k_end > t_begin ? (k_end - t_begin + TK - 1) / TK : 0;
  // ... and the warp's own 16 rows
  const int wq0 = q0 + warp * 16;
  int w_end = a.causal ? min(a.kv_len, wq0 + 16) : a.kv_len;
  if (wq0 >= a.S) w_end = 0;
  const int w_begin = a.window > 0 ? max(0, wq0 - a.window + 1) : 0;

  load_rows<DQ>(Qs, qp, a.q_ss, q0, bq, a.S);
  common::cp_async_commit();
  if (ntiles > 0) {
    load_rows<DQ>(Ks, kp, a.k_ss, t_begin, TK, a.T);
    load_rows<DV>(Vs, vp, a.v_ss, t_begin, TK, a.T);
    common::cp_async_commit();
  }

  // scores in log2 units: p = exp2(s * scale * log2(e) - m). A lane holds
  // rows g (index 0 of m and l; entries 0, 1 of a fragment) and g + 8
  // (index 1; entries 2, 3).
  const float sl2 = a.scale * 1.4426950408889634f;
  uint32_t qf[KC][4];
  float o[DN][4];
#pragma unroll
  for (int j = 0; j < DN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = t_begin + it * TK;
    // tile ``it`` has landed, and every warp is done with tile it - 1,
    // whose stage the next copies overwrite
    common::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < ntiles) {
      const int nxt = (it + 1) & 1;
      load_rows<DQ>(Ks + nxt * TK * PQ, kp, a.k_ss, k0 + TK, TK, a.T);
      load_rows<DV>(Vs + nxt * TK * PV, vp, a.v_ss, k0 + TK, TK, a.T);
      common::cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        common::ldsm_x4(qf[kc], Qs + (warp * 16 + (mi & 1) * 8 + mr) * PQ +
                                    kc * 16 + (mi >> 1) * 8);
    }
    // keys [k0, k0 + nk) hold everything the warp's rows see in this tile
    const int nk = min(TK, w_end - k0);
    if (nk <= 0 || k0 + TK <= w_begin) continue;
    const bf16* Kt = Ks + (it & 1) * TK * PQ;
    const bf16* Vt = Vs + (it & 1) * TK * PV;

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int np = 0; np < SN / 2; ++np) {  // 16 keys at a time
      if (np * 16 < nk) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t kb[4];
          common::ldsm_x4(kb, Kt + (np * 16 + (mi >> 1) * 8 + mr) * PQ +
                                  kc * 16 + (mi & 1) * 8);
          common::mma_bf16_16816(s[2 * np], qf[kc], kb[0], kb[1]);
          common::mma_bf16_16816(s[2 * np + 1], qf[kc], kb[2], kb[3]);
        }
      }
    }

    // scale, then mask unless every row of the warp sees every key of the
    // tile (most tiles of a long causal problem)
    const bool full = k0 + TK <= a.kv_len &&
                      (!a.causal || k0 + TK <= wq0 + 1) &&
                      (a.window <= 0 || k0 > wq0 + 15 - a.window);
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= sl2;
    if (!full) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, wq0 + g + (e >> 1) * 8,
                       k0 + j * 8 + 2 * t4 + (e & 1)))
            s[j][e] = NEG_INF;
    }
    // the online softmax; a quad of four lanes holds a row's 64 scores
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < SN; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float c = ex2(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SN; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = s[j][e] == NEG_INF ? 0.f : ex2(s[j][e] - mn);
          sum += s[j][e];
        }
      }
      l[r] = l[r] * c + sum;  // this lane's part; the quad sums at the end
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        o[j][2 * r] *= c;
        o[j][2 * r + 1] *= c;
      }
    }

    // o += p . v, 16 keys at a time: the score accumulators of two n8
    // tiles are the A fragment of one k16 step
#pragma unroll
    for (int kc = 0; kc < SN / 2; ++kc) {
      if (kc * 16 < nk) {
        const uint32_t pa[4] = {
            common::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            common::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            common::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            common::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          uint32_t vb[4];
          common::ldsm_x4_trans(vb, Vt + (kc * 16 + (mi & 1) * 8 + mr) * PV +
                                        dp * 16 + (mi >> 1) * 8);
          common::mma_bf16_16816(o[2 * dp], pa, vb[0], vb[1]);
          common::mma_bf16_16816(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  // normalise, stage the warp's 16 rows in its own rows of Qs (DV <= DQ
  // columns of each), then write them out 16 bytes a store
  common::cp_async_wait_all();
  __syncthreads();
  bf16* Ow = Qs + warp * 16 * PQ;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j)
      *reinterpret_cast<uint32_t*>(Ow + (g + 8 * r) * PQ + j * 8 + 2 * t4) =
          common::pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * DN; i += 32) {
    const int r = i / DN, c = i - r * DN;
    if (wq0 + r < a.S)
      *reinterpret_cast<uint4*>(op + (wq0 + r) * a.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * PQ + c * 8);
  }
}

// q_warps warps of 16 rows a block: all of a sequence up to 128 rows (the
// ViT's S = 65 takes five), else 128-row tiles (faster than 64-row ones at
// zamba2's S = 1024, PERF.md)
template <int DQ, int DV>
int launch_bf16(const AttnArgs& a, cudaStream_t st) {
  const int q_warps = a.S < 16 * MAX_WARPS ? (a.S + 15) / 16 : MAX_WARPS;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DQ, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bf16_smem_bytes<DQ, DV>(MAX_WARPS)));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (q_warps < 1) return 0;
  const long long blocks = static_cast<long long>(a.B) * a.Hq *
                           ((a.S + 16 * q_warps - 1) / (16 * q_warps));
  if (blocks <= 0) return 0;
  flash_fwd_bf16_kernel<DQ, DV>
      <<<static_cast<unsigned>(blocks), 32 * q_warps,
         bf16_smem_bytes<DQ, DV>(q_warps), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel). dq: the q/k head dim, dv: the v (and output) head dim, one of
// the instantiated pairs. strides: 12 element strides, (batch, seq, head)
// for q, k, v, o in that order; the head dim must be contiguous, and for
// bfloat16 every base and stride 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int dq, int dv, int B, int Hq,
                           int Hkv, int S, int T, const long long* strides,
                           int causal, int window, int kv_len, float scale,
                           void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  a.B = B; a.Hq = Hq; a.Hkv = Hkv; a.S = S; a.T = T;
  a.causal = causal; a.window = window; a.scale = scale;
  a.kv_len = kv_len < T ? kv_len : T;  // keys past T are not there
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_HEAD_DIMS(DQ, DV)                                  \
  if (dq == DQ && dv == DV)                                      \
    return dtype == 0 ? launch_fp32<DQ, DV>(a, st)               \
                      : dtype == 1 ? launch_bf16<DQ, DV>(a, st)  \
                                   : static_cast<int>(cudaErrorInvalidValue);
  // the pairs of kernels/flash_attention.py's HEAD_DIMS
  REPRO_HEAD_DIMS(64, 64)
  REPRO_HEAD_DIMS(80, 80)
  REPRO_HEAD_DIMS(128, 128)
  REPRO_HEAD_DIMS(192, 128)
  REPRO_HEAD_DIMS(48, 32)
#undef REPRO_HEAD_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
