// Online-softmax (flash) attention forward with GQA, causal, sliding-window
// and kv_len masks.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_bhsd
// (pallas_call at :106, body _flash_kernel :32; wrapper
// src/repro/kernels/ops.py:54 flash_attention).
//
// One block per (batch, q head, 64-row q tile); four warps, 16 q rows each.
// The block loops over 64-row K/V tiles staged in shared memory as fp32,
// keeps the running row max, row sum and the (16 x hd) accumulator of each
// warp in registers, all in fp32, and keeps p in fp32 for p.v as the TPU
// kernel does (flash_attention.py:73-79). Masked logits get p = 0; a q row
// that sees no key writes zeros. K/V tiles that no row of the q tile can
// see (causal, window, kv_len) are skipped, as the TPU kernel's pl.when
// does. Ragged S and T are masked, never padded, and kv_head =
// q_head / (Hq / Hkv). Any layout whose last dim is contiguous works: the
// wrapper passes the batch, sequence and head strides of each operand.
// Head dims 64, 80 (zamba2) and 128: a lane owns output columns lane,
// lane + 32, ..., ceil(hd / 32) of them, the last masked when 32 does not
// divide hd, so q, k and v are never padded in memory.
//
// Bound on the H100: for the ViT (B=256, S=T=65, 3 heads of 64, bf16) the
// four (B, S, H, hd) tensors are 25.6 MB, 7.6 us at 3.35 TB/s, while the
// 0.83 GFLOP of q.k and p.v take 0.8 us at the bf16 tensor-core peak: the
// bound is bytes. This first kernel does its products on the fp32 CUDA
// cores (scores: one lane per key column; p.v: one lane per output
// column), so at this size it is limited by issue rate, not by memory.
// wgmma on bf16 tiles with TMA-fed K/V is the follow-up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;  // q rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const AttnArgs a) {
  constexpr int KSTRIDE = HD + 1;  // padded row: lanes read distinct banks
  constexpr int DPL = (HD + 31) / 32;  // output columns per lane
  constexpr bool FULL = HD % 32 == 0;  // else the last column is masked
  extern __shared__ float smem[];
  float* Qs = smem;                // BQ x HD
  float* Ks = Qs + BQ * HD;        // BK x (HD + 1)
  float* Vs = Ks + BK * KSTRIDE;   // BK x HD
  float* Ps = Vs + BK * HD;        // BQ x BK

  const int nq = (a.S + BQ - 1) / BQ;
  int bid = blockIdx.x;
  const int qt = bid % nq;
  bid /= nq;
  const int h = bid % a.Hq;
  const int b = bid / a.Hq;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    const int s = q0 + r;
    Qs[i] = s < a.S ? to_f(qp[s * a.q_ss + d]) : 0.f;
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
  int k_end = min(a.kv_len, a.T);
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int c = i / HD, d = i - c * HD;
      const int t = k0 + c;
      const bool in = t < a.T;
      Ks[c * KSTRIDE + d] = in ? to_f(kp[t * a.k_ss + d]) : 0.f;
      Vs[c * HD + d] = in ? to_f(vp[t * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    const float* k_lo = Ks + lane * KSTRIDE;
    const float* k_hi = Ks + (lane + 32) * KSTRIDE;
    const int kpos0 = k0 + lane, kpos1 = k0 + lane + 32;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr;
      const int qpos = q0 + r;
      const float* qrow = Qs + r * HD;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
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
        vv[j] = (FULL || col < HD) ? Vs[c * HD + col] : 0.f;
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
        if (FULL || col < HD) op[s * a.o_ss + col] = from_f<T>(acc[rr][j] / l);
      }
    }
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * HD + BK * (HD + 1) + BK * HD + BQ * BK);
}

template <typename T, int HD>
int launch(const AttnArgs& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long blocks =
      static_cast<long long>(a.B) * a.Hq * ((a.S + BQ - 1) / BQ);
  if (blocks <= 0) return 0;
  flash_fwd_kernel<T, HD><<<static_cast<unsigned>(blocks), THREADS, smem,
                            st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it). strides: 12
// element strides, (batch, seq, head) for q, k, v, o in that order; the
// head dim must be contiguous.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int hd, int B, int Hq,
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
  a.causal = causal; a.window = window; a.kv_len = kv_len; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return launch<float, 64>(a, st);
  if (dtype == 0 && hd == 80) return launch<float, 80>(a, st);
  if (dtype == 0 && hd == 128) return launch<float, 128>(a, st);
  if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(a, st);
  if (dtype == 1 && hd == 80) return launch<__nv_bfloat16, 80>(a, st);
  if (dtype == 1 && hd == 128) return launch<__nv_bfloat16, 128>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
