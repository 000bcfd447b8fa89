// Rotary position embedding, split-half form: for each (row, head) of x
// (..., S, H, hd), the halves x1 = x[:hd/2] and x2 = x[hd/2:] become
//   y1 = x1 * cos - x2 * sin,   y2 = x1 * sin + x2 * cos
// with cos / sin the fp32 table of the row's position, (T, hd/2).
//
// Replaces no TPU kernel: the reference's RoPE is jnp code
// (src/repro/models/layers/rope.py:12). The port's plain version of it (a
// cast to fp32, four broadcast products over strided halves, a sub, an
// add, a cat and a cast back, each an ATen kernel, for q and again for k)
// moved about 2.45 GB per ViT q or k tensor at the benchmark's stage 12
// and took the largest share of the clients' forward.
//
// Bound on the H100: bytes. One read of x and one write of y in x's dtype
// (the table, at most a few hundred KB, stays in L1 / L2): the ViT's
// (4096, 65, 3, 64) bf16 q is 204 MB, 0.061 ms at 3.35 TB/s; q and k
// together in one launch 0.122 ms.
//
// Design: a thread takes V elements of each half of one (row, head) with
// 16-byte loads and stores (V = 8: one uint4 of bf16 / fp16, two of fp32;
// the table's 8 cos and 8 sin as two float4 each) and loops grid-stride
// over the units of q, then of k, so q and k rotate in one launch. Where
// hd / 2 is not a multiple of 8, or a base is not 16-byte aligned, the same
// kernel runs with V = 1. Indices are 32-bit where every count fits.
//
// Bits: the products, the difference and the sum are rounded one by one
// (__fmul_rn, __fsub_rn, __fadd_rn, which nvcc never contracts into an
// FMA) and the result to x's dtype to nearest even, so each output equals
// the plain version's ATen arithmetic bit for bit. With ``inverse`` the
// sin is negated in registers: the rotation by -angle, which is the
// backward (each input's gradient is the same two-term sum, which
// commutes, and rn(g * -s) = -rn(g * s)), bit for bit autograd's.
#include "common.cuh"

#include <cuda_fp16.h>

namespace {

constexpr int THREADS = 256;
constexpr int V = 8;  // elements of each half a thread takes (vector path)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half round_to<__half>(float v) {
  return __float2half_rn(v);
}

// N values of T at p, as fp32: 16-byte loads where N * sizeof(T) is a
// multiple of 16, else element by element
template <typename T, int N>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += PER) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + i));
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) v[i + j] = to_float(e[j]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_float(p[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N; i += PER) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) e[j] = round_to<T>(v[i + j]);
      *reinterpret_cast<uint4*>(p + i) = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = round_to<T>(v[i]);
  }
}

template <typename T>
struct Part {          // one tensor of the launch: rows of hd elements
  const T* x;
  T* y;
  long long rows;      // prod(x.shape[:-1]): (row, head) pairs
  int heads;           // x.shape[-2]
};

// units: N-element pieces of each half, q's first, then k's; I the index
// type (uint32 where every count fits)
template <typename T, int N, bool INV, typename I>
__global__ void __launch_bounds__(THREADS)
rope_rotate_kernel(Part<T> q, Part<T> k, const float* __restrict__ cosv,
                   const float* __restrict__ sinv, I trows, int half) {
  const I per_row = static_cast<I>(half / N);
  const I nq = static_cast<I>(q.rows) * per_row;
  const I total = nq + static_cast<I>(k.rows) * per_row;
  const I stride = static_cast<I>(gridDim.x) * THREADS;
  for (I u = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x; u < total;
       u += stride) {
    const bool is_q = u < nq;
    const T* x = is_q ? q.x : k.x;
    T* y = is_q ? q.y : k.y;
    const I heads = static_cast<I>(is_q ? q.heads : k.heads);
    const I v = is_q ? u : u - nq;
    const I row = v / per_row;
    const int j = static_cast<int>(v - row * per_row) * N;
    const I pos = (row / heads) % trows;
    const long long off = static_cast<long long>(row) * (2 * half) + j;
    const long long toff = static_cast<long long>(pos) * half + j;
    float x1[N], x2[N], c[N], s[N], y1[N], y2[N];
    load<T, N>(x + off, x1);
    load<T, N>(x + off + half, x2);
    load<float, N>(cosv + toff, c);
    load<float, N>(sinv + toff, s);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float sn = INV ? -s[e] : s[e];
      y1[e] = __fsub_rn(__fmul_rn(x1[e], c[e]), __fmul_rn(x2[e], sn));
      y2[e] = __fadd_rn(__fmul_rn(x1[e], sn), __fmul_rn(x2[e], c[e]));
    }
    store<T, N>(y + off, y1);
    store<T, N>(y + off + half, y2);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <typename T, int N, bool INV, typename I>
int launch(const Part<T>& q, const Part<T>& k, const float* cosv,
           const float* sinv, long long trows, int half, cudaStream_t st) {
  const long long units = (q.rows + k.rows) * (half / N);
  const long long want = (units + THREADS - 1) / THREADS;
  // enough blocks to fill every SM several times over; the rest loops
  const long long cap = static_cast<long long>(sm_count()) * 16;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  rope_rotate_kernel<T, N, INV, I><<<blocks, THREADS, 0, st>>>(
      q, k, cosv, sinv, static_cast<I>(trows), half);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N, bool INV>
int launch_i(const Part<T>& q, const Part<T>& k, const float* cosv,
             const float* sinv, long long trows, int half, cudaStream_t st) {
  const long long units = (q.rows + k.rows) * (half / N);
  if (units < (1LL << 31))
    return launch<T, N, INV, unsigned>(q, k, cosv, sinv, trows, half, st);
  return launch<T, N, INV, unsigned long long>(q, k, cosv, sinv, trows, half,
                                               st);
}

template <typename T>
int launch_t(const void* q, void* qo, long long q_rows, int q_heads,
             const void* k, void* ko, long long k_rows, int k_heads,
             const void* cosv, const void* sinv, long long trows, int half,
             int inverse, cudaStream_t st) {
  const Part<T> pq{static_cast<const T*>(q), static_cast<T*>(qo), q_rows,
                   q_heads};
  const Part<T> pk{static_cast<const T*>(k), static_cast<T*>(ko), k_rows,
                   k_rows > 0 ? k_heads : 1};
  const float* c = static_cast<const float*>(cosv);
  const float* s = static_cast<const float*>(sinv);
  bool vec = half % V == 0 && common::aligned16(q) &&
             common::aligned16(qo) && common::aligned16(cosv) &&
             common::aligned16(sinv);
  if (k_rows > 0) vec = vec && common::aligned16(k) && common::aligned16(ko);
  if (vec)
    return inverse ? launch_i<T, V, true>(pq, pk, c, s, trows, half, st)
                   : launch_i<T, V, false>(pq, pk, c, s, trows, half, st);
  return inverse ? launch_i<T, 1, true>(pq, pk, c, s, trows, half, st)
                 : launch_i<T, 1, false>(pq, pk, c, s, trows, half, st);
}

}  // namespace

extern "C" {

const char* rope_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k and their outputs);
// cos and sin float32 (table_rows, half); row r of q (or k) is at position
// (r / heads) % table_rows. k_rows 0: q alone.
int rope_launch(const void* q, void* qo, long long q_rows, int q_heads,
                const void* k, void* ko, long long k_rows, int k_heads,
                const void* cosv, const void* sinv, long long table_rows,
                int half, int dtype, int inverse, void* stream) {
  if (q_rows + k_rows <= 0) return 0;
  if (half <= 0 || table_rows <= 0 || q_heads <= 0 || q_rows < 0 ||
      k_rows < 0 || (k_rows > 0 && k_heads <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, qo, q_rows, q_heads, k, ko, k_rows, k_heads,
                           cosv, sinv, table_rows, half, inverse, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, qo, q_rows, q_heads, k, ko, k_rows,
                                   k_heads, cosv, sinv, table_rows, half,
                                   inverse, st);
  if (dtype == 2)
    return launch_t<__half>(q, qo, q_rows, q_heads, k, ko, k_rows, k_heads,
                            cosv, sinv, table_rows, half, inverse, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
