// Row-wise RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 math,
// output in x's dtype.
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm_rows (pallas_call at :33,
// body _rmsnorm_kernel :19).
//
// Bound on the H100: bytes. One read of x and one write of y (the (d,)
// scale stays in L1/L2): 25.6 MB for the ViT-Tiny residual stream at batch
// 256 (16640 x 192 fp32 rows, 7.6 us at 3.35 TB/s), 84 MB for zamba2's
// (4096, 2560) fp32 residual stream (25 us) and 168 MB for its (4096, 5120)
// gated norm (50 us). The TPU kernel normalised a (256, d) VMEM tile per
// grid step. Here a group of TPR threads owns one row and reads it once:
// each thread loads its share with 16-byte vectors (4 fp32 or 8 bf16) into
// registers, the group sums the squares (warp shuffles, then shared memory
// across its warps when TPR > 32), and the same registers are scaled and
// written, so x is read from memory once. TPR follows d: a warp while a
// thread holds at most MAXV vectors of the row (fp32 d <= 1024, the ViT's
// 192), else 128 or 256 threads (fp32 d <= 4096 or 8192: zamba2's 2560 and
// 5120). A row whose start is not 16-byte aligned (d * sizeof(x) not a
// multiple of 16) takes the same kernel with scalar elements; a row longer
// than 256 * MAXV elements or vectors is read twice (sum, then scale).
//
// The scale may be grouped: row r uses scale row r / rows_per_scale, so the
// vectorised engine normalises every client's rows with that client's own
// scale in one launch (rows_per_scale = rows for a single (d,) scale).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXV = 8;  // vectors of a row one thread holds in registers

// VW values of x at p, as fp32 (VW = 16 / sizeof(T): one 16-byte load)
template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = common::to_f(*p);
  } else if constexpr (sizeof(T) == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VW]) {
  if constexpr (VW == 1) {
    *p = common::from_f<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    uint4 u;
    u.x = common::pack_bf16(v[0], v[1]);
    u.y = common::pack_bf16(v[2], v[3]);
    u.z = common::pack_bf16(v[4], v[5]);
    u.w = common::pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// VW fp32 scale values (16-byte loads when VW is a multiple of 4)
template <int VW>
__device__ __forceinline__ void load_scale(const float* p, float (&v)[VW]) {
  if constexpr (VW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VW; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      v[i] = u.x; v[i + 1] = u.y; v[i + 2] = u.z; v[i + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VW; ++i) v[i] = p[i];
  }
}

template <typename T, int VW>
__device__ __forceinline__ void norm_store(T* y, const float* sc,
                                           const float (&v)[VW], float r) {
  float s[VW], out[VW];
  load_scale<VW>(sc, s);
#pragma unroll
  for (int e = 0; e < VW; ++e) out[e] = (v[e] * r) * s[e];
  store_vec<T, VW>(y, out);
}

// one row per TPR threads, THREADS / TPR rows a block; a row is nv
// vectors of VW elements
template <typename T, int VW, int TPR>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ y, long long rows, int d, float eps,
                    long long rows_per_scale) {
  constexpr int WPR = TPR / 32;  // warps per row
  __shared__ float part[THREADS / 32];
  const int t = threadIdx.x % TPR;
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / TPR) +
      threadIdx.x / TPR;
  const bool live = row < rows;  // no early return: TPR > 32 syncs below
  const int nv = d / VW;
  const bool held = nv <= MAXV * TPR;
  const T* xr = x + (live ? row : 0) * d;
  T* yr = y + row * d;

  float v[MAXV][VW];
  float ss = 0.f;
  if (held) {
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      const int i = t + j * TPR;
      if (live && i < nv) {
        load_vec<T, VW>(xr + i * VW, v[j]);
#pragma unroll
        for (int e = 0; e < VW; ++e) ss += v[j][e] * v[j][e];
      }
    }
  } else {
    for (int i = t; live && i < nv; i += TPR) {
      float u[VW];
      load_vec<T, VW>(xr + i * VW, u);
#pragma unroll
      for (int e = 0; e < VW; ++e) ss += u[e] * u[e];
    }
  }
  ss = common::warp_sum(ss);
  if constexpr (WPR > 1) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    const int first = warp - warp % WPR;
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) ss += part[first + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float* sc = scale + (row / rows_per_scale) * d;
  if (held) {
#pragma unroll
    for (int j = 0; j < MAXV; ++j) {
      const int i = t + j * TPR;
      if (i < nv) norm_store<T, VW>(yr + i * VW, sc + i * VW, v[j], r);
    }
  } else {
    for (int i = t; i < nv; i += TPR) {
      float u[VW];
      load_vec<T, VW>(xr + i * VW, u);
      norm_store<T, VW>(yr + i * VW, sc + i * VW, u, r);
    }
  }
}

template <typename T, int VW, int TPR>
int launch(const void* x, const void* scale, void* y, long long rows, int d,
           float eps, long long rows_per_scale, cudaStream_t st) {
  constexpr int RPB = THREADS / TPR;
  const unsigned blocks = static_cast<unsigned>((rows + RPB - 1) / RPB);
  rmsnorm_rows_kernel<T, VW, TPR><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(y), rows, d, eps, rows_per_scale);
  return static_cast<int>(cudaGetLastError());
}

// the thread group for a row of nv vectors: a warp while each thread holds
// at most MAXV of them, else 128 or 256 threads
template <typename T, int VW>
int launch_vw(const void* x, const void* scale, void* y, long long rows,
              int d, float eps, long long rows_per_scale, cudaStream_t st) {
  const int nv = d / VW;
  if (nv <= 32 * MAXV)
    return launch<T, VW, 32>(x, scale, y, rows, d, eps, rows_per_scale, st);
  if (nv <= 128 * MAXV)
    return launch<T, VW, 128>(x, scale, y, rows, d, eps, rows_per_scale, st);
  return launch<T, VW, 256>(x, scale, y, rows, d, eps, rows_per_scale, st);
}

template <typename T>
int launch_t(const void* x, const void* scale, void* y, long long rows,
             int d, float eps, long long rows_per_scale, cudaStream_t st) {
  constexpr int VW = 16 / sizeof(T);
  const bool aligned =
      (static_cast<long long>(d) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(scale) % 16 == 0;
  if (aligned)
    return launch_vw<T, VW>(x, scale, y, rows, d, eps, rows_per_scale, st);
  return launch_vw<T, 1>(x, scale, y, rows, d, eps, rows_per_scale, st);
}

}  // namespace

extern "C" {

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: 0 = float32, 1 = bfloat16 (x and y); scale is always float32,
// (rows / rows_per_scale, d).
int rmsnorm_rows_launch(const void* x, const void* scale, void* y,
                        long long rows, int d, float eps, int dtype,
                        long long rows_per_scale, void* stream) {
  if (rows <= 0) return 0;
  if (rows_per_scale <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(x, scale, y, rows, d, eps, rows_per_scale, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, scale, y, rows, d, eps,
                                   rows_per_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
