// Row-wise RMSNorm: y = x * rsqrt(mean(x^2) + eps) * scale, fp32 math,
// output in x's dtype.
//
// Replaces src/repro/kernels/rmsnorm.py::rmsnorm_rows (pallas_call at :33,
// body _rmsnorm_kernel :19).
//
// Bound on the H100: bytes. One read of x and one write of y (the (d,)
// scale stays in L1/L2), about 25.6 MB for the ViT-Tiny residual stream at
// batch 256 (16640 x 192 fp32 rows), so 7.6 us at 3.35 TB/s. The TPU kernel
// normalised a (256, d) VMEM tile per grid step; here one warp owns one
// row: lanes stride the row (coalesced), the sum of squares is reduced with
// warp shuffles, and the second pass re-reads the row from L1. No shared
// memory, no block-wide barrier, eight rows per 256-thread block.
//
// The scale may be grouped: row r uses scale row r / rows_per_scale, so the
// vectorised engine normalises every client's rows with that client's own
// scale in one launch (rows_per_scale = rows for a single (d,) scale).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ y, long long rows, int d, float eps,
                    long long rows_per_scale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const float* sc = scale + (row / rows_per_scale) * d;
  float ss = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f(xr[j]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int j = lane; j < d; j += 32)
    yr[j] = from_f<T>((to_f(xr[j]) * r) * sc[j]);
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
  if (rows_per_scale <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_rows_kernel<float><<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(y), rows, d, eps, rows_per_scale);
  } else if (dtype == 1) {
    rmsnorm_rows_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
        rows, d, eps, rows_per_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
