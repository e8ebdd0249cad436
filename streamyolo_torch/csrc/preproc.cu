// 0.5x streaming preprocess: 2x2 box average of a [H, W, 3] uint8 frame.
//
// Replaces the TPU kernel streamyolo_tpu/ops/preproc_pallas.py::_kernel
// (entry downsample2x_bilinear). At exactly 0.5 scale cv2 INTER_LINEAR
// samples source coordinate 2i + 0.5, so the resize is the average of the
// 2x2 block.
//
// Two modes, one pass each:
//   raw   (fused = 0): out = (sum of the 4 bytes) * 0.25, the plain
//         version's value (a sum of four bytes is exact in float32, so the
//         result does not depend on the order of the adds);
//   fused (fused = 1): additionally clip(floor(x + 0.5), 0, 255), the
//         rounding cv2 applies when it writes uint8, then the cast to the
//         compute dtype, written NHWC ([H/2, W/2, 3]): the model's input
//         layout (channels_last), so no separate round/cast/layout pass.
//
// Bound on an H100: bytes. At 1200x1920 -> 600x960 bf16 it reads 6.91 MB
// and writes 3.46 MB, about 3.1 us at 3.35 TB/s.
//
// Design: a 2-D grid, output row from blockIdx.y, runs of 8 output pixels
// along x. A thread's run is 16 source pixels, 48 bytes of each of the two
// source rows, read as three 16-byte streaming loads per row (evict-first:
// the raw frame is not read again), and 24 output values written as
// 16-byte stores (three for bf16, six for float32). That keeps ~96 bytes in
// flight per thread, so one wave of the grid covers the whole frame. The
// 16-byte path needs every row on the 16-byte grid: frame and output
// pointers 16-byte aligned (the launcher checks the pointers) and W a
// multiple of 16. Any other frame, such as a view at an odd offset or a
// ragged width, takes the per-pixel path of the same kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 8;  // output pixels per thread
constexpr int kThreads = 128;

__device__ __forceinline__ float box_value(uint32_t sum4, int fused) {
  float v = static_cast<float>(sum4) * 0.25f;
  if (fused) v = fminf(fmaxf(floorf(v + 0.5f), 0.0f), 255.0f);
  return v;
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[12], int b) {
  return (w[b >> 2] >> (8 * (b & 3))) & 0xffu;
}

__device__ __forceinline__ void store_run(float* dst, const float (&v)[3 * kRun]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 3 * kRun / 4; ++q)
    d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float (&v)[3 * kRun]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 3 * kRun / 8; ++q)
    d[q] = make_uint4(pack_bf16x2(v[8 * q], v[8 * q + 1]), pack_bf16x2(v[8 * q + 2], v[8 * q + 3]),
                      pack_bf16x2(v[8 * q + 4], v[8 * q + 5]),
                      pack_bf16x2(v[8 * q + 6], v[8 * q + 7]));
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
downsample2x_kernel(const uint8_t* __restrict__ src, T* __restrict__ dst, int w2, int fused,
                    int vec) {
  const int r = blockIdx.y;
  const int p0 = (blockIdx.x * blockDim.x + threadIdx.x) * kRun;
  if (p0 >= w2) return;
  const size_t row_bytes = static_cast<size_t>(w2) * 6;
  const uint8_t* top = src + 2 * static_cast<size_t>(r) * row_bytes + 6 * static_cast<size_t>(p0);
  const uint8_t* bot = top + row_bytes;
  T* out = dst + (static_cast<size_t>(r) * w2 + p0) * 3;

  if (vec) {  // uniform across the grid: a full run on the 16-byte grid
    uint32_t t[12], b[12];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint4 tv = __ldcs(reinterpret_cast<const uint4*>(top) + q);
      const uint4 bv = __ldcs(reinterpret_cast<const uint4*>(bot) + q);
      t[4 * q] = tv.x, t[4 * q + 1] = tv.y, t[4 * q + 2] = tv.z, t[4 * q + 3] = tv.w;
      b[4 * q] = bv.x, b[4 * q + 1] = bv.y, b[4 * q + 2] = bv.z, b[4 * q + 3] = bv.w;
    }
    float v[3 * kRun];
#pragma unroll
    for (int i = 0; i < 3 * kRun; ++i) {  // output pixel i / 3, channel i % 3
      const int s = 6 * (i / 3) + i % 3;
      v[i] = box_value(byte_at(t, s) + byte_at(t, s + 3) + byte_at(b, s) + byte_at(b, s + 3),
                       fused);
    }
    store_run(out, v);
    return;
  }
  const int n = min(kRun, w2 - p0);
  for (int q = 0; q < n; ++q) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int s = 6 * q + ch;
      out[3 * q + ch] = from_float<T>(box_value(
          static_cast<uint32_t>(top[s]) + top[s + 3] + bot[s] + bot[s + 3], fused));
    }
  }
}

}  // namespace

// out_kind: 0 = float32, 1 = bfloat16.
extern "C" int streamyolo_downsample2x(const void* src, void* dst, int h, int w,
                                       int out_kind, int fused, void* stream) {
  if (h <= 0 || w <= 0 || (h % 2) || (w % 2) || h / 2 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int h2 = h / 2, w2 = w / 2;
  const int vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dst) % 16 == 0 && w % 16 == 0;
  const dim3 grid((w2 + kRun * kThreads - 1) / (kRun * kThreads), h2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  if (out_kind == 0) {
    downsample2x_kernel<float><<<grid, kThreads, 0, s>>>(
        in, static_cast<float*>(dst), w2, fused, vec);
  } else if (out_kind == 1) {
    downsample2x_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(dst), w2, fused, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
