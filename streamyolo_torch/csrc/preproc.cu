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
// Design: one thread per output pixel; neighbouring threads read
// neighbouring 6-byte pairs of the two source rows, so each warp's loads
// are contiguous runs. Bound on an H100: bytes. At 1200x1920 -> 600x960
// bf16 it reads 6.91 MB and writes 3.46 MB, about 3.1 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void downsample2x_kernel(const uint8_t* __restrict__ src,
                                    T* __restrict__ dst, int h2, int w2,
                                    int fused) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h2 * w2) return;
  const int r = idx / w2;
  const int c = idx - r * w2;
  const size_t row_bytes = static_cast<size_t>(w2) * 6;
  const uint8_t* top = src + 2 * static_cast<size_t>(r) * row_bytes + 6 * static_cast<size_t>(c);
  const uint8_t* bot = top + row_bytes;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float v = (static_cast<float>(top[ch]) + static_cast<float>(bot[ch])) +
              (static_cast<float>(top[3 + ch]) + static_cast<float>(bot[3 + ch]));
    v = v * 0.25f;
    if (fused) v = fminf(fmaxf(floorf(v + 0.5f), 0.0f), 255.0f);
    dst[3 * static_cast<size_t>(idx) + ch] = from_float<T>(v);
  }
}

}  // namespace

// out_kind: 0 = float32, 1 = bfloat16.
extern "C" int streamyolo_downsample2x(const void* src, void* dst, int h, int w,
                                       int out_kind, int fused, void* stream) {
  if (h <= 0 || w <= 0 || (h % 2) || (w % 2)) return static_cast<int>(cudaErrorInvalidValue);
  const int h2 = h / 2, w2 = w / 2;
  const int threads = 256;
  const int blocks = (h2 * w2 + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  if (out_kind == 0) {
    downsample2x_kernel<float><<<blocks, threads, 0, s>>>(
        in, static_cast<float*>(dst), h2, w2, fused);
  } else if (out_kind == 1) {
    downsample2x_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(dst), h2, w2, fused);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
