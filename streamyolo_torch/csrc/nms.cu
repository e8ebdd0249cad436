// Exact greedy NMS keep mask for score-sorted, class-offset boxes.
//
// Replaces the TPU kernel streamyolo_tpu/ops/nms_pallas.py::_nms_kernel
// (entry nms_padded_pallas), which iterates the suppression fixed point
//   keep = valid & ~any(iou > thr & row < col & keep[:, None], 0)
// over a [K, K] IoU matrix held in VMEM. The greedy result is the unique
// fixed point of that iteration, so both give the same mask.
//
// Design: one block per image (the batch is the grid), two phases in one
// launch, everything in shared memory after one coalesced load.
//   1. Suppression bitmask, all threads at once. Bit j of word
//      mask[i][j / 32] is iou(i, j) > thr for j > i. A warp takes a row,
//      a lane a column of the row's words, and __ballot_sync packs each
//      word. Words wholly on or below the diagonal, and the rows of invalid
//      boxes (never read), are 0 without an IoU. Then one barrier.
//   2. Greedy scan by warp 0, no block barrier. K <= 1024, so the
//      "removed" set is 32 lanes x 32 bits: lane w holds word w. The rows
//      go in chunks of 32: every lane loads its word of the chunk's 32 mask
//      rows into registers; the chunk is resolved inside the word of its
//      owner lane (two dependent ops a row); one __shfl_sync broadcasts the
//      chunk's keep bits; every lane ORs the kept rows' words into its own.
//
// Shared memory: K * (16 + 4 + 1) bytes of boxes, areas and valid flags,
// plus K * ceil(K / 32) * 4 bytes of mask: 9.6 KB at K = 200, 149 KB at
// K = 1024 (above 48 KB only after cudaFuncSetAttribute, set once below).
//
// Bound on an H100: the work is tiny. At K = 200 the kernel reads 3.4 KB
// and writes 200 bytes, and the greedy result needs at most K^2 / 2 IoUs,
// so the byte and operation bounds are far below a microsecond and the
// kernel is bound by latency and by one SM's issue rate: the launch, the
// dependent global load, phase 1's K^2 / 2 IoUs on one SM, and the scan's
// chain of K dependent bit tests (plus one shuffle and 32 shared-memory
// loads per 32 rows). Phase 1 spends all K^2 / 2 IoUs instead of the
// greedy's data-dependent subset to take the K block barriers of a
// row-by-row sweep out of the chain.
//
// Numerics: IoU uses exactly the reference's float32 operations
// (nms_pallas.py:31-40): inter = max(brx - tlx, 0) * max(bry - tly, 0),
// union = (area_i + area_j) - inter, iou = inter / max(union, 1e-12),
// built with -fmad=false so each step rounds as on the CPU. The last step,
// fl(inter / u) > thr, is decided without the divide by an exact test in
// double (see suppresses), so the mask is bit-identical to the plain version.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kWarp = 32;
constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t smem_bytes(int k) {
  return static_cast<size_t>(k) *
         (sizeof(float4) + sizeof(float) + sizeof(uint32_t) * ((k + 31) / 32) + 1);
}

// iou(i, j) > thr with the reference's float32 operations, without the
// divide. q = inter / u rounds to a float above thr exactly when the real
// quotient lies above mid = (thr + next float above thr) / 2, or on it when
// round-to-nearest-even goes up (tie_up). mid has 25 significant bits and u
// 24, so mid * u is exact in double and the test decides exactly as
// fl(inter / u) > thr does.
__device__ __forceinline__ bool suppresses(float4 bi, float ai, float4 bj, float aj,
                                           double mid, bool tie_up) {
  const float tlx = fmaxf(bi.x, bj.x);
  const float tly = fmaxf(bi.y, bj.y);
  const float brx = fminf(bi.z, bj.z);
  const float bry = fminf(bi.w, bj.w);
  const float inter = fmaxf(brx - tlx, 0.0f) * fmaxf(bry - tly, 0.0f);
  const float uni = fmaxf((ai + aj) - inter, 1e-12f);
  const double a = inter, p = mid * static_cast<double>(uni);
  return a > p || (tie_up && a == p && isfinite(inter));
}

__global__ void __launch_bounds__(kThreads)
nms_bitmask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep_out, int k, double mid, int tie_up) {
  extern __shared__ float4 smem[];
  const int words = (k + 31) / 32;
  float4* sbox = smem;
  float* sarea = reinterpret_cast<float*>(sbox + k);
  uint32_t* smask = reinterpret_cast<uint32_t*>(sarea + k);
  uint8_t* svalid = reinterpret_cast<uint8_t*>(smask + static_cast<size_t>(k) * words);

  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 b = boxes[base + j];
    sbox[j] = b;
    sarea[j] = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
    svalid[j] = valid[base + j] != 0;
  }
  __syncthreads();

  // Phase 1: one warp per row at a time, one lane per column of a word.
  const int lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int i = threadIdx.x / kWarp; i < k; i += nwarps) {
    uint32_t* row = smask + i * words;
    const int w0 = svalid[i] ? (i + 1) / kWarp : words;  // first word with a j > i
    for (int w = lane; w < w0; w += kWarp) row[w] = 0;
    if (w0 == words) continue;  // uniform across the warp
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    for (int w = w0; w < words; ++w) {
      const int j = kWarp * w + lane;
      const bool over = j > i && j < k && suppresses(bi, ai, sbox[j], sarea[j], mid, tie_up);
      const uint32_t word = __ballot_sync(kFull, over);
      if (lane == 0) row[w] = word;
    }
  }
  __syncthreads();

  // Phase 2: the greedy scan, warp 0 alone.
  if (threadIdx.x >= kWarp) return;
  uint32_t removed = 0;  // lane w: columns 32w .. 32w + 31 suppressed so far
  for (int c = 0; c < words; ++c) {
    const int row0 = kWarp * c;
    const uint32_t vbits = __ballot_sync(kFull, row0 + lane < k && svalid[row0 + lane]);
    uint32_t m[kWarp];  // this lane's word of the chunk's mask rows
#pragma unroll
    for (int t = 0; t < kWarp; ++t)
      m[t] = (row0 + t < k && lane < words) ? smask[(row0 + t) * words + lane] : 0u;
    // Resolve the chunk in word c, invalid rows removed from the start. Row
    // t's mask only has bits above t, so bit t is final when row t is read
    // and the chunk's keep bits are ~r at the end. Every lane runs the same
    // two dependent ops per row; only the owner lane c's r is used.
    uint32_t r = removed | ~vbits;
#pragma unroll
    for (int t = 0; t < kWarp; ++t)
      if (!((r >> t) & 1u)) r |= m[t];
    const uint32_t kept = ~__shfl_sync(kFull, r, c);
    // every lane ORs the kept rows' words into its own (independent terms:
    // the compiler may reassociate the ORs)
    uint32_t gained = 0;
#pragma unroll
    for (int t = 0; t < kWarp; ++t) gained |= m[t] & (0u - ((kept >> t) & 1u));
    removed |= gained;
    if (row0 + lane < k) keep_out[base + row0 + lane] = (kept >> lane) & 1u;
  }
}

}  // namespace

extern "C" int streamyolo_nms(const void* boxes, const void* valid, void* keep,
                              int batch, int k, float thr, void* stream) {
  if (batch <= 0 || k <= 0 || k > kMaxK || !(fabsf(thr) < FLT_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  // raise the dynamic shared-memory cap to the K = 1024 size, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      nms_bitmask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxK)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float up = nextafterf(thr, INFINITY);
  const double mid = (static_cast<double>(thr) + static_cast<double>(up)) / 2;
  uint32_t up_bits;
  memcpy(&up_bits, &up, sizeof(up_bits));
  const int tie_up = (up_bits & 1u) == 0;  // a tie rounds to the even neighbour
  const int threads = k <= kWarp ? kWarp : kThreads;
  nms_bitmask_kernel<<<batch, threads, smem_bytes(k), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, mid, tie_up);
  return static_cast<int>(cudaGetLastError());
}
