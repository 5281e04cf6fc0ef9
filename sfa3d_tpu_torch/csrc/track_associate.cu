// The 3D tracker's greedy association: one launch per tracker step.
//
// Replaces the lax.fori_loop of sfa3d_tpu/tracking/tracker.py:131-142
// (_associate), which XLA ran on the device (it was not a Pallas kernel).
// The rotated IoU of every (detection, track) pair and its class and
// validity gate stay plain PyTorch outside the loop, as XLA computed them
// outside the loop in JAX; this kernel is the loop.
//
// Semantics, step for step: for i in 0..K-1, d = order[i] (detections by
// descending score) and row = used ? -1 : iou[d]; j = argmax(row), the
// lowest index on ties and NaN above every number (jnp.argmax); the step
// matches d to track j when row[j] >= iou_min (NaN never does), and then
// marks j used. There is no "> 0" condition, unlike the fusion match.
//
// What bounds it on this card: neither bytes nor arithmetic. A served step
// reads one (50, 64) IoU matrix (12.8 KB) and does 3,200 comparisons, but
// its K steps depend on each other through the used flags, so the floor is
// the launch plus a chain of K dependent steps.
//
// Design (simple first): one warp per frame, in a block of its own. The
// warp stages the frame's score order into shared memory and keeps the
// used flags of the T tracks there. A step reads row d with the lanes on
// neighbouring columns (lane l: columns l, l + 32, ...), takes each lane's
// best column under the argmax order above, then the warp's best with a
// butterfly of shuffles (every lane ends with the same pair: the order is
// total, ties broken by index), and lane 0 writes the step's result.
// Shared memory: 4 K + T bytes per frame.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// True when (av, ai) comes before (bv, bi) in jnp.argmax's order: NaN above
// every number, a larger value first, ties (NaN with NaN too) to the lower
// index. -0 and +0 are equal.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av > bv;
  return ai < bi;
}

__global__ void __launch_bounds__(kWarp)
    track_associate_kernel(const float* __restrict__ iou, const int32_t* __restrict__ order,
                           int32_t* __restrict__ det_match, uint8_t* __restrict__ trk_used,
                           int32_t k, int32_t t, float iou_min) {
  extern __shared__ int32_t smem[];
  int32_t* s_order = smem;                                      // k
  uint8_t* s_used = reinterpret_cast<uint8_t*>(smem + k);       // t
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  const float* f_iou = iou + b * k * t;
  const int32_t* f_order = order + b * k;
  int32_t* f_match = det_match + b * k;

  for (int i = lane; i < k; i += kWarp) {
    s_order[i] = f_order[i];
    f_match[i] = -1;  // every slot is written, a permutation or not
  }
  for (int j = lane; j < t; j += kWarp) s_used[j] = 0;
  __syncwarp();

  for (int i = 0; i < k; ++i) {
    const int d = s_order[i];
    const float* row = f_iou + static_cast<int64_t>(d) * t;
    float bv = -__int_as_float(0x7f800000);  // -inf, with an index past every column
    int bi = INT_MAX;
    for (int j = lane; j < t; j += kWarp) {
      const float v = s_used[j] ? -1.0f : row[j];
      if (better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const bool hit = bv >= iou_min;
    if (lane == 0) {
      f_match[d] = hit ? bi : -1;
      if (hit) s_used[bi] = 1;
    }
    __syncwarp();
  }
  uint8_t* f_used = trk_used + b * t;
  for (int j = lane; j < t; j += kWarp) f_used[j] = s_used[j];
}

// Bytes of dynamic shared memory a frame takes: its order and used flags.
size_t track_associate_smem(int32_t k, int32_t t) {
  return 4 * static_cast<size_t>(k) + static_cast<size_t>(t);
}

}  // namespace

// iou (batch, k, t) float32 (-1 where a pair may not match), order (batch,
// k) int32 (a permutation of 0..k-1 per frame) -> det_match (batch, k)
// int32, trk_used (batch, t) bool; all contiguous on `device`; batch >= 1,
// k >= 0, t >= 1, track_associate_smem(k, t) <= 48 KB (the wrapper checks).
extern "C" int track_associate_cuda(const void* iou, const void* order, void* det_match,
                                    void* trk_used, int64_t batch, int32_t k, int32_t t,
                                    float iou_min, int32_t device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  track_associate_kernel<<<static_cast<unsigned int>(batch), kWarp,
                           track_associate_smem(k, t),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const int32_t*>(order),
      static_cast<int32_t*>(det_match), static_cast<uint8_t*>(trk_used), k, t, iou_min);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
