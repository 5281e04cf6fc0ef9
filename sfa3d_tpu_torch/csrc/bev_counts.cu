// Exact per-cell point counts for the BEV raster's density channel.
//
// Replaces the Pallas TPU kernel sfa3d_tpu/ops/bev_pallas.py:76
// (bev_cell_counts, body _count_kernel at :45). On the TPU the count was
// built as bf16 one-hot matrix products accumulated in VMEM, because the
// TPU has no fast scatter. Hopper has fast integer atomics in L2, so the
// port is a plain histogram: one thread per point, one integer atomicAdd
// into a zeroed (B, H*W) int32 buffer, then a second pass converts the
// counts to float32. Integer atomics make the counts exact whatever order
// the atomics land in.
//
// Bound: the work moves bytes, not operations. At the served shape
// (B=8, N=32768, 608x608) the least the card must move is the indices read
// once (2 * 8 * 32768 * 4 B = 2.1 MB) plus the float counts written once
// (8 * 608 * 608 * 4 B = 11.8 MB), about 4.2 us at 3.35 TB/s. This simple
// version also zeroes, reads back and rewrites the int32 buffer (about
// 35 MB in all); folding those passes away is left to a later change.
//
// Plain C interface, bound with ctypes (sfa3d_tpu_torch/_build.py). The
// wrapper (sfa3d_tpu_torch/ops/bev_counts.py) allocates every buffer,
// checks shapes and types, and raises when the return value is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void count_points_kernel(const int32_t* __restrict__ row,
                                    const int32_t* __restrict__ col,
                                    int32_t* __restrict__ counts,
                                    int64_t total, int64_t n_points,
                                    int32_t height, int32_t width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int32_t r = row[i];
  const int32_t c = col[i];
  // -1 (or any index outside the raster) marks a point that counts nowhere,
  // as in the TPU kernel, whose one-hot compares match no cell for it.
  if (r < 0 || r >= height || c < 0 || c >= width) return;
  const int64_t b = i / n_points;
  atomicAdd(counts + (b * height + r) * width + c, 1);
}

__global__ void counts_to_float_kernel(const int32_t* __restrict__ counts,
                                       float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<float>(counts[i]);
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// row, col: (batch, n_points) int32, contiguous, on the device.
// counts_i32: (batch, height * width) int32, zeroed by the caller.
// counts_f32: (batch, height * width) float32 output.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int bev_cell_counts_cuda(const void* row, const void* col,
                                    void* counts_i32, void* counts_f32,
                                    int64_t batch, int64_t n_points,
                                    int32_t height, int32_t width,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = batch * n_points;
  const int64_t cells = batch * static_cast<int64_t>(height) * width;
  if (total > 0) {
    count_points_kernel<<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const int32_t*>(row), static_cast<const int32_t*>(col),
        static_cast<int32_t*>(counts_i32), total, n_points, height, width);
  }
  if (cells > 0) {
    counts_to_float_kernel<<<blocks_for(cells), kThreads, 0, s>>>(
        static_cast<const int32_t*>(counts_i32),
        static_cast<float*>(counts_f32), cells);
  }
  return static_cast<int>(cudaGetLastError());
}
