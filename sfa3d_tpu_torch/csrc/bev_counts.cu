// The BEV raster's per-cell reduction and exact per-cell point counts, as one
// shared-memory tile pass.
//
// Replaces the Pallas TPU kernel sfa3d_tpu/ops/bev_pallas.py:76
// (bev_cell_counts, body _count_kernel at :45). On the TPU the count was
// built as bf16 one-hot matrix products accumulated in VMEM, because the TPU
// has no fast scatter. Hopper has fast integer atomics in shared memory, so
// here one block owns a band of `tile_rows` rows of one frame and keeps the
// band's accumulators on chip: an int32 count per cell and, for the raster,
// an int32 max packed key per cell (-1 = empty). The block walks over all the
// frame's points, reading `row` with 16-byte loads and `col` and `key` only
// for the points in its band, updates its cells with shared-memory atomics,
// and then writes the finished band once. Integer add and max do not depend
// on the order the atomics land in, so the output is exact and the same in
// every run. A cell hit by many points serialises its atomics on one
// shared-memory address; merging the lanes of a warp that hit one cell first
// (match + reduce) cost more than it saved, even for a cell hit 10,000 times.
//
// Three modes of the one kernel:
//   raster (bev_raster_reduce_cuda): (B, N) row, col, key -> (B, 3, H, W)
//     float32, channels first: intensity, height, density. It replaces the
//     scatter_reduce amax, the count and the epilogue chain of PyTorch ops.
//   counts (bev_cell_counts_cuda): (B, N) row, col -> (B, H, W) float32
//     exact counts, what the TPU kernel computes.
//   argoverse (argoverse_raster_reduce_cuda): (B, N) int32 row, col and
//     float32 z, r -> (B, 3, H, W) float32 [count, max(z, 0), max(r, 0)] per
//     cell, unnormalised: the per-cell reductions of the Argoverse raster
//     (sfa3d_tpu/ops/bev.py::argoverse_points_to_bev, whose count is the TPU
//     kernel's work at 1000 x 1000 cells). The band keeps 12 B a cell: the
//     count and two int32 maxima of the bits of max(v, 0). Every such value
//     is a non-negative float (-0, NaN and negatives become +0), and for
//     those the int order of the bits is the float order, so atomicMax on
//     the bits gives the exact float maximum in any order. The maxima start
//     at the bits of +0.0, so an empty cell reads 0 in all three channels.
//     At the training shape (16, 131072) -> 1000 x 1000 the bound is bytes:
//     16 B a point read (33.5 MB) and 12 B a cell written (192 MB), 67 us at
//     3.35 TB/s. This first design is the KITTI raster's tile plan unchanged:
//     about 19 rows a band, so each band's block scans its frame's whole
//     `row` (53 scans of 0.5 MB a frame, from L2); bucketing the points by
//     band first is the queued redesign.
//
// Bound: bytes. At the served shape (B=8, N=32768, 608x608) the raster must
// read the indices and keys once (3 * 8 * 32768 * 4 B = 3.1 MB) and write the
// raster once (8 * 3 * 608 * 608 * 4 B = 35.5 MB): 11.5 us at 3.35 TB/s. The
// counts read 2.1 MB and write 11.8 MB: 4.2 us. The design moves just that
// to and from device memory: no int32 buffer to zero, read back and convert,
// and no intermediate per channel. Each block re-reads its frame's `row`
// (1 MB for the batch) from L2. Beyond the bound the design spends that scan
// and the shared-memory pass that empties the band and reads it back; the
// three phases of a block run one after the other. The band is written with
// streaming stores: the next stage reads the raster once, and it should not
// push the inputs out of L2.
//
// The epilogue repeats the plain version's float32 arithmetic step by step:
// multiplications by the float32 reciprocals the wrapper passes in, with
// __fmul_rn / __fadd_rn so that nothing contracts to a fused multiply-add,
// and logf (not __logf: the build does not use --use_fast_math).
//
// Plain C interface, bound with ctypes (sfa3d_tpu_torch/_build.py). The
// wrapper (sfa3d_tpu_torch/ops/bev_counts.py) plans the bands, allocates the
// output, checks shapes and types, and raises when the return value is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;             // 16-byte row loads per thread per step
constexpr int kPer = 4 * kUnroll;      // points per thread per step
constexpr int kStep = kUnroll * kThreads;  // 16-byte row loads per block per step

struct Epilogue {
  float inv_4095;   // float32(1 / 4095)
  float inv_8191;   // float32(1 / 8191)
  float inv_log64;  // float32(1 / ln 64)
};

__host__ __device__ inline int64_t pad4(int64_t n) { return (n + 3) & ~int64_t{3}; }

enum class Mode { kCounts, kRaster, kArgoverse };

// int32 planes a band keeps in shared memory: the count, then the max key
// (raster) or the two maxima (argoverse)
__host__ __device__ constexpr int planes(Mode m) {
  return m == Mode::kCounts ? 1 : m == Mode::kRaster ? 2 : 3;
}

// The bits of max(v, 0) as an int32 >= 0: -0, NaN and negatives give the
// bits of +0.0, and the int order of the result is its float order.
__device__ __forceinline__ int32_t floored_bits(float v) {
  return __float_as_int(v > 0.0f ? v : 0.0f);
}

// The frame's per-point inputs past row and col: the packed key (raster),
// or z and r (argoverse).
struct Frame {
  const int32_t* key;
  const float* z;
  const float* r;
};

// What one in-band point adds besides its count: its key (raster) or the
// floored bits of z and r (argoverse).
struct Payload {
  int32_t a, b;
};

template <Mode M>
__device__ __forceinline__ Payload load_payload(int64_t i, const Frame& f) {
  if (M == Mode::kRaster) return {__ldg(f.key + i), 0};
  if (M == Mode::kArgoverse) return {floored_bits(__ldg(f.z + i)), floored_bits(__ldg(f.r + i))};
  return {0, 0};
}

// Adds one point to cell (lr, c) of the band, where lr = row - r0 (wrapped
// above `rows` for a row before the band). A point outside the band or the
// raster's columns (-1 marks a dropped point) counts nowhere, as in the TPU
// kernel. p1 and p2 are the band's second and third planes.
template <Mode M>
__device__ __forceinline__ void add_point(uint32_t lr, uint32_t rows, int32_t c, Payload v,
                                          int32_t width, int32_t* cnt, int32_t* p1,
                                          int32_t* p2) {
  if (lr >= rows || c < 0 || c >= width) return;
  const int32_t cell = static_cast<int32_t>(lr) * width + c;
  atomicAdd(cnt + cell, 1);
  if (M != Mode::kCounts && v.a > p1[cell]) atomicMax(p1 + cell, v.a);
  if (M == Mode::kArgoverse && v.b > p2[cell]) atomicMax(p2 + cell, v.b);
}

// One point read with scalar loads (the few before the first 16-byte
// boundary of `row`, and the tail).
template <Mode M>
__device__ __forceinline__ void add_point_at(int64_t i, const int32_t* __restrict__ frow,
                                             const int32_t* __restrict__ fcol, const Frame& f,
                                             uint32_t r0, uint32_t rows, int32_t width,
                                             int32_t* cnt, int32_t* p1, int32_t* p2) {
  const uint32_t lr = static_cast<uint32_t>(__ldg(frow + i)) - r0;
  const bool in = lr < rows;
  const int32_t c = in ? __ldg(fcol + i) : -1;
  const Payload v = in ? load_payload<M>(i, f) : Payload{0, 0};
  add_point<M>(lr, rows, c, v, width, cnt, p1, p2);
}

__device__ __forceinline__ void load_rows(int4 (&r4)[kUnroll], const int4* __restrict__ vrow,
                                          int64_t v0, int64_t n_vec) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t v = v0 + static_cast<int64_t>(u) * kThreads;
    r4[u] = v < n_vec ? __ldg(vrow + v) : make_int4(-1, -1, -1, -1);
  }
}

__device__ __forceinline__ float intensity_of(int32_t k, const Epilogue& ep) {
  return k >= 0 ? __fmul_rn(static_cast<float>(k & 4095), ep.inv_4095) : 0.0f;
}

__device__ __forceinline__ float height_of(int32_t k, const Epilogue& ep) {
  return k >= 0 ? __fmul_rn(static_cast<float>(k >> 12), ep.inv_8191) : 0.0f;
}

__device__ __forceinline__ float density_of(int32_t n, const Epilogue& ep) {
  const float c = static_cast<float>(min(n, 63));
  return fminf(__fmul_rn(logf(__fadd_rn(c, 1.0f)), ep.inv_log64), 1.0f);
}

// grid (n_tiles, batch): block (t, b) owns rows [t * tile_rows, ...) of
// frame b. Dynamic shared memory: planes(M) arrays of pad4(tile_rows *
// width) int32, the counts first.
template <Mode M>
__global__ void __launch_bounds__(kThreads)
bev_tile_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col, Frame in,
                float* __restrict__ out, int64_t n_points, int32_t height, int32_t width,
                int32_t tile_rows, Epilogue ep) {
  extern __shared__ int4 smem[];
  const int64_t plane_cells = pad4(static_cast<int64_t>(tile_rows) * width);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem);
  int32_t* p1 = cnt + plane_cells;  // max key (raster), max z bits (argoverse)
  int32_t* p2 = p1 + plane_cells;   // max r bits (argoverse)
  int4* cnt4 = reinterpret_cast<int4*>(cnt);
  int4* p14 = reinterpret_cast<int4*>(p1);
  int4* p24 = reinterpret_cast<int4*>(p2);

  const int64_t b = blockIdx.y;
  const int32_t r0 = static_cast<int32_t>(blockIdx.x) * tile_rows;
  const int32_t rows = min(tile_rows, height - r0);
  const int32_t cells = rows * width;
  const int32_t cells4 = static_cast<int32_t>(pad4(cells) / 4);

  // the frame's points: the few before the first 16-byte boundary of
  // `row`, then four per 16-byte load (kPer per thread per step), then the
  // tail. The first step's rows are in flight while the band is emptied.
  const int64_t base = b * n_points;
  const int32_t* frow = row + base;
  const int32_t* fcol = col + base;
  const Frame f{M == Mode::kRaster ? in.key + base : nullptr,
                M == Mode::kArgoverse ? in.z + base : nullptr,
                M == Mode::kArgoverse ? in.r + base : nullptr};
  const uint32_t ur0 = static_cast<uint32_t>(r0);
  const uint32_t urows = static_cast<uint32_t>(rows);
  int64_t head = static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(frow) & 15)) & 15) / 4;
  if (head > n_points) head = n_points;
  const int64_t n_vec = (n_points - head) / 4;
  const int4* vrow = reinterpret_cast<const int4*>(frow + head);
  int4 r4[kUnroll];
  load_rows(r4, vrow, threadIdx.x, n_vec);

  // 1. empty band: counts 0, max keys -1, maxima +0.0
  for (int32_t q = threadIdx.x; q < cells4; q += kThreads) {
    cnt4[q] = make_int4(0, 0, 0, 0);
    if (M == Mode::kRaster) p14[q] = make_int4(-1, -1, -1, -1);
    if (M == Mode::kArgoverse) {
      p14[q] = make_int4(0, 0, 0, 0);
      p24[q] = make_int4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  // 2. accumulate
  for (int64_t i = threadIdx.x; i < head; i += kThreads) {
    add_point_at<M>(i, frow, fcol, f, ur0, urows, width, cnt, p1, p2);
  }
  for (int64_t v0 = threadIdx.x; v0 < n_vec; v0 += kStep) {
    // the columns and payloads of this step's in-band points, all loads
    // issued before the first is used
    uint32_t lr[kPer];
    int32_t c[kPer];
    Payload pay[kPer];
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int4 r = r4[s / 4];
      const int32_t rs = s % 4 == 0 ? r.x : s % 4 == 1 ? r.y : s % 4 == 2 ? r.z : r.w;
      const int64_t i = head + 4 * (v0 + static_cast<int64_t>(s / 4) * kThreads) + s % 4;
      lr[s] = static_cast<uint32_t>(rs) - ur0;
      c[s] = lr[s] < urows ? __ldg(fcol + i) : -1;
      pay[s] = lr[s] < urows ? load_payload<M>(i, f) : Payload{0, 0};
    }
    load_rows(r4, vrow, v0 + kStep, n_vec);  // the next step's rows
#pragma unroll
    for (int s = 0; s < kPer; ++s) add_point<M>(lr[s], urows, c[s], pay[s], width, cnt, p1, p2);
  }
  for (int64_t i = head + 4 * n_vec + threadIdx.x; i < n_points; i += kThreads) {
    add_point_at<M>(i, frow, fcol, f, ur0, urows, width, cnt, p1, p2);
  }
  __syncthreads();

  // 3. write the finished band once: 16-byte streaming stores where every
  // band starts on a 16-byte boundary (width % 4 == 0), else one float at a
  // time
  const int64_t plane = static_cast<int64_t>(height) * width;
  const bool vec = (width & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (M == Mode::kRaster) {
    float* o0 = out + (b * 3 * height + r0) * static_cast<int64_t>(width);
    float* o1 = o0 + plane;
    float* o2 = o1 + plane;
    if (vec) {
      for (int32_t q = threadIdx.x; q < cells / 4; q += kThreads) {
        const int4 k = p14[q];
        const int4 n = cnt4[q];
        __stcs(reinterpret_cast<float4*>(o0) + q,
               make_float4(intensity_of(k.x, ep), intensity_of(k.y, ep), intensity_of(k.z, ep),
                           intensity_of(k.w, ep)));
        __stcs(reinterpret_cast<float4*>(o1) + q,
               make_float4(height_of(k.x, ep), height_of(k.y, ep), height_of(k.z, ep),
                           height_of(k.w, ep)));
        __stcs(reinterpret_cast<float4*>(o2) + q,
               make_float4(density_of(n.x, ep), density_of(n.y, ep), density_of(n.z, ep),
                           density_of(n.w, ep)));
      }
    } else {
      for (int32_t i = threadIdx.x; i < cells; i += kThreads) {
        o0[i] = intensity_of(p1[i], ep);
        o1[i] = height_of(p1[i], ep);
        o2[i] = density_of(cnt[i], ep);
      }
    }
  } else if (M == Mode::kArgoverse) {
    float* o0 = out + (b * 3 * height + r0) * static_cast<int64_t>(width);
    float* o1 = o0 + plane;
    float* o2 = o1 + plane;
    if (vec) {
      for (int32_t q = threadIdx.x; q < cells / 4; q += kThreads) {
        const int4 n = cnt4[q];
        const int4 zq = p14[q];
        const int4 rq = p24[q];
        __stcs(reinterpret_cast<float4*>(o0) + q,
               make_float4(static_cast<float>(n.x), static_cast<float>(n.y),
                           static_cast<float>(n.z), static_cast<float>(n.w)));
        __stcs(reinterpret_cast<float4*>(o1) + q,
               make_float4(__int_as_float(zq.x), __int_as_float(zq.y), __int_as_float(zq.z),
                           __int_as_float(zq.w)));
        __stcs(reinterpret_cast<float4*>(o2) + q,
               make_float4(__int_as_float(rq.x), __int_as_float(rq.y), __int_as_float(rq.z),
                           __int_as_float(rq.w)));
      }
    } else {
      for (int32_t i = threadIdx.x; i < cells; i += kThreads) {
        o0[i] = static_cast<float>(cnt[i]);
        o1[i] = __int_as_float(p1[i]);
        o2[i] = __int_as_float(p2[i]);
      }
    }
  } else {
    float* o = out + (b * height + r0) * static_cast<int64_t>(width);
    if (vec) {
      for (int32_t q = threadIdx.x; q < cells / 4; q += kThreads) {
        const int4 n = cnt4[q];
        __stcs(reinterpret_cast<float4*>(o) + q,
               make_float4(static_cast<float>(n.x), static_cast<float>(n.y),
                           static_cast<float>(n.z), static_cast<float>(n.w)));
      }
    } else {
      for (int32_t i = threadIdx.x; i < cells; i += kThreads) o[i] = static_cast<float>(cnt[i]);
    }
  }
}

// Launches on `stream`, which belongs to `device`; the caller's current
// device is restored afterwards. Returns the first CUDA error (0 on success).
template <Mode M>
int launch(const void* row, const void* col, Frame in, void* out, int64_t batch,
           int64_t n_points, int32_t height, int32_t width, int32_t tile_rows, int32_t n_tiles,
           Epilogue ep, int32_t device, void* stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(pad4(static_cast<int64_t>(tile_rows) * width)) *
                      4 * planes(M);
  err = cudaFuncSetAttribute(bev_tile_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && batch > 0 && n_tiles > 0) {
    const dim3 grid(static_cast<unsigned int>(n_tiles), static_cast<unsigned int>(batch));
    bev_tile_kernel<M><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(row), static_cast<const int32_t*>(col), in,
        static_cast<float*>(out), n_points, height, width, tile_rows, ep);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

// The most dynamic shared memory one block may opt in to on `device`.
extern "C" int bev_smem_limit(int32_t device, int32_t* bytes) {
  int v = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = v;
  return static_cast<int>(err);
}

// row, col, key: (batch, n_points) int32, contiguous, on `device`.
// out: (batch, 3, height, width) float32; every element is written.
// tile_rows * n_tiles >= height, and pad4(tile_rows * width) * 8 bytes fit
// in the block's shared memory (the wrapper's tile_plan).
extern "C" int bev_raster_reduce_cuda(const void* row, const void* col, const void* key,
                                      void* out, int64_t batch, int64_t n_points, int32_t height,
                                      int32_t width, int32_t tile_rows, int32_t n_tiles,
                                      float inv_4095, float inv_8191, float inv_log64,
                                      int32_t device, void* stream) {
  return launch<Mode::kRaster>(row, col,
                               Frame{static_cast<const int32_t*>(key), nullptr, nullptr}, out,
                               batch, n_points, height, width, tile_rows, n_tiles,
                               Epilogue{inv_4095, inv_8191, inv_log64}, device, stream);
}

// row, col: (batch, n_points) int32, contiguous, on `device`.
// out: (batch, height, width) float32; every element is written.
// As above with pad4(tile_rows * width) * 4 bytes of shared memory.
extern "C" int bev_cell_counts_cuda(const void* row, const void* col, void* out, int64_t batch,
                                    int64_t n_points, int32_t height, int32_t width,
                                    int32_t tile_rows, int32_t n_tiles, int32_t device,
                                    void* stream) {
  return launch<Mode::kCounts>(row, col, Frame{nullptr, nullptr, nullptr}, out, batch, n_points,
                               height, width, tile_rows, n_tiles, Epilogue{0.0f, 0.0f, 0.0f},
                               device, stream);
}

// row, col: (batch, n_points) int32; z, r: (batch, n_points) float32; all
// contiguous, on `device`. out: (batch, 3, height, width) float32 [count,
// max(z, 0), max(r, 0)]; every element is written. As above with
// pad4(tile_rows * width) * 12 bytes of shared memory.
extern "C" int argoverse_raster_reduce_cuda(const void* row, const void* col, const void* z,
                                            const void* r, void* out, int64_t batch,
                                            int64_t n_points, int32_t height, int32_t width,
                                            int32_t tile_rows, int32_t n_tiles, int32_t device,
                                            void* stream) {
  return launch<Mode::kArgoverse>(
      row, col,
      Frame{nullptr, static_cast<const float*>(z), static_cast<const float*>(r)}, out, batch,
      n_points, height, width, tile_rows, n_tiles, Epilogue{0.0f, 0.0f, 0.0f}, device, stream);
}
