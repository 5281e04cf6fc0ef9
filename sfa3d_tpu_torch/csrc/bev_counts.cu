// The BEV raster's per-cell reduction and exact per-cell point counts, on
// shared-memory integer atomics.
//
// Replaces the Pallas TPU kernel sfa3d_tpu/ops/bev_pallas.py:76
// (bev_cell_counts, body _count_kernel at :45). On the TPU the count was
// built as bf16 one-hot matrix products accumulated in VMEM, because the TPU
// has no fast scatter. Hopper has fast integer atomics in shared memory, so
// here a block owns a band of rows of one frame and keeps the band's
// accumulators on chip: an int32 count per cell and, for the rasters, int32
// maxima per cell. It updates its cells with shared-memory atomics and then
// writes the finished band once. Integer add and max do not depend on the
// order the atomics land in, so the output is exact and the same in every
// run. A cell hit by many points serialises its atomics on one shared-memory
// address; merging the lanes of a warp that hit one cell first (match +
// reduce) cost more than it saved, even for a cell hit 10,000 times.
//
// Three entries:
//   raster (bev_raster_reduce_cuda): (B, N) row, col, key -> (B, 3, H, W)
//     float32, channels first: intensity, height, density. It replaces the
//     scatter_reduce amax, the count and the epilogue chain of PyTorch ops.
//   counts (bev_cell_counts_cuda): (B, N) row, col -> (B, H, W) float32
//     exact counts, what the TPU kernel computes.
//   argoverse (argoverse_raster_reduce_cuda, three kernels a call): (B, N)
//     int32 row, col and float32 z, r -> (B, 3, H, W)
//     float32 [count, max(z, 0), max(r, 0)] per cell, unnormalised: the
//     per-cell reductions of the Argoverse raster
//     (sfa3d_tpu/ops/bev.py::argoverse_points_to_bev, whose count is the TPU
//     kernel's work at 1000 x 1000 cells). A band keeps 12 B a cell: the
//     count and two int32 maxima of the bits of max(v, 0). Every such value
//     is a non-negative float (-0, NaN and negatives become +0), and for
//     those the int order of the bits is the float order, so atomicMax on
//     the bits gives the exact float maximum in any order. The maxima start
//     at the bits of +0.0, so an empty cell reads 0 in all three channels.
//
// The raster and the counts: one tile pass (bev_tile_kernel). Block (t, b)
// owns band t of frame b, walks over all the frame's points, reading `row`
// with 16-byte loads and `col` and `key` only for the points in its band,
// and writes its band once. Bound: bytes. At the served shape (B=8,
// N=32768, 608x608) the raster must read the indices and keys once (3 * 8 *
// 32768 * 4 B = 3.1 MB) and write the raster once (8 * 3 * 608 * 608 * 4 B =
// 35.5 MB): 11.5 us at 3.35 TB/s. The counts read 2.1 MB and write 11.8 MB:
// 4.2 us. Each block re-reads its frame's `row` (1 MB for the batch) from
// L2; beyond the bound the design spends that scan and the shared-memory
// pass that empties the band and reads it back.
//
// The Argoverse raster: points bucketed by band first (a counting sort),
// so that each band's block reads only its own points. At 1000 x 1000 and
// 131072 points a sweep the tile pass above would give a sweep 53 bands of
// 19 rows, each band's block rescanning the sweep's whole `row` (434 MB of
// L2 reads for 33.5 MB of input at B = 16), one block an SM. Instead:
//   1. histogram: a block per chunk of a frame's points counts the points
//      whose row lies in the raster, per band, in shared memory, and adds
//      its counts to the frame's band totals with one global atomic per
//      (block, band). The atomic's old value is where the chunk's run
//      starts within the band's bucket; the block writes it and its counts
//      to two (B, chunks, n_bands) tables.
//   2. scatter: a block per chunk takes the exclusive prefix of its
//      frame's band totals (the start of each band's bucket; the first
//      chunk's block writes them for the reduce) and of its own counts
//      (each band's run in staging) while its first points load, stages one
//      record per point, grouped by band, in shared memory, and writes the
//      runs out contiguously. A record is 12 B, structure of arrays: the
//      cell within the band (-1 for a column outside the raster), the
//      floored bits of z and of r. Records, not point indices: an index
//      would make the reduce gather col, z and r at random, a 32-byte
//      sector a field.
//   3. reduce: a block per (band, frame) empties its band in shared memory
//      while its first records load, reads only its bucket's records,
//      contiguously, applies the integer atomics, and writes the band once
//      with 16-byte streaming stores.
// The order of the runs within a bucket, and of the records within a run,
// changes from run to run (the histogram's and the staging atomics); the
// output does not. The plan (ops/bev_counts.py::argoverse_band_plan) gives
// a band 9 rows at 1000 columns (108 KB), so two reduce blocks share an SM
// and one's write overlaps another's empty and accumulate phases, and a
// chunk 1024-4096 points, as few as still give the histogram and scatter
// grids two blocks for each SM. Every distribution is handled: no bucket
// has a fixed capacity (every point of a frame in one band gives one
// reduce block all of them).
// Bound: bytes, 16 B a point read and 12 B a cell written: 14.0 MB (4.2 us
// at 3.35 TB/s) at (1, 131072), 225.6 MB (67 us) at (16, 131072), 902 MB
// (0.269 ms) at (64, 131072). Beyond that the design moves a second read of
// `row` (4 B a point), the records, written and read back (24 B an
// in-raster point), and its tables, written and read once (8 B an entry of
// argoverse_scratch_len's tables): about 28 B a point, 20% of the bound at
// B = 16 with about 94k of 131072 points in the raster. The reduce's writes
// are most of the time; the histogram and scatter, whose steps wait on one
// another inside a block, the rest (PERF.md). Loads are 4-byte and
// coalesced: a warp reads 128 contiguous bytes a load, so no alignment of
// the frames matters.
// The tile pass for this raster (argoverse_raster_reduce_tile_cuda) is kept
// only to be compared with; no wrapper calls it.
//
// Every band is written with streaming stores: the next stage reads the
// raster once, and it should not push the inputs out of L2. Above 48 KB of
// dynamic shared memory a kernel needs the opt-in attribute: it is set once
// per device and kernel, to the card's limit, never on every launch
// (allow_smem below).
//
// The epilogue repeats the plain version's float32 arithmetic step by step:
// multiplications by the float32 reciprocals the wrapper passes in, with
// __fmul_rn / __fadd_rn so that nothing contracts to a fused multiply-add,
// and logf (not __logf: the build does not use --use_fast_math).
//
// Plain C interface, bound with ctypes (sfa3d_tpu_torch/_build.py). The
// wrapper (sfa3d_tpu_torch/ops/bev_counts.py) plans the bands, allocates the
// output and the scratch, checks shapes and types, and raises when a return
// value is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#ifndef ARGOVERSE_REDUCE_THREADS
#define ARGOVERSE_REDUCE_THREADS 512
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 2;             // 16-byte row loads per thread per step
constexpr int kPer = 4 * kUnroll;      // points per thread per step
constexpr int kStep = kUnroll * kThreads;  // 16-byte row loads per block per step

// The Argoverse kernels: histogram and scatter blocks of kSortThreads, each
// histogram thread loading kHistPer points before it uses them (a chunk of
// 4096 points in one round of loads), each scatter thread kScatterPer
// points a round with the next round in flight; reduce blocks of
// kReduceThreads, kReducePer records a thread a round, likewise.
constexpr int kSortThreads = 256;
constexpr int kHistPer = 16;
constexpr int kScatterPer = 4;
constexpr int kReduceThreads = ARGOVERSE_REDUCE_THREADS;
constexpr int kReducePer = 4;
constexpr int kWarps = 32;  // the scan scratch: one int32 per warp of a block
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

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

// Writes a finished Argoverse band, rows [r0, r0 + cells / width) of frame
// b, from its three shared-memory planes to out (B, 3, H, W): 16-byte
// streaming stores where every band starts on a 16-byte boundary (width %
// 4 == 0), else one float at a time. Each plane is pad4(cells) long.
__device__ __forceinline__ void write_argoverse_band(const int32_t* cnt, const int32_t* p1,
                                                     const int32_t* p2, float* __restrict__ out,
                                                     int64_t b, int32_t r0, int32_t cells,
                                                     int32_t height, int32_t width) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  float* o0 = out + (b * 3 * height + r0) * static_cast<int64_t>(width);
  float* o1 = o0 + plane;
  float* o2 = o1 + plane;
  if ((width & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int4* cnt4 = reinterpret_cast<const int4*>(cnt);
    const int4* p14 = reinterpret_cast<const int4*>(p1);
    const int4* p24 = reinterpret_cast<const int4*>(p2);
    for (int32_t q = threadIdx.x; q < cells / 4; q += blockDim.x) {
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
    for (int32_t i = threadIdx.x; i < cells; i += blockDim.x) {
      o0[i] = static_cast<float>(cnt[i]);
      o1[i] = __int_as_float(p1[i]);
      o2[i] = __int_as_float(p2[i]);
    }
  }
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
    write_argoverse_band(cnt, p1, p2, out, b, r0, cells, height, width);
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

// ---------------------------------------------------------------------------
// The Argoverse raster: histogram, scatter, reduce
// ---------------------------------------------------------------------------

// The band of a row, or -1 for a row outside [0, height) (-1 marks a
// dropped point). The unsigned compare keeps negative rows out.
__device__ __forceinline__ int32_t band_of(int32_t row, int32_t height, int32_t band_rows) {
  return static_cast<uint32_t>(row) < static_cast<uint32_t>(height) ? row / band_rows : -1;
}

// The exclusive prefix of v over the block's threads, in thread order.
// Every thread of the block calls it; warp[kWarps] is shared scratch.
__device__ int32_t block_exclusive(int32_t v, int32_t* warp) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp[w] = incl;
  __syncthreads();
  int32_t before = 0;
  for (int i = 0; i < w; ++i) before += warp[i];
  __syncthreads();  // warp[] may be written again
  return before + incl - v;
}

// dst[k] = in[0] + ... + in[k - 1] for k < n, any n: each thread sums a run
// of consecutive entries, the block scans the runs. Every thread calls it;
// in and dst do not overlap.
__device__ void exclusive_scan(const int32_t* in, int32_t* dst, int32_t n, int32_t* warp) {
  const int32_t per = (n + static_cast<int32_t>(blockDim.x) - 1) / static_cast<int32_t>(blockDim.x);
  const int32_t lo = min(n, static_cast<int32_t>(threadIdx.x) * per);
  const int32_t hi = min(n, lo + per);
  int32_t s = 0;
  for (int32_t k = lo; k < hi; ++k) s += in[k];
  int32_t run = block_exclusive(s, warp);
  for (int32_t k = lo; k < hi; ++k) {
    const int32_t v = in[k];
    dst[k] = run;
    run += v;
  }
}

// grid (chunks, batch): block (c, b) counts the points [c * chunk, (c + 1) *
// chunk) of frame b whose row lies in the raster, per band, and adds the
// counts to totals[b] (n_bands int32, zeroed by the caller). Each add's old
// value is where the chunk's run starts within the band's bucket: it goes
// to offsets[b][c], the counts to counts[b][c] (n_bands int32 each).
// Dynamic shared memory: n_bands int32.
__global__ void __launch_bounds__(kSortThreads)
argoverse_band_histogram_kernel(const int32_t* __restrict__ row, int32_t* __restrict__ totals,
                                int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
                                int64_t n_points, int32_t height, int32_t band_rows,
                                int32_t n_bands, int32_t chunk) {
  extern __shared__ int32_t local[];
  const int64_t b = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t p1 = p0 + chunk < n_points ? p0 + chunk : n_points;
  const int32_t* frow = row + b * n_points;
  for (int32_t k = threadIdx.x; k < n_bands; k += kSortThreads) local[k] = 0;
  __syncthreads();
  for (int64_t i0 = p0 + threadIdx.x; i0 < p1; i0 += kHistPer * kSortThreads) {
    int32_t rw[kHistPer];
#pragma unroll
    for (int u = 0; u < kHistPer; ++u) {
      const int64_t i = i0 + u * kSortThreads;
      rw[u] = i < p1 ? __ldg(frow + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kHistPer; ++u) {
      const int32_t k = band_of(rw[u], height, band_rows);
      if (k >= 0) atomicAdd(local + k, 1);
    }
  }
  __syncthreads();
  int32_t* ftotals = totals + b * n_bands;
  const int64_t at = (b * gridDim.x + blockIdx.x) * n_bands;
  for (int32_t k = threadIdx.x; k < n_bands; k += kSortThreads) {
    const int32_t v = local[k];
    counts[at + k] = v;
    offsets[at + k] = v != 0 ? atomicAdd(ftotals + k, v) : 0;
  }
}

// One round of a scatter thread's points: kScatterPer points kSortThreads
// apart, from i0; -1 rows past p1.
struct ScatterRound {
  int32_t row[kScatterPer], col[kScatterPer];
  float z[kScatterPer], r[kScatterPer];
};

__device__ __forceinline__ void load_round(ScatterRound& q, const int32_t* __restrict__ row,
                                           const int32_t* __restrict__ col,
                                           const float* __restrict__ z,
                                           const float* __restrict__ r, int64_t i0, int64_t p1) {
#pragma unroll
  for (int u = 0; u < kScatterPer; ++u) {
    const int64_t i = i0 + u * kSortThreads;
    const bool ok = i < p1;
    q.row[u] = ok ? __ldg(row + i) : -1;
    q.col[u] = ok ? __ldg(col + i) : -1;
    q.z[u] = ok ? __ldg(z + i) : 0.0f;
    q.r[u] = ok ? __ldg(r + i) : 0.0f;
  }
}

// grid (chunks, batch): block (c, b) writes one record for each point of its
// chunk whose row lies in the raster into band k's bucket of frame b, which
// starts at totals[b][0] + ... + totals[b][k - 1] in the frame's records
// (block 0 of each frame writes these starts to starts[b]); the chunk's run
// starts offsets[b][c][k] into it and holds counts[b][c][k] records (the
// histogram's tables). records: (3, batch, n_points) int32, the planes
// cell, z bits, r bits. Dynamic shared memory: 3 * n_bands + 4 * chunk
// int32.
__global__ void __launch_bounds__(kSortThreads)
argoverse_band_scatter_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                              const float* __restrict__ z, const float* __restrict__ r,
                              const int32_t* __restrict__ totals, int32_t* __restrict__ starts,
                              const int32_t* __restrict__ counts,
                              const int32_t* __restrict__ offsets, int32_t* __restrict__ records,
                              int64_t batch, int64_t n_points, int32_t height, int32_t width,
                              int32_t band_rows, int32_t n_bands, int32_t chunk) {
  extern __shared__ int32_t sm[];
  __shared__ int32_t warp[kWarps];
  int32_t* base = sm;                   // where the chunk's run of each band starts in the frame's records
  int32_t* lstart = base + n_bands;     // where each band's run starts in the staging arrays
  int32_t* lnext = lstart + n_bands;    // the next free slot of each band's staged run
  int32_t* s_cell = lnext + n_bands;    // the staged records, grouped by band
  int32_t* s_z = s_cell + chunk;
  int32_t* s_r = s_z + chunk;
  int32_t* s_dst = s_r + chunk;         // each staged record's place in the frame's records

  const int64_t b = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t p1 = p0 + chunk < n_points ? p0 + chunk : n_points;
  const int64_t off = b * n_points;
  const int32_t* frow = row + off;
  const int32_t* fcol = col + off;
  const float* fz = z + off;
  const float* fr = r + off;
  ScatterRound cur;
  load_round(cur, frow, fcol, fz, fr, p0 + threadIdx.x, p1);  // in flight during the scans

  const int64_t at = (b * gridDim.x + blockIdx.x) * n_bands;
  for (int32_t k = threadIdx.x; k < n_bands; k += kSortThreads) lnext[k] = 0;
  exclusive_scan(totals + b * n_bands, base, n_bands, warp);  // the buckets' starts
  exclusive_scan(counts + at, lstart, n_bands, warp);          // the runs' places in staging
  __syncthreads();
  for (int32_t k = threadIdx.x; k < n_bands; k += kSortThreads) {
    if (blockIdx.x == 0) starts[b * n_bands + k] = base[k];
    base[k] += offsets[at + k];
  }
  __syncthreads();

  // 1. stage each point's record in its band's run
  for (int64_t i0 = p0 + threadIdx.x; i0 < p1; i0 += kScatterPer * kSortThreads) {
    ScatterRound next;
    load_round(next, frow, fcol, fz, fr, i0 + kScatterPer * kSortThreads, p1);
#pragma unroll
    for (int u = 0; u < kScatterPer; ++u) {
      const int32_t k = band_of(cur.row[u], height, band_rows);
      if (k < 0) continue;
      const int32_t lr = cur.row[u] - k * band_rows;
      const int32_t n = atomicAdd(lnext + k, 1);
      const int32_t s = lstart[k] + n;
      s_cell[s] = static_cast<uint32_t>(cur.col[u]) < static_cast<uint32_t>(width)
                      ? lr * width + cur.col[u] : -1;
      s_z[s] = floored_bits(cur.z[u]);
      s_r[s] = floored_bits(cur.r[u]);
      s_dst[s] = base[k] + n;
    }
    cur = next;
  }
  __syncthreads();

  // 2. the runs out, each contiguous in its bucket
  const int32_t staged = lstart[n_bands - 1] + lnext[n_bands - 1];
  int32_t* rc = records + off;
  int32_t* rz = rc + batch * n_points;
  int32_t* rr = rz + batch * n_points;
  for (int32_t s = threadIdx.x; s < staged; s += kSortThreads) {
    const int32_t d = s_dst[s];
    rc[d] = s_cell[s];
    rz[d] = s_z[s];
    rr[d] = s_r[s];
  }
}

// One round of a reduce thread's records: kReducePer records kReduceThreads
// apart, from j0; cell -1 past n.
struct ReduceRound {
  int32_t cell[kReducePer], z[kReducePer], r[kReducePer];
};

__device__ __forceinline__ void load_round(ReduceRound& q, const int32_t* __restrict__ rc,
                                           const int32_t* __restrict__ rz,
                                           const int32_t* __restrict__ rr, int32_t j0,
                                           int32_t n) {
#pragma unroll
  for (int u = 0; u < kReducePer; ++u) {
    const int32_t j = j0 + u * kReduceThreads;
    const bool ok = j < n;
    q.cell[u] = ok ? __ldg(rc + j) : -1;
    q.z[u] = ok ? __ldg(rz + j) : 0;
    q.r[u] = ok ? __ldg(rr + j) : 0;
  }
}

// grid (n_bands, batch): block (k, b) owns rows [k * band_rows, ...) of
// frame b and reads only band k's bucket of the frame's records: totals[b][k]
// records from starts[b][k]. Dynamic shared memory: three planes of
// pad4(band_rows * width) int32, the counts first.
__global__ void __launch_bounds__(kReduceThreads)
argoverse_band_reduce_kernel(const int32_t* __restrict__ totals, const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ records, float* __restrict__ out,
                             int64_t batch, int64_t n_points, int32_t height, int32_t width,
                             int32_t band_rows, int32_t n_bands) {
  extern __shared__ int4 smem[];
  const int64_t plane_cells = pad4(static_cast<int64_t>(band_rows) * width);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem);
  int32_t* p1 = cnt + plane_cells;  // max z bits
  int32_t* p2 = p1 + plane_cells;   // max r bits
  int4* cnt4 = reinterpret_cast<int4*>(cnt);
  int4* p14 = reinterpret_cast<int4*>(p1);
  int4* p24 = reinterpret_cast<int4*>(p2);

  const int32_t k = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int32_t r0 = k * band_rows;
  const int32_t cells = min(band_rows, height - r0) * width;
  const int32_t cells4 = static_cast<int32_t>(pad4(cells) / 4);

  // the bucket; its first records are in flight while the band is emptied
  const int32_t n = totals[b * n_bands + k];
  const int32_t start = n > 0 ? starts[b * n_bands + k] : 0;
  const int32_t* rc = records + b * n_points + start;
  const int32_t* rz = rc + batch * n_points;
  const int32_t* rr = rz + batch * n_points;
  ReduceRound cur;
  load_round(cur, rc, rz, rr, threadIdx.x, n);

  // 1. empty band: counts 0, maxima +0.0
  for (int32_t q = threadIdx.x; q < cells4; q += kReduceThreads) {
    cnt4[q] = make_int4(0, 0, 0, 0);
    p14[q] = make_int4(0, 0, 0, 0);
    p24[q] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  // 2. accumulate
  for (int32_t j0 = threadIdx.x; j0 < n; j0 += kReducePer * kReduceThreads) {
    ReduceRound next;
    load_round(next, rc, rz, rr, j0 + kReducePer * kReduceThreads, n);
#pragma unroll
    for (int u = 0; u < kReducePer; ++u) {
      const int32_t c = cur.cell[u];
      if (c < 0) continue;
      atomicAdd(cnt + c, 1);
      if (cur.z[u] > p1[c]) atomicMax(p1 + c, cur.z[u]);
      if (cur.r[u] > p2[c]) atomicMax(p2 + c, cur.r[u]);
    }
    cur = next;
  }
  __syncthreads();

  // 3. write the finished band once
  write_argoverse_band(cnt, p1, p2, out, b, r0, cells, height, width);
}

// ---------------------------------------------------------------------------
// Launching
// ---------------------------------------------------------------------------

enum Kernel { kTileCounts, kTileRaster, kTileArgoverse, kHistogram, kScatter, kReduce, kKernels };

// Whether a kernel may take more than 48 KB of dynamic shared memory on a
// device; set once per (device, kernel), to the card's limit less the
// kernel's static shared memory (the two together may not pass the limit).
std::mutex g_optin_lock;
std::atomic<bool> g_optin[kMaxDevices][kKernels];

template <typename KernelFn>
cudaError_t allow_smem(KernelFn kernel, int32_t device, Kernel which, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && g_optin[device][which].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> hold(g_optin_lock);
  if (cached && g_optin[device][which].load(std::memory_order_relaxed)) return cudaSuccess;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess && cached) g_optin[device][which].store(true, std::memory_order_release);
  return err;
}

// Runs `launch_fn` (which launches and returns a cudaError_t from any set-up
// call) with `device` current; the caller's device is restored afterwards.
// Returns the first CUDA error (0 on success).
template <typename F>
int on_device(int32_t device, F launch_fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch_fn();
  if (err == cudaSuccess) err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

template <Mode M>
int launch_tile(const void* row, const void* col, Frame in, void* out, int64_t batch,
                int64_t n_points, int32_t height, int32_t width, int32_t tile_rows,
                int32_t n_tiles, Epilogue ep, int32_t device, void* stream) {
  return on_device(device, [&]() -> cudaError_t {
    const size_t smem = static_cast<size_t>(pad4(static_cast<int64_t>(tile_rows) * width)) *
                        4 * planes(M);
    const Kernel which = M == Mode::kCounts ? kTileCounts
                         : M == Mode::kRaster ? kTileRaster : kTileArgoverse;
    const cudaError_t err = allow_smem(bev_tile_kernel<M>, device, which, smem);
    if (err != cudaSuccess || batch == 0 || n_tiles == 0) return err;
    const dim3 grid(static_cast<unsigned int>(n_tiles), static_cast<unsigned int>(batch));
    bev_tile_kernel<M><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(row), static_cast<const int32_t*>(col), in,
        static_cast<float*>(out), n_points, height, width, tile_rows, ep);
    return cudaSuccess;
  });
}

unsigned int chunks_of(int64_t n_points, int32_t chunk) {
  return static_cast<unsigned int>((n_points + chunk - 1) / chunk);
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

// The number of SMs on `device`.
extern "C" int bev_sm_count(int32_t device, int32_t* count) {
  int v = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
  *count = v;
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
  return launch_tile<Mode::kRaster>(row, col,
                                    Frame{static_cast<const int32_t*>(key), nullptr, nullptr},
                                    out, batch, n_points, height, width, tile_rows, n_tiles,
                                    Epilogue{inv_4095, inv_8191, inv_log64}, device, stream);
}

// row, col: (batch, n_points) int32, contiguous, on `device`.
// out: (batch, height, width) float32; every element is written.
// As above with pad4(tile_rows * width) * 4 bytes of shared memory.
extern "C" int bev_cell_counts_cuda(const void* row, const void* col, void* out, int64_t batch,
                                    int64_t n_points, int32_t height, int32_t width,
                                    int32_t tile_rows, int32_t n_tiles, int32_t device,
                                    void* stream) {
  return launch_tile<Mode::kCounts>(row, col, Frame{nullptr, nullptr, nullptr}, out, batch,
                                    n_points, height, width, tile_rows, n_tiles,
                                    Epilogue{0.0f, 0.0f, 0.0f}, device, stream);
}

// The Argoverse raster: the tables' memset, then the histogram, scatter and
// reduce kernels, enqueued on `stream` in that order. row, col: (batch,
// n_points) int32; z, r: (batch, n_points) float32; all contiguous, on
// `device`. out: (batch, 3, height, width) float32 [count, max(z, 0),
// max(r, 0)]; every element is written. scratch: int32, the tables then the
// records:
//   totals   (batch, n_bands)          points per band, zeroed here
//   starts   (batch, n_bands)          where each band's bucket starts
//   counts   (batch, chunks, n_bands)  each chunk's points per band
//   offsets  (batch, chunks, n_bands)  where each chunk's run starts in the
//                                      band's bucket
//   records  (3, batch, n_points)      cell in the band, z bits, r bits
// with chunks = ceil(n_points / chunk). Band k holds rows [k * band_rows,
// (k + 1) * band_rows) and n_bands * band_rows >= height. Shared memory a
// block: pad4(band_rows * width) * 12 bytes (reduce), (3 * n_bands + 4 *
// chunk) * 4 (scatter). Returns the first CUDA error; a step after a
// refused one is not enqueued.
extern "C" int argoverse_raster_reduce_cuda(const void* row, const void* col, const void* z,
                                            const void* r, void* out, void* scratch,
                                            int64_t batch, int64_t n_points, int32_t height,
                                            int32_t width, int32_t band_rows, int32_t n_bands,
                                            int32_t chunk, int32_t device, void* stream) {
  return on_device(device, [&]() -> cudaError_t {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned int chunks = n_points > 0 ? chunks_of(n_points, chunk) : 0;
    const int64_t per_table = batch * chunks * n_bands;
    int32_t* totals = static_cast<int32_t*>(scratch);
    int32_t* starts = totals + batch * n_bands;
    int32_t* counts = starts + batch * n_bands;
    int32_t* offsets = counts + per_table;
    int32_t* records = offsets + per_table;
    cudaError_t err = cudaMemsetAsync(totals, 0, sizeof(int32_t) * batch * n_bands, s);
    if (err != cudaSuccess || batch == 0) return err;
    const dim3 sort_grid(chunks, static_cast<unsigned int>(batch));
    if (chunks > 0) {
      const size_t hist_smem = sizeof(int32_t) * n_bands;
      err = allow_smem(argoverse_band_histogram_kernel, device, kHistogram, hist_smem);
      if (err != cudaSuccess) return err;
      argoverse_band_histogram_kernel<<<sort_grid, kSortThreads, hist_smem, s>>>(
          static_cast<const int32_t*>(row), totals, counts, offsets, n_points, height, band_rows,
          n_bands, chunk);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      const size_t scatter_smem =
          sizeof(int32_t) * (3 * static_cast<size_t>(n_bands) + 4 * static_cast<size_t>(chunk));
      err = allow_smem(argoverse_band_scatter_kernel, device, kScatter, scatter_smem);
      if (err != cudaSuccess) return err;
      argoverse_band_scatter_kernel<<<sort_grid, kSortThreads, scatter_smem, s>>>(
          static_cast<const int32_t*>(row), static_cast<const int32_t*>(col),
          static_cast<const float*>(z), static_cast<const float*>(r), totals, starts, counts,
          offsets, records, batch, n_points, height, width, band_rows, n_bands, chunk);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    const size_t reduce_smem = static_cast<size_t>(pad4(static_cast<int64_t>(band_rows) * width)) * 12;
    err = allow_smem(argoverse_band_reduce_kernel, device, kReduce, reduce_smem);
    if (err != cudaSuccess || n_bands == 0) return err;
    argoverse_band_reduce_kernel<<<dim3(static_cast<unsigned int>(n_bands),
                                        static_cast<unsigned int>(batch)),
                                   kReduceThreads, reduce_smem, s>>>(
        totals, starts, records, static_cast<float*>(out), batch, n_points, height, width,
        band_rows, n_bands);
    return cudaSuccess;
  });
}

// The Argoverse raster as one tile pass (the first design, kept to be
// compared with; no wrapper calls it). row, col: (batch, n_points) int32;
// z, r: (batch, n_points) float32; all contiguous, on `device`. out as
// above. pad4(tile_rows * width) * 12 bytes of shared memory (tile_plan).
extern "C" int argoverse_raster_reduce_tile_cuda(const void* row, const void* col, const void* z,
                                                 const void* r, void* out, int64_t batch,
                                                 int64_t n_points, int32_t height, int32_t width,
                                                 int32_t tile_rows, int32_t n_tiles,
                                                 int32_t device, void* stream) {
  return launch_tile<Mode::kArgoverse>(
      row, col,
      Frame{nullptr, static_cast<const float*>(z), static_cast<const float*>(r)}, out, batch,
      n_points, height, width, tile_rows, n_tiles, Epilogue{0.0f, 0.0f, 0.0f}, device, stream);
}
