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
// lowest index on ties, NaN (of either sign) above every number and -0 equal
// to +0 (jnp.argmax); the step matches d to track j when row[j] >= iou_min
// (NaN never does), and then marks j used. There is no "> 0" condition,
// unlike the fusion match: with iou_min <= -1 even used or ineligible
// columns match.
//
// What bounds it on this card: neither bytes nor arithmetic. A served step
// reads one (50, 64) IoU matrix (12.8 KB; 4.0e-06 ms at 3.35 TB/s) and does
// 3,200 comparisons, but its steps depend on each other through the used
// flags, so the floor is the launch plus a chain of dependent steps, one per
// *candidate* row (below). The cost of a step is the latency of its longest
// chain of dependent instructions; scripts/torch_track_phases.py reports it
// in SM cycles beside the bytes bound.
//
// Matrix design (track_associate_matrix_kernel<kSlots>), T <= 32 kSlots <=
// 256 and track_associate_matrix_smem(K, T) within the card's shared memory
// (the wrapper, ops/track_associate.py, decides by shape before the launch):
//   Stage, screen and key, off the chain, one block per frame. Every warp
//   takes rows of the frame (two at a time, both rows' loads in flight):
//   lane l loads columns l + 32 q of the row from global memory (L2: the
//   gate wrote the matrix just before), turns each value into an order key
//   and stores it in shared memory; a row is laid out in 32 kSlots words,
//   the columns past T holding key 0. The score order goes to shared memory
//   beside it. Staging and keying are one pass: the keys have to be computed
//   from the values anyway, so a copy engine (TMA, cp.async) would only add
//   a shared-memory round trip between the load and the key.
//   Keys. order_key(v) is 0xffffffff for every NaN, the key of +0 for -0,
//   and otherwise the float's bits with the sign bit set (v >= +0) or all
//   bits inverted (v < 0). Unsigned key order is then jnp.argmax's value
//   order: positive floats order as their bits, which the set sign bit puts
//   above every inverted negative; inverting a negative float's bits
//   reverses their order, as a larger magnitude is a smaller value; the
//   largest number, +inf, keys to 0xff800000, below the NaN key; equal
//   numbers (and +0, -0) key equal, and so do all NaNs, which jnp.argmax
//   also treats as equal (the first one wins). Every number keys to at
//   least order_key(-inf) = 0x007fffff, so key 0 marks padding that never
//   wins. A used column's key is order_key(-1.0f): the plain step's -1.
//   Screen. Row d is a candidate when one of its entries is >= iou_min (a
//   NaN never is), or when -1.0f >= iou_min. Why every other row's step is
//   "no match, nothing marked", whatever happened before it: each entry of
//   its row is NaN or < iou_min, and the step's -1 for a used column is
//   < iou_min too, so the argmax is a NaN or a number < iou_min, and the
//   step fails its test. A failed step changes no used flag, so dropping
//   those steps leaves every other step as it was. The screen writes -1 for
//   them; the chain walks only the candidate rows, in score order.
//   Chain, one warp. A ballot and a popcount prefix per 32 positions list
//   the candidate rows of `order` (in place: a position is read before any
//   lane writes the list). Lane l holds the used flags of its columns l +
//   32 q as a register bitmask. A step substitutes key(-1) for used columns,
//   takes the lane's largest key as a tree of unsigned maxima, the warp's
//   top key with __reduce_max_sync and the lowest column holding it with
//   __reduce_min_sync (the lane's lowest column holding its largest key is
//   found while the first reduction runs). The step hits when the top key
//   is a number (not the NaN key) and at least order_key(iou_min): the key
//   order is the value order, so that is row[j] >= iou_min. The lane that
//   holds the winning column sets its bit. The next candidate row's keys
//   load during the step; the results wait in shared memory and go out
//   after the chain.
//   Shared memory: K rows of 32 kSlots keys, the order / candidate list,
//   the results and the row flags, K (128 kSlots + 9) bytes: 13,250 B at
//   the served (50, 64), 51,650 B at (50, 256); up to K = 225 at T = 256
//   and K = 877 at T = 64 within an H100's 232,448 B.
// Row design (track_associate_row_kernel), every other shape (T > 256, or
// a matrix past the card's shared memory), up to 4 K + T bytes within it:
//   one warp per frame, in a block of its own. The warp stages the order
//   and keeps the used flags of the T tracks in shared memory. A step reads
//   row d from global memory with the lanes on neighbouring columns, takes
//   each lane's best column under the argmax order above, then the warp's
//   best with a butterfly of shuffles, and lane 0 writes the result. Each
//   step waits on its row's load: about 0.78 us a step at (1, 50, 64).
// Above 48 KB of dynamic shared memory a kernel needs the opt-in attribute:
// it is set once per device and kernel, to the card's limit, never on every
// launch (allow_smem below).
//
// Plain C interface, bound with ctypes (sfa3d_tpu_torch/_build.py). The
// wrapper checks shapes, types, devices and contiguity, picks the design,
// allocates the outputs, and raises when the return value is not 0.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSlots = 8;  // the matrix design's columns a lane: T <= 256
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kKeyNaN = 0xffffffffu;   // every NaN, above every number
constexpr uint32_t kKeyUsed = 0x407fffffu;  // order_key(-1.0f)

// Phase stamps for scripts/torch_track_phases.py, compiled in only with
// -DTRACK_ASSOCIATE_PHASE_STAMPS: thread 0 of each block records clock64()
// at the start (0), after staging, screen and keys and the block barrier
// (1), after the candidate list (2), after the chain (3) and after the
// write-back (4). The row design stamps 1 and 2 together, after staging the
// order.
#ifdef TRACK_ASSOCIATE_PHASE_STAMPS
constexpr int kStampBlocks = 4096;
constexpr int kStamps = 5;
__device__ long long g_phase_stamps[kStampBlocks * kStamps];
#define PHASE_STAMP(n)                                    \
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {    \
    g_phase_stamps[blockIdx.x * kStamps + (n)] = clock64(); \
  }
#else
#define PHASE_STAMP(n)
#endif

// True when (av, ai) comes before (bv, bi) in jnp.argmax's order: NaN above
// every number, a larger value first, ties (NaN with NaN too) to the lower
// index. -0 and +0 are equal.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av > bv;
  return ai < bi;
}

// An unsigned key in jnp.argmax's value order (the source note says why).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(__fadd_rn(v, 0.0f));  // -0 + 0 = +0
  const uint32_t key = b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) | 0x80000000u);
  return isnan(v) ? kKeyNaN : key;
}

// Warp `warp`'s part of staging: row r's keys into skeys (lane l: columns
// l + 32 q), its candidate flag into scand and -1 into smatch.
template <int kSlots>
__device__ __forceinline__ void key_row(const float (&v)[kSlots], int r, int t, int lane,
                                        uint32_t kmin, bool every_row, uint32_t* skeys,
                                        uint8_t* scand, int32_t* smatch) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    const uint32_t key = j < t ? order_key(v[q]) : 0u;
    skeys[r * kSlots * kWarp + j] = key;
    any |= key >= kmin && key != kKeyNaN;
  }
  any = __any_sync(kFull, any) || every_row;
  if (lane == 0) {
    scand[r] = any;
    smatch[r] = -1;
  }
}

template <int kSlots>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int t, int lane,
                                         float (&v)[kSlots]) {
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    v[q] = j < t ? __ldg(row + j) : 0.0f;
  }
}

// grid (batch), block track_associate_threads(k); t <= 32 kSlots. iou
// (batch, k, t), order (batch, k) -> det_match (batch, k), trk_used (batch,
// t). Dynamic shared memory: track_associate_matrix_smem(k, kSlots).
template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads)
    track_associate_matrix_kernel(const float* __restrict__ iou,
                                  const int32_t* __restrict__ order,
                                  int32_t* __restrict__ det_match,
                                  uint8_t* __restrict__ trk_used, int32_t k, int32_t t,
                                  float iou_min) {
  constexpr int kRow = kSlots * kWarp;  // keys per row: columns past t hold 0
  extern __shared__ uint4 smem4[];
  uint32_t* skeys = reinterpret_cast<uint32_t*>(smem4);           // k x kRow keys
  int32_t* slist = reinterpret_cast<int32_t*>(skeys + k * kRow);  // the order, then the candidate rows
  int32_t* smatch = slist + k;                                    // each detection's result
  uint8_t* scand = reinterpret_cast<uint8_t*>(smatch + k);         // row d is a candidate
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int64_t f = blockIdx.x;
  const float* f_iou = iou + f * k * t;
  // a NaN iou_min keys above every number: nothing hits, no row is a candidate
  const uint32_t kmin = isnan(iou_min) ? kKeyNaN : order_key(iou_min);
  const bool every_row = -1.0f >= iou_min;
  PHASE_STAMP(0)

  for (int i = threadIdx.x; i < k; i += blockDim.x) slist[i] = order[f * k + i];
  for (int r0 = warp; r0 < k; r0 += 2 * warps) {
    const int r1 = r0 + warps;
    float v0[kSlots], v1[kSlots];
    load_row<kSlots>(f_iou + static_cast<int64_t>(r0) * t, t, lane, v0);
    if (r1 < k) load_row<kSlots>(f_iou + static_cast<int64_t>(r1) * t, t, lane, v1);
    key_row<kSlots>(v0, r0, t, lane, kmin, every_row, skeys, scand, smatch);
    if (r1 < k) key_row<kSlots>(v1, r1, t, lane, kmin, every_row, skeys, scand, smatch);
  }
  __syncthreads();
  PHASE_STAMP(1)
  if (warp != 0) return;

  // the candidate rows in score order: a ballot and a popcount prefix per 32
  // positions, written over the order (n never passes the position read)
  int n = 0;
  for (int w = 0; w * kWarp < k; ++w) {
    const int i = w * kWarp + lane;
    const int d = i < k ? slist[i] : 0;
    const bool c = i < k && scand[d];
    const uint32_t bits = __ballot_sync(kFull, c);
    if (c) slist[n + __popc(bits & ((1u << lane) - 1u))] = d;
    n += __popc(bits);
  }
  __syncwarp();
  PHASE_STAMP(2)

  // the chain: bit q of `used` is column lane + 32 q
  uint32_t used = 0;
  uint32_t next[kSlots];
  const uint32_t* keys_of_lane = skeys + lane;
  int d_next = n > 0 ? slist[0] : 0;
  if (n > 0) {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) next[q] = keys_of_lane[d_next * kRow + q * kWarp];
  }
  for (int s = 0; s < n; ++s) {
    const int d = d_next;
    uint32_t key[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) key[q] = ((used >> q) & 1u) ? kKeyUsed : next[q];
    if (s + 1 < n) {
      d_next = slist[s + 1];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) next[q] = keys_of_lane[d_next * kRow + q * kWarp];
    }
    // the lane's largest key, as a tree of unsigned maxima
    uint32_t m[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) m[q] = key[q];
#pragma unroll
    for (int stride = 1; stride < kSlots; stride *= 2) {
#pragma unroll
      for (int q = 0; q + stride < kSlots; q += 2 * stride) m[q] = max(m[q], m[q + stride]);
    }
    const uint32_t best = m[0];
    const uint32_t top = __reduce_max_sync(kFull, best);
    // meanwhile: the lane's lowest column holding its largest key
    uint32_t at = kFull;
#pragma unroll
    for (int q = kSlots - 1; q >= 0; --q) at = key[q] == best ? q * kWarp + lane : at;
    const uint32_t jm = __reduce_min_sync(kFull, best == top ? at : kFull);
    const bool hit = top != kKeyNaN && top >= kmin;
    used |= static_cast<uint32_t>(hit && lane == static_cast<int>(jm % kWarp)) << (jm / kWarp);
    if (lane == 0) smatch[d] = hit ? static_cast<int32_t>(jm) : -1;
  }
  __syncwarp();
  PHASE_STAMP(3)
  for (int i = lane; i < k; i += kWarp) det_match[f * k + i] = smatch[i];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    if (j < t) trk_used[f * t + j] = (used >> q) & 1u;
  }
  PHASE_STAMP(4)
}

// grid (batch), block one warp: the row design. Dynamic shared memory:
// track_associate_row_smem(k, t).
__global__ void __launch_bounds__(kWarp)
    track_associate_row_kernel(const float* __restrict__ iou, const int32_t* __restrict__ order,
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
  PHASE_STAMP(0)

  for (int i = lane; i < k; i += kWarp) {
    s_order[i] = f_order[i];
    f_match[i] = -1;  // every slot is written, a permutation or not
  }
  for (int j = lane; j < t; j += kWarp) s_used[j] = 0;
  __syncwarp();
  PHASE_STAMP(1)
  PHASE_STAMP(2)

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
  PHASE_STAMP(3)
  uint8_t* f_used = trk_used + b * t;
  for (int j = lane; j < t; j += kWarp) f_used[j] = s_used[j];
  PHASE_STAMP(4)
}

// Per row: 32 kSlots keys, its place in the order / candidate list, its
// result and its flag.
size_t track_associate_matrix_smem(int32_t k, int slots) {
  return static_cast<size_t>(k) * (kWarp * 4 * slots + 9);
}

size_t track_associate_row_smem(int32_t k, int32_t t) {
  return 4 * static_cast<size_t>(k) + static_cast<size_t>(t);
}

// One warp per two rows in staging, at least one warp.
int track_associate_threads(int32_t k) {
  const int warps = (k + 1) / 2;
  return warps >= kMaxThreads / kWarp ? kMaxThreads : (warps < 1 ? kWarp : warps * kWarp);
}

// Whether a kernel may take more than 48 KB of dynamic shared memory on a
// device; set once per (device, kernel), to the card's limit.
std::mutex g_optin_lock;
std::atomic<bool> g_optin[kMaxDevices][kMaxSlots + 1];  // [device][0: row design, else kSlots]

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int32_t device, int which, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && g_optin[device][which].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> hold(g_optin_lock);
  if (cached && g_optin[device][which].load(std::memory_order_relaxed)) return cudaSuccess;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
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

template <int kSlots>
cudaError_t launch_matrix(const void* iou, const void* order, void* det_match, void* trk_used,
                          int64_t batch, int32_t k, int32_t t, float iou_min, int32_t device,
                          void* stream) {
  const size_t smem = track_associate_matrix_smem(k, kSlots);
  const cudaError_t err = allow_smem(track_associate_matrix_kernel<kSlots>, device, kSlots, smem);
  if (err != cudaSuccess) return err;
  track_associate_matrix_kernel<kSlots>
      <<<static_cast<unsigned int>(batch), track_associate_threads(k), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(iou), static_cast<const int32_t*>(order),
          static_cast<int32_t*>(det_match), static_cast<uint8_t*>(trk_used), k, t, iou_min);
  return cudaSuccess;
}

}  // namespace

#ifdef TRACK_ASSOCIATE_PHASE_STAMPS
// Copies the first n phase stamps (5 per block) to `out` on the host.
extern "C" int track_associate_phase_stamps(long long* out, int32_t n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_stamps, n * sizeof(long long)));
}
#endif

// The most dynamic shared memory one block may opt in to on `device`.
extern "C" int track_associate_smem_limit(int32_t device, int32_t* bytes) {
  int v = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = v;
  return static_cast<int>(err);
}

// The matrix design. iou (batch, k, t) float32 (-1 where a pair may not
// match), order (batch, k) int32 (a permutation of 0..k-1 per frame) ->
// det_match (batch, k) int32, trk_used (batch, t) bool; all contiguous on
// `device`; batch >= 1, k >= 0, 1 <= t <= 256 and
// track_associate_matrix_smem(k, ceil(t / 32)) within the block's limit
// (the wrapper's track_associate_design).
extern "C" int track_associate_cuda(const void* iou, const void* order, void* det_match,
                                    void* trk_used, int64_t batch, int32_t k, int32_t t,
                                    float iou_min, int32_t device, void* stream) {
  return on_device(device, [&] {
    switch ((t + kWarp - 1) / kWarp) {
#define MATRIX_CASE(n) \
  case n:              \
    return launch_matrix<n>(iou, order, det_match, trk_used, batch, k, t, iou_min, device, stream);
      MATRIX_CASE(1)
      MATRIX_CASE(2)
      MATRIX_CASE(3)
      MATRIX_CASE(4)
      MATRIX_CASE(5)
      MATRIX_CASE(6)
      MATRIX_CASE(7)
      MATRIX_CASE(8)
#undef MATRIX_CASE
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// The row design, same arguments; t >= 1 and track_associate_row_smem(k, t)
// within the block's limit.
extern "C" int track_associate_row_cuda(const void* iou, const void* order, void* det_match,
                                        void* trk_used, int64_t batch, int32_t k, int32_t t,
                                        float iou_min, int32_t device, void* stream) {
  return on_device(device, [&] {
    const size_t smem = track_associate_row_smem(k, t);
    const cudaError_t err = allow_smem(track_associate_row_kernel, device, 0, smem);
    if (err != cudaSuccess) return err;
    track_associate_row_kernel<<<static_cast<unsigned int>(batch), kWarp, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(iou), static_cast<const int32_t*>(order),
        static_cast<int32_t*>(det_match), static_cast<uint8_t*>(trk_used), k, t, iou_min);
    return cudaSuccess;
  });
}
