// The fusion path's three sequential loops: hard NMS, Gaussian soft-NMS and
// the greedy best-IoU match, one launch per batch.
//
// Replaces the lax.fori_loop programs of the JAX package, which XLA ran on
// the device (they were not Pallas kernels):
//   hard_nms_keep      sfa3d_tpu/fusion/nms.py:33-50 (hard_nms, the loop on
//                      boxes already in stable score order); also the NMS of
//                      sfa3d_tpu/models/yolov8.py:254 (select_detections)
//   soft_nms_gaussian  sfa3d_tpu/fusion/nms.py:53-87
//   greedy_match       sfa3d_tpu/fusion/fuse.py:64-91
//
// What bounds them on this card: neither bytes nor arithmetic. A frame moves
// a few KB (K boxes in, K flags or scores out) and needs at most K * K IoUs,
// but the K steps depend on each other: step i reads what steps < i decided.
// So the floor is the launch plus a chain of K dependent steps per frame,
// and the cost of a step is the latency of its longest chain of dependent
// instructions. All three kernels take everything that does not depend on
// an earlier step out of that chain. Phase 1 computes it, in parallel, into
// shared memory: one frame is a cluster of four blocks (thread block
// clusters), whose warps share the rows and write them into the first
// block's shared memory (distributed shared memory), so a batch of 8 frames
// spreads phase 1 over 32 SMs, not 8. Phase 2, in that block, runs the
// chain in one warp with its state in registers and no block barrier.
//
// hard_nms_keep, K <= 1024, one design.
//   Phase 1: the suppression bitmask. Word w of row i has bit b set when slot
//   j = 32w + b comes after i, is valid, and iou(j, i) > thr: "if i is kept,
//   it removes j". A warp computes one word: lane b one IoU, then
//   __ballot_sync. Rows of invalid slots and words left of the diagonal are
//   never read, so they are not computed, and where two boxes do not overlap
//   the division is skipped (the IoU is exactly 0 there).
//   Phase 2: lane w holds word w of the removed set. The slots are decided
//   32 at a time: the decisions in word c depend on one another only through
//   word c, so every lane runs that chain in registers (two slots a step:
//   bit tests, selects and an OR, four dependent instructions; the diagonal
//   words loaded ahead), then each lane w > c ORs in word w of the rows just
//   kept (independent loads, off the chain). It is the plain version's
//   predicate turned forward: "i is suppressed by a kept j < i with
//   iou(i, j) > thr" is "a kept j removes every later i with iou(i, j) >
//   thr", with the IoU in the same argument order.
//   Shared memory: K box edges and areas (20 B each, the sums and products
//   of the IoU taken once per box), 32 valid words, the diagonal word of
//   each row, and 32 * ceil(K/32) rows of 32 words (a fixed stride, so the
//   folds' loads take immediate offsets): 39,040 B at K = 256, 155,776 B at
//   K = 1024, inside the 232,448 B a block may use on an H100.
//
// soft_nms_gaussian, matrix design, K <= soft_nms_matrix_slots (239 on an
// H100; the wrapper computes it from the card's limit).
//   Phase 1: the decay matrix D[m][j] = expf(-(q * q) * inv_sigma), q =
//   iou(m, j), for valid pairs. The decay depends on the pair, not on the
//   step, so precomputing it changes no bit. The IoU is symmetric bit for bit
//   (fmaxf and fminf are, and IEEE + and * commute), so each pair is computed
//   once and written to D[m][j] and D[j][m].
//   Phase 2: lane l holds slots l, l + 32, ... (at most 8): scores in
//   registers, processed flags in a bitmask. A step takes the lane's best
//   score as an ordered 32-bit key (a tree over its slots, first index on
//   ties), the warp's largest key with __reduce_max_sync and the first slot
//   holding it with __reduce_min_sync (first index on ties, like
//   jnp.argmax), exits when nothing finite is left, and decays each lane's
//   own unprocessed slots by row m of D.
//   Shared memory: K * K floats, 32 valid words, K boxes: 53,936 B at the
//   served K = 114.
// soft_nms_gaussian, block design, for larger K (<= 1024): one block, one
//   thread per slot, each step a two-level block argmax and a recomputed
//   IoU. The wrapper (ops/fusion_loops.py) picks the design by K.
//
// greedy_match, matrix design, Ks <= 256 and Ky <= greedy_match_matrix_rows
// (890 at Ks = 50, 225 at Ks = 256 on an H100; the wrapper computes it from
// the card's limit).
//   Phase 1: the key matrix. key[i][j] is the float bits of iou(yolo i,
//   sfa j) (in that argument order, as the plain version takes it) when
//   both are valid, the IoU is > 0 and >= thr, else 0. One warp
//   builds row i (lane l: columns l + 32 q, their extents held in
//   registers), skips the division where the boxes do not overlap, and
//   flags the row when a key is not 0. A row with no candidate gets -1
//   there and then, off the chain.
//   Why that is the plain step, bit for bit: a candidate IoU is a positive
//   float, whose bits order as unsigned integers, and 0 lies below every
//   candidate. If the reference's row maximum v (over unmatched columns,
//   invalid pairs at -1) passes ">= thr and > 0", every entry equal to v is
//   a candidate, so the lowest index holding the top key is the lowest
//   index holding v; if v fails, no entry can be a candidate (it would be
//   larger than v), and the top key is 0. Boxes are taken as finite, as
//   the block design takes them.
//   Phase 2: the candidate rows in order (a ballot and a popcount prefix
//   per 32 rows), then one warp walks them: lane l holds columns l + 32 q,
//   the matched flags a register bitmask. A step zeroes the keys of matched
//   columns, takes the lane's best as a tree (the lower index on ties), the
//   warp's top key with __reduce_max_sync and the first column holding it
//   with __reduce_min_sync, and sets the winner's bit unless the top key is
//   0. The next row's keys are loaded during the step (off the chain); the
//   results wait in shared memory and go out after the chain.
//   Phase 1 runs on a cluster of kCluster = 4 blocks per frame, as in the
//   NMS kernels. Measured against clusters of 1 and 2 (a trial build of
//   scripts/torch_loop_phases.py; H100 80GB HBM3, 700 W), device time for
//   1 / 2 / 4 blocks: 6.81 / 5.87 / 5.37 us at 8 x 64 x 50 (tied IoUs),
//   9.72 / 8.60 / 8.00 us when every row is a candidate, 41.9 / 34.0 / 32.0
//   us at 8 x 225 x 256; one block with no cluster tied four at 64 x 50
//   (5.52 / 5.49 us) and lost at 225 x 256 (49.4 / 32.1 us). Four blocks
//   win where phase 1 grows and tie or win elsewhere.
//   Shared memory: Ky rows of 32 ceil(Ks / 32) keys, the candidate list,
//   the results and the row flags: 16,704 B at the served 64 x 50.
// greedy_match, block design, for a larger Ks or Ky (<= 1024): one block,
//   one thread per SFA box, each YOLO row a step of recomputed IoUs and a
//   two-level block argmax. The wrapper picks the design by shape.
//
// Bit parity with the plain PyTorch versions (sfa3d_tpu_torch/ops/
// fusion_loops.py): the IoU repeats fusion/iou.py's float32 steps with
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, so nvcc cannot contract a
// product and a sum into a fused multiply-add; the soft-NMS decay is
// expf(-(iou * iou) * inv_sigma) with inv_sigma = float32(1 / sigma) passed
// in (the form XLA compiles for a constant sigma), the same libm function as
// PyTorch's exp on the card; the build never uses --use_fast_math.
//
// Plain C interface, bound with ctypes (sfa3d_tpu_torch/_build.py). The
// wrappers check shapes, types, devices and contiguity, allocate the
// outputs, and raise when the return value is not 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr int kMaxWords = 32;             // valid words: 1024 slots
constexpr int kCluster = 4;               // blocks per frame in phase 1
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kKeyNegInf = 0x007fffffu;  // score_key(-INFINITY)
constexpr uint32_t kKeyPosInf = 0xff800000u;  // score_key(+INFINITY)

// Phase stamps for scripts/torch_loop_phases.py, compiled in only with
// -DFUSION_LOOPS_PHASE_STAMPS: thread 0 of each block of the NMS kernels and
// the match's matrix kernel records clock64() at the start (0), after
// loading the frame (1), after phase 1 (2; the match: after its candidate
// list too) and after phase 2 (3, the first block of a cluster).
#ifdef FUSION_LOOPS_PHASE_STAMPS
constexpr int kStampBlocks = 4096;
__device__ long long g_phase_stamps[kStampBlocks * 4];
#define PHASE_STAMP(n)                                     \
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {     \
    g_phase_stamps[blockIdx.x * 4 + (n)] = clock64();      \
  }
#else
#define PHASE_STAMP(n)
#endif

struct Box {
  float x, y, w, h;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ p) {
  return Box{p[0], p[1], p[2], p[3]};
}

__device__ __forceinline__ Box as_box(const float4& b) { return Box{b.x, b.y, b.z, b.w}; }

// A box as the IoU reads it: its edges x, y, x + w, y + h and its area
// w * h, each rounded once, as fusion/iou.py rounds them.
struct Extent {
  float x0, y0, x1, y1, area;
};

__device__ __forceinline__ Extent as_extent(const float4& e, float area) {
  return Extent{e.x, e.y, e.z, e.w, area};
}

__device__ __forceinline__ Extent extent_of(const Box& b) {
  return Extent{b.x, b.y, __fadd_rn(b.x, b.w), __fadd_rn(b.y, b.h), __fmul_rn(b.w, b.h)};
}

// iou(a, b) for a = box1 (the row) and b = box2 (the column), in
// fusion/iou.py's float32 steps: the intersection first, then the rest.
__device__ __forceinline__ float intersection(const Extent& a, const Extent& b) {
  const float left = fmaxf(a.x0, b.x0);
  const float top = fmaxf(a.y0, b.y0);
  const float right = fminf(a.x1, b.x1);
  const float bottom = fminf(a.y1, b.y1);
  return __fmul_rn(fmaxf(__fsub_rn(right, left), 0.0f), fmaxf(__fsub_rn(bottom, top), 0.0f));
}

__device__ __forceinline__ float iou_given(const Extent& a, const Extent& b, float inter) {
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

__device__ __forceinline__ float iou_xywh(const Box& a, const Box& b) {
  const Extent ea = extent_of(a), eb = extent_of(b);
  return iou_given(ea, eb, intersection(ea, eb));
}

__device__ __forceinline__ float decay_factor(float q, float inv_sigma) {
  return expf(__fmul_rn(-__fmul_rn(q, q), inv_sigma));
}

// The k x k decay matrix in whole float4s, so that what follows it stays
// 16-byte aligned.
__host__ __device__ __forceinline__ int matrix_float4s(int k) { return (k * k + 3) / 4; }

__device__ __forceinline__ bool bit_of(const uint32_t* words, int j) {
  return (words[j >> 5] >> (j & 31)) & 1u;
}

// A key that orders scores as floats compare: a larger score, a larger key.
// -0 counts as +0 (equal scores, equal keys: the first index wins) and every
// NaN as the largest (argmax picks a NaN). 0 is left free for processed
// slots, below every score's key.
__device__ __forceinline__ uint32_t score_key(float s) {
  const uint32_t b = __float_as_uint(__fadd_rn(s, 0.0f));  // -0 + 0 = +0
  const uint32_t key = b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) | 0x80000000u);
  return isnan(s) ? kFull : key;
}

// Phase 0 of the NMS kernels: the frame's boxes into `sbox` (as x, y, w, h)
// or, with `sarea`, as extents (x0, y0, x1, y1 in `sbox`, the areas in
// `sarea`), and its valid flags, packed 32 to a word, into `svbits`.
__device__ __forceinline__ void load_frame(const float* __restrict__ boxes,
                                           const uint8_t* __restrict__ valid, int64_t f, int k,
                                           float4* sbox, float* sarea, uint32_t* svbits) {
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const Box b = load_box(boxes + (f * k + j) * 4);
    if (sarea != nullptr) {
      const Extent e = extent_of(b);
      sbox[j] = make_float4(e.x0, e.y0, e.x1, e.y1);
      sarea[j] = e.area;
    } else {
      sbox[j] = make_float4(b.x, b.y, b.w, b.h);
    }
  }
  const int lane = threadIdx.x % kWarp;
  const int nw = (k + kWarp - 1) / kWarp;
  for (int w = threadIdx.x / kWarp; w < nw; w += blockDim.x / kWarp) {
    const int j = w * kWarp + lane;
    const uint32_t bits = __ballot_sync(kFull, j < k && valid[f * k + j] != 0);
    if (lane == 0) svbits[w] = bits;
  }
}

// (v, i) beats (ov, oi) when v is larger, or equal with a smaller index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmax with the first index on ties; every thread gets the
// result. Two __syncthreads: the per-warp winners go through `wv`/`wi`, the
// block's winner through `rv`/`ri`, so the next call's writes never race
// this call's reads.
__device__ __forceinline__ void block_argmax(float v, int i, float* wv, int* wi, float* rv,
                                             int* ri, float& out_v, int& out_i) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    take_better(v, i, __shfl_down_sync(kFull, v, off), __shfl_down_sync(kFull, i, off));
  }
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / kWarp;
    v = lane < n_warps ? wv[lane] : -INFINITY;
    i = lane < n_warps ? wi[lane] : 0x7fffffff;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      take_better(v, i, __shfl_down_sync(kFull, v, off), __shfl_down_sync(kFull, i, off));
    }
    if (lane == 0) {
      *rv = v;
      *ri = i;
    }
  }
  __syncthreads();
  out_v = *rv;
  out_i = *ri;
}

// grid (batch * kCluster) in clusters of kCluster blocks, one cluster per
// frame; block min(1024, 32 k) threads. boxes (batch, k, 4) in stable score
// order, valid (batch, k) -> keep (batch, k): keep[i] = valid[i] and no kept
// j < i has iou(i, j) > thr. Dynamic shared memory: hard_nms_smem(k) in
// every block of the cluster; the mask is built in the first block's,
// through distributed shared memory.
__global__ void __launch_bounds__(kMaxThreads)
    hard_nms_keep_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                         uint8_t* __restrict__ keep, int32_t k, float thr) {
  const int nw = (k + kWarp - 1) / kWarp;
  extern __shared__ float4 smem4[];
  float4* sedge = smem4;                                      // k box edges
  uint32_t* svbits = reinterpret_cast<uint32_t*>(sedge + k);  // kMaxWords valid words
  uint32_t* sdiag = svbits + kMaxWords;                       // 32 nw: word i / 32 of row i
  uint32_t* smask = sdiag + kWarp * nw;                       // 32 nw rows of kMaxWords words
  float* sarea = reinterpret_cast<float*>(smask + kWarp * nw * kMaxWords);  // k box areas
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  uint32_t* lead_diag = cluster.map_shared_rank(sdiag, 0);
  uint32_t* lead_mask = cluster.map_shared_rank(smask, 0);
  const int64_t f = blockIdx.x / blocks;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  PHASE_STAMP(0)
  load_frame(boxes, valid, f, k, sedge, sarea, svbits);
  if (rank == 0) {
    for (int i = threadIdx.x; i < kWarp * nw; i += blockDim.x) sdiag[i] = 0;  // invalid rows
  }
  cluster.sync();  // every block runs, and the lead block's diagonal is zero
  PHASE_STAMP(1)

  // phase 1: row i, word w >= i / 32, one warp per word, the rows dealt to
  // the cluster's warps back and forth (long rows first, then short ones).
  // Where two boxes do not overlap (the intersection is 0, or NaN and then
  // so is the union) the IoU is exactly 0: the division is skipped, and the
  // intersection itself runs on every lane with no branch (a lane past k
  // reads the bytes behind the edges and is masked out).
  const bool zero_hits = 0.0f > thr;
  const int all_warps = blocks * warps;
  const int g = rank * warps + warp;
  for (int t = 0; t * all_warps < k; ++t) {
    const int i = t * all_warps + (t % 2 == 0 ? g : all_warps - 1 - g);
    if (i >= k || !bit_of(svbits, i)) continue;  // never kept: its row is never used
    const Extent earlier = as_extent(sedge[i], sarea[i]);
    for (int w = i / kWarp; w < nw; ++w) {
      const int j = w * kWarp + lane;
      const bool pair = j > i && ((svbits[w] >> lane) & 1u);  // bit j is 0 for j >= k
      const float4 e = sedge[j];
      const float inter = intersection(Extent{e.x, e.y, e.z, e.w, 0.0f}, earlier);
      bool hit = zero_hits;
      if (pair && inter > 0.0f) hit = iou_given(as_extent(e, sarea[j]), earlier, inter) > thr;
      const uint32_t word = __ballot_sync(kFull, pair && hit);
      if (lane == 0) {
        lead_mask[i * kMaxWords + w] = word;
        if (w == i / kWarp) lead_diag[i] = word;
      }
    }
  }
  cluster.sync();
  PHASE_STAMP(2)
  if (rank != 0 || warp != 0) return;

  // phase 2: one warp; lane w holds word w of the removed set. The chain of
  // word c runs on registers only: its 32 diagonal words come in with eight
  // 16-byte loads first, and each step decides two slots with bit tests,
  // selects and an OR (no branch). Row b of word c only sets bits after b,
  // so bit b of `r` is final once the chain reaches b, and the kept slots of
  // word c are v & ~r.
  uint32_t removed = 0, kept_word = 0;
  for (int c = 0; c < nw; ++c) {
    uint32_t diag[kWarp];
    const uint4* d4 = reinterpret_cast<const uint4*>(sdiag + c * kWarp);
#pragma unroll
    for (int q = 0; q < kWarp / 4; ++q) {
      const uint4 d = d4[q];
      diag[4 * q] = d.x;
      diag[4 * q + 1] = d.y;
      diag[4 * q + 2] = d.z;
      diag[4 * q + 3] = d.w;
    }
    uint32_t r = __shfl_sync(kFull, removed, c);
#pragma unroll
    for (int b = 0; b < kWarp; b += 2) {  // two slots a step: four dependent operations
      const uint32_t d0 = diag[b], d1 = diag[b + 1];
      const uint32_t both = ((d0 >> (b + 1)) & 1u) ? d0 : (d0 | d1);  // off the chain
      const uint32_t b_kept = (r & (2u << b)) ? d0 : both;
      const uint32_t b_removed = (r & (2u << b)) ? 0u : d1;
      r |= (r & (1u << b)) ? b_removed : b_kept;
    }
    const uint32_t kept = svbits[c] & ~r;
    kept_word = lane == c ? kept : kept_word;
    // lane w folds word w of the rows just kept: independent loads, off the
    // chain (lanes past nw fold words that are never read)
    const uint32_t* rows = smask + c * kWarp * kMaxWords + lane;
    uint32_t acc = 0;
#pragma unroll
    for (int b = 0; b < kWarp; ++b) acc |= rows[b * kMaxWords] & (0u - ((kept >> b) & 1u));
    removed |= acc;
  }
  for (int w = 0; w < nw; ++w) {
    const uint32_t kw = __shfl_sync(kFull, kept_word, w);
    const int j = w * kWarp + lane;
    if (j < k) keep[f * k + j] = (kw >> lane) & 1u;
  }
  PHASE_STAMP(3)
}

// Phase 2 of the soft-NMS matrix kernel: the dependent steps, one warp, lane
// holding slots lane + 32 q; bit q of `open` marks an unprocessed valid slot
// (all valid ones at the start). Processed slots have the key 0.
template <int kSlots>
__device__ __forceinline__ void soft_nms_steps(float (&s)[kSlots], uint32_t open,
                                               const float* __restrict__ decay, int k,
                                               int lane) {
  const float* col = decay + lane;
  for (int step = 0; step < k; ++step) {
    // the lane's best slot, as a tree: on ties the left one, of lower index
    uint32_t key[kSlots], at[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      key[q] = ((open >> q) & 1u) ? score_key(s[q]) : 0u;
      at[q] = q * kWarp + lane;
    }
#pragma unroll
    for (int stride = 1; stride < kSlots; stride *= 2) {
#pragma unroll
      for (int q = 0; q + stride < kSlots; q += 2 * stride) {
        const bool right = key[q + stride] > key[q];
        key[q] = right ? key[q + stride] : key[q];
        at[q] = right ? at[q + stride] : at[q];
      }
    }
    const uint32_t best = key[0];
    const uint32_t top = __reduce_max_sync(kFull, best);
    const uint32_t m = __reduce_min_sync(kFull, best == top ? at[0] : kFull);
    // nothing finite left: -inf (or only processed slots), +inf or NaN at
    // the top; tested after m, so that the test waits beside the second
    // reduction
    if (top <= kKeyNegInf || top >= kKeyPosInf) break;
    open &= ~(static_cast<uint32_t>(lane == static_cast<int>(m % kWarp)) << (m / kWarp));
    const float* row = col + m * k;  // a slot past k reads past the row and discards it
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const float decayed = __fmul_rn(s[q], row[q * kWarp]);
      s[q] = ((open >> q) & 1u) ? decayed : s[q];
    }
  }
}

// grid (batch * kCluster) in clusters of kCluster blocks, one cluster per
// frame; block min(1024, 32 k) threads; k <= 32 kSlots. Gaussian soft-NMS in
// slot order: repeatedly select the highest unprocessed score, freeze it,
// and decay every other unprocessed score by expf(-(iou * iou) * inv_sigma).
// Writes the final scores (0 for invalid slots) and surv = valid & score >
// score_thresh. Dynamic shared memory: soft_nms_matrix_smem(k) in every block
// of the cluster; the matrix is built in the first block's.
template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads)
    soft_nms_matrix_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                           const uint8_t* __restrict__ valid, float* __restrict__ out_scores,
                           uint8_t* __restrict__ surv, int32_t k, float inv_sigma,
                           float score_thresh) {
  // The matrix comes first: the last row's reads past k land in the valid
  // words behind it, inside the block's shared memory.
  extern __shared__ float4 smem4[];
  float* decay = reinterpret_cast<float*>(smem4);                        // k x k
  uint32_t* svbits = reinterpret_cast<uint32_t*>(smem4 + matrix_float4s(k));  // kMaxWords
  float4* sbox = reinterpret_cast<float4*>(svbits + kMaxWords);          // k boxes
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  float* lead_decay = cluster.map_shared_rank(decay, 0);
  const int64_t f = blockIdx.x / blocks;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  PHASE_STAMP(0)
  load_frame(boxes, valid, f, k, sbox, nullptr, svbits);
  cluster.sync();  // every block of the cluster runs
  PHASE_STAMP(1)

  // phase 1: one warp per row m, the pairs m < j, the rows dealt to the
  // cluster's warps back and forth; the matrix is built in the first
  // block's shared memory. Boxes that do not overlap have an IoU of exactly
  // 0 and the decay d0.
  const float d0 = decay_factor(0.0f, inv_sigma);
  const int all_warps = blocks * (blockDim.x / kWarp);
  const int g = rank * (blockDim.x / kWarp) + warp;
  for (int t = 0; t * all_warps < k; ++t) {
    const int m = t * all_warps + (t % 2 == 0 ? g : all_warps - 1 - g);
    if (m >= k || !bit_of(svbits, m)) continue;  // never selected, never decayed
    const Extent bm = extent_of(as_box(sbox[m]));
    for (int j = m + 1 + lane; j < k; j += kWarp) {
      if (!bit_of(svbits, j)) continue;
      const Extent bj = extent_of(as_box(sbox[j]));
      const float inter = intersection(bm, bj);
      const float d = inter > 0.0f ? decay_factor(iou_given(bm, bj, inter), inv_sigma) : d0;
      lead_decay[m * k + j] = d;
      lead_decay[j * k + m] = d;
    }
  }
  cluster.sync();
  PHASE_STAMP(2)
  if (rank != 0 || warp != 0) return;

  // phase 2: one warp; lane holds slots lane + 32 q
  float s[kSlots];
  uint32_t valid_bits = 0;  // bit q: slot lane + 32 q is valid
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    const bool v = j < k && bit_of(svbits, j);
    s[q] = v ? scores[f * k + j] : -INFINITY;
    valid_bits |= static_cast<uint32_t>(v) << q;
  }
  soft_nms_steps<kSlots>(s, valid_bits, decay, k, lane);
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    if (j < k) {
      const bool v = (valid_bits >> q) & 1u;
      const float out = v ? s[q] : 0.0f;
      out_scores[f * k + j] = out;
      surv[f * k + j] = v && out > score_thresh;
    }
  }
  PHASE_STAMP(3)
}

// grid (batch), block >= k threads, k <= 1024: the block design for a K whose
// decay matrix does not fit. Thread j owns slot j; each step is a block
// argmax and a recomputed IoU.
__global__ void soft_nms_block_kernel(const float* __restrict__ boxes,
                                      const float* __restrict__ scores,
                                      const uint8_t* __restrict__ valid,
                                      float* __restrict__ out_scores,
                                      uint8_t* __restrict__ surv, int32_t k, float inv_sigma,
                                      float score_thresh) {
  extern __shared__ float4 sbox[];
  __shared__ float wv[kMaxWarps];
  __shared__ int wi[kMaxWarps];
  __shared__ float rv;
  __shared__ int ri;
  const int64_t f = blockIdx.x;
  const int j = threadIdx.x;
  Box mine{0.0f, 0.0f, 0.0f, 0.0f};
  bool v = false;
  float s = -INFINITY;
  if (j < k) {
    mine = load_box(boxes + (f * k + j) * 4);
    sbox[j] = make_float4(mine.x, mine.y, mine.w, mine.h);
    v = valid[f * k + j] != 0;
    s = v ? scores[f * k + j] : -INFINITY;
  }
  bool processed = !v;  // threads past k never take part
  __syncthreads();
  for (int step = 0; step < k; ++step) {
    float best;
    int m;
    block_argmax(processed ? -INFINITY : s, j, wv, wi, &rv, &ri, best, m);
    if (!isfinite(best)) break;  // nothing left: no later step changes anything
    if (!processed && j != m) {
      s = __fmul_rn(s, decay_factor(iou_xywh(as_box(sbox[m]), mine), inv_sigma));
    }
    if (j == m) processed = true;
  }
  if (j < k) {
    const float out = v ? s : 0.0f;
    out_scores[f * k + j] = out;
    surv[f * k + j] = v && out > score_thresh;
  }
}

// grid (batch * kCluster) in clusters of kCluster blocks, one cluster per
// frame; block match_threads(ky) threads; ks <= 32 kSlots. YOLO
// rows scanned in order; row i claims the unmatched SFA box with the
// largest IoU (first index on ties) when that IoU is >= thr and > 0.
// Dynamic shared memory: greedy_match_matrix_smem(ky, kSlots) in every
// block; the keys, list and flags are built in the first block's, through
// distributed shared memory.
template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads)
    greedy_match_kernel(const float* __restrict__ yolo_boxes,
                        const uint8_t* __restrict__ yolo_valid,
                        const float* __restrict__ sfa_boxes,
                        const uint8_t* __restrict__ sfa_valid, int32_t* __restrict__ match_idx,
                        uint8_t* __restrict__ sfa_matched, int32_t ky, int32_t ks, float thr) {
  constexpr int kRow = kSlots * kWarp;  // keys per row: columns past ks hold 0
  extern __shared__ float4 smem4[];
  uint32_t* skeys = reinterpret_cast<uint32_t*>(smem4);                 // ky x kRow keys
  int16_t* slist = reinterpret_cast<int16_t*>(skeys + ky * kRow);        // candidate rows
  int16_t* sres = slist + ky;                                           // their matches
  uint8_t* scand = reinterpret_cast<uint8_t*>(sres + ky);                // row i is a candidate
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  uint32_t* lead_keys = cluster.map_shared_rank(skeys, 0);
  uint8_t* lead_cand = cluster.map_shared_rank(scand, 0);
  const int64_t f = blockIdx.x / blocks;
  PHASE_STAMP(0)
  // the lane's SFA columns j = lane + 32 q as extents (invalid ones and
  // those past ks never overlap: their bit of col_ok is 0)
  Extent col[kSlots];
  uint32_t col_ok = 0;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    col[q] = Extent{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (j < ks) {
      col[q] = extent_of(load_box(sfa_boxes + (f * ks + j) * 4));
      col_ok |= static_cast<uint32_t>(sfa_valid[f * ks + j] != 0) << q;
    }
  }
  cluster.sync();  // every block runs before any writes into the first block
  PHASE_STAMP(1)

  // phase 1: one warp per YOLO row, the rows dealt round the cluster's
  // warps; a row with no candidate gets -1 here
  for (int i = rank * warps + warp; i < ky; i += blocks * warps) {
    uint32_t any = 0;
    if (yolo_valid[f * ky + i]) {  // the same branch for the whole warp
      const Extent row = extent_of(load_box(yolo_boxes + (f * ky + i) * 4));
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const float inter = intersection(row, col[q]);
        uint32_t key = 0;
        if (((col_ok >> q) & 1u) && inter > 0.0f) {
          const float v = iou_given(row, col[q], inter);
          key = v >= thr && v > 0.0f ? __float_as_uint(v) : 0u;
        }
        lead_keys[i * kRow + q * kWarp + lane] = key;
        any |= key;
      }
    }
    any = __any_sync(kFull, any != 0);
    if (lane == 0) {
      lead_cand[i] = any;
      if (!any) match_idx[f * ky + i] = -1;
    }
  }
  cluster.sync();
  if (rank != 0 || warp != 0) return;

  // the candidate rows in order: a ballot and a popcount prefix per 32 rows
  int n = 0;
  for (int w = 0; w * kWarp < ky; ++w) {
    const int i = w * kWarp + lane;
    const bool c = i < ky && scand[i];
    const uint32_t bits = __ballot_sync(kFull, c);
    if (c) slist[n + __popc(bits & ((1u << lane) - 1u))] = static_cast<int16_t>(i);
    n += __popc(bits);
  }
  __syncwarp();
  PHASE_STAMP(2)

  // phase 2: one warp walks the candidate rows; bit q of `matched`: column
  // lane + 32 q is taken. The next row's keys load during the step.
  uint32_t matched = 0;
  uint32_t next[kSlots];
  const uint32_t* keys_of_lane = skeys + lane;
  if (n > 0) {
    const uint32_t* row = keys_of_lane + slist[0] * kRow;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) next[q] = row[q * kWarp];
  }
  for (int t = 0; t < n; ++t) {
    uint32_t key[kSlots], at[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      key[q] = ((matched >> q) & 1u) ? 0u : next[q];
      at[q] = q * kWarp + lane;
    }
    if (t + 1 < n) {
      const uint32_t* row = keys_of_lane + slist[t + 1] * kRow;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) next[q] = row[q * kWarp];
    }
    // the lane's best column, as a tree: on ties the left one, of lower index
#pragma unroll
    for (int stride = 1; stride < kSlots; stride *= 2) {
#pragma unroll
      for (int q = 0; q + stride < kSlots; q += 2 * stride) {
        const bool right = key[q + stride] > key[q];
        key[q] = right ? key[q + stride] : key[q];
        at[q] = right ? at[q + stride] : at[q];
      }
    }
    const uint32_t top = __reduce_max_sync(kFull, key[0]);
    const uint32_t jm = __reduce_min_sync(kFull, key[0] == top ? at[0] : kFull);
    const bool ok = top != 0u;  // 0: every candidate of the row is taken
    matched |= static_cast<uint32_t>(ok && lane == static_cast<int>(jm % kWarp)) << (jm / kWarp);
    if (lane == 0) sres[t] = static_cast<int16_t>(ok ? static_cast<int>(jm) : -1);
  }
  __syncwarp();
  for (int t = lane; t < n; t += kWarp) match_idx[f * ky + slist[t]] = sres[t];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    if (j < ks) sfa_matched[f * ks + j] = (matched >> q) & 1u;
  }
  PHASE_STAMP(3)
}

// grid (batch), block >= max(ks, 32) threads, ky <= 1024: the block design
// for a shape whose key matrix does not fit. YOLO rows scanned in order,
// as above. The YOLO rows and their flags sit in shared memory, thread j
// owns SFA box j; each step recomputes a row of IoUs and takes a block
// argmax.
__global__ void greedy_match_block_kernel(const float* __restrict__ yolo_boxes,
                                          const uint8_t* __restrict__ yolo_valid,
                                          const float* __restrict__ sfa_boxes,
                                          const uint8_t* __restrict__ sfa_valid,
                                          int32_t* __restrict__ match_idx,
                                          uint8_t* __restrict__ sfa_matched, int32_t ky,
                                          int32_t ks, float thr) {
  extern __shared__ float4 sbox[];  // the frame's ky YOLO boxes
  __shared__ uint8_t svalid[kMaxThreads];
  __shared__ float wv[kMaxWarps];
  __shared__ int wi[kMaxWarps];
  __shared__ float rv;
  __shared__ int ri;
  const int64_t f = blockIdx.x;
  const int j = threadIdx.x;
  for (int q = j; q < ky; q += blockDim.x) {
    const Box b = load_box(yolo_boxes + (f * ky + q) * 4);
    sbox[q] = make_float4(b.x, b.y, b.w, b.h);
    svalid[q] = yolo_valid[f * ky + q];
  }
  Box mine{0.0f, 0.0f, 0.0f, 0.0f};
  bool sv = false;
  if (j < ks) {
    mine = load_box(sfa_boxes + (f * ks + j) * 4);
    sv = sfa_valid[f * ks + j] != 0;
  }
  __syncthreads();
  bool matched = false;
  for (int i = 0; i < ky; ++i) {
    if (!svalid[i]) {  // a row of -1: no match; the same branch for every thread
      if (j == 0) match_idx[f * ky + i] = -1;
      continue;
    }
    float r = -INFINITY;  // threads past ks never win
    if (j < ks) {
      r = sv && !matched ? iou_xywh(as_box(sbox[i]), mine) : -1.0f;
    }
    float best;
    int jm;
    block_argmax(r, j, wv, wi, &rv, &ri, best, jm);
    const bool ok = best >= thr && best > 0.0f;
    if (j == 0) match_idx[f * ky + i] = ok ? jm : -1;
    if (j == jm && ok) matched = true;
  }
  if (j < ks) sfa_matched[f * ks + j] = matched;
}

int threads_for(int32_t n) {
  const int t = (n + kWarp - 1) / kWarp * kWarp;
  return t < kWarp ? kWarp : t;
}

// One warp per row in phase 1, at most 1024 threads.
int phase_threads(int32_t k) { return k >= kMaxWarps ? kMaxThreads : k * kWarp; }

size_t hard_nms_smem(int32_t k) {
  const size_t rows = (static_cast<size_t>(k) + kWarp - 1) / kWarp * kWarp;
  return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float)) + kMaxWords * 4 + rows * 4 +
         rows * kMaxWords * 4;
}

size_t soft_nms_matrix_smem(int32_t k) {
  return static_cast<size_t>(matrix_float4s(k)) * sizeof(float4) + kMaxWords * 4 +
         static_cast<size_t>(k) * sizeof(float4);
}

// Per YOLO row: 32 kSlots keys, its place in the candidate list, its
// result (both int16) and its flag.
size_t greedy_match_matrix_smem(int32_t ky, int slots) {
  return static_cast<size_t>(ky) * (kWarp * 4 * slots + 5);
}

// One warp per YOLO row of the block's share in phase 1, at least one warp.
int match_threads(int32_t ky) {
  const int rows = (ky + kCluster - 1) / kCluster;
  return rows >= kMaxWarps ? kMaxThreads : (rows < 1 ? kWarp : rows * kWarp);
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

// Launches `kernel` on `batch` clusters of kCluster blocks (one cluster per
// frame), each block with `threads` threads and `smem` bytes of dynamic
// shared memory, allowing more than the default 48 KB first.
template <typename... Params, typename... Args>
cudaError_t launch_in_clusters(void (*kernel)(Params...), int64_t batch, int threads, size_t smem,
                               void* stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(batch * kCluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int kSlots>
cudaError_t launch_soft_matrix(const void* boxes, const void* scores, const void* valid,
                               void* out_scores, void* surv, int64_t batch, int32_t k,
                               float inv_sigma, float score_thresh, void* stream) {
  return launch_in_clusters(soft_nms_matrix_kernel<kSlots>, batch, phase_threads(k),
                            soft_nms_matrix_smem(k), stream, static_cast<const float*>(boxes),
                            static_cast<const float*>(scores), static_cast<const uint8_t*>(valid),
                            static_cast<float*>(out_scores), static_cast<uint8_t*>(surv), k,
                            inv_sigma, score_thresh);
}

template <int kSlots>
cudaError_t launch_match_matrix(const void* yolo_boxes, const void* yolo_valid,
                                const void* sfa_boxes, const void* sfa_valid, void* match_idx,
                                void* sfa_matched, int64_t batch, int32_t ky, int32_t ks,
                                float thr, void* stream) {
  return launch_in_clusters(
      greedy_match_kernel<kSlots>, batch, match_threads(ky), greedy_match_matrix_smem(ky, kSlots),
      stream, static_cast<const float*>(yolo_boxes), static_cast<const uint8_t*>(yolo_valid),
      static_cast<const float*>(sfa_boxes), static_cast<const uint8_t*>(sfa_valid),
      static_cast<int32_t*>(match_idx), static_cast<uint8_t*>(sfa_matched), ky, ks, thr);
}

}  // namespace

#ifdef FUSION_LOOPS_PHASE_STAMPS
// Copies the first n phase stamps (4 per block) to `out` on the host.
extern "C" int fusion_phase_stamps(long long* out, int32_t n) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_stamps, n * sizeof(long long)));
}
#endif

// The most dynamic shared memory one block may opt in to on `device`.
extern "C" int fusion_smem_limit(int32_t device, int32_t* bytes) {
  int v = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *bytes = v;
  return static_cast<int>(err);
}

// boxes (batch, k, 4) float32, valid (batch, k) bool -> keep (batch, k)
// bool; all contiguous on `device`; 1 <= k <= 1024, batch >= 1.
extern "C" int hard_nms_keep_cuda(const void* boxes, const void* valid, void* keep, int64_t batch,
                                  int32_t k, float thr, int32_t device, void* stream) {
  return on_device(device, [&] {
    return launch_in_clusters(hard_nms_keep_kernel, batch, phase_threads(k), hard_nms_smem(k),
                              stream, static_cast<const float*>(boxes),
                              static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k,
                              thr);
  });
}

// The matrix design. boxes (batch, k, 4), scores (batch, k) float32, valid
// (batch, k) bool -> out_scores (batch, k) float32, surv (batch, k) bool;
// 1 <= k <= 256 and soft_nms_matrix_smem(k) within the block's limit (the
// wrapper's soft_nms_matrix_slots).
extern "C" int soft_nms_gaussian_cuda(const void* boxes, const void* scores, const void* valid,
                                      void* out_scores, void* surv, int64_t batch, int32_t k,
                                      float inv_sigma, float score_thresh, int32_t device,
                                      void* stream) {
  return on_device(device, [&] {
    switch ((k + kWarp - 1) / kWarp) {
#define SOFT_NMS_CASE(n) \
  case n:                \
    return launch_soft_matrix<n>(boxes, scores, valid, out_scores, surv, batch, k, inv_sigma, \
                                 score_thresh, stream);
      SOFT_NMS_CASE(1)
      SOFT_NMS_CASE(2)
      SOFT_NMS_CASE(3)
      SOFT_NMS_CASE(4)
      SOFT_NMS_CASE(5)
      SOFT_NMS_CASE(6)
      SOFT_NMS_CASE(7)
      SOFT_NMS_CASE(8)
#undef SOFT_NMS_CASE
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// The block design, same arguments; 1 <= k <= 1024.
extern "C" int soft_nms_gaussian_block_cuda(const void* boxes, const void* scores,
                                            const void* valid, void* out_scores, void* surv,
                                            int64_t batch, int32_t k, float inv_sigma,
                                            float score_thresh, int32_t device, void* stream) {
  return on_device(device, [&] {
    soft_nms_block_kernel<<<static_cast<unsigned int>(batch), threads_for(k),
                            static_cast<size_t>(k) * sizeof(float4),
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out_scores),
        static_cast<uint8_t*>(surv), k, inv_sigma, score_thresh);
    return cudaSuccess;
  });
}

// The matrix design. yolo_boxes (batch, ky, 4), yolo_valid (batch, ky),
// sfa_boxes (batch, ks, 4), sfa_valid (batch, ks) -> match_idx (batch, ky)
// int32, sfa_matched (batch, ks) bool; 0 <= ky, 1 <= ks <= 256 and
// greedy_match_matrix_smem(ky, ceil(ks / 32)) within the block's limit (the
// wrapper's greedy_match_matrix_rows).
extern "C" int greedy_match_cuda(const void* yolo_boxes, const void* yolo_valid,
                                 const void* sfa_boxes, const void* sfa_valid, void* match_idx,
                                 void* sfa_matched, int64_t batch, int32_t ky, int32_t ks,
                                 float thr, int32_t device, void* stream) {
  return on_device(device, [&] {
    switch ((ks + kWarp - 1) / kWarp) {
#define MATCH_CASE(n)                                                                        \
  case n:                                                                                    \
    return launch_match_matrix<n>(yolo_boxes, yolo_valid, sfa_boxes, sfa_valid, match_idx, \
                                  sfa_matched, batch, ky, ks, thr, stream);
      MATCH_CASE(1)
      MATCH_CASE(2)
      MATCH_CASE(3)
      MATCH_CASE(4)
      MATCH_CASE(5)
      MATCH_CASE(6)
      MATCH_CASE(7)
      MATCH_CASE(8)
#undef MATCH_CASE
      default:
        return cudaErrorInvalidValue;
    }
  });
}

// The block design, same arguments; 0 <= ky <= 1024, 1 <= ks <= 1024.
extern "C" int greedy_match_block_cuda(const void* yolo_boxes, const void* yolo_valid,
                                       const void* sfa_boxes, const void* sfa_valid,
                                       void* match_idx, void* sfa_matched, int64_t batch,
                                       int32_t ky, int32_t ks, float thr, int32_t device,
                                       void* stream) {
  return on_device(device, [&] {
    greedy_match_block_kernel<<<static_cast<unsigned int>(batch), threads_for(ks),
                                static_cast<size_t>(ky) * sizeof(float4),
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(yolo_boxes), static_cast<const uint8_t*>(yolo_valid),
        static_cast<const float*>(sfa_boxes), static_cast<const uint8_t*>(sfa_valid),
        static_cast<int32_t*>(match_idx), static_cast<uint8_t*>(sfa_matched), ky, ks, thr);
    return cudaSuccess;
  });
}
