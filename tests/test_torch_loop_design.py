"""The design of the two NMS kernels of `csrc/fusion_loops.cu`, checked on the
CPU. A CUDA kernel cannot run here, so numpy models repeat each kernel's
phases step for step: hard NMS as a packed uint32 suppression bitmask
(forward removal) and a scan that keeps one word of the removed set per
lane; soft-NMS as a precomputed decay matrix (each pair computed once and
mirrored) and a step loop over ordered 32-bit keys. Each model must give
exactly what the plain PyTorch version gives (the version `chip_smoke.py`
holds the kernels against on the card) and what the JAX package gives.
Both rest on the IoU being symmetric bit for bit, which is pinned first."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sfa3d_tpu.fusion import nms as jnms
from sfa3d_tpu_torch.fusion import nms
from sfa3d_tpu_torch.fusion.iou import pairwise_iou_xywh
from sfa3d_tpu_torch.ops import fusion_loops

# soft-NMS scores against JAX: XLA's exp and PyTorch's differ by an ulp or two,
# compounded over the decays (as in test_torch_fusion.py)
SOFT_NMS_RTOL = 1e-6
THR = 0.45
KEY_NEG_INF, KEY_POS_INF = 0x007FFFFF, 0xFF800000  # the kernel's keys of -inf, +inf
LANES = np.arange(32, dtype=np.uint32)
T = torch.from_numpy


def _boxes(rng, b, k, layout):
    if layout == "random":
        xy = rng.uniform(0, 200, (b, k, 2))
    else:  # a coarse grid: many overlaps, duplicates and exactly tied IoUs
        xy = rng.integers(0, 10, (b, k, 2)) * 10.0
    return np.concatenate([xy, rng.uniform(4, 60, (b, k, 2))], -1).astype(np.float32)


def _case(name, b, k, layout):
    """(boxes, scores, valid) of one named case, seeded by its name."""
    rng = np.random.default_rng(sum(map(ord, name)))
    boxes = _boxes(rng, b, k, layout)
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    valid = rng.random((b, k)) < 0.8
    if name == "equal_scores":
        scores[:] = 0.5
    if name == "all_invalid":
        valid[1] = False
    if name == "duplicates":  # IoU exactly 1
        boxes[:, 1::2] = boxes[:, ::2][:, : k // 2]
    if name.startswith("select_candidates"):  # the YOLO NMS: class-offset boxes
        boxes[..., :2] += rng.integers(0, 3, (b, k, 1)).astype(np.float32) * 4096.0
    if name == "signed_scores":  # negative scores, +0 and -0: ties between the zeros
        scores = rng.choice(np.float32([-0.5, -0.0, 0.0, 0.25, 0.5]), (b, k))
    if name == "zero_scores":  # +0 ties with a processed slot on the unsigned path
        scores = rng.choice(np.float32([0.0, 0.25, 0.5]), (b, k))
    if name.startswith("chain"):  # each box overlaps the next (IoU 7/13) but not the one after
        start = int(name[len("chain"):] or 0)
        x = 3.0 * np.maximum(np.arange(k) - start, 0) + 1000.0 * (np.arange(k) < start)
        boxes = np.broadcast_to(np.stack([x, np.zeros(k), np.full(k, 10.0), np.full(k, 10.0)], -1),
                                (b, k, 4)).astype(np.float32).copy()
        scores = np.broadcast_to(np.linspace(1, 0.5, k), (b, k)).astype(np.float32).copy()
        valid[:] = True
    return boxes, scores, valid


def _pack(bits):
    """(..., 32 n) bool -> (..., n) uint32, bit b of word w = element 32 w + b."""
    return np.packbits(bits, axis=-1, bitorder="little").view("<u4")


def _sorted(boxes, scores, valid):
    order = np.argsort(np.where(valid, -scores, np.inf), axis=1, kind="stable")
    return np.take_along_axis(boxes, order[..., None], 1), np.take_along_axis(valid, order, 1), order


# ---------------------------------------------------------------------------
# the IoU is symmetric
# ---------------------------------------------------------------------------

def _iou_pair(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    a, b = _boxes(rng, 1, 120, "random")[0], _boxes(rng, 1, 90, "grid")[0]
    if name == "grid":
        a = _boxes(rng, 1, 120, "grid")[0]
    if name == "duplicates":
        b[:40] = a[:40]
    if name == "zero_area":
        a[:30, 2] = 0.0
        b[:30, 3] = 0.0
        b[30:40, 2:] = 0.0
    if name == "touching_edges":  # b's left edge on a's right edge, b's top on a's bottom
        b[:45, 0] = a[:45, 0] + a[:45, 2]
        b[45:, 1] = a[45:90, 1] + a[45:90, 3]
    return a, b


@pytest.mark.parametrize("name", ["random", "grid", "duplicates", "zero_area", "touching_edges"])
def test_pairwise_iou_is_symmetric_bit_for_bit(name):
    """iou(a, b) == iou(b, a): the hard-NMS mask takes iou(later, earlier)
    as the plain version does, and the soft-NMS decay matrix computes each
    pair once for both orders."""
    a, b = _iou_pair(name)
    ab = pairwise_iou_xywh(T(a), T(b)).numpy()
    ba = pairwise_iou_xywh(T(b), T(a)).numpy()
    np.testing.assert_array_equal(ab, ba.T)
    q = ab * ab  # what the decay reads: a zero's sign drops out
    np.testing.assert_array_equal(q.view(np.uint32), (ba.T * ba.T).view(np.uint32))
    assert (ab > THR).any() or name == "zero_area"


# ---------------------------------------------------------------------------
# hard NMS: suppression bitmask + one-warp scan
# ---------------------------------------------------------------------------

def hard_nms_kernel_model(boxes, valid, thr):
    """hard_nms_keep_kernel in numpy: (B, K, 4) boxes in stable score order,
    (B, K) valid -> (B, K) keep."""
    b, k = valid.shape
    nw = -(-k // 32)
    pad = 32 * nw
    iou = pairwise_iou_xywh(T(boxes), T(boxes)).numpy()  # iou[f, later, earlier]
    keep = np.zeros((b, k), bool)
    for f in range(b):
        v = np.zeros(pad, bool)
        v[:k] = valid[f]
        vbits = _pack(v)
        # phase 1: row i (the earlier slot) has bit j set when the later slot
        # j is valid and iou(j, i) > thr; rows of invalid slots stay 0
        hit = np.zeros((pad, pad), bool)
        hit[:k, :k] = np.triu(np.ones((k, k), bool), 1) & (iou[f].T > thr)
        mask = _pack(hit & v[None, :] & v[:, None])  # (32 nw rows, nw words)
        # phase 2: lane w holds word w of the removed set
        removed = np.zeros(nw, np.uint32)
        kept_word = np.zeros(nw, np.uint32)
        for c in range(nw):
            rows = mask[32 * c: 32 * c + 32]
            diag = np.where((vbits[c] >> LANES) & 1, rows[:, c], 0).astype(np.uint32)
            r = int(removed[c])
            for bit in range(0, 32, 2):  # the chain of word c, two slots a step
                d0, d1 = int(diag[bit]), int(diag[bit + 1])
                both = d0 if (d0 >> (bit + 1)) & 1 else d0 | d1
                b_kept = d0 if r & (2 << bit) else both
                b_removed = 0 if r & (2 << bit) else d1
                r |= b_removed if r & (1 << bit) else b_kept
            r = np.uint32(r)
            kept_word[c] = vbits[c] & ~r
            kept_rows = rows[((kept_word[c] >> LANES) & 1).astype(bool)]
            removed |= np.bitwise_or.reduce(kept_rows, axis=0) if len(kept_rows) else np.uint32(0)
        keep[f] = np.unpackbits(kept_word.view(np.uint8), bitorder="little")[:k].astype(bool)
    return keep


HARD_CASES = [("random", 1, "random"), ("grid", 31, "grid"), ("grid", 32, "grid"),
              ("grid", 33, "grid"), ("random", 114, "random"), ("grid", 255, "grid"),
              ("select_candidates", 256, "grid"), ("select_candidates_1024", 1024, "grid"),
              ("all_invalid", 64, "grid"), ("equal_scores", 114, "grid"),
              ("duplicates", 50, "grid"), ("chain", 70, "grid"), ("chain1", 70, "grid")]


@pytest.mark.parametrize("name,k,layout", HARD_CASES, ids=[f"{c[0]}_{c[1]}" for c in HARD_CASES])
def test_hard_nms_bitmask_scan_model(name, k, layout):
    boxes, scores, valid = _case(name, 2, k, layout)
    sboxes, svalid, order = _sorted(boxes, scores, valid)
    keep = hard_nms_kernel_model(sboxes, svalid, THR)
    np.testing.assert_array_equal(keep, fusion_loops.hard_nms_keep_plain(T(sboxes), T(svalid), THR).numpy())
    in_input_order = np.zeros_like(keep)
    np.put_along_axis(in_input_order, order, keep, 1)
    np.testing.assert_array_equal(in_input_order, nms.hard_nms(T(boxes), T(scores), T(valid), THR).numpy())
    jhard = jax.jit(jnms.hard_nms)
    for f in range(len(boxes)):
        np.testing.assert_array_equal(in_input_order[f], np.asarray(jhard(boxes[f], scores[f], valid[f], THR)))
    if name == "all_invalid":
        assert not keep[1].any()
    if k >= 50 and name != "random":
        assert (svalid & ~keep).any(), "nothing suppressed: vacuous"
    if name.startswith("chain"):  # every other box of the chain survives
        start = int(name[len("chain"):] or 0)
        assert (keep[:, start:] == (np.arange(k - start) % 2 == 0)).all()


# ---------------------------------------------------------------------------
# soft-NMS: decay matrix + one-warp argmax chain
# ---------------------------------------------------------------------------

def _score_key(s):
    """The kernel's score_key: float order as uint32 order, -0 as +0, NaN as
    the largest."""
    bits = (s + np.float32(0.0)).view(np.uint32)
    key = np.where(bits >> 31, ~bits, bits | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(s), np.uint32(0xFFFFFFFF), key)


def soft_nms_kernel_model(boxes, scores, valid, sigma=0.5, score_thresh=0.001):
    """soft_nms_matrix_kernel in numpy: the decay matrix first (pairs m < j,
    mirrored), then the steps on score_key's keys (first index on ties),
    processed slots keyed 0."""
    b, k = valid.shape
    iou = pairwise_iou_xywh(T(boxes), T(boxes))
    decay = torch.exp(-(iou * iou) * fusion_loops.inv_sigma(sigma)).numpy()  # the libm the plain uses
    upper = np.triu(np.ones((k, k), bool), 1)
    decay = np.where(upper, decay, np.swapaxes(decay, 1, 2))
    out = np.zeros((b, k), np.float32)
    for f in range(b):
        s = np.where(valid[f], scores[f], -np.inf).astype(np.float32)
        open_ = valid[f].copy()
        for _ in range(k):
            keys = np.where(open_, _score_key(s), np.uint32(0))
            top = keys.max()
            if top <= KEY_NEG_INF or top >= KEY_POS_INF:
                break
            m = int(np.flatnonzero(keys == top)[0])
            upd = open_ & (np.arange(k) != m)
            s = np.where(upd, s * decay[f, m], s)
            open_[m] = False
        out[f] = np.where(valid[f], s, np.float32(0.0))
    return out, valid & (out > score_thresh)


SOFT_CASES = [("random", 1, "random"), ("grid", 33, "grid"), ("random", 114, "random"),
              ("grid", 239, "grid"), ("equal_scores", 114, "grid"), ("duplicates", 50, "grid"),
              ("all_invalid", 64, "grid"), ("signed_scores", 64, "grid"),
              ("zero_scores", 64, "grid")]


@pytest.mark.parametrize("name,k,layout", SOFT_CASES, ids=[f"{c[0]}_{c[1]}" for c in SOFT_CASES])
def test_soft_nms_decay_matrix_model(name, k, layout):
    boxes, scores, valid = _case(name, 2, k, layout)
    got_s, got_v = soft_nms_kernel_model(boxes, scores, valid)
    want_s, want_v = (t.numpy() for t in fusion_loops.soft_nms_gaussian_plain(T(boxes), T(scores), T(valid)))
    np.testing.assert_array_equal(got_s.view(np.uint32), want_s.view(np.uint32))
    np.testing.assert_array_equal(got_v, want_v)
    for f in range(len(boxes)):
        ws, wv = (np.asarray(t) for t in jnms.soft_nms_gaussian(boxes[f], scores[f], valid[f]))
        np.testing.assert_array_equal(got_v[f], wv)
        np.testing.assert_allclose(got_s[f], ws, rtol=SOFT_NMS_RTOL, atol=1e-12)
    if name == "all_invalid":
        assert not got_s[1].any()
    elif k > 1:
        assert ((got_s < scores) & valid & (scores > 0)).any(), "nothing decayed: vacuous"


def test_score_keys_order_as_the_floats_do():
    s = np.float32([-np.inf, -3.0, -1e-30, -0.0, 0.0, 1e-45, 0.5, 1.0, 3e38, np.inf])
    keys = _score_key(s)
    assert keys[0] == KEY_NEG_INF and keys[-1] == KEY_POS_INF
    assert keys[3] == keys[4]  # -0 and +0 tie: the first index wins, as in argmax
    assert (np.diff(keys[[0, 1, 2, 4, 5, 6, 7, 8, 9]].astype(np.int64)) > 0).all()
    assert _score_key(np.float32([np.nan]))[0] > KEY_POS_INF


# ---------------------------------------------------------------------------
# the wrapper picks the soft-NMS design by K
# ---------------------------------------------------------------------------

class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the launch path."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_soft_nms_matrix_slots_follow_the_shared_memory():
    assert fusion_loops.soft_nms_matrix_slots(232448) == 239  # an H100
    assert fusion_loops.soft_nms_matrix_slots(49152) == 108  # 48 KB
    assert fusion_loops.soft_nms_matrix_slots(10**9) == 32 * fusion_loops.MATRIX_SLOTS_PER_LANE
    assert fusion_loops.soft_nms_matrix_slots(100) == 0
    assert fusion_loops.soft_nms_matrix_smem(114) == 53936  # the served K
    assert fusion_loops.soft_nms_matrix_smem(239) == 232448
    for limit in (49152, 100000, 232448):
        k = fusion_loops.soft_nms_matrix_slots(limit)
        assert fusion_loops.soft_nms_matrix_smem(k) <= limit < fusion_loops.soft_nms_matrix_smem(k + 1)


@pytest.mark.parametrize("k,symbol", [(1, "soft_nms_gaussian_cuda"), (239, "soft_nms_gaussian_cuda"),
                                      (240, "soft_nms_gaussian_block_cuda"),
                                      (1024, "soft_nms_gaussian_block_cuda")])
def test_soft_nms_wrapper_picks_the_design_by_k(monkeypatch, k, symbol):
    """K up to soft_nms_matrix_slots of the card's shared memory launches the
    matrix kernel, a larger K the block kernel; both count one launch."""
    called = []

    def smem_limit(device, out):
        out._obj.value = 232448
        return 0

    def launcher(name):
        def launch(*args):
            called.append((name, args[5], args[6]))  # batch, k
            return 0
        return launch

    fake = SimpleNamespace(fusion_smem_limit=smem_limit,
                           soft_nms_gaussian_cuda=launcher("soft_nms_gaussian_cuda"),
                           soft_nms_gaussian_block_cuda=launcher("soft_nms_gaussian_block_cuda"))
    monkeypatch.setattr(fusion_loops, "load_library", lambda name, signatures: fake)
    monkeypatch.setattr(fusion_loops, "_matrix_slots", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    cuda = lambda t: torch.Tensor._make_subclass(_CudaTyped, t)  # noqa: E731
    before = fusion_loops.soft_nms_gaussian.launches
    fusion_loops.soft_nms_gaussian(cuda(torch.zeros((2, k, 4))), cuda(torch.zeros((2, k))),
                                   cuda(torch.ones((2, k), dtype=torch.bool)))
    assert called == [(symbol, 2, k)]
    assert fusion_loops.soft_nms_gaussian.launches == before + 1


def test_hard_nms_wrapper_takes_1024_slots(monkeypatch):
    called = []
    fake = SimpleNamespace(hard_nms_keep_cuda=lambda *args: called.append(args[4]) or 0)
    monkeypatch.setattr(fusion_loops, "load_library", lambda name, signatures: fake)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    cuda = lambda t: torch.Tensor._make_subclass(_CudaTyped, t)  # noqa: E731
    fusion_loops.hard_nms_keep(cuda(torch.zeros((1, 1024, 4))), cuda(torch.ones((1, 1024), dtype=torch.bool)), 0.5)
    assert called == [1024]
