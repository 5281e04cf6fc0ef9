"""The design of the three loop kernels of `csrc/fusion_loops.cu`, checked on
the CPU. A CUDA kernel cannot run here, so numpy models repeat each kernel's
phases step for step: hard NMS as a packed uint32 suppression bitmask
(forward removal) and a scan that keeps one word of the removed set per
lane; soft-NMS as a precomputed decay matrix (each pair computed once and
mirrored) and a step loop over ordered 32-bit keys; the match as a matrix of
candidate keys (an IoU's float bits, or 0), the list of rows that hold a
candidate, and a one-warp chain over those rows only. Each model must give
exactly what the plain PyTorch version gives (the version `chip_smoke.py`
holds the kernels against on the card) and what the JAX package gives. The
NMS models rest on the IoU being symmetric bit for bit, which is pinned
first; the match rests on argmax over candidate keys being the plain step,
which is pinned beside its model."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sfa3d_tpu.fusion import fuse as jfuse
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
# the greedy match: candidate keys + a one-warp chain over candidate rows
# ---------------------------------------------------------------------------

def _candidate_keys(iou, pair_valid, thr):
    """The kernel's phase-1 key of each pair: the IoU's float bits when the
    pair is valid and the IoU is > 0 and >= thr, else 0."""
    cand = pair_valid & (iou > 0) & (iou >= np.float32(thr))
    return np.where(cand, iou.astype(np.float32).view(np.uint32), np.uint32(0)).astype(np.uint32)


def _reference_step(iou, pair_valid, matched, thr):
    """One step of the plain version on (N, Ks) rows: argmax over the row
    with invalid pairs and matched columns at -1, accepted when the value
    is >= thr and > 0. -> (N,) int, -1 for no match."""
    row = np.where(pair_valid & ~matched, iou, np.float32(-1.0))
    j = np.argmax(row, axis=1)
    best = row[np.arange(len(row)), j]
    return np.where((best >= np.float32(thr)) & (best > 0), j, -1)


def _key_step(keys, matched):
    """The chain's step on (N, Ks) keys: matched columns keyed 0, the largest
    key and the lowest column holding it, -1 when the largest key is 0."""
    k = np.where(matched, np.uint32(0), keys)
    top = k.max(axis=1)
    j = np.argmax(k == top[:, None], axis=1)
    return np.where(top != 0, j, -1)


def greedy_match_kernel_model(yolo, yolo_valid, sfa, sfa_valid, thr):
    """greedy_match_kernel in numpy: (B, Ky, 4) + (B, Ky), (B, Ks, 4) + (B, Ks)
    -> (match_idx (B, Ky) int32, sfa_matched (B, Ks), candidate rows (B,))."""
    b, ky = yolo_valid.shape
    ks = sfa_valid.shape[1]
    slots = -(-ks // 32)
    cols = LANES.astype(np.int64)[:, None] + 32 * np.arange(slots)[None, :]  # (lane, q) -> column
    iou = pairwise_iou_xywh(T(yolo), T(sfa)).numpy()
    match_idx = np.full((b, ky), -1, np.int32)
    sfa_matched = np.zeros((b, ks), bool)
    n_cand = np.zeros(b, np.int64)
    for f in range(b):
        # phase 1: rows of 32 * slots keys, 0 past ks; a row's flag
        keys = np.zeros((ky, 32 * slots), np.uint32)
        keys[:, :ks] = _candidate_keys(iou[f], yolo_valid[f][:, None] & sfa_valid[f][None, :], thr)
        flag = np.zeros(32 * -(-ky // 32), bool)
        flag[:ky] = keys.any(axis=1)
        # the candidate rows in order: a ballot and a popcount prefix per 32 rows
        rows, n = np.zeros(ky, np.int64), 0
        for w, bits in enumerate(_pack(flag)):
            for lane in np.flatnonzero(flag[32 * w: 32 * w + 32]):
                rows[n + bin(int(bits) & ((1 << int(lane)) - 1)).count("1")] = 32 * w + lane
            n += bin(int(bits)).count("1")
        n_cand[f] = n
        # phase 2: lane l holds columns l + 32 q; bit q of matched[l]
        matched = np.zeros(32, np.uint32)
        for i in rows[:n]:
            taken = (matched[:, None] >> np.arange(slots, dtype=np.uint32)) & 1
            key = np.where(taken.astype(bool), np.uint32(0), keys[i][cols])
            at = cols.astype(np.uint32)
            stride = 1
            while stride < slots:  # the lane's best as a tree, the left one on ties
                for q in range(0, slots - stride, 2 * stride):
                    right = key[:, q + stride] > key[:, q]
                    key[:, q] = np.where(right, key[:, q + stride], key[:, q])
                    at[:, q] = np.where(right, at[:, q + stride], at[:, q])
                stride *= 2
            top = key[:, 0].max()  # __reduce_max_sync
            jm = int(np.where(key[:, 0] == top, at[:, 0], np.uint32(0xFFFFFFFF)).min())  # __reduce_min_sync
            if top != 0:
                matched[jm % 32] |= np.uint32(1 << (jm // 32))
                match_idx[f, i] = jm
        j = np.arange(ks)
        sfa_matched[f] = (matched[j % 32] >> (j // 32).astype(np.uint32)) & 1
    return match_idx, sfa_matched, n_cand


def _match_case(name, b=2):
    """(yolo, yolo_valid, sfa, sfa_valid, thr) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ky, ks = {"ky0": (0, 50), "ks1": (64, 1), "ks_cap": (70, 256)}.get(name, (64, 50))
    thr = {"served_thr05": 0.5, "touching_thr0": 0.0, "thr_above_1": 1.5}.get(name, 0.7)
    if name == "ties_grid":  # grid boxes, SFA columns duplicated: tied IoUs
        yolo = _boxes(rng, b, ky, "grid")
        sfa = yolo[:, :ks].copy()
        sfa[:, 1::2] = sfa[:, ::2]
        thr = 0.3
    else:
        yolo = _boxes(rng, b, ky, "random")
        sfa = yolo[:, rng.integers(0, max(ky, 1), ks) % max(ky, 1)] if ky else _boxes(rng, b, ks, "random")
        sfa = (sfa + rng.normal(0, 2, sfa.shape)).astype(np.float32)
    yv, sv = rng.random((b, ky)) < 0.8, rng.random((b, ks)) < 0.8
    if name == "every_row":  # every YOLO row a candidate, many competing for one box
        sfa = np.repeat(yolo[:, :ks:5], 5, axis=1)[:, :ks].copy()
        yolo = sfa[:, np.arange(ky) % ks] + np.float32(0.5)
        yv[:], sv[:] = True, True
        thr = 0.5
    if name == "no_candidates":
        sfa[..., 0] += np.float32(5000.0)
    if name == "all_invalid":
        yv[0], sv[1] = False, False
    if name == "touching_thr0":  # half the SFA boxes touch a YOLO box's right edge: IoU exactly 0
        half = ks // 2
        sfa[:, :half, 0] = yolo[:, :half, 0] + yolo[:, :half, 2]
        sfa[:, :half, 1] = yolo[:, :half, 1]
    return yolo, yv, sfa, sv, thr


MATCH_CASES = ["served", "served_thr05", "ties_grid", "every_row", "no_candidates", "all_invalid",
               "touching_thr0", "thr_above_1", "ky0", "ks1", "ks_cap"]


@pytest.mark.parametrize("name", MATCH_CASES)
def test_greedy_match_key_matrix_model(name):
    yolo, yv, sfa, sv, thr = _match_case(name)
    idx, matched, n_cand = greedy_match_kernel_model(yolo, yv, sfa, sv, thr)
    want_idx, want_m = (t.numpy() for t in fusion_loops.greedy_match_plain(T(yolo), T(yv), T(sfa), T(sv), thr))
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(matched, want_m)
    ky, ks = yv.shape[1], sv.shape[1]
    for f in range(len(yolo) if ky else 0):  # JAX's loop body cannot index a (0, Ks) matrix
        zeros = np.zeros(ky, np.float32)
        j_idx, j_m = (np.asarray(t) for t in jfuse.greedy_match(
            jfuse.DetectionSet(yolo[f], zeros, zeros.astype(np.int32), yv[f]),
            jfuse.DetectionSet(sfa[f], np.zeros(ks, np.float32), np.zeros(ks, np.int32), sv[f]), thr))
        np.testing.assert_array_equal(idx[f], j_idx)
        np.testing.assert_array_equal(matched[f], j_m)
    np.testing.assert_array_equal(
        n_cand, fusion_loops.greedy_match_candidate_rows(T(yolo), T(yv), T(sfa), T(sv), thr).numpy())
    assert (n_cand <= yv.sum(1)).all()
    if name in ("no_candidates", "thr_above_1", "ky0"):
        assert not n_cand.any() and (idx == -1).all() and not matched.any()
    elif name == "every_row":
        assert (n_cand == ky).all() and (idx == -1).any(), "every row a candidate, some left unmatched"
    elif name == "all_invalid":
        assert n_cand[0] == 0 and (idx[0] == -1).all() and not matched[1].any()
    else:
        assert (idx >= 0).any(), "no match: vacuous"
        if name.startswith("served"):
            assert (n_cand < yv.sum(1)).all(), "every valid row a candidate: the chain is not shortened"
    if name == "touching_thr0":
        iou = pairwise_iou_xywh(T(yolo), T(sfa)).numpy()
        touching = np.arange(ks) < ks // 2
        assert (iou[:, :ks // 2, :ks // 2][:, np.eye(ks // 2, dtype=bool)] == 0).all()
        assert (yv[:, :, None] & sv[:, None, :] & (iou == 0) & touching).any()
    if name == "ties_grid":
        iou = pairwise_iou_xywh(T(yolo), T(sfa)).numpy()
        assert (iou[:, :, 0::2][..., :ks // 2] == iou[:, :, 1::2][..., :ks // 2]).all()


@pytest.mark.parametrize("thr", [-0.5, 0.0, 0.25, 0.5, 0.7, 1.0, 1.5, np.nan])
def test_argmax_over_candidate_keys_is_the_plain_step(thr):
    """The exactness argument of the match's key matrix: on rows with heavy
    ties, random valid pairs and random matched columns, the chain's step
    (argmax over keys, 0 unless a candidate) equals the plain step, for
    every threshold, none included (thr <= 0 still needs a positive IoU)."""
    rng = np.random.default_rng(11)
    n, ks = 4000, 40
    iou = rng.choice(np.float32([0.0, 0.25, 0.5, 0.7, 1.0]), (n, ks))
    iou = np.where(rng.random((n, ks)) < 0.3, rng.random((n, ks)).astype(np.float32), iou)
    pair_valid = rng.random((n, ks)) < rng.random((n, 1))
    matched = rng.random((n, ks)) < rng.random((n, 1))
    want = _reference_step(iou, pair_valid, matched, thr)
    got = _key_step(_candidate_keys(iou, pair_valid, thr), matched)
    np.testing.assert_array_equal(got, want)
    if thr <= 0.7:
        assert (want >= 0).sum() > n // 10 and (want == -1).sum() > 0


def test_greedy_match_matrix_rows_follow_the_shared_memory():
    assert fusion_loops.greedy_match_matrix_smem(64, 50) == 16704  # the served shape
    assert fusion_loops.greedy_match_matrix_rows(50, 232448) == 890  # an H100
    assert fusion_loops.greedy_match_matrix_rows(256, 232448) == 225
    assert fusion_loops.greedy_match_matrix_rows(32, 232448) == fusion_loops.MAX_SLOTS
    assert fusion_loops.greedy_match_matrix_rows(32 * fusion_loops.MATRIX_SLOTS_PER_LANE + 1, 10**9) == 0
    for ks in (1, 50, 200, 256):
        for limit in (49152, 232448):
            ky = fusion_loops.greedy_match_matrix_rows(ks, limit)
            assert fusion_loops.greedy_match_matrix_smem(ky, ks) <= limit
            assert ky == fusion_loops.MAX_SLOTS or fusion_loops.greedy_match_matrix_smem(ky + 1, ks) > limit


# ---------------------------------------------------------------------------
# the wrappers pick the soft-NMS design by K, the match's by shape
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
    monkeypatch.setattr(fusion_loops, "_smem_limits", {})
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


@pytest.mark.parametrize("ky,ks,limit,symbol", [
    (64, 50, 232448, "greedy_match_cuda"), (0, 1, 232448, "greedy_match_cuda"),
    (890, 50, 232448, "greedy_match_cuda"), (891, 50, 232448, "greedy_match_block_cuda"),
    (225, 256, 232448, "greedy_match_cuda"), (226, 256, 232448, "greedy_match_block_cuda"),
    (8, 257, 232448, "greedy_match_block_cuda"), (1024, 1024, 232448, "greedy_match_block_cuda"),
    (61, 50, 16000, "greedy_match_cuda"), (62, 50, 16000, "greedy_match_block_cuda")])
def test_greedy_match_wrapper_picks_the_design_by_shape(monkeypatch, ky, ks, limit, symbol):
    """Ky up to greedy_match_matrix_rows(Ks) of the card's shared memory
    launches the key-matrix kernel, a larger Ky or Ks the block kernel; both
    count one launch."""
    called = []

    def smem_limit(device, out):
        out._obj.value = limit
        return 0

    def launcher(name):
        def launch(*args):
            called.append((name, args[6], args[7], args[8]))  # batch, ky, ks
            return 0
        return launch

    fake = SimpleNamespace(fusion_smem_limit=smem_limit,
                           greedy_match_cuda=launcher("greedy_match_cuda"),
                           greedy_match_block_cuda=launcher("greedy_match_block_cuda"))
    monkeypatch.setattr(fusion_loops, "load_library", lambda name, signatures: fake)
    monkeypatch.setattr(fusion_loops, "_smem_limits", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    cuda = lambda t: torch.Tensor._make_subclass(_CudaTyped, t)  # noqa: E731
    before = fusion_loops.greedy_match.launches
    idx, matched = fusion_loops.greedy_match(
        cuda(torch.zeros((2, ky, 4))), cuda(torch.ones((2, ky), dtype=torch.bool)),
        cuda(torch.zeros((2, ks, 4))), cuda(torch.ones((2, ks), dtype=torch.bool)), 0.7)
    assert called == [(symbol, 2, ky, ks)]
    assert fusion_loops.greedy_match.launches == before + 1
    assert idx.shape == (2, ky) and idx.dtype == torch.int32 and matched.shape == (2, ks)
