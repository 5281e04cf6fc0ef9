"""The association kernel's matrix design (`csrc/track_associate.cu`)
modelled in numpy on the CPU, against the plain PyTorch loop
(`track_associate_plain`, itself held against JAX's `fori_loop` in
tests/test_torch_tracking.py): the order keys, the candidate-row screen,
the chain over candidate rows with used columns keyed as -1 and the warp's
two reductions; and the wrapper's choice of design by shape.

Everything here is exact: the kernel and the plain loop make the same
integer decisions, so any difference is a fault."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sfa3d_tpu_torch.ops import track_associate as ta
from sfa3d_tpu_torch.ops.track_associate import (
    track_associate_candidate_rows,
    track_associate_design,
    track_associate_matrix_smem,
    track_associate_plain,
)
from tests.test_torch_import import _CudaTyped
from tests.test_torch_tracking import _crafted_matrices

KEY_NAN = np.uint32(0xFFFFFFFF)
KEY_USED = np.uint32(0x407FFFFF)  # order_key(-1.0f)
H100_SMEM = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
IOU_MINS = [0.01, 0.0, -0.0, -1.0, -2.0, np.inf, -np.inf, np.nan]


def order_key(v) -> np.ndarray:
    """The kernel's order_key: NaN to the top key, -0 to +0's key, else the
    float bits with the sign bit set (>= +0) or all bits inverted (< 0)."""
    v = np.asarray(v, np.float32)
    with np.errstate(invalid="ignore"):
        b = (v + np.float32(0.0)).view(np.uint32)
    key = b ^ ((b.view(np.int32) >> 31).view(np.uint32) | np.uint32(0x80000000))
    return np.where(np.isnan(v), KEY_NAN, key).astype(np.uint32)


def matrix_design_model(iou: np.ndarray, order: np.ndarray, iou_min: float):
    """One frame through the matrix design as the kernel runs it: keys in
    rows of 32 ceil(T / 32) (padding 0), the screen, the candidate rows in
    score order, and per step lane l's columns l + 32 q, its largest key and
    lowest column holding it, the warp's top key and lowest such column.
    Returns (det_match, trk_used, chain steps)."""
    k, t = iou.shape
    slots = -(-t // 32)
    keys = np.zeros((k, 32 * slots), np.uint32)
    keys[:, :t] = order_key(iou)
    kmin = KEY_NAN if np.isnan(iou_min) else order_key(np.float32(iou_min))
    cand = ((keys >= kmin) & (keys != KEY_NAN)).any(1) | bool(np.float32(-1.0) >= np.float32(iou_min))
    det_match = np.full(k, -1, np.int32)
    used = np.zeros(32 * slots, bool)
    columns = np.arange(32 * slots, dtype=np.uint32).reshape(slots, 32)
    steps = [int(d) for d in order if cand[d]]
    for d in steps:
        lanes = np.where(used, KEY_USED, keys[d]).reshape(slots, 32)  # [q, lane]
        best = lanes.max(0)
        at = np.where(lanes == best, columns, KEY_NAN).min(0)
        top = best.max()
        jm = int(np.where(best == top, at, KEY_NAN).min())
        hit = top != KEY_NAN and top >= kmin
        used[jm] |= hit
        det_match[d] = jm if hit else -1
    return det_match, used[:t], len(steps)


def _random_cases():
    """Seeded inputs at the tracker's shapes: crowded (tied levels, -1 gates,
    a few columns every row's best) at (50, 64) and (50, 256), and sparse
    (most rows without a candidate) at (30, 100)."""
    rng = np.random.default_rng(17)
    cases = {}
    for name, (k, t, gate) in {"crowded_50x64": (50, 64, 0.4), "crowded_50x256": (50, 256, 0.4),
                               "sparse_30x100": (30, 100, 0.97)}.items():
        m = rng.uniform(0, 1, (k, t)).astype(np.float32)
        tie = rng.random((k, t)) < 0.3
        m[tie] = rng.choice(np.float32([0.0, 0.01, 0.25, 0.5, 0.9]), int(tie.sum()))
        m[rng.random((k, t)) < gate] = -1.0
        m[:, rng.integers(0, t, 3)] = np.float32(0.95)
        if name.startswith("sparse"):
            m[rng.random(k) < 0.6] = -1.0
        cases[name] = m
    return cases


def _all_cases():
    return {**_crafted_matrices(), **_random_cases()}


def test_order_key_is_argmax_order():
    """For every pair of special values: key(a) > key(b) exactly when a comes
    first in jnp.argmax's order (NaN of either sign above every number,
    -0 equal to +0), and equal keys exactly for equal values."""
    tiny = np.float32(1.4e-45)
    vals = np.float32([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 0.01, -0.01, 2.0, -2.0,
                       3.4e38, -3.4e38, 1.2e-38, -1.2e-38, np.nextafter(np.float32(1), np.float32(2)),
                       np.nextafter(np.float32(-1), np.float32(-2)), 0.5, -0.5])
    vals = np.concatenate([vals, [tiny, -tiny]])
    keys = order_key(vals)
    for a, ka in zip(vals, keys):
        for b, kb in zip(vals, keys):
            both_nan = np.isnan(a) and np.isnan(b)
            equal = both_nan or a == b
            first = (np.isnan(a) and not np.isnan(b)) or (not np.isnan(a) and not np.isnan(b) and a > b)
            assert (ka == kb) == equal, (a, b)
            assert (ka > kb) == first, (a, b)
    assert order_key(np.float32(-1.0)) == KEY_USED
    assert keys[~np.isnan(vals)].min() == order_key(-np.inf) > 0  # key 0 (padding) never wins


@pytest.mark.parametrize("iou_min", IOU_MINS, ids=str)
@pytest.mark.parametrize("name", sorted(_all_cases()))
def test_matrix_design_model_equals_plain(name, iou_min):
    """The kernel's matrix design, step for step in numpy, equals the plain
    loop on every crafted and seeded input at every threshold: the screen
    drops only steps that change nothing, and the keys' argmax with used
    columns keyed as -1 is the plain step's."""
    iou = _all_cases()[name]
    order = np.random.default_rng(23).permutation(iou.shape[0]).astype(np.int32)
    want = track_associate_plain(torch.from_numpy(iou)[None], torch.from_numpy(order)[None], float(iou_min))
    got_match, got_used, steps = matrix_design_model(iou, order, iou_min)
    np.testing.assert_array_equal(got_match, want[0][0].numpy())
    np.testing.assert_array_equal(got_used, want[1][0].numpy())
    assert steps == int(track_associate_candidate_rows(torch.from_numpy(iou)[None], float(iou_min)).sum())


@pytest.mark.parametrize("iou_min", [0.01, 0.0, -1.0, -2.0])
def test_rows_without_a_candidate_match_nothing(iou_min):
    """Every row that track_associate_candidate_rows leaves out gets -1 from
    the plain loop, in every frame of a batch of seeded inputs, and with
    iou_min <= -1 every row is a candidate."""
    rng = np.random.default_rng(29)
    iou = rng.choice(np.float32([-1.0, -1.0, -1.0, 0.005, 0.3, np.nan]), (6, 40, 64))
    iou[:, ::4] = -1.0  # rows that only a threshold <= -1 lets in
    order = np.stack([rng.permutation(40) for _ in range(6)]).astype(np.int32)
    iou_t, order_t = torch.from_numpy(iou), torch.from_numpy(order)
    cand = track_associate_candidate_rows(iou_t, iou_min)
    det_match, _ = track_associate_plain(iou_t, order_t, iou_min)
    assert (det_match[~cand] == -1).all()
    if iou_min <= -1.0:
        assert cand.all()
    else:
        assert 0 < int(cand.sum()) < cand.numel()


@pytest.mark.parametrize("k, t, limit, design", [
    (50, 64, H100_SMEM, "matrix"),  # the served shape
    (8, 1, H100_SMEM, "matrix"),
    (50, 256, H100_SMEM, "matrix"),
    (225, 256, H100_SMEM, "matrix"),  # the largest K that fits at T = 256
    (226, 256, H100_SMEM, "row"),
    (877, 64, H100_SMEM, "matrix"),
    (878, 64, H100_SMEM, "row"),
    (50, 257, H100_SMEM, "row"),  # past 8 columns a lane
    (50, 256, 48 * 1024, "row"),  # a card without the opt-in
    (13000, 1, H100_SMEM, "row"),
])
def test_design_by_shape(k, t, limit, design):
    assert track_associate_design(k, t, limit) == design


def test_design_refuses_past_shared_memory():
    assert track_associate_matrix_smem(50, 64) == 13250 and track_associate_matrix_smem(50, 256) == 51650
    with pytest.raises(ValueError, match="shared memory"):
        track_associate_design(60000, 1, H100_SMEM)


@pytest.mark.parametrize("t, entry", [(64, "track_associate_cuda"), (256, "track_associate_cuda"),
                                      (300, "track_associate_row_cuda")])
def test_wrapper_launches_the_design_for_its_shape(monkeypatch, t, entry):
    """A CUDA-typed call reaches the C entry of the design its shape takes,
    exactly once, with the frame's shape, and counts one launch."""
    calls = []

    def smem_limit(device, out):
        out._obj.value = H100_SMEM
        return 0

    def record(name):
        return lambda *args: calls.append((name, args[4:7])) or 0

    monkeypatch.setattr(ta, "load_library", lambda name, signatures: SimpleNamespace(
        track_associate_smem_limit=smem_limit, track_associate_cuda=record("track_associate_cuda"),
        track_associate_row_cuda=record("track_associate_row_cuda")))
    monkeypatch.setattr(ta, "_smem_limits", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    cuda = lambda x: torch.Tensor._make_subclass(_CudaTyped, x)  # noqa: E731
    before = ta.track_associate.launches
    ta.track_associate(cuda(torch.zeros((2, 50, t))), cuda(torch.zeros((2, 50), dtype=torch.int32)), 0.01)
    assert calls == [(entry, (2, 50, t))]
    assert ta.track_associate.launches == before + 1
