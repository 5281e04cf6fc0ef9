"""The port's 3D tracker (`sfa3d_tpu_torch/tracking/`) against the JAX
package's on the CPU: the scenes of tests/test_tracking.py, a seeded
40-frame random sequence, the association loop's plain version, the angle
wrap and the CLEAR-MOT metrics.

Tolerances: integer outputs (ids, alive, confirmed, next_id, the
association) are exact. Boxes, velocities and scores within TRACK_ATOL:
the Kalman update's 7- and 10-term float32 dot products and the (7, 7) LU
solve may round in another order than XLA's (with PyTorch 2.13's CPU
build every scene and the 40-frame sequence came out bit-exact). The rotated IoU
matches JAX op by op; jitted JAX contracts FMAs (up to 7.6e-7), which could
flip an association only where two IoUs of a row, or an IoU and iou_min,
lie within that of each other. Over every step of these scenes the
smallest gap between a row's two largest distinct positive IoUs is 4.6e-3
and the nearest IoU to iou_min 3.9e-3, so none can flip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.tracking import metrics as jmetrics
from sfa3d_tpu.tracking import tracker as jtracker
from sfa3d_tpu_torch.tracking import clear_mot, track_sequence, tracker_output_to_frames
from sfa3d_tpu_torch.tracking import tracker as ptracker
from sfa3d_tpu_torch.ops.track_associate import track_associate, track_associate_plain
from tests.test_tracking import linear_scene, make_frame

TRACK_ATOL = 1e-5  # m, rad, m/frame and score units
INT_KEYS = ("ids", "alive", "confirmed")
FLOAT_KEYS = ("boxes", "velocities", "scores")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread: the tensors are tiny, and
    in a loaded multi-worker run more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_frames(frames):
    return [tuple(np.asarray(a) for a in f) for f in frames]


def run_both(frames, max_tracks=32, **kw):
    """Step both trackers over the same frames. Returns ((jax outputs, jax
    next_id), (port outputs, port next_id)), outputs as numpy per frame."""
    frames = _np_frames(frames)
    jstate, pstate = jtracker.init_tracks(max_tracks), ptracker.init_tracks(max_tracks, "cpu")
    jouts, pouts = [], []
    for b, s, v in frames:
        jstate, jo = jtracker.tracker_step(jstate, jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), **kw)
        pstate, po = ptracker.tracker_step(pstate, b, s, v, **kw)
        jouts.append({k: np.asarray(o) for k, o in jo.items()})
        pouts.append({k: o.numpy() for k, o in po.items()})
    return (jouts, int(jstate.next_id)), (pouts, int(pstate.next_id))


def assert_same_tracks(jax_run, port_run):
    (jouts, jnext), (pouts, pnext) = jax_run, port_run
    assert pnext == jnext
    assert len(pouts) == len(jouts)
    for f, (jo, po) in enumerate(zip(jouts, pouts)):
        for k in INT_KEYS:
            np.testing.assert_array_equal(po[k], jo[k], err_msg=f"frame {f} {k}")
        alive = jo["alive"]
        for k in FLOAT_KEYS:
            assert po[k].dtype == np.float32
            # free slots keep stale rows in both; compare the live ones
            np.testing.assert_allclose(po[k][alive], jo[k][alive], rtol=0, atol=TRACK_ATOL,
                                       err_msg=f"frame {f} {k}")


def _two_objects():
    return [make_frame([(5.0 + 1.0 * f, -6.0, -1.0, 1.6, 1.8, 4.2, 0.0, 0, 0.9),
                        (25.0 - 1.0 * f, 6.0, -1.0, 1.6, 1.8, 4.2, 0.0, 0, 0.8)]) for f in range(10)]


def _class_flip():
    return [make_frame([(10.0, 0.0, -1.0, 1.6, 1.8, 4.2, 0.0, c, 0.9)]) for c in (0, 1)]


def _pi_flip():
    return [make_frame([(10.0 + f, 0.0, -1.0, 1.6, 1.8, 4.2, 0.3 if f % 2 == 0 else 0.3 - np.pi, 0, 0.9)])
            for f in range(8)]


def _birth_capacity():
    objs = [(5.0 + 6.0 * i, -20.0 + 5.0 * i, -1.0, 1.6, 1.8, 4.2, 0.0, 0, 0.9) for i in range(6)]
    return [make_frame(objs), make_frame(objs[::-1])]


def _moving_scene():
    from sfa3d_tpu.data.synthetic import moving_scene_sequence

    frames = []
    seq = moving_scene_sequence(10, seed=11, n_objects=6, points_per_object=8, n_ground=8, n_clutter=8)
    for f, (_pts, labels, _ids) in enumerate(seq):
        perm = np.random.default_rng(f).permutation(6)
        boxes = np.zeros((16, 8), np.float32)
        boxes[:6] = labels[perm]
        scores = np.where(np.arange(16) < 6, 0.9, 0.0).astype(np.float32)
        frames.append((boxes, scores, np.arange(16) < 6))
    return frames


# scene -> (frames, max_tracks, tracker_step keywords): the scenes of
# tests/test_tracking.py:57-184
SCENES = {
    "single_track": (lambda: linear_scene(12), 32, {}),
    "confirmation": (lambda: linear_scene(4), 32, {"min_hits": 3}),
    "death": (lambda: linear_scene(10, drop_frames=range(5, 10)), 32, {"max_age": 3}),
    "occlusion": (lambda: linear_scene(9, drop_frames=(4,)), 32, {"max_age": 3}),
    "two_objects": (_two_objects, 32, {}),
    "class_gating": (_class_flip, 32, {}),
    "pi_flip": (_pi_flip, 32, {}),
    "birth_capacity": (_birth_capacity, 4, {}),
    "empty_frames": (lambda: [make_frame([])] * 3, 8, {}),
    "noisy_sequence": (lambda: linear_scene(8, noise=0.05), 32, {}),
    "moving_scene": (_moving_scene, 32, {"min_hits": 1}),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_tracker_matches_jax_on_scene(scene):
    make, max_tracks, kw = SCENES[scene]
    assert_same_tracks(*run_both(make(), max_tracks, **kw))


def random_sequence(seed=0, n_frames=40, k=12, n_objects=9):
    """A seeded crowd: objects of three classes moving at constant velocity
    with jittered detections, dropouts, false positives, a pi-flipped yaw
    and objects that leave; more objects than slots at times. Returns
    (frames, ground-truth (ids, centres) per frame)."""
    rng = np.random.default_rng(seed)
    start = rng.uniform([0, -15], [40, 15], (n_objects, 2))
    vel = rng.uniform(-1.0, 1.0, (n_objects, 2))
    cls = rng.integers(0, 3, n_objects)
    dims = np.array([[1.76, 0.66, 0.84], [1.52, 1.63, 3.88], [1.73, 0.60, 1.76]])[cls]
    yaw = rng.uniform(-np.pi, np.pi, n_objects)
    leave = rng.integers(25, 60, n_objects)  # frame an object leaves the scene
    frames, gt = [], []
    for f in range(n_frames):
        boxes = np.zeros((k, 8), np.float32)
        scores = np.zeros((k,), np.float32)
        rows, ids, centres = [], [], []
        for o in range(n_objects):
            if f >= leave[o]:
                continue
            xy = start[o] + vel[o] * f
            ids.append(o)
            centres.append(xy)
            if rng.random() < 0.1:  # dropout
                continue
            y = yaw[o] + (np.pi if (o == 0 and f % 3 == 1) else 0.0)  # object 0's yaw flips by pi
            rows.append([cls[o], *(xy + rng.normal(0, 0.1, 2)), -1.0, *dims[o], y])
        for _ in range(rng.integers(0, 3)):  # false positives
            rows.append([rng.integers(0, 3), *rng.uniform([0, -15], [40, 15]), -1.0, 1.5, 1.6, 3.9,
                         rng.uniform(-np.pi, np.pi)])
        rows = rows[:k]
        order = rng.permutation(len(rows))  # shuffled, so slot order says nothing of identity
        for slot, i in enumerate(order):
            boxes[slot] = rows[i]
            scores[slot] = rng.uniform(0.3, 1.0)
        frames.append((boxes, scores, np.arange(k) < len(rows)))
        gt.append((np.asarray(ids, np.int64), np.asarray(centres, np.float64).reshape(-1, 2)))
    return frames, gt


def test_tracker_matches_jax_on_seeded_40_frame_sequence():
    frames, _ = random_sequence()
    jrun, prun = run_both(frames, max_tracks=16, iou_min=0.01, max_age=3, min_hits=2)
    assert_same_tracks(jrun, prun)
    jouts, jnext = jrun
    assert jnext > 9, "the sequence should birth more tracks than objects"
    assert any(o["alive"].all() for o in jouts), "the slots should fill at some frame"


def test_track_sequence_equals_step_loop():
    frames, _ = random_sequence(seed=1, n_frames=12)
    boxes, scores, valid = (np.stack(x) for x in zip(*frames))
    outs = track_sequence(boxes, scores, valid, max_tracks=16, device="cpu")
    _, (pouts, _) = run_both(frames, max_tracks=16)
    for f, po in enumerate(pouts):
        for k, v in po.items():
            np.testing.assert_array_equal(outs[k][f].numpy(), v, err_msg=f"frame {f} {k}")
    assert track_sequence(boxes[:0], scores[:0], valid[:0], device="cpu") == {}


def test_wrap_pi_matches_jax_at_and_around_pi():
    """Exact: (a + pi) mod 2 pi - pi in float32, the mod taking the
    divisor's sign, on both sides."""
    pi = np.float32(np.pi)
    edges = np.concatenate([pi * np.arange(-7, 8, dtype=np.float32), [3 * np.pi, -3 * np.pi, 0.0, -0.0]])
    edges = edges.astype(np.float32)
    a = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)), np.nextafter(edges, np.float32(-np.inf)),
                        np.random.default_rng(0).uniform(-30, 30, 2000).astype(np.float32)])
    want = np.asarray(jax.jit(jtracker._wrap_pi)(jnp.asarray(a)))
    got = ptracker._wrap_pi(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -pi and got.max() < pi + 1e-6


def test_predict_matches_jax_exactly():
    """The constant-velocity prediction adds one or two terms per element,
    in XLA's order: bit-exact."""
    rng = np.random.default_rng(3)
    mean = rng.normal(0, 5, (16, 10)).astype(np.float32)
    cov = rng.normal(0, 10, (16, 10, 10)).astype(np.float32)
    jst = jtracker.init_tracks(16)._replace(mean=jnp.asarray(mean), cov=jnp.asarray(cov))
    pst = ptracker.init_tracks(16, "cpu").replace(mean=torch.from_numpy(mean), cov=torch.from_numpy(cov))
    want, got = jax.jit(jtracker._predict)(jst), ptracker._predict(pst)
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want.mean))
    np.testing.assert_array_equal(got.cov.numpy(), np.asarray(want.cov))


def _jax_loop(iou, order, iou_min):
    """The loop body of sfa3d_tpu/tracking/tracker.py:131-142 on a given
    gated IoU matrix (K, T) and order (K,)."""
    k, t = iou.shape

    def body(i, carry):
        det_match, trk_used = carry
        d = order[i]
        row = jnp.where(trk_used, -1.0, iou[d])
        j = jnp.argmax(row)
        hit = row[j] >= iou_min
        return det_match.at[d].set(jnp.where(hit, j, -1)), trk_used.at[j].set(trk_used[j] | hit)

    return jax.lax.fori_loop(0, k, body, (jnp.full((k,), -1, jnp.int32), jnp.zeros((t,), bool)))


def _crafted_matrices():
    rng = np.random.default_rng(5)
    k, t = 12, 16
    cases = {}
    # ties: every value from a few levels, so rows tie and the lowest index must win
    cases["ties"] = rng.choice(np.float32([-1.0, 0.0, 0.005, 0.01, 0.3, 0.7]), (k, t))
    cases["all_ineligible"] = np.full((k, t), -1.0, np.float32)
    # one track is best for every detection: only the first in order takes it
    crowd = rng.uniform(0.0, 0.5, (k, t)).astype(np.float32)
    crowd[:, 3] = 0.9
    cases["crowded"] = crowd
    # values exactly at iou_min (0.01 in float32) and a hair under
    at = np.full((k, t), -1.0, np.float32)
    at[::2, ::3] = np.float32(0.01)
    at[1::2, 1::3] = np.nextafter(np.float32(0.01), np.float32(0))
    cases["at_iou_min"] = at
    cases["zeros_signed"] = rng.choice(np.float32([-0.0, 0.0]), (k, t))
    # quiet NaNs of both signs: a row of only NaNs, NaNs beside values >= iou_min
    nan = rng.uniform(-1.0, 1.0, (k, t)).astype(np.float32)
    nan[rng.random((k, t)) < 0.3] = np.float32(np.nan)
    nan[rng.random((k, t)) < 0.15] = -np.float32(np.nan)
    nan[2] = np.float32(np.nan)
    nan[5, ::2] = -np.float32(np.nan)
    nan[5, 1::2] = np.float32(0.8)
    cases["nan_signed"] = nan
    cases["inf_signed"] = rng.choice(np.float32([-np.inf, np.inf, -1.0, 0.3, 0.3, 0.9]), (k, t))
    cases["below_minus_one"] = rng.choice(np.float32([-7.5, -2.0, -1.5, -1.0, 0.02]), (k, t))
    # shapes: more detections than tracks and fewer; T off a multiple of 32; T = 256
    for name, (kk, tt) in {"k_over_t_20x5": (20, 5), "k_under_t_4x40": (4, 40), "t_33": (12, 33),
                           "t_100": (12, 100), "t_256": (12, 256)}.items():
        m = rng.choice(np.float32([0.0, 0.01, 0.4, 0.4, 0.95]), (kk, tt))
        m[rng.random((kk, tt)) < 0.5] = -1.0
        m[:, tt - 1] = np.float32(0.97)  # the last column, past the last full warp of columns
        cases[name] = m
    return cases


@pytest.mark.parametrize("name", sorted(_crafted_matrices()))
@pytest.mark.parametrize("iou_min", [0.01, 0.0, -1.0, -2.0])
def test_associate_plain_matches_jax_loop(name, iou_min):
    """Exact on crafted ties, all-ineligible rows, values at iou_min, NaNs
    of both signs, infinities, values below -1 and shapes on either side of
    a warp of columns; with iou_min <= -1 even ineligible pairs match (there
    is no > 0 condition, unlike the fusion match)."""
    iou = _crafted_matrices()[name]
    order = np.random.default_rng(7).permutation(iou.shape[0]).astype(np.int32)
    want = [np.asarray(x) for x in _jax_loop(jnp.asarray(iou), jnp.asarray(order), iou_min)]
    got = track_associate_plain(torch.from_numpy(iou)[None], torch.from_numpy(order)[None], iou_min)
    np.testing.assert_array_equal(got[0][0].numpy(), want[0])
    np.testing.assert_array_equal(got[1][0].numpy(), want[1])
    # the wrapper takes the plain version for CPU tensors
    wrapped = track_associate(torch.from_numpy(iou)[None], torch.from_numpy(order)[None], iou_min)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def test_associate_plain_batches_frames_independently():
    cases = [c for c in _crafted_matrices().values() if c.shape == (12, 16)]
    iou = np.stack(cases)
    order = np.stack([np.random.default_rng(i).permutation(12) for i in range(len(cases))]).astype(np.int32)
    got = track_associate_plain(torch.from_numpy(iou), torch.from_numpy(order), 0.01)
    for f in range(len(cases)):
        want = [np.asarray(x) for x in _jax_loop(jnp.asarray(iou[f]), jnp.asarray(order[f]), 0.01)]
        np.testing.assert_array_equal(got[0][f].numpy(), want[0])
        np.testing.assert_array_equal(got[1][f].numpy(), want[1])


def test_associate_matches_jax_on_tied_tracks():
    """The tracker's own association (rotated IoU, class and validity gate,
    stable score order, the loop): two tracks on the same box (tied IoUs),
    equal scores, an invalid detection and a detection of another class."""
    T = 8
    mean = np.zeros((T, 10), np.float32)
    mean[:4, :7] = [10.0, 0.0, -1.0, 0.3, 1.6, 1.8, 4.2]  # four tracks on one box
    mean[4:6, :7] = [20.0, 5.0, -1.0, 0.0, 1.6, 1.8, 4.2]
    alive = np.array([1, 1, 0, 1, 1, 1, 0, 0], bool)
    cls = np.array([0, 0, 0, 1, 0, 0, 0, 0], np.int32)
    boxes = np.array([[0, 10.2, 0.1, -1, 1.6, 1.8, 4.2, 0.3], [0, 10.1, 0.0, -1, 1.6, 1.8, 4.2, 0.3],
                      [1, 10.0, 0.0, -1, 1.6, 1.8, 4.2, 0.3], [0, 20.0, 5.0, -1, 1.6, 1.8, 4.2, 0.0],
                      [0, 10.0, 0.0, -1, 1.6, 1.8, 4.2, 0.3], [0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    scores = np.float32([0.8, 0.8, 0.9, 0.5, 0.8, 0.0])
    valid = np.array([1, 1, 1, 1, 0, 0], bool)
    jst = jtracker.init_tracks(T)._replace(mean=jnp.asarray(mean), alive=jnp.asarray(alive), cls=jnp.asarray(cls))
    pst = ptracker.init_tracks(T, "cpu").replace(mean=torch.from_numpy(mean), alive=torch.from_numpy(alive),
                                                 cls=torch.from_numpy(cls))
    det_cls = boxes[:, 0].astype(np.int32)
    want = jax.jit(jtracker._associate, static_argnums=5)(
        jst, jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(det_cls), jnp.asarray(valid), 0.01)
    got = ptracker._associate(pst, torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(det_cls),
                              torch.from_numpy(valid), 0.01)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].tolist()[:4] == [0, 1, 3, 4], "ties go to the lowest slot, the class-1 track to its class"


def test_clear_mot_and_frames_match_jax():
    frames, gt = random_sequence()
    boxes, scores, valid = (np.stack(x) for x in zip(*frames))
    port_outs = track_sequence(boxes, scores, valid, max_tracks=16, device="cpu")
    jax_outs = jtracker.track_sequence(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), max_tracks=16)
    for cls in (None, 0, 1):
        got_frames = tracker_output_to_frames(port_outs, cls=cls)
        want_frames = jmetrics.tracker_output_to_frames({k: np.asarray(v) for k, v in jax_outs.items()}, cls=cls)
        assert [g[0].tolist() for g in got_frames] == [w[0].tolist() for w in want_frames]
        for g, w in zip(got_frames, want_frames):
            np.testing.assert_allclose(g[1], w[1], rtol=0, atol=TRACK_ATOL)
    step_list = [{k: v[f] for k, v in port_outs.items()} for f in range(len(frames))]
    assert [f[0].tolist() for f in tracker_output_to_frames(step_list)] == \
        [f[0].tolist() for f in tracker_output_to_frames(port_outs)]
    got = clear_mot(gt, tracker_output_to_frames(port_outs))
    want = jmetrics.clear_mot(gt, jmetrics.tracker_output_to_frames({k: np.asarray(v) for k, v in jax_outs.items()}))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-9), k
    assert got["matches"] > 100 and 0 < got["id_switches"] + got["false_positives"]


def test_clear_mot_equal_on_crafted_frames():
    f = lambda ids, xys: (np.asarray(ids, np.int64), np.asarray(xys, np.float64).reshape(len(ids), 2))  # noqa: E731
    gt = [f([0, 1], [(0, 0), (10, 0)]), f([0, 1], [(1, 0), (11, 0)]), f([0], [(2, 0)]), f([0, 1], [(3, 0), (13, 0)])]
    pred = [f([5, 6], [(0.1, 0), (10, 0.2)]), f([6, 5], [(1.2, 0), (11, 0)]), f([], []),
            f([5, 9], [(3, 0.1), (40, 0)])]
    assert clear_mot(gt, pred) == jmetrics.clear_mot(gt, pred)
    assert clear_mot([], []) == jmetrics.clear_mot([], [])
    with pytest.raises(ValueError, match="frames"):
        clear_mot(gt, pred[:2])
