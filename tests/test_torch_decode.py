"""The port's peak decode and box conversion against the JAX package on
seeded head tensors. `lax.top_k` and `torch.topk` may order tied scores
differently, so detection sets are compared sorted by (cls, x, y)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu_torch.ops import decode as tdec

# sfa3d_tpu.ops re-exports the function `decode`, which hides the module
jdec = importlib.import_module("sfa3d_tpu.ops.decode")

TOL = 1e-5


def _heads(rng, b=2, h=48, w=40):
    """Post-sigmoid heatmap and offset, raw direction/z/dim, NHWC."""
    return {
        "hm_cen": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "cen_offset": rng.uniform(0, 1, (b, h, w, 2)).astype(np.float32),
        "direction": rng.normal(0, 1, (b, h, w, 2)).astype(np.float32),
        "z_coor": rng.normal(0, 1, (b, h, w, 1)).astype(np.float32),
        "dim": rng.normal(1, 0.5, (b, h, w, 3)).astype(np.float32),
    }


def _sorted(rows):
    return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


def test_heat_nms_matches_jax(rng):
    hm = _heads(rng)["hm_cen"]
    hm[0, 5, 5, 1] = hm[0, 5, 6, 1] = 2.0  # a tied plateau keeps both
    want = np.asarray(jdec.heat_nms(jnp.asarray(hm)))
    got = tdec.heat_nms(torch.from_numpy(hm)).numpy()
    np.testing.assert_array_equal(got, want)


def test_topk_scores_match_jax(rng):
    scores = np.array(jdec.heat_nms(jnp.asarray(_heads(rng)["hm_cen"])))
    want = jdec.topk_detections(jnp.asarray(scores), K=50)
    got = tdec.topk_detections(torch.from_numpy(scores), K=50)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape == (2, 50)
    # same peaks (ties aside): the (score, ind, cls) triples agree as sets
    for b in range(2):
        gs = {(float(s), int(i), int(c)) for s, i, c in zip(got[0][b], got[1][b], got[2][b])}
        ws = {(float(s), int(i), int(c)) for s, i, c in
              zip(np.asarray(want[0][b]), np.asarray(want[1][b]), np.asarray(want[2][b]))}
        assert gs == ws


@pytest.mark.parametrize("peak_thresh", [0.2, 0.9])
def test_decode_post_processing_and_real_match_jax(rng, peak_thresh):
    heads = _heads(rng)
    order = ("hm_cen", "cen_offset", "direction", "z_coor", "dim")
    jd = jdec.decode(*(jnp.asarray(heads[k]) for k in order), K=50)
    jb, jm = jdec.post_processing(jd, peak_thresh=peak_thresh)
    jr, jrm = jdec.detections_to_real(jb, jm)
    td = tdec.decode(*(torch.from_numpy(heads[k]) for k in order), K=50)
    tb, tm = tdec.post_processing(td, peak_thresh=peak_thresh)
    tr, trm = tdec.detections_to_real(tb, tm)

    assert td.shape == (2, 50, 10) and tb.shape == (2, 50, 9) and tr.shape == (2, 50, 8)
    for b in range(2):
        jmask, tmask = np.asarray(jrm)[b], trm.numpy()[b]
        assert jmask.sum() == tmask.sum() > 0
        for want, got in ((np.asarray(jd)[b], td.numpy()[b]),
                          (np.asarray(jb)[b], tb.numpy()[b]),
                          (np.asarray(jr)[b], tr.numpy()[b])):
            if want.shape[-1] == 10:  # decode rows: put cls first for the sort
                want, got = want[:, [9] + list(range(9))], got[:, [9] + list(range(9))]
            np.testing.assert_allclose(
                _sorted(got[tmask]), _sorted(want[jmask]), rtol=0, atol=TOL
            )


def test_masked_detections_to_numpy_matches_jax(rng):
    heads = _heads(rng)
    order = ("hm_cen", "cen_offset", "direction", "z_coor", "dim")
    jb, jm = jdec.post_processing(jdec.decode(*(jnp.asarray(heads[k]) for k in order)), 0.5)
    tb, tm = tdec.post_processing(tdec.decode(*(torch.from_numpy(heads[k]) for k in order)), 0.5)
    want = jdec.masked_detections_to_numpy(np.asarray(jb)[:1], np.asarray(jm)[:1])
    got = tdec.masked_detections_to_numpy(tb[:1], tm[:1])
    assert set(got) == set(want) == {0, 1, 2}
    for c in want:
        assert got[c].shape == want[c].shape
        if len(want[c]):
            key = lambda r: r[np.lexsort((r[:, 2], r[:, 1]))]
            np.testing.assert_allclose(key(got[c]), key(want[c]), rtol=0, atol=TOL)
