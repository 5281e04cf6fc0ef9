"""The port's KFPN feature capture (`KFPN.forward_features`) and its
matplotlib-free dumps (`sfa3d_tpu_torch/viz/kfpn_viz.py`) against the JAX
package's `capture_features=True` and `viz/kfpn_viz.py::save_all`, at a
64 x 64 BEV.

Tolerances: each captured tensor within `test_torch_model.py`'s 1e-4
(float32 convolutions summed in another order than XLA's), after the port's
NCHW layout is turned into JAX's NHWC; the heads equal the plain forward's
exactly; the dumps' file names equal JAX's; the viridis table equals
matplotlib's. The figures' pixels are the port's own layout (ROADMAP
section 3).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import HEADS_TOL, jax_variables  # noqa: F401  (a fixture)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def captured(jax_variables):  # noqa: F811
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.models.port import state_dict_from_jax

    jmodel, variables = jax_variables
    model = create_model("fpn_resnet_18")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    bev = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want_heads, want = jmodel.apply(variables, jnp.asarray(bev), train=False, capture_features=True)
    with torch.no_grad():
        x = torch.from_numpy(bev).permute(0, 3, 1, 2)
        heads, viz = model.forward_features(x)
        plain = model(x)
    return want_heads, want, heads, viz, plain


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_heads_equal_the_plain_forward(captured):
    want_heads, _, heads, _, plain = captured
    assert set(heads) == set(plain) == set(want_heads)
    for k in plain:
        assert torch.equal(heads[k], plain[k]), k
        np.testing.assert_allclose(_nhwc(heads[k]), np.asarray(want_heads[k]), rtol=0, atol=HEADS_TOL, err_msg=k)


@pytest.mark.parametrize("part", ["backbone", "pyramid"])
def test_feature_maps_match_jax(captured, part):
    _, want, _, viz, _ = captured
    assert len(viz[part]) == len(want[part]) == (4 if part == "backbone" else 3)
    for got, ref in zip(viz[part], want[part]):
        ref = np.asarray(ref)
        assert _nhwc(got).shape == ref.shape
        np.testing.assert_allclose(_nhwc(got), ref, rtol=0, atol=HEADS_TOL)


def test_fpn_outputs_and_kfpn_weights_match_jax(captured):
    _, want, _, viz, _ = captured
    assert set(viz["fpn_outputs"]) == set(want["fpn_outputs"]) == set(viz["kfpn_weights"])
    for head, levels in want["fpn_outputs"].items():
        assert len(viz["fpn_outputs"][head]) == len(levels) == 3
        for got, ref in zip(viz["fpn_outputs"][head], levels):
            np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=HEADS_TOL, err_msg=head)
        w = viz["kfpn_weights"][head].permute(0, 2, 3, 1, 4).numpy()  # (B, C, H, W, L) -> (B, H, W, C, L)
        ref = np.asarray(want["kfpn_weights"][head])
        assert w.shape == ref.shape and ref.shape[-1] == 3
        np.testing.assert_allclose(w, ref, rtol=0, atol=HEADS_TOL, err_msg=head)


def test_dumps_have_jax_file_names(captured, tmp_path, monkeypatch):
    """JAX's figures are laid out but not rendered (savefig writes only the
    file's name): the names are what is compared."""
    import matplotlib
    from matplotlib.figure import Figure

    from sfa3d_tpu.viz.kfpn_viz import save_all as jsave_all
    from sfa3d_tpu_torch.data.png import read_image_bgr
    from sfa3d_tpu_torch.viz.kfpn_viz import save_all

    matplotlib.use("Agg")
    monkeypatch.setattr(Figure, "savefig", lambda self, path, **kw: open(path, "wb").close())
    monkeypatch.setattr(Figure, "tight_layout", lambda self, **kw: None)
    _, want, _, viz, _ = captured
    jsave_all(want, str(tmp_path / "jax"))
    save_all(viz, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4 + 2 * 3 + 3 * 5
    for name in names:
        img = read_image_bgr(str(tmp_path / "port" / name))
        colours = (img[..., 0].astype(np.int64) << 16) | (img[..., 1].astype(np.int64) << 8) | img[..., 2]
        assert img.ndim == 3 and len(np.unique(colours)) > 2, name


def test_panels_follow_imshow_through_viridis():
    import matplotlib

    from sfa3d_tpu_torch.viz.bev_projection import VIRIDIS_BGR
    from sfa3d_tpu_torch.viz.kfpn_viz import colorize

    cmap = matplotlib.colormaps["viridis"]
    want = np.round(cmap(np.arange(256))[:, :3] * 255).astype(np.uint8)[:, ::-1]
    np.testing.assert_array_equal(VIRIDIS_BGR, want)
    feat = np.random.default_rng(0).normal(size=(20, 30)).astype(np.float32)
    norm = matplotlib.colors.Normalize(vmin=feat.min(), vmax=feat.max())
    rgba = np.round(cmap(norm(feat))[..., :3] * 255).astype(np.uint8)  # imshow's default mapping
    np.testing.assert_array_equal(colorize(feat), rgba[..., ::-1])
    np.testing.assert_array_equal(colorize(np.ones((3, 4))), np.broadcast_to(VIRIDIS_BGR[0], (3, 4, 3)))
