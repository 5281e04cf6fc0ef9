"""The port's AOT export of the detector (`runtime/export.py`,
`cli/export.py`), its facade (`ArtifactDetector`), fixed-batch serving
(`runtime/serving.py`), `cli serve --artifact` and the `cli` dispatcher, on
the CPU, against the port's live path and the JAX package's export.

One detector artifact is exported here (through the CLI: fpn_resnet_18 at
608x608, a point budget of MAXP as tests/test_export.py uses, symbolic
batch, JAX-initialised weights bridged by `state_dict_from_jax`); the other
artifact files here are copies whose manifest differs (a fixed batch,
another kind, another platform), with the same program.

Tolerances: the artifact equals the port's live `detect_frames` bit for bit
(the same ATen ops and the same plain raster on the CPU); against JAX's
artifact boxes are within 1e-3 (float32 convolutions in another order) and
masks equal; served detections within DET_ATOL of the facade's own
`detect` (padded batches of another size sum in another order)."""

import io
import json
import struct

import jax
import numpy as np
import pytest
import torch

from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu.runtime.export import export_detector as jexport_detector
from sfa3d_tpu.runtime.export import load_exported as jload_exported
from sfa3d_tpu.runtime.export import save_exported as jsave_exported
from sfa3d_tpu_torch.cli import export as export_cli
from sfa3d_tpu_torch.cli import serve
from sfa3d_tpu_torch.data.synthetic import synthetic_scene
from sfa3d_tpu_torch.detector import ArtifactDetector, ArtifactFusedDetector, Detector
from sfa3d_tpu_torch.models.port import state_dict_from_jax
from sfa3d_tpu_torch.ops.bev import filter_and_pad_points
from sfa3d_tpu_torch.pipeline import detect_frames
from sfa3d_tpu_torch.runtime.export import load_exported, read_manifest
from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer

MAXP = 4096  # a small point budget keeps the CPU runs short
BOX_TOL = 1e-3  # boxes vs the JAX artifact (the parity tolerance)
DET_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_det():
    """The JAX KFPN-18 with its heatmap biases raised by 2.0, so random
    weights give peaks (numpy leaves)."""
    model = jcreate_model("fpn_resnet_18")
    variables = jinit_detector(model, jax.random.PRNGKey(0), input_size=(128, 128))
    variables = jax.tree_util.tree_map(lambda t: np.array(t), variables)
    for i in range(3):
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
    return model, variables


@pytest.fixture(scope="module")
def artifact(jax_det, tmp_path_factory):
    """(path, manifest, .pth) of a symbolic-batch CPU detector artifact that
    `python -m sfa3d_tpu_torch.cli export` wrote from the bridged JAX
    weights."""
    root = tmp_path_factory.mktemp("artifact")
    pth = root / "Model_fpn_resnet_18.pth"
    torch.save(state_dict_from_jax(jax_det[1]), pth)
    path = root / "model.sfa3dt"
    manifest = export_cli.main(["--pretrained_path", str(pth), "--platform", "cpu",
                                "--max_points", str(MAXP), "-o", str(path)])
    return str(path), manifest, str(pth)


@pytest.fixture(scope="module")
def live(artifact):
    return Detector(checkpoint=artifact[2], device="cpu")


def _scans(n, seed=0):
    return [synthetic_scene(seed=seed + i)[0] for i in range(n)]


def _batch(scans):
    pairs = [filter_and_pad_points(s, MAXP) for s in scans]
    return np.stack([p for p, _ in pairs]), np.stack([v for _, v in pairs])


def _with_manifest(path, out, **changes):
    """A copy of the artifact at `path` whose manifest has `changes`; the
    program bytes are unchanged."""
    manifest = read_manifest(path)
    with open(path, "rb") as f:
        f.seek(8)
        (mlen,) = struct.unpack("<Q", f.read(8))
        f.seek(16 + mlen)
        blob = f.read()
    mbytes = json.dumps({**manifest, **changes}).encode()
    with open(out, "wb") as f:
        f.write(b"SFA3DT01" + struct.pack("<Q", len(mbytes)) + mbytes + blob)
    return str(out)


def test_cli_export_writes_the_manifest(artifact):
    path, manifest, _ = artifact
    assert manifest == read_manifest(path)
    assert manifest["kind"] == "detector" and manifest["arch"] == "KFPN"
    assert (manifest["K"], manifest["peak_thresh"], manifest["max_points"]) == (50, 0.2, MAXP)
    assert manifest["batch"] is None and manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    assert [i["shape"] for i in manifest["inputs"]] == [["b", MAXP, 4], ["b", MAXP]]
    with open(path, "rb") as f:
        assert f.read(8) == b"SFA3DT01"
    assert len(open(path, "rb").read()) > 1_000_000  # the weights are baked in
    with pytest.raises(SystemExit, match="one platform"):
        export_cli.main(["--platforms", "cpu,cuda", "-o", "unused.sfa3dt"])
    with pytest.raises(SystemExit, match="disagree"):
        export_cli.main(["--platform", "cpu", "--platforms", "cuda", "-o", "unused.sfa3dt"])


@pytest.mark.parametrize("b", [1, 2, 3])
def test_symbolic_artifact_equals_live_detect_frames(artifact, live, b):
    """Batches 1, 2 and 3 through the artifact traced at batch 2 equal the
    live program bit for bit; the program's raster is one node of the
    exported graph."""
    art = load_exported(artifact[0])
    targets = [str(n.target) for n in art.exported.graph.nodes if n.op == "call_function"]
    assert targets.count("sfa3d_torch.bev_raster_reduce.default") == 1
    pts, valid = _batch(_scans(b, seed=10 * b))
    got = art.call(pts, valid)
    want = detect_frames(live.model, pts, valid, K=50, peak_thresh=0.2, device="cpu")
    assert set(got) == {"detections", "boxes_bev", "boxes_real", "mask"}
    for k in got:
        assert got[k].device.type == "cpu" and torch.equal(got[k], want[k]), k
    assert want["mask"].any(), "no detection: vacuous"


def test_artifact_matches_the_jax_artifact(artifact, jax_det, tmp_path):
    """The same JAX weights through JAX's export_detector / load_exported
    and through the port's: masks equal, boxes within BOX_TOL."""
    model, variables = jax_det
    exported, manifest = jexport_detector(model, variables, max_points=MAXP)
    jpath = str(tmp_path / "model.sfa3dx")
    jsave_exported(jpath, exported, manifest)
    pts, valid = _batch(_scans(2, seed=5))
    want = jload_exported(jpath).call(pts, valid)
    got = ArtifactDetector(artifact[0]).detect_batch(pts, valid)
    np.testing.assert_array_equal(got["mask"], np.asarray(want["mask"]))
    np.testing.assert_allclose(got["boxes_real"], np.asarray(want["boxes_real"]), rtol=0, atol=BOX_TOL)
    np.testing.assert_allclose(got["detections"], np.asarray(want["detections"]), rtol=0, atol=BOX_TOL)
    assert got["mask"].sum() > 0
    # and the port refuses the JAX file by its magic
    with pytest.raises(ValueError, match="JAX StableHLO artifact"):
        load_exported(jpath)


def test_magic_kind_and_platform_checks(artifact, tmp_path):
    path = artifact[0]
    junk = tmp_path / "junk.bin"
    junk.write_bytes(np.random.default_rng(0).integers(0, 256, 64, dtype=np.uint8).tobytes())
    with pytest.raises(ValueError, match="not a sfa3d_tpu_torch export"):
        read_manifest(str(junk))
    with pytest.raises(ValueError, match="not a sfa3d_tpu_torch export"):
        ArtifactDetector(str(junk))
    with pytest.raises(ValueError, match="cannot back the fused pipeline"):
        ArtifactFusedDetector(path)
    fused = _with_manifest(path, tmp_path / "fused.sfa3dt", kind="fused")
    assert read_manifest(fused)["kind"] == "fused"  # the header alone, no program loaded
    with pytest.raises(ValueError, match="cannot back the LiDAR detector server"):
        ArtifactDetector(fused)
    on_cuda = _with_manifest(path, tmp_path / "cuda.sfa3dt", platforms=["cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_exported(on_cuda)
    with pytest.raises(ValueError, match="one of cuda, cpu"):
        load_exported(_with_manifest(path, tmp_path / "two.sfa3dt", platforms=["cpu", "cuda"]))


def test_facade_checks_and_detect(artifact, live, tmp_path):
    ad = ArtifactDetector(artifact[0])
    assert (ad.K, ad.peak_thresh, ad.max_points, ad.fixed_batch) == (50, 0.2, MAXP, None)
    assert ad.device == torch.device("cpu")
    pts, valid = _batch(_scans(1))
    with pytest.raises(ValueError, match=f"exported for max_points={MAXP}"):
        ad.detect_batch(np.zeros((1, MAXP + 1, 4), np.float32), np.zeros((1, MAXP + 1), bool))
    fixed = ArtifactDetector(_with_manifest(artifact[0], tmp_path / "b2.sfa3dt", batch=2))
    with pytest.raises(ValueError, match=r"fixed-batch artifact \(batch=2\) cannot run batch 1"):
        fixed.detect_batch(pts, valid)
    scan = _scans(1, seed=7)[0]
    scan.astype(np.float32).tofile(tmp_path / "000007.bin")
    got = ad.detect_file(str(tmp_path / "000007.bin"))
    p, v = filter_and_pad_points(scan, MAXP)
    want = detect_frames(live.model, p[None], v[None], device="cpu")
    assert len(got) == int(want["mask"].sum()) > 0
    assert [d["score"] for d in got] == want["detections"][0, want["mask"][0], 0].tolist()
    with pytest.raises(ValueError, match="fixed-batch artifact"):
        fixed.detect(scan)  # one frame: as in JAX, only the batching server pads


def _rows(dets):
    return np.asarray([[d["class_id"], d["score"], d["x"], d["y"], d["z"], d["h"], d["w"], d["l"], d["yaw"]]
                       for d in dets]).reshape(-1, 9)


@pytest.mark.parametrize("fixed", [False, True], ids=["symbolic", "fixed_batch_2"])
def test_batching_server_over_artifact(artifact, tmp_path, capsys, fixed):
    """BatchingDetectorServer over the facade: a symbolic artifact runs
    power-of-two buckets; a fixed-batch one pads every batch to its size,
    with max_batch clamped to it (and a warning)."""
    path = _with_manifest(artifact[0], tmp_path / "b2.sfa3dt", batch=2) if fixed else artifact[0]
    ad = ArtifactDetector(path)
    scans = _scans(3, seed=40)
    server = BatchingDetectorServer(ad, max_batch=4, max_delay_ms=500.0)
    try:
        assert server.buckets() == ([2] if fixed else [1, 2, 4])
        assert server.max_batch == (2 if fixed else 4)
        futs = [server.submit(s) for s in scans]
        got = [f.result(timeout=600) for f in futs]
    finally:
        server.stop()
    err = capsys.readouterr().err
    assert ("clamping max_batch 4 -> 2 (fixed-batch artifact)" in err) == fixed
    assert server.stats["served"] == 3
    if fixed:
        assert server.stats["padded"] == 2 * server.stats["batches"] - 3
    solo = ArtifactDetector(artifact[0])
    for scan, dets in zip(scans, got):
        want = solo.detect(scan)
        np.testing.assert_allclose(_rows(dets), _rows(want), rtol=0, atol=DET_ATOL)


def _run_stdio(argv, requests):
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in requests))
    stdout = io.StringIO()
    stats = serve.main(argv, stdin=stdin, stdout=stdout)
    return [json.loads(line) for line in stdout.getvalue().splitlines()], stats


@pytest.mark.parametrize("track", [False, True], ids=["detect", "track"])
def test_serve_cli_answers_from_the_artifact(artifact, tmp_path, capsys, track):
    """`cli serve --artifact` over stdio, the model flags ignored with a
    warning: replies equal the facade's detections; with --track, replies
    carry tracks from TrackingSessions sized by the artifact's K."""
    scans = _scans(3, seed=60)
    for i, s in enumerate(scans):
        s.astype(np.float32).tofile(tmp_path / f"{i:06d}.bin")
    requests = [{"id": i, "lidar": str(tmp_path / f"{i:06d}.bin"), "stream": "cam0"} for i in range(3)]
    argv = ["--artifact", artifact[0], "--platform", "cpu", "--K", "10", "--max_delay_ms", "1"]
    replies, stats = _run_stdio(argv + (["--track", "--track_min_hits", "1"] if track else []), requests)
    assert "--K is IGNORED with --artifact" in capsys.readouterr().err
    assert [r["id"] for r in replies] == [0, 1, 2] and stats["served"] == 3
    ad = ArtifactDetector(artifact[0])
    for r, scan in zip(replies, scans):
        np.testing.assert_allclose(_rows(r["detections"]), _rows(ad.detect(scan)), rtol=0, atol=DET_ATOL)
        assert len(r["detections"]) > 10  # the artifact's K = 50, not --K
        assert ("tracks" in r) == track
    if track:
        assert all(r["stream"] == "cam0" and r["tracks"] for r in replies)


def test_serve_cli_artifact_refusals(artifact):
    with pytest.raises(SystemExit, match="--fused needs a fused artifact"):
        serve.main(["--artifact", artifact[0], "--platform", "cpu", "--fused"])
    with pytest.raises(SystemExit, match=r"exported for \['cpu'\]; it cannot run on cuda"):
        serve.main(["--artifact", artifact[0]])
    with pytest.raises(NotImplementedError, match="--compilation_cache"):
        serve.main(["--artifact", artifact[0], "--platform", "cpu", "--compilation_cache"])


def test_cli_dispatcher_lists_the_ported_commands(capsys):
    from sfa3d_tpu_torch.cli import __main__ as dispatcher

    assert list(dispatcher.COMMANDS) == ["train", "yolo-train", "eval", "serve", "export", "argoverse-test",
                                         "test", "fuse", "demo", "track", "slam", "stereo-calib"]
    with pytest.raises(SystemExit) as ex:
        dispatcher.main(["--help"])
    assert ex.value.code == 0
    out = capsys.readouterr().out
    assert all(f"  {name}" in out for name in dispatcher.COMMANDS)
    with pytest.raises(SystemExit) as ex:
        dispatcher.main(["slam-calib"])
    assert ex.value.code == 2 and "unknown command: slam-calib" in capsys.readouterr().out
    # a command runs its module's main with the remaining arguments
    with pytest.raises(NotImplementedError, match="--compilation_cache"):
        dispatcher.main(["serve", "--compilation_cache", "--platform", "cpu"])
