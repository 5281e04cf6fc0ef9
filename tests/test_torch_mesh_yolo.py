"""The port's YOLOv8 epoch data-parallel over two gloo ranks (spawned
processes, `parallel/yolo_step.py` with `mesh=`) against JAX's
`make_yolo_epoch_fn(mesh=make_mesh(2))` on the 8 virtual CPU devices of
tests/conftest.py, and against the port's one-process epoch.

S = 2 steps of B = 4 frames (2 a rank) at 64 x 128, YOLOv8n with 3 classes
from one JAX init, AdamW with a 1-step warmup and EMA, the global batch's
hflip draws from JAX's keys. In float64 (JAX under a scoped
`jax.enable_x64` with the YOLO float32 pins lifted,
tests/test_torch_yolo_loss.py::jax_float64; float64 ground-truth boxes):
the epoch's mean losses and num_fg within 1e-10 relative, every parameter
and BatchNorm statistic within 1e-10 absolute, the EMA within 1e-10 plus
4 float32 ulps of the largest parameter change (its decay goes through a
float32 exp, an ulp apart between numpy and XLA). Rank 1's frames hold
fewer boxes than rank 0's, so the global target-score normalizer and the
global BatchNorm statistics both matter. Both ranks end identical.
"""

import threading

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from sfa3d_tpu.models import yolov8 as jyolo
from sfa3d_tpu.parallel import make_mesh as jmake_mesh
from sfa3d_tpu.parallel import yolo_step as jstep
from sfa3d_tpu_torch.models.port import yolo_state_dict_from_jax
from sfa3d_tpu_torch.parallel import mesh as pmesh
from sfa3d_tpu_torch.runtime.schedules import warmup_cosine_decay_schedule
from tests._mesh_replay import replay, replay_rank
from tests.test_torch_yolo_loss import jax_float64

HW = (64, 128)
N_FRAMES, S, B, G, C, WORLD = 6, 2, 4, 8, 3, 2
LR, WD, WARMUP, DECAY_STEPS = 1e-2, 5e-4, 1, 4
EMA_DECAY, EMA_TAU = 0.999, 2.0
EMA_ULPS = 4 * 2.0 ** -24
F64_TOL = 1e-10
SPAWN_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port and its spawned ranks on one torch thread each (the ranks
    share this process's threads): beside the JAX workers of a parallel
    test run, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(rng):
    """N_FRAMES random frames, G box slots; frames 3-5 hold at most 2 boxes."""
    images = rng.integers(0, 256, (N_FRAMES, *HW, 3)).astype(np.uint8)
    xy = rng.uniform(0, [HW[1] - 12, HW[0] - 12], (N_FRAMES, G, 2))
    wh = rng.uniform(8, 40, (N_FRAMES, G, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [HW[1], HW[0]])], -1)
    mask = rng.random((N_FRAMES, G)) < 0.8
    mask[3:, 2:] = False
    return {"images": images, "boxes": boxes, "labels": rng.integers(0, C, (N_FRAMES, G)).astype(np.int32),
            "mask": mask}


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    model = jyolo.YOLOv8(scale="n", num_classes=C)
    init = jtu.tree_map(np.asarray, model.init(jax.random.PRNGKey(3), jnp.zeros((1, *HW, 3)), train=True))
    v64 = jtu.tree_map(lambda a: np.asarray(a, np.float64), init)
    data = _split(np.random.default_rng(4))
    # rank 0 takes columns 0-1 of each step (frames 0-2), rank 1 columns 2-3 (frames 3-5: fewer boxes)
    idx = np.asarray([[0, 1, 3, 4], [2, 0, 5, 3]], np.int32)
    sched = warmup_cosine_decay_schedule(0.0, LR, WARMUP, DECAY_STEPS, LR * 0.01)
    table = [sched(i) for i in range(S)]
    key = jax.random.PRNGKey(11)
    with jax_float64():  # the draws of the JAX epoch, which runs under x64
        flips = np.stack([np.asarray(jax.random.bernoulli(k, 0.5, (B,))) for k in jax.random.split(key, S)])
    assert 0 < flips.sum() < flips.size

    root = tmp_path_factory.mktemp("mesh_yolo")
    case = {"model": ("yolov8", "n", C), "state_dict": yolo_state_dict_from_jax(v64, "n", C), "dtype": torch.float64,
            "tx": ("adamw", table, WD), "ema": (EMA_DECAY, EMA_TAU), "imgsz": HW,
            "data": {k: torch.from_numpy(v) for k, v in data.items()}, "idx": torch.from_numpy(idx),
            "flips": torch.from_numpy(flips)}
    torch.save(case, root / "yolo.pt")
    errors = []

    def spawn():
        try:
            pmesh.spawn_ranks(replay_rank, WORLD, args=([(str(root / "yolo.pt"), str(root / "yolo"))],),
                              device="cpu", timeout=SPAWN_TIMEOUT)
        except BaseException as e:  # reported by the tests
            errors.append(e)

    t = threading.Thread(target=spawn)
    t.start()
    with jax_float64():
        jm = jyolo.YOLOv8(scale="n", num_classes=C, dtype=jnp.float64)
        lr = jnp.asarray(np.asarray(table, np.float64))
        tx = optax.adamw(lambda count: lr[count], weight_decay=WD,
                         mask=jtu.tree_map(lambda p: p.ndim > 1, v64["params"]))
        state = jstep.create_train_state(jm, v64, tx, ema=True)
        epoch_fn = jstep.make_yolo_epoch_fn(jm, tx, HW, ema_decay=EMA_DECAY, ema_tau=EMA_TAU, mesh=jmake_mesh(WORLD))
        state, metrics = epoch_fn(state, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(idx), key)
        after = jtu.tree_map(np.asarray, state)
        metrics = {k: float(v) for k, v in metrics.items()}
    one = replay(case)
    t.join(SPAWN_TIMEOUT + 30)
    assert not t.is_alive(), "the ranks outlived their timeout"
    if errors:
        raise errors[0]
    ranks = [torch.load(root / f"yolo.rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"v64": v64, "after": after, "metrics": metrics, "one": one, "ranks": ranks}


def _compare(got_sd, want_sd, atol, what):
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked") or k.endswith("dfl.conv.weight"):
            continue
        err = (got_sd[k].double() - w.double()).abs().max().item()
        assert err <= atol, (what, k, err)


def test_yolo_epoch_two_ranks_equal_jax_mesh(epochs):
    after, metrics, ranks = epochs["after"], epochs["metrics"], epochs["ranks"]
    want_sd = yolo_state_dict_from_jax({"params": after.params, "batch_stats": after.batch_stats}, "n", C)
    start_sd = yolo_state_dict_from_jax(epochs["v64"], "n", C)
    moved = max((want_sd[k] - start_sd[k]).abs().max().item() for k in want_sd if k.endswith("weight"))
    assert moved > 1e-3  # the parameters moved in the epoch
    want_ema = yolo_state_dict_from_jax({"params": after.ema_params, "batch_stats": after.batch_stats}, "n", C)
    for r in ranks:
        assert r["world_size"] == WORLD and r["step"] == S and not r["jax_imported"]
        for k, w in metrics.items():
            assert abs(r["stats"][0][k] - w) <= F64_TOL * abs(w), (k, r["stats"][0][k], w)
        assert r["equal_to_rank0"], f"rank {r['rank']}'s state differs from rank 0's"
    a = ranks[0]  # rank 1's state equals rank 0's bit for bit, so rank 0's stands for both
    _compare(a["state_dict"], want_sd, F64_TOL, "rank 0")
    _compare(a["ema"], {k: want_ema[k] for k in a["ema"]}, F64_TOL + EMA_ULPS * moved, "rank 0 ema")


def test_yolo_epoch_two_ranks_equal_one_process(epochs):
    one = epochs["one"]
    for r in epochs["ranks"]:
        for k, w in one["stats"][0].items():
            assert abs(r["stats"][0][k] - w) <= F64_TOL * abs(w), (k, r["stats"][0][k], w)
        assert r["equal_to_rank0"]
    _compare(epochs["ranks"][0]["state_dict"], one["state_dict"], F64_TOL, "rank 0")
    _compare(epochs["ranks"][0]["ema"], one["ema"], F64_TOL, "rank 0 ema")
