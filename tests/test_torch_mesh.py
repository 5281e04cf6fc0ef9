"""The port's data parallelism (`sfa3d_tpu_torch/parallel/mesh.py`) on the
CPU: two gloo ranks (spawned processes) against the one-process step and
against JAX's `make_train_step(mesh=make_mesh(2))` on the 8 virtual CPU
devices of tests/conftest.py.

KFPN-18 on a 64 x 64 raster, S = 2 micro-batches of B = 2 frames per rank
(4 global), float64, SGD (nesterov momentum) and EMA, one step from one
JAX init (two steps on one batch in `balanced_two_steps`: the data-parallel
step stays the one-process step after the weights have moved). SGD keeps the comparison at the summation order's rounding: Adam's
first update is lr * g / (|g| + eps), which turns a 1e-17 difference in a
near-zero gradient into 1e-11 of a parameter. Held to 1e-10: the loss terms
(relative), every parameter and BatchNorm running statistic (absolute), the
EMA (against JAX within 4 float32 ulps of the step's change more: its decay
goes through a float32 exp, an ulp apart between numpy and XLA). Both ranks
hold identical parameters, statistics and EMA.

The unbalanced case puts every object in rank 0's half: rank 1's frames
have no heatmap peak and no object slot. JAX's step takes the global
positive and object counts and the global BatchNorm statistics; the port
must too, and the per-rank form (each rank normalising by its own counts
and BatchNorm statistics, the losses averaged as DDP would) is shown to
miss JAX's loss by far more than the tolerance.

`replicate` is checked on the same two ranks (a small convolution and
BatchNorm): after an update on its own input and a perturbation, rank 1
must hold rank 0's parameters, BatchNorm
buffers, SGD momentum or Adam moments and step, EMA and step count; a
state whose structure differs across the ranks raises on both.

The spawned ranks get a timeout and are killed when it runs out, so a hung
rendezvous fails its test instead of the suite's time limit.
"""

import threading

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from sfa3d_tpu.config.train import OptimConfig as JOptimConfig
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.parallel import create_train_state as jcreate_train_state
from sfa3d_tpu.parallel import make_mesh as jmake_mesh
from sfa3d_tpu.parallel import make_train_step as jmake_train_step
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu.runtime.schedules import create_optimizer as jcreate_optimizer
from sfa3d_tpu_torch.collectives import all_reduce_sum, data_parallel
from sfa3d_tpu_torch.config.train import OptimConfig
from sfa3d_tpu_torch.data.loader import EpochSampler
from sfa3d_tpu_torch.losses import compute_loss
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import state_dict_from_jax
from sfa3d_tpu_torch.parallel import mesh as pmesh
from tests._mesh_replay import ForcedMesh, replay, replay_rank

HW, HM, S, B_RANK, WORLD = 64, 16, 2, 2, 2
B = B_RANK * WORLD
EMA_DECAY, EMA_TAU = 0.999, 2.0
F64_TOL = 1e-10
EMA_ULPS = 4 * 2.0 ** -24
OPTIM = dict(optimizer_type="sgd", lr=1e-2, lr_type="cosin")
SPAWN_TIMEOUT = 240  # s for both ranks, spawn and torch import included
CASES = ("balanced", "unbalanced", "balanced_two_steps")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port and its spawned ranks on one torch thread each (the ranks
    share this process's threads): beside the JAX workers of a parallel
    test run, more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def global_batch(rng, unbalanced=False):
    """S x B frames (NHWC, float64): a uniform raster and targets with 3
    objects a frame; with `unbalanced`, rank 1's frames (the second half of
    B) hold none."""
    k = 50
    bev = rng.uniform(0, 1, (S, B, HW, HW, 3))
    obj_mask = np.zeros((S, B, k))
    obj_mask[..., :3] = 1
    if unbalanced:
        obj_mask[:, B_RANK:] = 0
    inds = (rng.integers(0, HM * HM, (S, B, k)) * obj_mask).astype(np.int32)
    hm = rng.uniform(0, 0.9, (S, B, HM, HM, 3)) ** 4
    for si in range(S):
        for bi in range(B):
            for j in range(int(obj_mask[si, bi].sum())):
                y, x = np.unravel_index(inds[si, bi, j], (HM, HM))
                hm[si, bi, y, x, int(rng.integers(0, 3))] = 1.0
    m = obj_mask[..., None]
    targets = {
        "hm_cen": hm,
        "cen_offset": rng.uniform(0, 1, (S, B, k, 2)) * m,
        "direction": rng.uniform(-1, 1, (S, B, k, 2)) * m,
        "z_coor": rng.uniform(0, 4, (S, B, k, 1)) * m,
        "dim": rng.uniform(0.5, 4, (S, B, k, 3)) * m,
        "obj_mask": obj_mask,
        "indices_center": inds,
    }
    return {"bev": bev, "targets": targets}


def to_torch(batch):
    return {"bev": torch.from_numpy(batch["bev"]).permute(0, 1, 4, 2, 3),
            "targets": {k: torch.from_numpy(v) for k, v in batch["targets"].items()}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX init (float64 statistics), the two batches, and the port's
    cases written for the ranks."""
    jm = jcreate_model("fpn_resnet_18")
    variables = jtu.tree_map(lambda a: np.asarray(a, np.float64),
                             jinit_detector(jm, jax.random.PRNGKey(0), input_size=(HW, HW)))
    rng = np.random.default_rng(21)
    balanced = global_batch(rng)
    batches = {"balanced": [balanced], "unbalanced": [global_batch(rng, unbalanced=True)],
               "balanced_two_steps": [balanced, balanced]}
    root = tmp_path_factory.mktemp("mesh")
    sd = state_dict_from_jax(variables)
    torch.save(sd, root / "init.pt")  # one copy for every case
    jobs = []
    for name, bs in batches.items():
        case = {"model": "fpn_resnet_18", "state_dict": str(root / "init.pt"), "dtype": torch.float64,
                "tx": ("create_optimizer", OptimConfig(**OPTIM), 10, 1), "ema": (EMA_DECAY, EMA_TAU),
                "batches": [to_torch(b) for b in bs]}
        torch.save(case, root / f"{name}.pt")
        jobs.append((str(root / f"{name}.pt"), str(root / name)))
    replicate_job = (str(root / "replicate"), {"sgd": OptimConfig(**OPTIM),
                                                "adam": OptimConfig(optimizer_type="adam", lr=1e-3)})
    return {"variables": variables, "batches": batches, "root": root, "jobs": jobs, "sd": sd,
            "replicate_job": replicate_job}


@pytest.fixture(scope="module")
def runs(setup):
    """Two gloo ranks replay both cases (in a thread, while JAX compiles its
    mesh step here), JAX's 2-device mesh step on both batches, and the
    one-process port step."""
    errors = []

    def spawn():
        try:
            pmesh.spawn_ranks(replay_rank, WORLD, args=(setup["jobs"], setup["replicate_job"]), device="cpu",
                              timeout=SPAWN_TIMEOUT)
        except BaseException as e:  # reported by the tests
            errors.append(e)

    t = threading.Thread(target=spawn)
    t.start()
    jax_out = {}
    with jax.enable_x64(True):
        jm = jcreate_model("fpn_resnet_18", dtype=jnp.float64)
        tx = jcreate_optimizer(JOptimConfig(**OPTIM), num_epochs=10, steps_per_epoch=1)
        step = jmake_train_step(jm, tx, mesh=jmake_mesh(WORLD), ema_decay=EMA_DECAY, ema_tau=EMA_TAU)
        for name, bs in setup["batches"].items():
            st = jcreate_train_state(jm, setup["variables"], tx, ema=True)
            stats = []
            for b in bs:
                st, st_stats = step(st, b)
                stats.append({k: float(v) for k, v in st_stats.items()})
            jax_out[name] = (jtu.tree_map(np.asarray, st), stats)
    one = {name: replay(torch.load(job[0], weights_only=False)) for name, job in zip(CASES, setup["jobs"])}
    t.join(SPAWN_TIMEOUT + 30)
    assert not t.is_alive(), "the ranks outlived their timeout"
    if errors:
        raise errors[0]
    ranks = {name: [torch.load(f"{job[1]}.rank{r}.pt", weights_only=False) for r in range(WORLD)]
             for name, job in zip(CASES, setup["jobs"])}
    replicated = [torch.load(f"{setup['replicate_job'][0]}.rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jax": jax_out, "one": one, "ranks": ranks, "replicated": replicated}


def _port_sd(jstate, tree=None):
    sd = state_dict_from_jax({"params": jstate.params if tree is None else tree, "batch_stats": jstate.batch_stats})
    return {k: v.double() for k, v in sd.items()}


def _assert_sd_close(got, want, what, atol=F64_TOL):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        err = (got[k].double() - w.double()).abs().max().item()
        assert err <= atol, (what, k, err)


def test_gate_off_by_default(monkeypatch):
    monkeypatch.delenv("SFA3D_DIST", raising=False)
    assert pmesh.maybe_init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.synced) == (1, 0, False)
    with pytest.raises(ValueError, match="process group of 2"):
        pmesh.make_mesh(2, device="cpu")
    monkeypatch.setenv("SFA3D_DIST", "1")
    for k in ("SFA3D_COORDINATOR", "SFA3D_NUM_PROCESSES", "SFA3D_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="SFA3D_COORDINATOR"):
        pmesh.maybe_init_distributed(device="cpu")


def test_process_shards_are_disjoint_and_complete():
    n, world = 37, 3
    shards = [list(EpochSampler(n, shuffle=True, seed=9, process_index=p, process_count=world)) for p in range(world)]
    assert sorted(i for s in shards for i in s) == list(range(n))
    assert all(not (set(a) & set(b)) for i, a in enumerate(shards) for b in shards[i + 1:])
    batch = {"x": torch.arange(2 * 6).reshape(2, 6), "y": [torch.arange(6 * 3).reshape(1, 6, 3)]}
    parts = [pmesh.shard_batch(pmesh.Mesh(world, r, torch.device("cpu")), batch, axis=1) for r in range(world)]
    assert torch.equal(torch.cat([p["x"] for p in parts], 1), batch["x"])
    assert torch.equal(torch.cat([p["y"][0] for p in parts], 1), batch["y"][0])
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(pmesh.Mesh(4, 0, torch.device("cpu")), batch, axis=1)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_the_one_process_step(runs, case):
    one, ranks = runs["one"][case], runs["ranks"][case]
    for r in ranks:
        assert r["world_size"] == WORLD and r["step"] == len(one["stats"]) == len(runs["jax"][case][1])
        for got, want in zip(r["stats"], one["stats"]):
            for k, v in want.items():
                assert abs(got[k] - v) <= F64_TOL * abs(v), (k, got[k], v)
        assert r["equal_to_rank0"], f"rank {r['rank']}'s state differs from rank 0's"
    a, b = ranks  # rank 1's state equals rank 0's bit for bit, so rank 0's stands for both
    _assert_sd_close(a["state_dict"], one["state_dict"], "rank 0")
    _assert_sd_close(a["ema"], one["ema"], "rank 0 ema")
    assert a["stats"] == b["stats"]


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_jax_mesh_step(setup, runs, case):
    after, jstats = runs["jax"][case]
    rank = runs["ranks"][case][0]
    assert len(rank["stats"]) == len(jstats) == rank["step"]
    for got, want in zip(rank["stats"], jstats):
        for k, v in want.items():
            assert abs(got[k] - v) <= F64_TOL * abs(v), (k, got[k], v)
    want = _port_sd(after)
    _assert_sd_close(rank["state_dict"], want, "state")
    start = {k: v.double() for k, v in setup["sd"].items()}
    names = list(rank["ema"])
    moved = max((want[k] - start[k]).abs().max().item() for k in names)
    assert moved > 1e4 * F64_TOL  # the step moved the parameters (not vacuous)
    want_ema = _port_sd(after, after.ema_params)
    for k in names:
        err = (rank["ema"][k].double() - want_ema[k]).abs().max().item()
        assert err <= EMA_ULPS * moved + F64_TOL, (k, err)


def test_unbalanced_objects_need_global_normalizers_and_statistics(setup, runs):
    """The per-rank form (DDP's: each rank's loss over its own counts and
    BatchNorm statistics, then averaged) misses JAX's global loss; the
    port's ranks hit it."""
    jloss = runs["jax"]["unbalanced"][1][0]["total_loss"]
    got = runs["ranks"]["unbalanced"][0]["stats"][0]["total_loss"]
    model = create_model("fpn_resnet_18").double()
    model.load_state_dict(setup["sd"])
    batch = to_torch(setup["batches"]["unbalanced"][0])
    per_rank = []
    with torch.no_grad():
        for s in range(S):
            for r in range(WORLD):
                sl = slice(r * B_RANK, (r + 1) * B_RANK)
                heads = {k: v.permute(0, 2, 3, 1) for k, v in model.train()(batch["bev"][s, sl]).items()}
                per_rank.append(compute_loss(heads, {k: v[s, sl] for k, v in batch["targets"].items()})[0].item())
    per_rank_loss = float(np.mean(per_rank))  # the mean over the ranks and the micro-batches
    assert abs(got - jloss) <= F64_TOL * abs(jloss)
    assert abs(per_rank_loss - jloss) > 1e-3 * abs(jloss), (per_rank_loss, jloss)


def test_spawned_rank_imports_no_jax(runs):
    assert not any(r["jax_imported"] for rs in runs["ranks"].values() for r in rs)


def test_mesh_path_forced_at_world_one_equals_the_plain_step(setup):
    """A gloo group of one in this process with the collectives forced on
    (`ForcedMesh`, as chip_smoke times the mesh path on one card): global
    BatchNorm in flax's order, the all-reduced normalizers and gradients
    give the plain step (cuDNN-free F.batch_norm, local counts) in float64
    to 1e-10; `replicate` leaves the state as it is."""
    case = torch.load(setup["jobs"][1][0], weights_only=False)  # the unbalanced batch
    one = replay(case)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{pmesh.free_port()}",
                                         world_size=1, rank=0)
    try:
        mesh = ForcedMesh(1, 0, torch.device("cpu"))
        forced = replay(case, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    for k, v in one["stats"][0].items():
        assert abs(forced["stats"][0][k] - v) <= F64_TOL * abs(v), (k, forced["stats"][0][k], v)
    _assert_sd_close(forced["state_dict"], one["state_dict"], "forced")
    _assert_sd_close(forced["ema"], one["ema"], "forced ema")


def test_one_rank_is_a_noop():
    model = create_model("fpn_resnet_18")
    mesh = pmesh.make_mesh(device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert pmesh.replicate(mesh, model) is model
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    assert data_parallel(mesh).__class__.__name__ == "nullcontext"
    assert all_reduce_sum(torch.ones(3)).tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_replicate_broadcasts_rank_zero(runs, optimizer):
    """Each rank made an update on its own input and was perturbed, so every
    tensor differed before `replicate`; after it every rank holds rank 0's
    state as rank 0 held it."""
    r0, r1 = (r[optimizer] for r in runs["replicated"])
    want = r0["before"]
    assert r1["before"]["step"] != want["step"]
    for part in ("model", "optimizer", "ema"):
        assert set(want[part]) == set(r1["after"][part]) and want[part], part
        if part == "optimizer":  # momentum; exp_avg, exp_avg_sq and step
            keys = {k.split(".", 1)[1] for k in want[part]}
            assert keys == ({"momentum_buffer"} if optimizer == "sgd" else {"exp_avg", "exp_avg_sq", "step"})
        for k, v in want[part].items():
            assert not torch.equal(r1["before"][part][k], v), (part, k)
            assert torch.equal(r1["after"][part][k], v), (part, k)
            assert torch.equal(r0["after"][part][k], v), (part, k)
    assert r0["after"]["step"] == r1["after"]["step"] == want["step"]


def test_replicate_refuses_a_mismatched_structure_on_every_rank(runs):
    for r in runs["replicated"]:
        assert r["mismatch_error"] is not None and "differently shaped" in r["mismatch_error"], r["rank"]
