"""The port's data x spatial train step (`parallel/train_step.py` over
`parallel/mesh.py::make_mesh_2d`) on the CPU: four spawned gloo ranks
against JAX's `make_train_step(mesh=make_mesh_2d(2, 2))` on the 8 virtual
CPU devices of tests/conftest.py and against the port's one-process step.

KFPN-18 on a 64 x 64 raster, S = 2 micro-batches of 4 frames (2 a data
index), float64, SGD (nesterov momentum) and EMA, one step from one JAX
init. The bounds are JAX's own proof's (scripts/spatial_parity_check.py):
every loss term within 1e-12 relative, and every parameter's update within
1e-9 relative of the largest change of its tensor; against the port's
one-process step also every parameter and BatchNorm statistic within 1e-10
absolute (tests/test_torch_mesh.py's bound). Cases:

- 2 x 2: against JAX's 2 x 2 step and the one-process step; then
  `make_eval_step` over the same mesh (the batch over 'data' only, as
  JAX's eval step) against the one-process eval step, within 1e-10;
- 1 x 4: layer4 has 2 rows for 4 ranks, so two ranks own none of its rows
  (the case JAX's Shardy partitioner got wrong, twice the kernel
  gradients), against the one-process step;
- resnet_18 (the deconv arch) on 1 x 4, where the transposed convolutions
  read the rows of two ranks that own none, against the one-process step;
- KFPN on 1 x 4 in float32 under bfloat16 autocast (the training CLI's
  default dtype), where the empty maps of the ranks with no rows must take
  the autocast type of the others: the loss terms within 1e-2 relative of
  the one-process bfloat16 step (bfloat16 rounding), every rank equal.

JAX's 2-D step turns the Shardy partitioner off for the whole process
(jax 0.9's workaround in `sfa3d_tpu/parallel/train_step.py`); the module
runs it once and restores the flag. The spawned ranks get a timeout and
are killed when it runs out.
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
from sfa3d_tpu.parallel import make_train_step as jmake_train_step
from sfa3d_tpu.parallel.mesh import make_mesh_2d as jmake_mesh_2d
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu.runtime.schedules import create_optimizer as jcreate_optimizer
from sfa3d_tpu_torch.config.train import OptimConfig
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import state_dict_from_jax
from sfa3d_tpu_torch.parallel import mesh as pmesh
from scripts.torch_spatial_parity_check import seeded_batch
from tests._mesh_replay import replay
from tests._spatial_ranks import eval_stats, step_rank

HW = 64
WORLD = 4
EMA_DECAY, EMA_TAU = 0.999, 2.0
LOSS_RTOL = 1e-12  # loss terms, relative
UPDATE_RTOL = 1e-9  # each parameter's update, relative to its tensor's largest change
F64_TOL = 1e-10  # parameters and statistics against the one-process step, absolute
EMA_ULPS = 4 * 2.0 ** -24  # the EMA's float32 decay: an ulp apart between numpy and XLA
OPTIM = dict(optimizer_type="sgd", lr=1e-2, lr_type="cosin")
SPAWN_TIMEOUT = 300  # s for the four ranks, spawn and torch import included
BF16_LOSS_RTOL = 1e-2  # loss terms of the bfloat16 case, relative
CASES = {"kfpn_2x2": ("fpn_resnet_18", (2, 2)), "kfpn_1x4": ("fpn_resnet_18", (1, 4)),
         "deconv_1x4": ("resnet_18", (1, 4))}
BF16_CASE = "kfpn_1x4_bfloat16"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port and its ranks on one torch thread each (the ranks share
    this process's threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm = jcreate_model("fpn_resnet_18")
    variables = jtu.tree_map(lambda a: np.asarray(a, np.float64),
                             jinit_detector(jm, jax.random.PRNGKey(0), input_size=(HW, HW)))
    tbatch = seeded_batch(5, HW)  # S x B frames: a uniform raster, 3 objects a frame
    batch = {"bev": tbatch["bev"].permute(0, 1, 3, 4, 2).numpy(),  # JAX's NHWC
             "targets": {k: v.numpy() for k, v in tbatch["targets"].items()}}
    root = tmp_path_factory.mktemp("spatial_step")
    sds = {"fpn_resnet_18": state_dict_from_jax(variables),
           "resnet_18": create_model("resnet_18").init_weights(torch.Generator().manual_seed(3)).state_dict()}
    jobs = []
    for name, (arch, shape) in CASES.items():
        case = {"model": arch, "state_dict": sds[arch], "dtype": torch.float64,
                "tx": ("create_optimizer", OptimConfig(**OPTIM), 10, 1), "ema": (EMA_DECAY, EMA_TAU),
                "batches": [tbatch], "eval": name == "kfpn_2x2"}
        torch.save(case, root / f"{name}.pt")
        jobs.append((str(root / f"{name}.pt"), shape, str(root / name)))
    f32 = {"bev": tbatch["bev"].float(), "targets": {k: v.float() if v.is_floating_point() else v
                                                     for k, v in tbatch["targets"].items()}}
    case = {"model": "fpn_resnet_18", "state_dict": {k: v.float() for k, v in sds["fpn_resnet_18"].items()},
            "dtype": torch.float32, "tx": ("create_optimizer", OptimConfig(**OPTIM), 10, 1), "ema": None,
            "compute_dtype": "bfloat16", "batches": [f32]}
    torch.save(case, root / f"{BF16_CASE}.pt")
    jobs.append((str(root / f"{BF16_CASE}.pt"), (1, 4), str(root / BF16_CASE)))
    return {"variables": variables, "batch": batch, "sds": sds, "jobs": jobs}


@pytest.fixture(scope="module")
def runs(setup):
    """The ranks replay every case (in a thread, while JAX compiles its 2 x 2
    step here), JAX's 2 x 2 step, and the one-process port step of each
    case."""
    errors = []

    def spawn():
        try:
            pmesh.spawn_ranks(step_rank, WORLD, args=(setup["jobs"],), device="cpu", timeout=SPAWN_TIMEOUT)
        except BaseException as e:  # reported by the tests
            errors.append(e)

    t = threading.Thread(target=spawn)
    t.start()
    shardy = jax.config.jax_use_shardy_partitioner
    try:
        with jax.enable_x64(True):
            jm = jcreate_model("fpn_resnet_18", dtype=jnp.float64)
            tx = jcreate_optimizer(JOptimConfig(**OPTIM), num_epochs=10, steps_per_epoch=1)
            step = jmake_train_step(jm, tx, mesh=jmake_mesh_2d(2, 2), ema_decay=EMA_DECAY, ema_tau=EMA_TAU)
            st, stats = step(jcreate_train_state(jm, setup["variables"], tx, ema=True), setup["batch"])
            jax_out = (jtu.tree_map(np.asarray, st), {k: float(v) for k, v in stats.items()})
    finally:
        jax.config.update("jax_use_shardy_partitioner", shardy)
    names = [*CASES, BF16_CASE]
    one = {name: replay(torch.load(job[0], weights_only=False)) for name, job in zip(names, setup["jobs"])}
    t.join(SPAWN_TIMEOUT + 30)
    assert not t.is_alive(), "the ranks outlived their timeout"
    if errors:
        raise errors[0]
    ranks = {name: [torch.load(f"{job[2]}.rank{r}.pt", weights_only=False) for r in range(WORLD)]
             for name, job in zip(names, setup["jobs"])}
    return {"jax": jax_out, "one": one, "ranks": ranks, "shardy_before": shardy}


def _assert_updates(got, want, start, names, what):
    """Every parameter's update within UPDATE_RTOL of its tensor's largest
    change; returns how many tensors moved."""
    moved = 0
    for k in names:
        upd_want = want[k].double() - start[k].double()
        scale = upd_want.abs().max().item()
        err = (got[k].double() - start[k].double() - upd_want).abs().max().item()
        if scale == 0.0:
            assert err == 0.0, (what, k)
            continue
        assert err <= UPDATE_RTOL * scale, (what, k, err / scale)
        moved += 1
    return moved


def _assert_loss(got, want, what):
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_RTOL * abs(v), (what, k, got[k], v)


@pytest.mark.parametrize("case", list(CASES))
def test_spatial_step_equals_the_one_process_step(setup, runs, case):
    one, ranks = runs["one"][case], runs["ranks"][case]
    arch = CASES[case][0]
    start = setup["sds"][arch]
    names = [k for k, _ in create_model(arch).named_parameters()]
    for r in ranks:
        assert r["step"] == 1 and r["equal_to_rank0"], (case, r["rank"])
        _assert_loss(r["stats"][0], one["stats"][0], case)
    a = ranks[0]  # every rank's state equals rank 0's bit for bit
    assert _assert_updates(a["state_dict"], one["state_dict"], start, names, case) >= 10
    for k, w in one["state_dict"].items():
        if not k.endswith("num_batches_tracked"):
            err = (a["state_dict"][k].double() - w.double()).abs().max().item()
            assert err <= F64_TOL, (case, k, err)
    for k, w in one["ema"].items():
        assert (a["ema"][k] - w).abs().max().item() <= F64_TOL, (case, "ema", k)


def test_spatial_step_equals_jax_2d_step(setup, runs):
    jstate, jstats = runs["jax"]
    rank = runs["ranks"]["kfpn_2x2"][0]
    _assert_loss(rank["stats"][0], jstats, "against JAX")
    want = {k: v.double() for k, v in state_dict_from_jax({"params": jstate.params,
                                                          "batch_stats": jstate.batch_stats}).items()}
    start = setup["sds"]["fpn_resnet_18"]
    names = list(rank["ema"])
    assert _assert_updates(rank["state_dict"], want, start, names, "against JAX") >= 10
    for k, w in want.items():
        if k not in names and not k.endswith("num_batches_tracked"):  # BatchNorm statistics
            assert (rank["state_dict"][k].double() - w).abs().max().item() <= F64_TOL, k
    want_ema = state_dict_from_jax({"params": jstate.ema_params, "batch_stats": jstate.batch_stats})
    moved = max((want[k] - start[k].double()).abs().max().item() for k in names)
    for k in names:
        err = (rank["ema"][k].double() - want_ema[k].double()).abs().max().item()
        assert err <= EMA_ULPS * moved + F64_TOL, (k, err)


def test_eval_step_over_the_2d_mesh(setup, runs):
    case = torch.load(setup["jobs"][0][0], weights_only=False)
    want = eval_stats(case, runs["one"]["kfpn_2x2"]["state_dict"])
    for r in runs["ranks"]["kfpn_2x2"]:
        for k, v in want.items():
            assert abs(r["eval"][k] - v) <= F64_TOL * abs(v), (r["rank"], k, r["eval"][k], v)


def test_bfloat16_autocast_step_with_zero_row_ranks(runs):
    ranks, one = runs["ranks"][BF16_CASE], runs["one"][BF16_CASE]
    assert all(r["equal_to_rank0"] and r["step"] == 1 for r in ranks)
    for k, v in one["stats"][0].items():
        got = ranks[0]["stats"][0][k]
        assert abs(got - v) <= BF16_LOSS_RTOL * abs(v), (k, got, v)


def test_zero_row_ranks_ran_every_exchange(runs):
    """On 1 x 4 two ranks own no row of layer4 and still took part: their
    states equal the others' and their losses the whole batch's."""
    for case in ("kfpn_1x4", "deconv_1x4"):
        ranks = runs["ranks"][case]
        assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
        assert all(r["equal_to_rank0"] for r in ranks)
        assert len({r["stats"][0]["total_loss"] for r in ranks}) == 1


def test_shardy_flag_restored_and_ranks_import_no_jax(runs):
    assert jax.config.jax_use_shardy_partitioner == runs["shardy_before"]
    assert not any(r["jax_imported"] for rs in runs["ranks"].values() for r in rs)
