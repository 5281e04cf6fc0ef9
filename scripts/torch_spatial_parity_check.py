"""Numerical-equivalence proof for the port's sharded train steps (dp and
dp x sp): the port of scripts/spatial_parity_check.py.

Claim under test (`sfa3d_tpu_torch/parallel/train_step.py` over
`parallel/mesh.py::make_mesh` and `make_mesh_2d`): sharding the batch over
'data', and the BEV rows over 'spatial' too, where the port writes the
row exchanges itself (`sfa3d_tpu_torch/spatial.py`), computes the SAME loss
and the SAME parameter update as the unsharded step on identical init and
data. Float64, as the JAX proof: in float32 the sharded reductions'
reassociation flips ReLU kinks and an updated step differs by whole
percents, while a halo or collective fault makes O(1) errors at any
precision. Bounds: every loss term within 1e-12 relative, every
parameter's update within 1e-9 relative of its tensor's largest change.

KFPN-18 on a 64 x 64 raster (`--hw`), S = 2 micro-batches of 4 frames,
SGD, from a seeded init; four ranks: dp = make_mesh() over the four (one
frame each), dpsp = make_mesh_2d(2, 2) (two frames a data index, half the
rows a rank). On cuda (the default) the ranks take one card each over
NCCL when four are visible (the exchange's batched point-to-point
route), else they are gloo ranks sharing the visible cards
(`spawn_ranks(..., backend="gloo")`; the exchange stages rows through
host memory); the unsharded step runs in this process on cuda:0.
`--platform cpu` runs everything on the CPU. Raises without a GPU unless
given `--platform cpu`.

    python3 scripts/torch_spatial_parity_check.py [--platform cpu]

Prints one JSON line with JAX's keys: loss_unsharded, {dp,dpsp}_worst_loss_rel,
{dp,dpsp}_worst_update_rel, {dp,dpsp}_worst_update_leaf, ok; and the
ranks' backend and device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

LOSS_RTOL = 1e-12
UPDATE_RTOL = 1e-9
WORLD = 4
MESHES = {"dp": None, "dpsp": (2, 2)}  # None: make_mesh() over the world
S, B = 2, 4
SPAWN_TIMEOUT = 600


def seeded_batch(seed: int, hw: int):
    """S x B frames (NCHW, float64): a uniform raster and targets with 3
    objects a frame on the heatmap grid (hw / 4)."""
    rng = np.random.default_rng(seed)
    hm_hw, k = hw // 4, 50
    bev = rng.uniform(0, 1, (S, B, 3, hw, hw))
    obj_mask = np.zeros((S, B, k))
    obj_mask[..., :3] = 1
    inds = (rng.integers(0, hm_hw * hm_hw, (S, B, k)) * obj_mask).astype(np.int32)
    hm = rng.uniform(0, 0.9, (S, B, hm_hw, hm_hw, 3)) ** 4
    for si in range(S):
        for bi in range(B):
            for j in range(3):
                y, x = np.unravel_index(inds[si, bi, j], (hm_hw, hm_hw))
                hm[si, bi, y, x, int(rng.integers(0, 3))] = 1.0
    m = obj_mask[..., None]
    targets = {"hm_cen": hm, "cen_offset": rng.uniform(0, 1, (S, B, k, 2)) * m,
               "direction": rng.uniform(-1, 1, (S, B, k, 2)) * m, "z_coor": rng.uniform(0, 4, (S, B, k, 1)) * m,
               "dim": rng.uniform(0.5, 4, (S, B, k, 3)) * m, "obj_mask": obj_mask, "indices_center": inds}
    return {"bev": torch.from_numpy(bev), "targets": {k: torch.from_numpy(v) for k, v in targets.items()}}


def make_case(hw: int = 64, seed: int = 7):
    """The init (float64 state_dict) and the batch."""
    from sfa3d_tpu_torch.models import create_model

    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(seed)).double()
    return {"state_dict": model.state_dict(), "batch": seeded_batch(seed, hw)}


def one_step(case, device, mesh=None):
    """One SGD step from the case's init on its batch (this rank's shard of
    it with a mesh) -> (stats, parameters after the step, on the host)."""
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step, replicate, shard_batch
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    model = create_model("fpn_resnet_18").double()
    model.load_state_dict(case["state_dict"])
    model.to(device)
    spec = create_optimizer(OptimConfig(optimizer_type="sgd", lr=1e-2, lr_type="multi_step", steps=(100,)),
                            num_epochs=10, steps_per_epoch=5)
    state = create_train_state(model, spec)
    if mesh is None:
        step = make_train_step(model, spec, device=device)
        batch = {"bev": case["batch"]["bev"].to(device),
                 "targets": {k: v.to(device) for k, v in case["batch"]["targets"].items()}}
    else:
        replicate(mesh, state)
        step = make_train_step(model, spec, mesh=mesh)
        batch = shard_batch(mesh, case["batch"], axis=1)
    state, stats = step(state, batch)
    return ({k: float(v) for k, v in stats.items()},
            {k: p.detach().cpu() for k, p in model.named_parameters()})


def parity_rank(case_path: str, prefix: str) -> None:
    """A rank of a world of four (its group already joined): the dp and the
    dpsp step on this rank's shard; rank 0 saves both results to
    `<prefix>.pt`, the other ranks whether their parameters equal rank 0's."""
    from sfa3d_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    case = torch.load(case_path, weights_only=False)
    device = torch.device("cuda", torch.cuda.current_device()) if case["platform"] == "cuda" else "cpu"
    out = {}
    for label, shape in MESHES.items():
        mesh = make_mesh(device=device) if shape is None else make_mesh_2d(*shape, device=device)
        stats, params = one_step(case, device, mesh)
        equal = True
        for v in params.values():
            ref = v.to(mesh.device, copy=True)
            torch.distributed.broadcast(ref, src=0)
            equal = equal and torch.equal(ref.cpu(), v)
        out[label] = {"stats": stats, "params": params if mesh.rank == 0 else None, "equal_to_rank0": equal}
    rank = torch.distributed.get_rank()
    torch.save(out, f"{prefix}.rank{rank}.pt")


def compare(ref, sharded, params0):
    """(worst loss-term relative error, worst update relative error, its
    leaf) of one sharded run against the unsharded one."""
    stats_ref, params_ref = ref
    worst_loss = max(abs(sharded["stats"][k] - v) / max(abs(v), 1e-300) for k, v in stats_ref.items())
    worst_upd, worst_leaf, checked = 0.0, None, 0
    for k, p_ref in params_ref.items():
        upd_ref = p_ref - params0[k]
        upd = sharded["params"][k] - params0[k]
        scale = upd_ref.abs().max().item()
        if scale == 0.0:
            if upd.abs().max().item() != 0.0:
                return worst_loss, float("inf"), k
            continue
        rel = (upd - upd_ref).abs().max().item() / scale
        if rel > worst_upd:
            worst_upd, worst_leaf = rel, k
        checked += 1
    if checked < 10:
        raise AssertionError(f"only {checked} nonzero-update leaves")
    return worst_loss, worst_upd, worst_leaf


def report(case, ranks, device):
    """The JSON report of the ranks' results against the unsharded step run
    here on `device`; raises when a bound is broken."""
    ref = one_step(case, device)
    params0 = {k: v.cpu() for k, v in case["state_dict"].items()}
    out = {"loss_unsharded": ref[0]["total_loss"]}
    for label in MESHES:
        if not all(r[label]["equal_to_rank0"] for r in ranks):
            raise AssertionError(f"{label}: the ranks' parameters differ")
        worst_loss, worst_upd, leaf = compare(ref, ranks[0][label], params0)
        out.update({f"{label}_worst_loss_rel": worst_loss, f"{label}_worst_update_rel": worst_upd,
                    f"{label}_worst_update_leaf": leaf})
        if not (worst_loss <= LOSS_RTOL and worst_upd <= UPDATE_RTOL):
            raise AssertionError(f"{label}: loss {worst_loss}, update {worst_upd} ({leaf}) beyond the bounds")
    out["ok"] = True
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--hw", type=int, default=64, help="raster side (a multiple of 32)")
    args = ap.parse_args(argv)
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.parallel.mesh import spawn_ranks

    device = resolve_device(args.platform)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    case = {**make_case(args.hw), "platform": device.type}
    backend = "nccl" if device.type == "cuda" and torch.cuda.device_count() >= WORLD else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        case_path, prefix = os.path.join(tmp, "case.pt"), os.path.join(tmp, "parity")
        torch.save(case, case_path)
        spawn_ranks(parity_rank, WORLD, args=(case_path, prefix), device=device, timeout=SPAWN_TIMEOUT,
                    backend=backend)
        ranks = [torch.load(f"{prefix}.rank{r}.pt", weights_only=False) for r in range(WORLD)]
    out = report(case, ranks, device)
    out.update(backend=backend, device=torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
