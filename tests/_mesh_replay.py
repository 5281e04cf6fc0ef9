"""Replay a recorded training case on one process or data-parallel over the
ranks of a process group: the helper of tests/test_torch_mesh.py and
tests/test_torch_mesh_yolo.py, which hold the data-parallel steps
(`sfa3d_tpu_torch/parallel/mesh.py`) to the one-process steps on the
global batch. It imports no JAX: the spawned ranks load it by name (they
inherit the test process's sys.path) and must stay JAX-free.

A case is a dict (saved with `torch.save`):
  "model":       "fpn_resnet_18" (KFPN) or ("yolov8", scale, num_classes)
  "state_dict":  the initial weights and BatchNorm statistics, or the path
                 of a file that holds them (cases that share them)
  "dtype":       the parameters' dtype
  "tx":          ("create_optimizer", OptimConfig, num_epochs, steps_per_epoch)
                 or ("adamw", [learning rate of each step], weight_decay)
  "ema":         (decay, tau), or None
  "compute_dtype": (optional, KFPN) the step's compute dtype, "float32" if absent
  KFPN:          "batches": [global {"bev": (S, B, 3, H, W), "targets": ...}],
                 one train step each
  YOLOv8:        "data" (the split), "idx" (S, B), "flips" (S, B), "imgsz":
                 one epoch
"""

from __future__ import annotations

import sys

import torch

from sfa3d_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch


class ForcedMesh(Mesh):
    """A mesh whose collectives run at world size 1 too: the data-parallel
    path on a group of one, which must give the plain step."""

    @property
    def synced(self) -> bool:
        return True


class _Table:
    """A learning-rate schedule given as one value per step (picklable)."""

    def __init__(self, values):
        self.values = [float(v) for v in values]

    def __call__(self, step: int) -> float:
        return self.values[min(int(step), len(self.values) - 1)]


def _optimizer(tx):
    from sfa3d_tpu_torch.runtime.schedules import OptimizerSpec, create_optimizer

    if tx[0] == "create_optimizer":
        return create_optimizer(*tx[1:])
    return OptimizerSpec("adamw", _Table(tx[1]), weight_decay=tx[2])


def _model(case):
    if isinstance(case["model"], str):
        from sfa3d_tpu_torch.models import create_model

        model = create_model(case["model"])
    else:
        from sfa3d_tpu_torch.models.yolov8 import YOLOv8

        _, scale, num_classes = case["model"]
        model = YOLOv8(scale, num_classes)
    sd = case["state_dict"]
    model.load_state_dict(torch.load(sd, weights_only=True) if isinstance(sd, str) else sd, strict=True)
    return model.to(case["dtype"])


def replay(case, mesh=None):
    """Run the case on the CPU, data-parallel over the mesh's ranks when a
    mesh is given (each rank takes its slice of every batch after
    `replicate`). Returns {"stats": [{name: float} per step or epoch],
    "state_dict", "ema" (or None), "step" (updates made)}."""
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step, yolo_step

    device = None if mesh is not None else "cpu"
    model = _model(case)
    spec = _optimizer(case["tx"])
    ema = case["ema"]
    out = {"stats": []}
    if isinstance(case["model"], str):
        state = create_train_state(model, spec, ema=ema is not None)
        if mesh is not None:
            replicate(mesh, state)
        step = make_train_step(model, spec, *(ema or (0.0,)), compute_dtype=case.get("compute_dtype", "float32"),
                               device=device, mesh=mesh)
        here = mesh if mesh is not None else Mesh(1, 0, torch.device("cpu"))
        for batch in case["batches"]:
            state, stats = step(state, shard_batch(here, batch, axis=1))
            out["stats"].append({k: float(v) for k, v in stats.items()})
    else:
        state = yolo_step.create_train_state(model, spec, ema=ema is not None)
        if mesh is not None:
            replicate(mesh, state)
        epoch = yolo_step.make_yolo_epoch_fn(model, spec, case["imgsz"], *(ema or (0.0,)), device=device, mesh=mesh)
        state, metrics = epoch(state, case["data"], case["idx"], flips=case["flips"])
        out["stats"].append({k: float(v) for k, v in metrics.items()})
    out["state_dict"] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out["ema"] = None if state.ema_params is None else {k: v.clone() for k, v in state.ema_params.items()}
    out["step"] = state.step
    return out


def _jax_imported() -> bool:
    return any(m == "jax" or m.startswith(("jax.", "sfa3d_tpu.")) for m in sys.modules)


def _equal_to_rank0(tensors) -> bool:
    """Whether this rank's tensors equal rank 0's bit for bit (each
    broadcast from rank 0 and compared here)."""
    equal = True
    for v in tensors:
        ref = v.clone()
        torch.distributed.broadcast(ref, src=0)
        equal = equal and torch.equal(ref, v)
    return equal


def replay_rank(jobs, replicate_job=None) -> None:
    """A spawned CPU rank: for each (case path, output prefix), replay the
    case over the process group and save the result, with the rank, the
    world size, whether jax or the JAX package was imported and whether its
    parameters, statistics and EMA equal rank 0's bit for bit, to
    `<prefix>.rank<r>.pt` (the state itself from rank 0 only); then
    `replicate_rank(*replicate_job)`, if given."""
    mesh = make_mesh(device="cpu")
    for case_path, out_prefix in jobs:
        out = replay(torch.load(case_path, weights_only=False), mesh=mesh)
        tensors = list(out["state_dict"].values()) + list((out["ema"] or {}).values())
        out.update(rank=mesh.rank, world_size=mesh.world_size, jax_imported=_jax_imported(),
                   equal_to_rank0=_equal_to_rank0(tensors))
        if mesh.rank:
            out["state_dict"] = out["ema"] = None
        torch.save(out, f"{out_prefix}.rank{mesh.rank}.pt")
    if replicate_job is not None:
        replicate_rank(*replicate_job)


def _perturb_rank(state, rank: int) -> None:
    """Move every tensor of a train state on this rank by rank + 1 (so no
    two ranks agree), and its step count by 10 * rank."""
    with torch.no_grad():
        for v in state.model.state_dict().values():
            v.add_(rank + 1)
        for opt_state in state.optimizer.state.values():
            for v in opt_state.values():
                if torch.is_tensor(v):
                    v.add_(rank + 1)
        for v in state.ema_params.values():
            v.add_(rank + 1)
    state.step += 10 * rank


class TinyNet(torch.nn.Module):
    """A convolution and the port's BatchNorm: a train state with
    parameters, running statistics and optimizer state, small enough to
    save whole from every rank."""

    def __init__(self):
        super().__init__()
        from sfa3d_tpu_torch.models.resnet import FlaxBatchNorm2d

        self.conv = torch.nn.Conv2d(3, 4, 3)
        self.bn = FlaxBatchNorm2d(4)

    def forward(self, x):
        return self.bn(self.conv(x))


def replicate_rank(out_prefix: str, optimizers) -> None:
    """A spawned CPU rank: for each OptimConfig of `optimizers` (by name),
    one update of a TinyNet on this rank's own input (so the optimizer
    holds state: momentum; exp_avg, exp_avg_sq, step), then every tensor
    and the step count made to differ from the other ranks', then
    `replicate`. Saves each state as it was before and after, and what
    `replicate` raised for a state whose structure differs across the
    ranks (rank 1's EMA misses a tensor), to `<prefix>.rank<r>.pt`."""
    from sfa3d_tpu_torch.parallel import create_train_state
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    mesh = make_mesh(device="cpu")
    out = {"rank": mesh.rank}
    for name, optim in optimizers.items():
        model = TinyNet().double()
        spec = create_optimizer(optim, num_epochs=10, steps_per_epoch=1)
        state = create_train_state(model, spec, ema=True)
        x = torch.randn(2, 3, 8, 8, dtype=torch.float64, generator=torch.Generator().manual_seed(mesh.rank))
        model.train()(x).square().mean().backward()
        state.optimizer.step()
        state.step = 1
        _perturb_rank(state, mesh.rank)
        before = _snapshot(state)
        replicate(mesh, state)
        out[name] = {"before": before, "after": _snapshot(state)}
    if mesh.rank == 1:
        state.ema_params.pop(next(iter(state.ema_params)))
    try:
        replicate(mesh, state)
        out["mismatch_error"] = None
    except ValueError as e:
        out["mismatch_error"] = str(e)
    torch.save(out, f"{out_prefix}.rank{mesh.rank}.pt")


def _snapshot(state):
    """Every tensor of a train state by name, copied, and its step count."""
    opt = {f"{i}.{k}": v.clone() for i, p in enumerate(state.model.parameters())
           for k, v in state.optimizer.state.get(p, {}).items() if torch.is_tensor(v)}
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()}, "optimizer": opt,
            "ema": {k: v.clone() for k, v in state.ema_params.items()}, "step": state.step}
