"""The data-parallel layer of the port over `torch.distributed`: the
counterpart of `sfa3d_tpu/parallel/mesh.py`.

JAX runs one controller over N devices and lets a data-sharded jit
partition the program. The port runs the PyTorch idiom: one process (a
"rank") per device, joined by a process group. The names keep JAX's
meanings:

- `make_mesh(n_devices=None)`: a `Mesh` describing the data-parallel group
  this process belongs to (world size, rank, device, process group).
  Without an initialised process group it is a world of one.
- `shard_batch(mesh, batch, axis=0)`: this rank's contiguous 1/world slice
  of a global batch, on the rank's device (JAX's sharding of the batch axis
  over 'data'). A loader built with process_index / process_count already
  yields the local slice and needs no call.
- `replicate(mesh, state)`: broadcast the parameters, buffers, optimizer
  state, step and EMA from rank 0, so every rank starts equal.
- `maybe_init_distributed(device=None)`: the multi-process launch, gated on
  SFA3D_DIST=1 and reading SFA3D_COORDINATOR (host:port),
  SFA3D_NUM_PROCESSES and SFA3D_PROCESS_ID as the JAX package does;
  `init_process_group` over tcp://, NCCL on cuda and gloo on the CPU.
- `spawn_ranks(fn, world_size, ...)`: N local ranks with the spawn start
  method, one per `cuda:i` (or N CPU ranks, or with backend="gloo" N ranks
  sharing the cards), each in a process group.

Under a data-sharded jit two things are global that PyTorch's defaults
keep per rank: BatchNorm statistics (XLA turns the reduction into a psum)
and the loss normalizers (the focal loss's positive count, the L1 mask
sums, YOLOv8's target-score sum). Inside
`collectives.py::data_parallel(mesh)` a forward and its loss see the
group: `models/resnet.py::FlaxBatchNorm2d` all-reduces its per-channel
sums, and the losses all-reduce their normalizers before they divide, so
each rank's loss is its local share of JAX's global loss and the
gradients, summed over the ranks (`all_reduce_grads`), are JAX's.

At world size 1 nothing is wrapped and no collective runs:
`data_parallel` is then a null context and the step is the one-device
step.

Data x spatial (JAX's `make_mesh_2d`): `make_mesh_2d(data, spatial)` puts
rank r at (data r // spatial, spatial r % spatial), JAX's
`reshape(data, spatial)` order, and carries three groups: the world, the
spatial group (the ranks that share a data index) and the data group (the
ranks that share a spatial index). `shard_batch` gives a rank its frames
(over 'data') and `shard_rows` its rows (over 'spatial', by
`spatial.py::row_range`). Inside `data_parallel` BatchNorm reduces over the
world and the losses' normalizers over the data group
(`collectives.py`); `spatial.py::row_sharded` splits a network's rows.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.spatial import shard_rows  # noqa: F401  (the mesh's rows, beside shard_batch)

DATA_AXIS = "data"  # the 1-D mesh's one axis (JAX's name)
SPATIAL_AXIS = "spatial"  # make_mesh_2d's second axis: feature-map rows
GRAD_BUCKET_BYTES = 25 << 20  # gradients all-reduced in flat buckets of about this size
INIT_TIMEOUT = datetime.timedelta(minutes=10)  # rendezvous and collectives of a launched group


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data-parallel group: `world_size` ranks,
    this process's `rank`, its `device`, and the process `group` (None for
    the default group). `synced` is True when there is more than one rank:
    only then do BatchNorm, the losses and the steps run collectives."""

    world_size: int
    rank: int
    device: torch.device
    group: Any = None

    @property
    def synced(self) -> bool:
        return self.world_size > 1

    @property
    def process_group(self):
        """The group collectives run over (the default group when None)."""
        return dist.group.WORLD if self.group is None else self.group

    @property
    def data_size(self) -> int:
        """Ranks along 'data': each holds other frames of the batch."""
        return self.world_size

    @property
    def data_index(self) -> int:
        return self.rank

    @property
    def spatial_size(self) -> int:
        """Ranks along 'spatial': each holds other rows of the same frames."""
        return 1

    @property
    def loss_group(self):
        """The group the losses' normalizers are summed over: the ranks
        that hold other frames' targets (None when there is one)."""
        return self.process_group


@dataclasses.dataclass(frozen=True)
class Mesh2D(Mesh):
    """One rank's view of a (data x spatial) mesh over the whole process
    group: rank r is at (data r // spatial, spatial r % spatial);
    `spatial_group` holds the ranks of its data index (`spatial_ranks`),
    `data_group` the ranks of its spatial index. BatchNorm statistics and the gradients are summed over
    the world, the losses' normalizers over the data group."""

    data: int = 1
    spatial: int = 1
    spatial_group: Any = None
    data_group: Any = None

    @property
    def data_size(self) -> int:
        return self.data

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_size(self) -> int:
        return self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def spatial_ranks(self) -> Tuple[int, ...]:
        """The global ranks of the spatial group, in spatial order."""
        first = self.rank - self.spatial_index
        return tuple(range(first, first + self.spatial))

    @property
    def loss_group(self):
        return self.data_group if self.data > 1 else None


def _group_device(device: Device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device: Device = None, group: Any = None) -> Mesh:
    """The data-parallel group of this process: the initialised process
    group (or `group`), else a world of one. `n_devices=None` takes every
    rank of the group; a number must equal the group's size. `device`
    defaults to cuda (the current cuda device); pass "cpu" on the CPU."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        if group is not None:
            raise ValueError("a process group was given but torch.distributed is not initialised")
        world, rank = 1, 0
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process group of {n_devices} ranks; "
                         f"this one has {world} (start the ranks with spawn_ranks or SFA3D_DIST)")
    return Mesh(world_size=world, rank=rank, device=_group_device(device), group=group)


def make_mesh_2d(data: int, spatial: int, device: Device = None) -> Mesh2D:
    """The (data x spatial) mesh of this process: the initialised process
    group, whose size must be data * spatial (or a world of one when both
    are 1). Every rank creates the spatial groups, then the data groups,
    with `dist.new_group` in one order; each keeps its own. `device` as in
    make_mesh."""
    if data < 1 or spatial < 1:
        raise ValueError(f"a mesh of {data} x {spatial} ranks")
    initialised = dist.is_available() and dist.is_initialized()
    world, rank = (dist.get_world_size(), dist.get_rank()) if initialised else (1, 0)
    if world != data * spatial:
        raise ValueError(f"a {data} x {spatial} mesh needs a process group of {data * spatial} ranks; "
                         f"this one has {world} (start the ranks with spawn_ranks or SFA3D_DIST)")
    spatial_group = data_group = None
    if world > 1:
        for d in range(data):
            g = dist.new_group([d * spatial + s for s in range(spatial)])
            if d == rank // spatial:
                spatial_group = g
        for s in range(spatial):
            g = dist.new_group([d * spatial + s for d in range(data)])
            if s == rank % spatial:
                data_group = g
    return Mesh2D(world_size=world, rank=rank, device=_group_device(device), data=data, spatial=spatial,
                  spatial_group=spatial_group, data_group=data_group)


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every parameter's .grad over the ranks in place, in flat buckets
    of about GRAD_BUCKET_BYTES per dtype, issued in parameter order (the
    same on every rank). A parameter without a gradient is skipped; it
    must be so on every rank."""
    if not mesh.synced:
        return
    buckets, room = [], 0
    for p in params:
        g = p.grad
        if g is None:
            continue
        if buckets and buckets[-1][0].dtype == g.dtype and room > 0:
            buckets[-1].append(g)
        else:
            buckets.append([g])
            room = GRAD_BUCKET_BYTES
        room -= g.numel() * g.element_size()
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.process_group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def min_over_ranks(mesh: Mesh, value: int) -> int:
    """The smallest of every rank's `value` (one collective when synced)."""
    if not mesh.synced:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.process_group)
    return int(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (nothing at world size 1)."""
    if mesh is not None and mesh.synced:
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def _shard(mesh: Mesh, x, axis: int):
    if isinstance(x, dict):
        return {k: _shard(mesh, v, axis) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_shard(mesh, v, axis) for v in x)
    t = torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    n = t.shape[axis]
    if n % mesh.data_size:
        raise ValueError(f"batch axis {axis} of size {n} does not divide over {mesh.data_size} ranks")
    k = n // mesh.data_size
    return t.narrow(axis, mesh.data_index * k, k).to(mesh.device)


def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """This rank's slice of a global batch (a tensor, or a dict / list /
    tuple of them): rows [i * n / d, (i + 1) * n / d) of `axis` (1 for the
    (S, B, ...) accumulation stacks), i the rank's data index and d the
    ranks along 'data' (the world on a 1-D mesh), on the mesh's device. The
    batch axis must divide by d."""
    return _shard(mesh, batch, axis)


def _state_tensors(state):
    """Every tensor a rank holds of a train state (or a module, or a dict
    of tensors), in an order that is the same on every rank."""
    if isinstance(state, torch.nn.Module):
        return list(state.state_dict().values())
    if isinstance(state, dict):
        return [v for _, v in sorted(state.items())]
    out = list(state.model.state_dict().values())
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            out += [v for _, v in sorted(state.optimizer.state.get(p, {}).items()) if torch.is_tensor(v)]
    if state.ema_params is not None:
        out += [v for _, v in sorted(state.ema_params.items())]
    return out


def replicate(mesh: Mesh, state):
    """Broadcast a train state (parameters, buffers, optimizer state and
    step, EMA), a module or a dict of tensors from rank 0 to every rank, in
    place; returns it. At world size 1, the state as it is. The ranks must
    hold the same structure (they build it the same way); a mismatch
    raises on every rank before any tensor moves."""
    if not mesh.synced:
        return state
    tensors = _state_tensors(state)
    step = getattr(state, "step", None)
    sig = torch.tensor([len(tensors), sum(v.numel() for v in tensors), -1 if step is None else 0],
                       dtype=torch.int64, device=mesh.device)
    lo, hi = sig.clone(), sig.clone()  # all_reduce MIN / MAX: gloo gathers no cuda tensors
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.process_group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.process_group)
    if not torch.equal(lo, hi):
        raise ValueError(f"replicate: the ranks hold differently shaped states ({lo.tolist()} .. {hi.tolist()})")
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    for v in tensors:
        if v.device == mesh.device:
            dist.broadcast(v.data, src=src, group=mesh.group)
        else:  # e.g. Adam's step counter on the host under NCCL
            buf = v.data.to(mesh.device)
            dist.broadcast(buf, src=src, group=mesh.group)
            v.data.copy_(buf)
    if step is not None:
        t = torch.tensor([int(step)], dtype=torch.int64, device=mesh.device)
        dist.broadcast(t, src=src, group=mesh.group)
        state.step = int(t.item())
    return state


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def maybe_init_distributed(device: Device = None) -> bool:
    """Join the process group of a multi-process launch when SFA3D_DIST=1;
    returns False (and does nothing) otherwise. The rendezvous is
    SFA3D_COORDINATOR (host:port), the world SFA3D_NUM_PROCESSES and this
    process's rank SFA3D_PROCESS_ID. On cuda (the default) the backend is
    NCCL and the rank takes cuda:(rank modulo the visible GPUs); on the CPU
    it is gloo."""
    env = os.environ
    if not env.get("SFA3D_DIST"):
        return False
    if dist.is_initialized():
        return True
    missing = [k for k in ("SFA3D_COORDINATOR", "SFA3D_NUM_PROCESSES", "SFA3D_PROCESS_ID") if not env.get(k)]
    if missing:
        raise ValueError(f"SFA3D_DIST=1 needs SFA3D_COORDINATOR (host:port), SFA3D_NUM_PROCESSES and "
                         f"SFA3D_PROCESS_ID; missing {missing}")
    world, rank = int(env["SFA3D_NUM_PROCESSES"]), int(env["SFA3D_PROCESS_ID"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(_backend(dev), init_method=f"tcp://{env['SFA3D_COORDINATOR']}", world_size=world,
                            rank=rank, timeout=INIT_TIMEOUT)
    return True


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, world_size: int, init_method: str, devices: Sequence[str],
                threads: int, args: tuple, backend: str) -> None:
    """One spawned rank: its device, its process group, then fn(*args)."""
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(threads)
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # local ranks meet on the loopback
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=INIT_TIMEOUT)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), device: Device = None,
                timeout: Optional[float] = None, backend: Optional[str] = None) -> None:
    """Run fn(*args) in `world_size` new processes (the spawn start method),
    each a rank of one process group over tcp://127.0.0.1:<a free port>.
    `fn` must be a module-level function. On cuda (the default) rank i
    takes cuda:i over NCCL, which refuses two ranks on one GPU, so the
    world needs that many visible GPUs; with backend="gloo" rank i takes
    cuda:(i modulo the visible GPUs) over gloo, so ranks may share a card
    (a check of correctness, not of speed). "cpu" gives CPU ranks over gloo
    that share this process's torch threads. Raises if a rank fails;
    after `timeout` seconds every rank still running is killed and
    TimeoutError raised."""
    dev = resolve_device(device)
    backend = _backend(dev) if backend is None else backend
    if dev.type == "cuda" and backend == "gloo":
        devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(world_size)]
    elif dev.type == "cuda":
        if world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} ranks need {world_size} GPUs; {torch.cuda.device_count()} visible "
                             "(NCCL refuses two ranks on one GPU)")
        devices = [f"cuda:{i}" for i in range(world_size)]
    else:
        devices = ["cpu"] * world_size
    threads = max(1, torch.get_num_threads() // world_size)  # CPU ranks share this process's threads
    init = f"tcp://127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, world_size, init, devices, threads, tuple(args), backend),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks still running after {timeout} s; killed")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
