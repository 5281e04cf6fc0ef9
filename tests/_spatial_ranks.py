"""The spawned CPU ranks of the row-sharding tests (tests/test_torch_spatial.py,
test_torch_spatial_step.py, test_torch_spatial_fused.py): module-level
functions of a JAX-free module, which the ranks load by name (they inherit
the test process's sys.path).

`ops_rank` holds `sfa3d_tpu_torch/spatial.py`'s exchange and sharded
layers against slicing and the unsharded ops on seeded float64 maps;
`step_rank` replays training cases (tests/_mesh_replay.py) over data x
spatial meshes; `fused_rank` runs the fused program's two networks and its
detections over a 2 x 2 mesh. Each rank saves what it found to
`<prefix>.rank<r>.pt`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sfa3d_tpu_torch.parallel.mesh import make_mesh_2d, shard_rows
from sfa3d_tpu_torch.spatial import (
    RowConv2d,
    RowConvTranspose2d,
    RowMaxPool2d,
    fetch_rows,
    gather_rows,
    row_range,
    row_sharded,
)

MESHES = ((1, 4), (2, 2))  # (data, spatial) over a world of 4
B, C, W = 2, 3, 6
EXCHANGE_HEIGHTS = (2, 5, 7, 38)  # over 4 ranks: 1+1+0+0, 2+2+1+0, 2+2+2+1, 10+10+10+8


def _jax_imported() -> bool:
    return any(m == "jax" or m.startswith(("jax.", "sfa3d_tpu.")) for m in sys.modules)


def _maxabs(t: torch.Tensor) -> float:
    return t.abs().max().item() if t.numel() else 0.0


def _integer_map(seed: int, shape) -> torch.Tensor:
    """Small integers in float64: every sum of them is exact in any order."""
    return torch.from_numpy(np.random.default_rng(seed).integers(-8, 9, shape).astype(np.float64))


def exchange_requests(height: int, parts: int):
    """Requests of each spatial index for the exchange checks: ranges that
    reach past both ends of the map, cross every owner, repeat other
    ranks' rows and ask for nothing."""
    spans = [(-3, 2), (1, height + 2), (height - 1, height + 4), (0, 0), (height // 2, height // 2 + 1)]
    return [spans[(i * 2 + height) % len(spans)] for i in range(parts)]


def _padded_rows(x: torch.Tensor, a: int, b: int, pad: float) -> torch.Tensor:
    h = x.shape[-2]
    out = x.new_full((*x.shape[:-2], b - a, x.shape[-1]), pad)
    lo, hi = max(a, 0), min(b, h)
    if hi > lo:
        out[..., lo - a:hi - a, :] = x[..., lo:hi, :]
    return out


def _exchange_checks(mesh, rank):
    """fetch_rows and gather_rows against slicing and scatter-add, exactly."""
    found = {}
    n, s = mesh.spatial_size, mesh.spatial_index
    for height in EXCHANGE_HEIGHTS:
        x = _integer_map(height, (B, C, height, W))
        requests = exchange_requests(height, n)
        lo, hi = row_range(height, n, s)
        local = x[..., lo:hi, :].clone().requires_grad_(True)
        with row_sharded(mesh, height, W) as sh:
            got = fetch_rows(local, height, requests, pad=float("-inf") if height % 2 else 0.0)
            # each spatial index sends back its own seeded gradient
            grads = [_integer_map(1000 + 10 * height + q, (B, C, max(0, b - a), W))
                     for q, (a, b) in enumerate(requests)]
            got.backward(grads[s])
            a, b = requests[s]
            want = _padded_rows(x, a, b, float("-inf") if height % 2 else 0.0)
            want_grad = torch.zeros_like(x)
            for (qa, qb), g in zip(requests, grads):
                ra, rb = max(qa, 0), min(qb, height)
                if rb > ra:
                    want_grad[..., ra:rb, :] += g[..., ra - qa:rb - qa, :]
            ok_fetch = torch.equal(got.detach(), want) and torch.equal(local.grad, want_grad[..., lo:hi, :])
            local2 = x[..., lo:hi, :].clone().requires_grad_(True)
            whole = gather_rows(local2, sh)
            g = _integer_map(2000 + height + s, whole.shape)
            whole.backward(g)
            ok_gather = torch.equal(whole.detach(), x) and torch.equal(local2.grad, g[..., lo:hi, :])
        found[height] = {"fetch": ok_fetch, "gather": ok_gather, "rows": hi - lo}
    return found


def _layers():
    """name -> (layer factory, input heights), every op the models split."""
    return {
        "conv_k1_s1": (lambda: RowConv2d(C, 4, 1), (5, 7)),
        "conv_k1_s2": (lambda: RowConv2d(C, 4, 1, stride=2), (5, 8)),
        "conv_k3_s1": (lambda: RowConv2d(C, 4, 3, padding=1, bias=True), (2, 5, 7)),
        "conv_k3_s2": (lambda: RowConv2d(C, 4, 3, stride=2, padding=1), (4, 7, 9)),
        "conv_k7_s2": (lambda: RowConv2d(C, 4, 7, stride=2, padding=3, bias=False), (8, 13)),
        "maxpool_3_s2": (lambda: RowMaxPool2d(3, stride=2, padding=1), (4, 7, 9)),
        "maxpool_5_s1": (lambda: RowMaxPool2d(5, stride=1, padding=2), (2, 5, 7)),
        "upsample_align_corners": ("align", (2, 5, 19)),
        "upsample_nearest_kfpn": ("nearest_kfpn", (2, 5, 19)),
        "upsample_nearest_yolo": ("nearest_yolo", (2, 5, 19)),
        "conv_transpose_k4_s2": (lambda: RowConvTranspose2d(C, 4, 4, stride=2, padding=1, bias=False), (2, 3, 5)),
    }


def _apply(kind, layer, x):
    from sfa3d_tpu_torch.models.kfpn import upsample2x_align_corners, upsample2x_nearest
    from sfa3d_tpu_torch.models.yolov8 import Upsample2x

    if kind == "align":
        return upsample2x_align_corners(x)
    if kind == "nearest_kfpn":
        return upsample2x_nearest(x)
    if kind == "nearest_yolo":
        return Upsample2x()(x)
    return layer(x)


def _layer_checks(mesh):
    """Each sharded layer against the unsharded one: the output gathered
    whole, the input's gradient on the rank's rows and the parameters'
    gradients summed over the spatial group; the largest differences."""
    found = {}
    n, s = mesh.spatial_size, mesh.spatial_index
    for name, (factory, heights) in _layers().items():
        errs = []
        for height in heights:
            torch.manual_seed(height)
            layer = None if isinstance(factory, str) else factory().double()
            kind = factory if isinstance(factory, str) else "layer"
            x = torch.randn(B, C, height, W, dtype=torch.float64, generator=torch.Generator().manual_seed(height))
            full_x = x.clone().requires_grad_(True)
            want = _apply(kind, layer, full_x)
            r = torch.randn(want.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(7 + height))
            (want * r).sum().backward()
            want_params = [p.grad.clone() for p in layer.parameters()] if layer is not None else []
            if layer is not None:
                layer.zero_grad()
            lo, hi = row_range(height, n, s)
            local = x[..., lo:hi, :].clone().requires_grad_(True)
            with row_sharded(mesh, height, W):
                out = gather_rows(_apply(kind, layer, local))
            (out * r).sum().backward()
            err = max(_maxabs(out.detach() - want.detach()), _maxabs(local.grad - full_x.grad[..., lo:hi, :]))
            if layer is not None:
                for p, w in zip(layer.parameters(), want_params):
                    g = p.grad.clone()
                    torch.distributed.all_reduce(g, group=mesh.spatial_group)
                    err = max(err, _maxabs(g - w))
            errs.append(err)
        found[name] = max(errs)
    return found


def ops_rank(prefix: str) -> None:
    """A spawned CPU rank of a world of 4: the exchange and layer checks on
    each mesh of MESHES."""
    torch.set_num_threads(1)
    rank = torch.distributed.get_rank()
    out = {"rank": rank, "meshes": {}}
    for data, spatial in MESHES:
        mesh = make_mesh_2d(data, spatial, device="cpu")
        out["meshes"][(data, spatial)] = {"exchange": _exchange_checks(mesh, rank), "layers": _layer_checks(mesh)}
    out["jax_imported"] = _jax_imported()
    torch.save(out, f"{prefix}.rank{rank}.pt")


def eval_stats(case, state_dict, mesh=None):
    """`make_eval_step` on the case's first micro-batch with the weights
    `state_dict` (this rank's frames of it with a mesh) -> {name: float}."""
    import types

    from sfa3d_tpu_torch.parallel import make_eval_step, shard_batch
    from tests._mesh_replay import _model

    model = _model({**case, "state_dict": state_dict})
    first = case["batches"][0]
    batch = {"bev": first["bev"][0], "targets": {k: v[0] for k, v in first["targets"].items()}}
    if mesh is None:
        stats = make_eval_step(model, device="cpu")(types.SimpleNamespace(model=model), batch)
    else:
        stats = make_eval_step(model, mesh=mesh)(types.SimpleNamespace(model=model), shard_batch(mesh, batch))
    return {k: float(v) for k, v in stats.items()}


def step_rank(jobs) -> None:
    """A spawned CPU rank of a world of 4: for each (case path, (data,
    spatial), output prefix), the case replayed over that mesh
    (tests/_mesh_replay.py::replay), saved with whether this rank's state
    equals rank 0's bit for bit, and, where the case asks for it
    ("eval"), the eval step's stats over the mesh with the trained
    weights."""
    from tests._mesh_replay import _equal_to_rank0, replay

    torch.set_num_threads(1)
    for case_path, shape, prefix in jobs:
        mesh = make_mesh_2d(*shape, device="cpu")
        case = torch.load(case_path, weights_only=False)
        out = replay(case, mesh=mesh)
        if case.get("eval"):
            out["eval"] = eval_stats(case, out["state_dict"], mesh)
        tensors = list(out["state_dict"].values()) + list((out["ema"] or {}).values())
        out.update(rank=mesh.rank, jax_imported=_jax_imported(), equal_to_rank0=_equal_to_rank0(tensors))
        if mesh.rank:
            out["state_dict"] = out["ema"] = None
        torch.save(out, f"{prefix}.rank{mesh.rank}.pt")


def fused_rank(case_path: str, prefix: str) -> None:
    """A spawned CPU rank of a world of 4 on a 2 x 2 mesh: the fused
    program's KFPN heads and YOLOv8 levels in float64 (the rank's frames,
    whole) against the one-device program's, and the program's float32
    detections of the rank's data shard."""
    from sfa3d_tpu_torch.fusion.batch import FusedProgram, build_fused_pipeline
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8
    from sfa3d_tpu_torch.parallel.mesh import shard_batch

    torch.set_num_threads(1)
    case = torch.load(case_path, weights_only=False)
    mesh = make_mesh_2d(2, 2, device="cpu")
    kfpn = create_model("fpn_resnet_18")
    kfpn.load_state_dict(case["kfpn"])
    yolo = YOLOv8("n", 80)
    yolo.load_state_dict(case["yolo"])
    kfpn.eval(), yolo.eval()
    out = {"rank": mesh.rank}
    kw = case["kw"]
    dets = build_fused_pipeline(kfpn, yolo, device="cpu", mesh=mesh, **kw)(*case["inputs"])
    out["detections"] = {k: v.numpy() for k, v in dets.items()}
    kfpn64, yolo64 = kfpn.double(), yolo.double()
    bev, images = (shard_batch(mesh, torch.as_tensor(case[k]).double()) for k in ("bev64", "images64"))
    sharded, whole = FusedProgram(kfpn64, yolo64, mesh=mesh, **kw), FusedProgram(kfpn64, yolo64, **kw)
    with torch.inference_mode():
        got_heads, want_heads = sharded.kfpn_heads(bev), whole.kfpn_heads(bev)
        got_levels, want_levels = sharded.yolo_levels(images), whole.yolo_levels(images)
    out["heads_err"] = max((got_heads[k] - want_heads[k]).abs().max().item() for k in want_heads)
    out["levels_err"] = max((g - w).abs().max().item() for gl, wl in zip(got_levels, want_levels)
                            for g, w in zip(gl, wl))
    out["heads_scale"] = max(v.abs().max().item() for v in want_heads.values())
    out["local_rows"] = shard_rows(mesh, bev).shape[-2]
    out["jax_imported"] = _jax_imported()
    torch.save(out, f"{prefix}.rank{mesh.rank}.pt")
