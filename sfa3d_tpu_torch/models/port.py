"""Weight bridge: JAX package variables and reference `.pth` files -> the
port's KFPN and YOLOv8 state_dicts.

`state_dict_from_jax` is the port's own copy of the mapping in
`sfa3d_tpu/models/port.py:217` (`export_kfpn_state_dict`): flax
`{"params", "batch_stats"}` trees, as numpy, become the reference
PoseResNet state_dict that `KFPN.load_state_dict(strict=True)` takes.
`yolo_state_dict_from_jax` does the same for YOLOv8 in the ultralytics
layout.

Layout: flax conv kernel (kH, kW, I, O) -> torch weight (O, I, kH, kW);
BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
running_mean/running_var.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

from sfa3d_tpu_torch.models.kfpn import HEADS
from sfa3d_tpu_torch.models.resnet import RESNET_SPEC


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32).transpose(3, 2, 0, 1)))


def state_dict_from_jax(variables: Mapping[str, Any], num_layers: int = 18) -> "OrderedDict[str, torch.Tensor]":
    """JAX KFPN variables (numpy leaves) -> the port's KFPN state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put_convbn(p, s, torch_conv, torch_bn):
        sd[f"{torch_conv}.weight"] = _kernel(p["conv"]["kernel"])
        if "bias" in p["conv"]:
            sd[f"{torch_conv}.bias"] = _t(p["conv"]["bias"])
        sd[f"{torch_bn}.weight"] = _t(p["bn"]["scale"])
        sd[f"{torch_bn}.bias"] = _t(p["bn"]["bias"])
        sd[f"{torch_bn}.running_mean"] = _t(s["bn"]["mean"])
        sd[f"{torch_bn}.running_var"] = _t(s["bn"]["var"])
        sd[f"{torch_bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    bb_p, bb_s = params["backbone"], stats["backbone"]
    put_convbn(bb_p["stem"], bb_s["stem"], "conv1", "bn1")
    block_cls, counts = RESNET_SPEC[num_layers]
    n_convs = 3 if block_cls.expansion == 4 else 2
    for stage, blocks in enumerate(counts):
        for i in range(blocks):
            f = f"layer{stage + 1}_{i}"
            t = f"layer{stage + 1}.{i}"
            for c in range(1, n_convs + 1):
                put_convbn(bb_p[f][f"cb{c}"], bb_s[f][f"cb{c}"], f"{t}.conv{c}", f"{t}.bn{c}")
            if "downsample" in bb_p[f]:
                put_convbn(bb_p[f]["downsample"], bb_s[f]["downsample"],
                           f"{t}.downsample.0", f"{t}.downsample.1")

    for lvl in (1, 2, 3):
        node = params[f"conv_up_level{lvl}"]
        sd[f"conv_up_level{lvl}.weight"] = _kernel(node["kernel"])
        sd[f"conv_up_level{lvl}.bias"] = _t(node["bias"])

    for idx in range(3):
        for head in HEADS:
            t = f"fpn{idx}_{head}"
            node = params[t]
            sd[f"{t}.0.weight"] = _kernel(node["conv1"]["kernel"])
            sd[f"{t}.0.bias"] = _t(node["conv1"]["bias"])
            sd[f"{t}.2.weight"] = _kernel(node["conv2"]["kernel"])
            sd[f"{t}.2.bias"] = _t(node["conv2"]["bias"])
    return sd


def yolo_state_dict_from_jax(variables: Mapping[str, Any], scale: str = "n",
                             num_classes: int = 80) -> "OrderedDict[str, torch.Tensor]":
    """JAX YOLOv8 variables (numpy leaves) -> the ultralytics-layout
    state_dict (`model.N.*`) that the port's `YOLOv8.load_state_dict(strict=
    True)` takes: the port's own copy of the mapping in
    `sfa3d_tpu/models/yolov8.py:486` (`export_ultralytics_state_dict`), with
    the same keys in the same order, BatchNorm `num_batches_tracked` and the
    fixed DFL kernel `model.22.dfl.conv.weight` included."""
    from sfa3d_tpu_torch.models.yolov8 import (
        _UL_BACKBONE, _UL_NECK, HEAD_INDEX, REG_MAX, scale_depths,
    )

    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def get(tree, path):
        for p in path:
            tree = tree[p]
        return tree

    def conv_bn(prefix, path):
        sd[f"{prefix}.conv.weight"] = _kernel(get(params, path + ("conv", "kernel")))
        sd[f"{prefix}.bn.weight"] = _t(get(params, path + ("bn", "scale")))
        sd[f"{prefix}.bn.bias"] = _t(get(params, path + ("bn", "bias")))
        sd[f"{prefix}.bn.running_mean"] = _t(get(stats, path + ("bn", "mean")))
        sd[f"{prefix}.bn.running_var"] = _t(get(stats, path + ("bn", "var")))
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def plain_conv(prefix, path):
        sd[f"{prefix}.weight"] = _kernel(get(params, path + ("kernel",)))
        sd[f"{prefix}.bias"] = _t(get(params, path + ("bias",)))

    d1, d2, d3, d4 = scale_depths(scale)
    c2f_depth = {"c2f1": d1, "c2f2": d2, "c2f3": d3, "c2f4": d4,
                 "n_c2f1": d4, "n_c2f2": d4, "n_c2f3": d4, "n_c2f4": d4}
    for idx, name in {**_UL_BACKBONE, **_UL_NECK}.items():
        prefix = f"model.{idx}"
        if name in c2f_depth:
            conv_bn(f"{prefix}.cv1", (name, "cv1"))
            conv_bn(f"{prefix}.cv2", (name, "cv2"))
            for i in range(c2f_depth[name]):
                conv_bn(f"{prefix}.m.{i}.cv1", (name, f"m{i}", "cv1"))
                conv_bn(f"{prefix}.m.{i}.cv2", (name, f"m{i}", "cv2"))
        elif name == "sppf":
            conv_bn(f"{prefix}.cv1", ("sppf", "cv1"))
            conv_bn(f"{prefix}.cv2", ("sppf", "cv2"))
        else:
            conv_bn(prefix, (name,))

    det = f"model.{HEAD_INDEX}"
    for i in range(3):
        for b in range(2):
            conv_bn(f"{det}.cv2.{i}.{b}", ("detect", f"cv2_{i}_{b}"))
            conv_bn(f"{det}.cv3.{i}.{b}", ("detect", f"cv3_{i}_{b}"))
        plain_conv(f"{det}.cv2.{i}.2", ("detect", f"cv2_{i}_2"))
        plain_conv(f"{det}.cv3.{i}.2", ("detect", f"cv3_{i}_2"))
    sd[f"{det}.dfl.conv.weight"] = torch.arange(REG_MAX, dtype=torch.float32).reshape(1, REG_MAX, 1, 1)
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference `.pth` checkpoint into a plain state_dict: unwraps a
    {"state_dict": ...} container and strips DataParallel's `module.`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
