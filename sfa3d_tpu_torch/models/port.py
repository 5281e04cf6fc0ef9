"""Weight bridge: JAX package variables and reference `.pth` files -> the
port's KFPN state_dict.

`state_dict_from_jax` is the port's own copy of the mapping in
`sfa3d_tpu/models/port.py:217` (`export_kfpn_state_dict`): flax
`{"params", "batch_stats"}` trees, as numpy, become the reference
PoseResNet state_dict that `KFPN.load_state_dict(strict=True)` takes.

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


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference `.pth` checkpoint into a plain state_dict: unwraps a
    {"state_dict": ...} container and strips DataParallel's `module.`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
