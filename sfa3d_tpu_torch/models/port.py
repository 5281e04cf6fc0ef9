"""Weight bridge: JAX package variables and reference `.pth` files -> the
port's KFPN and YOLOv8 state_dicts.

`state_dict_from_jax` is the port's own copy of the mapping in
`sfa3d_tpu/models/port.py:217` (`export_kfpn_state_dict`): flax
`{"params", "batch_stats"}` trees, as numpy, become the reference
PoseResNet state_dict that `KFPN.load_state_dict(strict=True)` takes.
`deconv_state_dict_from_jax` does the same for the deconv arch
(`DeconvCenterNet`, the `resnet_*` archs).
`yolo_state_dict_from_jax` does the same for YOLOv8 in the ultralytics
layout.

Layout: flax conv kernel (kH, kW, I, O) -> torch weight (O, I, kH, kW);
BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
running_mean/running_var. float64 leaves stay float64 (the float64 parity
checks); every other float becomes float32.

`state_dict_from_jax` also takes the variables of the JAX package's two
KFPN reformulations, which the port does not build: an `s2d_stem` model's
(4, 4, 12, 64) stem kernel becomes the 7x7 one, and a `fused_heads`
model's `fused{idx}_conv1` / `fused{idx}_conv2` pairs become the five
towers (`_standard_kfpn_params`); the port's standard KFPN then computes
the same function.

`load_train_state_from_jax` carries a whole JAX `TrainState` (params,
batch_stats, the optax moments, step, ema_params) into the port's
training state, so both sides start a step from the same numbers; a
`DeconvCenterNet` takes the deconv bridge.
`load_torch_checkpoint` reads reference `.pth` files and the port's own
training checkpoints (`runtime/checkpoint.py`).
`port_torchvision_backbone` / `load_imagenet_backbone` merge a
torchvision ImageNet ResNet into a model's backbone (`--imagenet_pretrained`).
"""

from __future__ import annotations

import glob
import os
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from sfa3d_tpu_torch.models.kfpn import HEADS
from sfa3d_tpu_torch.models.resnet import RESNET_SPEC


def _float(a) -> np.ndarray:
    a = np.asarray(a)
    return np.array(a, dtype=np.float64 if a.dtype == np.float64 else np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(_float(a))


def _kernel(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_float(a).transpose(3, 2, 0, 1)))


def _backbone_from_jax(sd, params, stats, num_layers: int) -> None:
    """The ResNet backbone's entries (reference names) into `sd`."""

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


def _head_from_jax(sd, node, prefix: str) -> None:
    sd[f"{prefix}.0.weight"] = _kernel(node["conv1"]["kernel"])
    sd[f"{prefix}.0.bias"] = _t(node["conv1"]["bias"])
    sd[f"{prefix}.2.weight"] = _kernel(node["conv2"]["kernel"])
    sd[f"{prefix}.2.bias"] = _t(node["conv2"]["bias"])


def _stem_kernel_from_s2d(k4) -> np.ndarray:
    """The inverse of the JAX package's `stem_kernel_to_s2d`: a (4, 4, 4C, F)
    stride-1 kernel over the space-to-depth input -> the (7, 7, C, F)
    stride-2 stem, K8[2u + dy, 2v + dx, c, f] = K4[u, v, (dy * 2 + dx) * C
    + c, f] without K8's first row and column, which the transform leaves
    zero (ValueError otherwise: no 7x7 stem computes that kernel)."""
    k4 = np.asarray(k4)
    c, f = k4.shape[2] // 4, k4.shape[3]
    k8 = k4.reshape(4, 4, 2, 2, c, f).transpose(0, 2, 1, 3, 4, 5).reshape(8, 8, c, f)
    if k8[0].any() or k8[:, 0].any():
        raise ValueError("the s2d stem kernel has taps outside the 7x7 window: not a converted standard stem")
    return k8[1:, 1:]


def _towers_from_fused(conv1, conv2, idx: int) -> Dict[str, Any]:
    """A `fused_heads` level's conv pair -> the five head towers, the
    inverse of the JAX package's `fuse_head_params`: conv1 splits along its
    outputs and conv2 keeps its diagonal blocks, in the heads' sorted order.
    An off-diagonal conv2 weight that is not zero raises ValueError (the
    towers cannot compute it)."""
    order = sorted(HEADS.items())
    k1, b1 = np.asarray(conv1["kernel"]), np.asarray(conv1["bias"])
    k2, b2 = np.asarray(conv2["kernel"]), np.asarray(conv2["bias"])
    hc = k1.shape[-1] // len(order)
    off_diagonal = np.array(k2, copy=True)
    towers, off_in, off_out = {}, 0, 0
    for head, out_ch in order:
        rows, cols = slice(off_in, off_in + hc), slice(off_out, off_out + out_ch)
        towers[f"fpn{idx}_{head}"] = {"conv1": {"kernel": k1[..., rows], "bias": b1[rows]},
                                      "conv2": {"kernel": k2[:, :, rows, cols], "bias": b2[cols]}}
        off_diagonal[:, :, rows, cols] = 0
        off_in, off_out = off_in + hc, off_out + out_ch
    if off_diagonal.any():
        raise ValueError(f"fused{idx}_conv2 mixes the heads (off-diagonal weights): not separable into towers")
    return towers


def _standard_kfpn_params(params: Mapping[str, Any]) -> Mapping[str, Any]:
    """JAX KFPN params of any layout -> the standard layout: an `s2d_stem`
    stem kernel back to 7x7, `fused_heads` pairs back to towers; standard
    params come back as they are."""
    stem = params["backbone"]["stem"]["conv"]["kernel"]
    fused = "fused0_conv1" in params
    if np.shape(stem)[0] == 7 and not fused:
        return params
    params = dict(params)
    if np.shape(stem)[0] != 7:
        stem_node = {**params["backbone"]["stem"], "conv": {**params["backbone"]["stem"]["conv"],
                                                            "kernel": _stem_kernel_from_s2d(stem)}}
        params["backbone"] = {**params["backbone"], "stem": stem_node}
    if fused:
        for idx in range(3):
            params.update(_towers_from_fused(params.pop(f"fused{idx}_conv1"), params.pop(f"fused{idx}_conv2"), idx))
    return params


def state_dict_from_jax(variables: Mapping[str, Any], num_layers: int = 18) -> "OrderedDict[str, torch.Tensor]":
    """JAX KFPN variables (numpy leaves; the standard, `s2d_stem` or
    `fused_heads` layout) -> the port's KFPN state_dict."""
    params = _standard_kfpn_params(variables["params"])
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _backbone_from_jax(sd, params, variables.get("batch_stats", {}), num_layers)
    for lvl in (1, 2, 3):
        node = params[f"conv_up_level{lvl}"]
        sd[f"conv_up_level{lvl}.weight"] = _kernel(node["kernel"])
        sd[f"conv_up_level{lvl}.bias"] = _t(node["bias"])
    for idx in range(3):
        for head in HEADS:
            _head_from_jax(sd, params[f"fpn{idx}_{head}"], f"fpn{idx}_{head}")
    return sd


def deconv_state_dict_from_jax(variables: Mapping[str, Any], num_layers: int = 18) -> "OrderedDict[str, torch.Tensor]":
    """JAX `DeconvCenterNet` variables (numpy leaves) -> the port's
    DeconvCenterNet state_dict in the reference deconv PoseResNet layout, the
    inverse of `sfa3d_tpu/models/port.py::port_deconv_state_dict` (:188):
    deconv i is `deconv_layers.{3i}` (flax kernel (kH, kW, O, I) -> torch
    (I, O, kH, kW)) and its BatchNorm `deconv_layers.{3i + 1}`; head towers
    are `{head}.0` / `{head}.2`."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    _backbone_from_jax(sd, params, stats, num_layers)
    for i in range(3):
        conv, bn = f"deconv_layers.{3 * i}", f"deconv_layers.{3 * i + 1}"
        sd[f"{conv}.weight"] = _kernel(params[f"deconv{i}"]["kernel"])
        sd[f"{bn}.weight"] = _t(params[f"deconv_bn{i}"]["scale"])
        sd[f"{bn}.bias"] = _t(params[f"deconv_bn{i}"]["bias"])
        sd[f"{bn}.running_mean"] = _t(stats[f"deconv_bn{i}"]["mean"])
        sd[f"{bn}.running_var"] = _t(stats[f"deconv_bn{i}"]["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    for head in HEADS:
        _head_from_jax(sd, params[f"head_{head}"], head)
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


def _find_moments(node, attr: str):
    """The optax state node that carries `attr` ('mu' of Adam, 'trace' of
    SGD), searched through chains and inject_hyperparams wrappers."""
    if hasattr(node, attr):
        return node
    if hasattr(node, "inner_state"):
        return _find_moments(node.inner_state, attr)
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_moments(child, attr)
            if found is not None:
                return found
    return None


def load_train_state_from_jax(state, jax_state, num_layers: int = 18):
    """Carry a JAX `TrainState` into the port's `TrainState` (in place):
    params and batch_stats into the model, the optax moments into the
    torch.optim state (Adam mu / nu / count -> exp_avg / exp_avg_sq / step;
    the SGD trace -> momentum_buffer), the step, and ema_params. Tensors
    take the model's dtype and device. The JAX state's leaves only need to
    convert with np.asarray (the port imports no JAX). Returns `state`."""

    def host(tree):
        if isinstance(tree, Mapping):
            return {k: host(v) for k, v in tree.items()}
        return np.asarray(tree)

    from sfa3d_tpu_torch.models.centernet_deconv import DeconvCenterNet

    batch_stats = host(jax_state.batch_stats)
    model = state.model
    bridge = deconv_state_dict_from_jax if isinstance(model, DeconvCenterNet) else state_dict_from_jax
    ref = next(model.parameters())
    sd = bridge({"params": host(jax_state.params), "batch_stats": batch_stats}, num_layers)
    model.load_state_dict(sd, strict=True)
    names = [k for k, _ in model.named_parameters()]

    def as_params(tree):
        out = bridge({"params": host(tree), "batch_stats": batch_stats}, num_layers)
        return {k: out[k].to(ref.dtype).to(ref.device) for k in names}

    params = dict(model.named_parameters())
    adam = _find_moments(jax_state.opt_state, "mu")
    sgd = _find_moments(jax_state.opt_state, "trace")
    opt = state.optimizer
    if adam is not None:
        mu, nu = as_params(adam.mu), as_params(adam.nu)
        step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
        for k in names:
            opt.state[params[k]] = {"step": step.clone(), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
    elif sgd is not None:
        trace = as_params(sgd.trace)
        for k in names:
            opt.state[params[k]] = {"momentum_buffer": trace[k]}
    else:
        raise ValueError("the JAX optimizer state holds neither Adam moments nor an SGD trace")
    state.step = int(np.asarray(jax_state.step))
    state.ema_params = None if jax_state.ema_params is None else as_params(jax_state.ema_params)
    return state


def load_torch_checkpoint(path: str, use_ema: bool = False) -> Dict[str, torch.Tensor]:
    """Read a `.pth` checkpoint into a plain KFPN state_dict: a reference
    file (a raw state_dict or {"state_dict": ...}; DataParallel's `module.`
    stripped) or a training checkpoint of the port (`runtime/checkpoint.py`).
    With use_ema the port checkpoint's EMA weights replace the parameters
    (the BatchNorm statistics stay the run's own)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    ema = sd.get("ema_params") if isinstance(sd, dict) else None
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    if use_ema:
        if ema is None:
            raise ValueError(f"use_ema asked for, but {path} holds no ema_params (trained without --ema_decay?)")
        sd.update(ema)
    return sd


BACKBONE_PREFIXES = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.", "layer4.")


def port_torchvision_backbone(state_dict: Mapping[str, Any], model_state_dict: Mapping[str, torch.Tensor],
                              num_layers: int = 18) -> "OrderedDict[str, torch.Tensor]":
    """Merge a torchvision ResNet ImageNet state_dict into the backbone of a
    KFPN or deconv model's state_dict -> a new state_dict (the JAX
    package's `port_torchvision_backbone` on the port's names). torchvision
    and PoseResNet share the backbone's key names, so this is a filter and
    a strict shape check, not a layout change: every backbone entry of the
    model (`conv1`, `bn1`, `layer1`..`layer4`; weights, biases and the
    BatchNorm running statistics, as JAX merges `batch_stats`) takes the
    file's tensor in the model's dtype; `fc.*` and `num_batches_tracked`
    are ignored, and the FPN, deconv and head entries keep their values. A
    backbone entry missing from the file, or of another shape (a
    ResNet-50 file for an 18-layer model), raises ValueError naming the
    key."""
    from sfa3d_tpu_torch.models.resnet import RESNET_SPEC

    _, counts = RESNET_SPEC[num_layers]
    last = [f"layer{stage + 1}.{n - 1}.conv1.weight" for stage, n in enumerate(counts)]
    beyond = [f"layer{stage + 1}.{n}.conv1.weight" for stage, n in enumerate(counts)]
    if any(k not in model_state_dict for k in last) or any(k in model_state_dict for k in beyond):
        raise ValueError(f"the model's backbone is not a ResNet-{num_layers}")
    out = OrderedDict(model_state_dict)
    for k, have in model_state_dict.items():
        if not k.startswith(BACKBONE_PREFIXES) or k.endswith("num_batches_tracked"):
            continue
        if k not in state_dict:
            raise ValueError(f"ImageNet weight {k} is missing from the file (not a torchvision "
                             f"resnet{num_layers} state_dict?)")
        new = torch.as_tensor(state_dict[k])
        if tuple(new.shape) != tuple(have.shape):
            raise ValueError(f"ImageNet weight {k} has shape {tuple(new.shape)}, model expects "
                             f"{tuple(have.shape)} — wrong num_layers for this checkpoint?")
        out[k] = new.to(have.dtype).clone()
    return out


def load_imagenet_backbone(model_state_dict: Mapping[str, torch.Tensor], num_layers: int = 18,
                           weights_path: Optional[str] = None) -> "OrderedDict[str, torch.Tensor]":
    """`--imagenet_pretrained`: a torchvision ImageNet ResNet `.pth` merged
    into the backbone of `model_state_dict` (`port_torchvision_backbone`).
    With no path, the newest `resnet{N}-*.pth` of the torch hub cache
    ($TORCH_HOME/hub/checkpoints, TORCH_HOME defaulting to ~/.cache/torch)
    is read; nothing is ever downloaded, and FileNotFoundError says so."""
    if weights_path is None:
        hub_dir = os.path.join(os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch")),
                               "hub", "checkpoints")
        candidates = sorted(glob.glob(os.path.join(hub_dir, f"resnet{num_layers}-*.pth")))
        if not candidates:
            raise FileNotFoundError(
                f"no ImageNet resnet{num_layers} checkpoint found in {hub_dir}, and none is "
                f"downloaded; pass --imagenet_weights /path/to/resnet{num_layers}-*.pth "
                "(a torchvision state_dict)")
        weights_path = candidates[-1]
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    return port_torchvision_backbone(sd, model_state_dict, num_layers)
