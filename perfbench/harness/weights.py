"""Seeded weights, made on the device in one draw.

`seeded_state(template, seed, device, rules)` gives a state dict with the
template's names and shapes: every floating tensor is a slice of one
`torch.randn` drawn by a `torch.Generator` on `device` from the seed,
scaled by its kind, unless a rule (a regular expression on the key) says
otherwise:

    convolution weight   lecun normal, std 1 / sqrt(fan_in)
    bias                 0; rules "bias" {key: value or list} set it
    BatchNorm            weight 1 + s z, bias s z, running mean s z,
                         running var exp(s z), s = rules["bn_spread"]

The same seed on the same device gives the same tensors, so the program
and the reference each take their own copy from the seed.
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _rule(rules: dict, kind: str, key: str):
    for pattern, value in rules.get(kind, {}).items():
        if re.search(pattern, key):
            return value
    return None


def seeded_state(template: Dict[str, torch.Tensor], seed: int, device, rules: dict) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    floats = [v for v in template.values() if v.is_floating_point()]
    flat = torch.randn(sum(v.numel() for v in floats), generator=generator(seed, device),
                       device=device, dtype=torch.float32)
    spread = float(rules.get("bn_spread", 0.0))
    bn_of = {k.rsplit(".", 1)[0] for k in template if k.endswith("running_mean")}
    out, at = {}, 0
    for key, ref in template.items():
        if not ref.is_floating_point():
            out[key] = torch.zeros(ref.shape, dtype=ref.dtype, device=device)
            continue
        z = flat[at: at + ref.numel()].view(ref.shape)
        at += ref.numel()
        module, leaf = key.rsplit(".", 1)
        if module in bn_of:
            out[key] = {"weight": 1.0 + spread * z, "bias": spread * z,
                        "running_mean": spread * z, "running_var": torch.exp(spread * z)}[leaf]
        elif leaf == "weight":
            out[key] = z * (1.0 / math.sqrt(ref[0].numel()))
        else:
            value = _rule(rules, "bias", key)
            value = torch.as_tensor(0.0 if value is None else value, dtype=torch.float32)
            out[key] = value.to(device).expand(ref.shape).clone()
    return out
