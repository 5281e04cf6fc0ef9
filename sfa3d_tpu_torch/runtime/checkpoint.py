"""Training checkpoints of the port: the counterpart of
`sfa3d_tpu/runtime/checkpoint.py` in the port's own format.

One file per saved epoch, `Model_{saved_fn}_epoch_{epoch}.pth`, written with
`torch.save`:
    {"format": FORMAT, "state_dict": model.state_dict() (parameters and
     BatchNorm statistics), "optimizer": optimizer.state_dict(),
     "step": int, "epoch": int, "ema_params": {name: tensor} (EMA runs)}
The "state_dict" key makes the file a reference-style `.pth` too:
`Detector(checkpoint=...)` loads it (and its EMA weights with use_ema).
The JAX package's Orbax checkpoint directories need JAX and are refused
with a message.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

FORMAT = "sfa3d_tpu_torch/train-checkpoint-v1"


def _checkpoint_name(saved_fn: str, epoch: int) -> str:
    return f"Model_{saved_fn}_epoch_{epoch}.pth"


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: an Orbax checkpoint directory of the JAX package needs orbax/JAX; "
            "sfa3d_tpu_torch reads its own .pth training checkpoints"
        )


def save_checkpoint(checkpoints_dir: str, saved_fn: str, state, epoch: int) -> str:
    """Save a full training checkpoint for `epoch`; returns its path. The
    file is written beside its final name and then renamed into place."""
    os.makedirs(checkpoints_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(checkpoints_dir, _checkpoint_name(saved_fn, epoch)))
    payload = {
        "format": FORMAT,
        "state_dict": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
    }
    if state.ema_params is not None:
        payload["ema_params"] = state.ema_params
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str) -> dict:
    _refuse_orbax(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(payload, dict) and payload.get("format") == FORMAT):
        raise ValueError(f"{path} is not a training checkpoint of sfa3d_tpu_torch")
    return payload


def load_checkpoint(path: str, state) -> Tuple[object, int]:
    """Restore a training checkpoint into `state` (in place) -> (state,
    epoch). EMA follows the state, both ways: a state that keeps an EMA but
    a checkpoint without one seeds it from the restored parameters; a state
    without EMA drops a stored one."""
    payload = _read(path)
    state.model.load_state_dict(payload["state_dict"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if state.ema_params is not None:
        ref = next(state.model.parameters())
        stored = payload.get("ema_params")
        state.ema_params = {
            k: (stored[k] if stored is not None else p.detach()).to(ref.device, ref.dtype).clone()
            for k, p in state.model.named_parameters()
        }
    return state, int(payload["epoch"])


def load_params_only(path: str, use_ema: bool = False) -> dict:
    """The model state_dict of a checkpoint (parameters + BatchNorm
    statistics) for inference; with use_ema the EMA parameters replace the
    raw ones."""
    from sfa3d_tpu_torch.models.port import load_torch_checkpoint

    _refuse_orbax(path)
    return load_torch_checkpoint(path, use_ema=use_ema)


def load_pretrained_params(state, state_dict) -> object:
    """Weights-only load (the reference's --pretrained_path): the model's
    parameters and BatchNorm statistics from `state_dict` (a model
    state_dict, e.g. `load_params_only`'s), the optimizer state and the
    step kept. In place; returns `state`. The EMA, if any, is left as it
    was, as the JAX package's `state.replace(params=, batch_stats=)`
    leaves ema_params."""
    state.model.load_state_dict(state_dict, strict=True)
    return state


def prune_checkpoints(checkpoints_dir: str, saved_fn: str, keep_last: int) -> None:
    """Delete all but the newest `keep_last` epoch checkpoints (0 keeps all)."""
    if keep_last <= 0:
        return
    pattern = re.compile(re.escape(f"Model_{saved_fn}_epoch_") + r"(\d+)\.pth")
    found = sorted((int(m.group(1)), name) for name in os.listdir(checkpoints_dir)
                   if (m := pattern.fullmatch(name)))
    for _, name in found[:-keep_last]:
        os.remove(os.path.join(checkpoints_dir, name))


def latest_checkpoint(checkpoints_dir: str, saved_fn: str) -> Optional[str]:
    """The newest epoch checkpoint in `checkpoints_dir`, or None."""
    if not os.path.isdir(checkpoints_dir):
        return None
    pattern = re.compile(re.escape(f"Model_{saved_fn}_epoch_") + r"(\d+)\.pth")
    epochs = [int(m.group(1)) for name in os.listdir(checkpoints_dir) if (m := pattern.fullmatch(name))]
    if not epochs:
        return None
    return os.path.join(checkpoints_dir, _checkpoint_name(saved_fn, max(epochs)))
