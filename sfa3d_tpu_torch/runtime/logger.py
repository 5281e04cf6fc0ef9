"""Logging and progress meters of the training CLI, the port of
`sfa3d_tpu/runtime/logger.py`: a file + console logger, running-average
meters, progress lines, and a TensorBoard writer when one is importable."""

from __future__ import annotations

import logging
import os
import time

import torch


class Logger:
    """File + console logger writing logs_dir/logger_{saved_fn}.txt."""

    def __init__(self, logs_dir: str, saved_fn: str):
        os.makedirs(logs_dir, exist_ok=True)
        logger = logging.getLogger(f"sfa3d_tpu_torch.{saved_fn}")
        logger.setLevel(logging.INFO)
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
        fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
        fh = logging.FileHandler(os.path.join(logs_dir, f"logger_{saved_fn}.txt"))
        fh.setFormatter(fmt)
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(fh)
        logger.addHandler(sh)
        self._logger = logger

    def info(self, msg: str):
        self._logger.info(msg)

    def warning(self, msg: str):
        self._logger.warning(msg)

    def close(self):
        for h in list(self._logger.handlers):
            self._logger.removeHandler(h)
            h.close()


class AverageMeter:
    """Running average of a value."""

    def __init__(self, name: str, fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(1, self.count)

    def __str__(self):
        fmtstr = "{name} {val" + self.fmt + "} ({avg" + self.fmt + "})"
        return fmtstr.format(**self.__dict__)


class ProgressMeter:
    """Formatted per-batch progress lines."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        num_digits = len(str(num_batches // 1))
        self.batch_fmtstr = "[{:" + str(num_digits) + "d}/" + f"{num_batches}]"
        self.meters = meters
        self.prefix = prefix

    def get_message(self, batch: int) -> str:
        entries = [self.prefix + self.batch_fmtstr.format(batch)]
        entries += [str(m) for m in self.meters]
        return "\t".join(entries)


def time_synchronized(device=None) -> float:
    """Device-synchronized wall clock (the reference's utils/misc.py:69-71):
    on a CUDA device, `torch.cuda.synchronize()` first, then `time.time()`.
    `device` None is the current CUDA device when CUDA is available; a CPU
    device synchronizes nothing."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def create_tb_writer(logs_dir: str):
    """A TensorBoard SummaryWriter on logs_dir/tensorboard, or None when no
    TensorBoard writer package is importable."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=os.path.join(logs_dir, "tensorboard"))
