"""Training entry point of the port, the counterpart of
`sfa3d_tpu/cli/train.py`:

    python -m sfa3d_tpu_torch.cli.train --dataset_dir DIR [--dataset argoverse] [flags]

An epoch loop over `create_train_loader` batches (per-epoch reseeded
sampling and augmentation), one accumulated train step per batch
(`parallel/train_step.py`), validation loss and a checkpoint every
`--checkpoint_freq` epochs (with `--val_ap`, the KITTI AP of the val split
at each checkpoint, through `cli/eval.py`), console + file logging, TensorBoard when a
writer is importable, resume (`--resume_path`, `--auto_resume`) and
weights-only loading (`--pretrained_path`), and the learning-rate curve as
a PNG (drawn with `viz/raster.py`). It runs on cuda (raising without a
GPU) unless `--platform cpu` is given. Flags whose work is not ported raise
NotImplementedError (`config/train.py::refuse_unported`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def _device(configs) -> torch.device:
    from sfa3d_tpu_torch.device import resolve_device

    return resolve_device("cpu" if configs.runtime.platform == "cpu" else None)


def main(argv=None):
    from sfa3d_tpu_torch.config.train import parse_train_configs
    from sfa3d_tpu_torch.data.loader import create_train_loader, create_val_loader
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.models.port import load_torch_checkpoint
    from sfa3d_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step
    from sfa3d_tpu_torch.runtime.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        prune_checkpoints,
        save_checkpoint,
    )
    from sfa3d_tpu_torch.runtime.logger import AverageMeter, Logger, ProgressMeter, create_tb_writer
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    configs = parse_train_configs(argv)
    device = _device(configs)
    os.makedirs(configs.checkpoints_dir, exist_ok=True)
    os.makedirs(configs.logs_dir, exist_ok=True)
    logger = Logger(configs.logs_dir, configs.runtime.saved_fn)
    tb_writer = create_tb_writer(configs.logs_dir)
    logger.info(f"device: {device}, compute dtype {configs.model.compute_dtype}")

    model = create_model(configs.model.arch, configs.model.head_conv)
    model.init_weights(torch.Generator().manual_seed(configs.runtime.seed))
    if configs.runtime.pretrained_path:
        model.load_state_dict(load_torch_checkpoint(configs.runtime.pretrained_path), strict=True)
        logger.info(f"loaded pretrained weights from {configs.runtime.pretrained_path}")
    model = model.to(device)
    logger.info(f"model {configs.model.arch}: {sum(p.numel() for p in model.parameters()):,} params")

    train_loader = create_train_loader(configs, device=device)
    steps_per_epoch = max(1, len(train_loader))
    logger.info(f"number of batches in training set: {steps_per_epoch}")
    tx = create_optimizer(configs.optim, configs.runtime.num_epochs, steps_per_epoch)
    plot_lr_schedule(tx.lr, configs.runtime.num_epochs, steps_per_epoch, configs.logs_dir,
                     configs.optim.lr_type)

    use_ema = configs.optim.ema_decay > 0.0
    state = create_train_state(model, tx, ema=use_ema)
    if use_ema:
        logger.info(f"parameter EMA on: decay {configs.optim.ema_decay} tau {configs.optim.ema_tau}")
    start_epoch = configs.runtime.start_epoch
    resume_path = configs.runtime.resume_path
    if not resume_path and configs.runtime.auto_resume:
        resume_path = latest_checkpoint(configs.checkpoints_dir, configs.runtime.saved_fn)
        if resume_path:
            logger.info(f"auto_resume found {resume_path}")
    if resume_path:
        state, epoch = load_checkpoint(resume_path, state)
        start_epoch = epoch + 1
        logger.info(f"resumed from {resume_path} at epoch {epoch}")

    train_step = make_train_step(model, tx, ema_decay=configs.optim.ema_decay,
                                 ema_tau=configs.optim.ema_tau,
                                 compute_dtype=configs.model.compute_dtype, device=device)
    eval_step = make_eval_step(model, device=device)

    try:
        if configs.runtime.evaluate:
            val_loss = validate(create_val_loader(configs, device=device), state, eval_step)
            logger.info(f"val_loss: {val_loss:.4e}")
            return val_loss

        global_step = state.step  # resume keeps the schedule's position
        for epoch in range(start_epoch, configs.runtime.num_epochs + 1):
            logger.info(f">>> Epoch: [{epoch}/{configs.runtime.num_epochs}]")
            train_loader.set_epoch(epoch)
            batch_time = AverageMeter("Time", ":6.3f")
            data_time = AverageMeter("Data", ":6.3f")
            losses = AverageMeter("Loss", ":.4e")
            progress = ProgressMeter(steps_per_epoch, [batch_time, data_time, losses],
                                     prefix=f"Train - Epoch: [{epoch}/{configs.runtime.num_epochs}]")
            start = time.time()
            for batch_idx, batch in enumerate(train_loader):
                data_time.update(time.time() - start)
                state, stats = train_step(state, batch)
                global_step += 1
                losses.update(float(stats["total_loss"]), configs.runtime.batch_size)
                batch_time.update(time.time() - start)
                if tb_writer is not None and global_step % configs.runtime.tensorboard_freq == 0:
                    tb_writer.add_scalars("Train", {k: float(v) for k, v in stats.items()}
                                          | {"avg_loss": losses.avg}, global_step)
                    tb_writer.add_scalar("LR", tx.lr(global_step), global_step)
                if global_step % configs.runtime.print_freq == 0:
                    logger.info(progress.get_message(batch_idx))
                start = time.time()
            logger.info(progress.get_message(steps_per_epoch - 1))

            if (not configs.runtime.no_val) and epoch % configs.runtime.checkpoint_freq == 0:
                val_loss = validate(create_val_loader(configs, device=device), state, eval_step)
                logger.info(f"val_loss: {val_loss:.4e}")
                if tb_writer is not None:
                    tb_writer.add_scalar("Val_loss", val_loss, epoch)

            if epoch % configs.runtime.checkpoint_freq == 0:
                path = save_checkpoint(configs.checkpoints_dir, configs.runtime.saved_fn, state, epoch)
                logger.info(f"save a checkpoint at {path}")
                if configs.runtime.val_ap:
                    maybe_val_ap(configs, path, epoch, logger, tb_writer)
                prune_checkpoints(configs.checkpoints_dir, configs.runtime.saved_fn,
                                  configs.runtime.keep_checkpoints)
    finally:
        if tb_writer is not None:
            tb_writer.close()
        logger.close()
    return None


def maybe_val_ap(configs, ckpt_path, epoch, logger, tb_writer):
    """The val split's detection AP at a checkpoint (--val_ap): the eval CLI
    run in-process on the checkpoint just saved (its EMA weights when EMA is
    on), on the training device; logs mAP, mAOS and the per-class AP.
    Returns the eval CLI's results; with `--dataset argoverse`, which has
    no AP evaluation, it warns and returns None, as the JAX trainer does."""
    if configs.data.dataset != "kitti":
        logger.warning("--val_ap supports the KITTI layout only; skipping")
        return None
    from sfa3d_tpu_torch.cli.eval import main as eval_main

    ap_args = ["--dataset_dir", configs.data.dataset_dir, "--split", "val", "--arch", configs.model.arch,
               "--pretrained_path", ckpt_path, "--K", str(configs.decode.K),
               "--peak_thresh", str(configs.decode.peak_thresh)]
    if configs.runtime.platform:
        ap_args += ["--platform", configs.runtime.platform]
    if configs.runtime.val_ap_samples:
        ap_args += ["--num_samples", str(configs.runtime.val_ap_samples)]
    ema = configs.optim.ema_decay > 0.0
    if ema:  # with EMA on, the EMA weights are what training delivers
        ap_args += ["--use_ema"]
    res = eval_main(ap_args)
    per_class = {k: v for k, v in res.items() if k.startswith("AP_") and not isinstance(v, dict)}
    logger.info(
        f"val AP{' (EMA weights)' if ema else ''} (epoch {epoch}): mAP {res['mAP']:.4f} "
        f"mAOS {res.get('mAOS', 0.0):.4f} " + " ".join(f"{k} {v:.4f}" for k, v in sorted(per_class.items()))
    )
    if tb_writer is not None:
        tb_writer.add_scalar("Val_mAP", res["mAP"], epoch)
        tb_writer.add_scalar("Val_mAOS", res["mAOS"], epoch)
        tb_writer.add_scalars("Val_AP", per_class, epoch)
    return res


def validate(val_loader, state, eval_step) -> float:
    """Sample-weighted mean validation loss over the loader's batches."""
    total, n = 0.0, 0
    for batch in val_loader:
        flat = {
            "bev": batch["bev"].reshape((-1,) + tuple(batch["bev"].shape[2:])),
            "targets": {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in batch["targets"].items()},
        }
        n_samples = flat["bev"].shape[0]
        stats = eval_step(state, flat)
        total += float(stats["total_loss"]) * n_samples
        n += n_samples
    return total / max(1, n)


def plot_lr_schedule(lr_sched, num_epochs, steps_per_epoch, logs_dir, lr_type):
    """The learning rate of every epoch as logs_dir/LR_{lr_type}.png: a line
    with a dot per epoch inside a framed plot with a grid and labelled axes,
    1280 x 960 px, drawn with `viz/raster.py`."""
    from sfa3d_tpu_torch.data.png import write_png_rgb
    from sfa3d_tpu_torch.viz import raster

    ys = np.asarray([lr_sched(e * steps_per_epoch) for e in range(num_epochs)], np.float64)
    img = np.full((960, 1280, 3), 255, np.uint8)
    x0, y0, x1, y1 = 150, 40, 1240, 860
    lo, hi = float(ys.min()), float(ys.max())
    span = hi - lo or max(abs(hi), 1e-12)
    lo, hi = lo - 0.05 * span, hi + 0.05 * span
    font, grey, black, blue = raster.FONT_HERSHEY_SIMPLEX, (220, 220, 220), (0, 0, 0), (180, 119, 31)

    def px(e, y):
        u = x0 + (x1 - x0) * (e / max(num_epochs - 1, 1))
        return int(round(u)), int(round(y1 - (y1 - y0) * (y - lo) / (hi - lo)))

    for k in range(6):
        v = lo + (hi - lo) * k / 5
        _, yy = px(0, v)
        raster.line(img, (x0, yy), (x1, yy), grey, 1)
        label = f"{v:.2e}"
        (w, h), _ = raster.get_text_size(label, font, 0.5, 1)
        raster.put_text(img, label, (x0 - 10 - w, yy + h // 2), font, 0.5, black, 1)
    for k in range(6):
        e = (num_epochs - 1) * k / 5
        xx, _ = px(e, lo)
        raster.line(img, (xx, y0), (xx, y1), grey, 1)
        label = f"{e:g}"
        (w, _), _ = raster.get_text_size(label, font, 0.5, 1)
        raster.put_text(img, label, (xx - w // 2, y1 + 25), font, 0.5, black, 1)
    points = np.asarray([px(e, y) for e, y in enumerate(ys)], np.int32)
    raster.polylines(img, [points.reshape(-1, 1, 2)], False, blue, 2)
    for u, v in points:
        raster.rectangle(img, (int(u) - 2, int(v) - 2), (int(u) + 2, int(v) + 2), blue, 2)
    raster.rectangle(img, (x0, y0), (x1, y1), black, 1)
    raster.put_text(img, "epoch", ((x0 + x1) // 2 - 30, y1 + 70), font, 0.8, black, 1)
    raster.put_text(img, "LR", (20, (y0 + y1) // 2), font, 0.8, black, 1)
    raster.put_text(img, "LR", (x1 - 60, y0 + 30), font, 0.8, blue, 1)
    write_png_rgb(os.path.join(logs_dir, f"LR_{lr_type}.png"), img[:, :, ::-1])


if __name__ == "__main__":
    main()
