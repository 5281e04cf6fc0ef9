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
a PNG (drawn with `viz/raster.py`). `--arch` trains KFPN (fpn_resnet_*) or
the deconv CenterNet (resnet_*) on the same targets and losses (both heads
at stride 4 of the raster). `--imagenet_pretrained` merges a torchvision
ImageNet ResNet into the fresh model's backbone before the optimizer and
EMA are built (`--imagenet_weights PATH`, else the torch hub cache).
`--profile_dir DIR` runs the epochs under `torch.profiler` (CPU activity,
and CUDA activity on the card) and writes DIR/trace_rank{r}.json, a Chrome
trace, and on the card DIR/key_averages_rank{r}.txt, the profiler's table
by device time. It runs on cuda (raising without a
GPU) unless `--platform cpu` is given. Flags with no counterpart in the
port raise NotImplementedError (`config/train.py::refuse_unported`).

Data parallelism (`parallel/mesh.py`), one process per device:
- SFA3D_DIST=1 with SFA3D_COORDINATOR, SFA3D_NUM_PROCESSES and
  SFA3D_PROCESS_ID: this process is one rank of that launch (NCCL on cuda,
  gloo under --platform cpu); --mesh_shape, if given, must equal the world;
- else `--mesh_shape N` above 1 (None: every visible GPU on cuda) spawns N
  local ranks, rank i on cuda:i, or N CPU ranks under --platform cpu;
- else one process, the one-device step, with no collective.
Each rank loads its 1/N of every global batch (the loader's process
sharding: the same frames per step as JAX's mesh), takes the steps every
rank takes (the least of the ranks' batch counts), and logs the global
losses. Rank 0 alone logs, writes TensorBoard, the LR plot and the
checkpoints (the other ranks wait at a barrier until a checkpoint is
written) and runs --val_ap; resume and --pretrained_path load on every
rank and the state is then broadcast from rank 0.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import numpy as np
import torch


class _QuietLogger:
    """The logger of a rank other than 0: logs nothing."""

    def info(self, msg: str):
        pass

    def warning(self, msg: str):
        pass

    def close(self):
        pass


def _device(configs) -> torch.device:
    from sfa3d_tpu_torch.device import resolve_device

    return resolve_device("cpu" if configs.runtime.platform == "cpu" else None)


def main(argv=None):
    """Parse the flags and train: one rank of an SFA3D_DIST launch, N
    spawned local ranks (--mesh_shape N > 1), or one process. Returns the
    validation loss with --evaluate (rank 0's, or None after a spawn)."""
    from sfa3d_tpu_torch.config.train import mesh_size, parse_train_configs
    from sfa3d_tpu_torch.parallel.mesh import maybe_init_distributed, spawn_ranks

    configs = parse_train_configs(argv)
    device = _device(configs)
    if maybe_init_distributed(device=device):
        try:
            return train(configs)
        finally:
            torch.distributed.destroy_process_group()
    n = mesh_size(configs)
    if n > 1:
        spawn_ranks(_rank_main, n, args=(argv,), device="cpu" if device.type == "cpu" else None)
        return None
    return train(configs)


def _rank_main(argv) -> None:
    """A spawned rank (`mesh.py::spawn_ranks` has joined it to the group)."""
    from sfa3d_tpu_torch.config.train import parse_train_configs

    train(parse_train_configs(argv))


def train(configs):
    """The training run of this process, data-parallel over the process
    group when one is initialised (a world of one otherwise)."""
    from sfa3d_tpu_torch.data.loader import create_train_loader, create_val_loader
    from sfa3d_tpu_torch.models import create_model, get_num_parameters
    from sfa3d_tpu_torch.models.port import load_imagenet_backbone, load_torch_checkpoint
    from sfa3d_tpu_torch.parallel import create_train_state, make_eval_step, make_train_step
    from sfa3d_tpu_torch.parallel.mesh import barrier, make_mesh, min_over_ranks, replicate
    from sfa3d_tpu_torch.runtime.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
        prune_checkpoints,
        save_checkpoint,
    )
    from sfa3d_tpu_torch.runtime.logger import AverageMeter, Logger, ProgressMeter, create_tb_writer
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    dev = _device(configs)
    mesh = make_mesh(configs.runtime.mesh_shape if torch.distributed.is_initialized() else None,
                     device=dev if dev.type == "cpu" else None)
    device = mesh.device if mesh.synced else dev
    step_mesh = mesh if mesh.synced else None  # at world size 1 the one-device step
    chief = mesh.rank == 0
    if chief:
        os.makedirs(configs.checkpoints_dir, exist_ok=True)
        os.makedirs(configs.logs_dir, exist_ok=True)
    logger = Logger(configs.logs_dir, configs.runtime.saved_fn) if chief else _QuietLogger()
    tb_writer = create_tb_writer(configs.logs_dir) if chief else None
    logger.info(f"device: {device}, compute dtype {configs.model.compute_dtype}")
    if mesh.synced:
        logger.info(f"data parallel: {mesh.world_size} ranks over {torch.distributed.get_backend()}, "
                    f"global batch {configs.runtime.batch_size}, "
                    f"{configs.runtime.batch_size // mesh.world_size} frames a rank")

    model = create_model(configs.model.arch, configs.model.head_conv)
    model.init_weights(torch.Generator().manual_seed(configs.runtime.seed))
    if configs.model.imagenet_pretrained:
        model.load_state_dict(load_imagenet_backbone(model.state_dict(), configs.model.num_layers,
                                                     configs.model.imagenet_weights), strict=True)
        logger.info(f"initialized backbone from ImageNet resnet{configs.model.num_layers} weights")
    if configs.runtime.pretrained_path:
        model.load_state_dict(load_torch_checkpoint(configs.runtime.pretrained_path), strict=True)
        logger.info(f"loaded pretrained weights from {configs.runtime.pretrained_path}")
    model = model.to(device)
    logger.info(f"model {configs.model.arch}: {get_num_parameters(model):,} params")

    shards = dict(process_index=mesh.rank, process_count=mesh.world_size, device=device)
    train_loader = create_train_loader(configs, **shards)
    steps_per_epoch = max(1, min_over_ranks(mesh, len(train_loader)))
    logger.info(f"number of batches in training set: {steps_per_epoch}")
    tx = create_optimizer(configs.optim, configs.runtime.num_epochs, steps_per_epoch)
    if chief:
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
    state = replicate(mesh, state)

    train_step = make_train_step(model, tx, ema_decay=configs.optim.ema_decay,
                                 ema_tau=configs.optim.ema_tau,
                                 compute_dtype=configs.model.compute_dtype, device=device, mesh=step_mesh)
    eval_step = make_eval_step(model, device=device, mesh=step_mesh)

    try:
        if configs.runtime.evaluate:
            val_loss = validate(create_val_loader(configs, **shards), state, eval_step, step_mesh)
            logger.info(f"val_loss: {val_loss:.4e}")
            return val_loss

        global_step = state.step  # resume keeps the schedule's position
        rt = configs.runtime
        with profiled(rt.profile_dir, device, mesh.rank) if rt.profile_dir else contextlib.nullcontext():
            for epoch in range(start_epoch, configs.runtime.num_epochs + 1):
                logger.info(f">>> Epoch: [{epoch}/{configs.runtime.num_epochs}]")
                train_loader.set_epoch(epoch)
                batch_time = AverageMeter("Time", ":6.3f")
                data_time = AverageMeter("Data", ":6.3f")
                losses = AverageMeter("Loss", ":.4e")
                progress = ProgressMeter(steps_per_epoch, [batch_time, data_time, losses],
                                         prefix=f"Train - Epoch: [{epoch}/{configs.runtime.num_epochs}]")
                start = time.time()
                batches = iter(train_loader)
                for batch_idx, batch in enumerate(itertools.islice(batches, steps_per_epoch)):
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
                _close(batches)  # a rank with a batch more than the others leaves it
                logger.info(progress.get_message(steps_per_epoch - 1))

                if (not configs.runtime.no_val) and epoch % configs.runtime.checkpoint_freq == 0:
                    val_loss = validate(create_val_loader(configs, **shards), state, eval_step, step_mesh)
                    logger.info(f"val_loss: {val_loss:.4e}")
                    if tb_writer is not None:
                        tb_writer.add_scalar("Val_loss", val_loss, epoch)

                if epoch % configs.runtime.checkpoint_freq == 0:
                    if chief:
                        path = save_checkpoint(configs.checkpoints_dir, configs.runtime.saved_fn, state, epoch)
                        logger.info(f"save a checkpoint at {path}")
                        if configs.runtime.val_ap:
                            maybe_val_ap(configs, path, epoch, logger, tb_writer)
                        prune_checkpoints(configs.checkpoints_dir, configs.runtime.saved_fn,
                                          configs.runtime.keep_checkpoints)
                    barrier(mesh)  # no rank goes on (or resumes) before the checkpoint is whole
    finally:
        if tb_writer is not None:
            tb_writer.close()
        logger.close()
    return None


@contextlib.contextmanager
def profiled(profile_dir: str, device: torch.device, rank: int = 0):
    """--profile_dir: runs the body under `torch.profiler` (CPU activity;
    CUDA activity too on the card), then writes
    profile_dir/trace_rank{rank}.json (a Chrome trace) and, on the card,
    profile_dir/key_averages_rank{rank}.txt (the table of `key_averages()`
    by self device time)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_rank{rank}.json"))
    if device.type == "cuda":
        table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
        with open(os.path.join(profile_dir, f"key_averages_rank{rank}.txt"), "w") as f:
            f.write(table + "\n")

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


def _close(iterator) -> None:
    """Retire a loader's iterator left before its end (its producer thread)."""
    close = getattr(iterator, "close", None)
    if close is not None:
        close()


def validate(val_loader, state, eval_step, mesh=None) -> float:
    """Sample-weighted mean validation loss over the loader's batches. With
    a mesh of more than one rank each rank holds its share of every global
    batch and the stats are global: every rank trims its batch to the
    smallest share of any rank (the global tail then divides by the world,
    as JAX trims it) and the loop ends when any rank has no frame left."""
    from sfa3d_tpu_torch.parallel.mesh import min_over_ranks

    world = 1 if mesh is None else mesh.world_size
    total, n = 0.0, 0
    batches = iter(val_loader)
    while True:
        batch = next(batches, None)
        local = 0 if batch is None else batch["bev"].shape[0] * batch["bev"].shape[1]
        take = local if mesh is None else min_over_ranks(mesh, local)
        if take == 0:
            _close(batches)
            break
        flat = {
            "bev": batch["bev"].reshape((-1,) + tuple(batch["bev"].shape[2:]))[:take],
            "targets": {k: v.reshape((-1,) + tuple(v.shape[2:]))[:take] for k, v in batch["targets"].items()},
        }
        stats = eval_step(state, flat)
        total += float(stats["total_loss"]) * take * world
        n += take * world
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
