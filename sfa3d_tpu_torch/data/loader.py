"""Input pipeline: dataset -> device batches, the port of
`sfa3d_tpu/data/loader.py`.

An epoch-seeded shuffling sampler with per-process shards, host batching of
fixed-shape samples, and `prepare_train_batch`, which turns a collated batch
of raw padded scans into BEV rasters (mirrored along W where a sample was
flipped) and training targets on the device: one `points_to_bev_nchw` call,
so one launch of the hand-written raster kernel (`bev_raster_reduce`) per
collated batch of S x B frames on the card. `--dataset argoverse` takes
`data/argoverse.py`'s loader, whose preparation launches the tile kernel's
Argoverse mode once per collated batch.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.ops.bev import dequantize_points, hflip_bev, points_to_bev_nchw, quantize_points_uint16
from sfa3d_tpu_torch.ops.targets import build_targets


class EpochSampler:
    """Shuffled per-epoch indices with optional process sharding:
    `set_epoch` reseeds (DistributedSampler.set_epoch), and process p of n
    takes every n-th index from p on, so the shards are disjoint."""

    def __init__(self, n: int, shuffle: bool = True, seed: int = 2020,
                 process_index: int = 0, process_count: int = 1):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return iter(idx[self.process_index:: self.process_count].tolist())


def prepare_train_batch(
    points: torch.Tensor,  # (N, P, 4) float32, or int16 bit patterns of uint16 points
    valid: torch.Tensor,  # (N, P) bool
    labels: torch.Tensor,  # (N, M, 8)
    n_labels: torch.Tensor,  # (N,)
    hflip: torch.Tensor,  # (N,) bool
    *,
    hm_size: Tuple[int, int] = (152, 152),
    max_objects: int = 50,
    num_classes: int = 3,
    bev_size: Tuple[int, int] = (cnf.BEV_HEIGHT, cnf.BEV_WIDTH),
):
    """Device-side preparation of a flat batch of N samples, on the points'
    device: BEV raster (N, 3, H, W), mirrored along W where hflip, and the
    `build_targets` dict, each with N first."""
    if points.dtype in (torch.int16, torch.uint16):
        points = dequantize_points(points)
    bev = hflip_bev(points_to_bev_nchw(points, valid, bev_height=bev_size[0], bev_width=bev_size[1]), hflip)
    targets = build_targets(labels, n_labels, hflip, num_classes=num_classes,
                            hm_size=hm_size, max_objects=max_objects)
    return bev, targets


class KittiTrainLoader:
    """Yields train-step batches {"bev": (S, B, 3, H, W), "targets": (S,
    B, ...)} on `device`, S the accumulation factor and B the per-step batch.

    num_workers > 0 is the asynchronous pipeline: a thread pool reads and
    augments samples (numpy releases the GIL) while a producer thread
    collates and runs the device preparation, keeping up to `prefetch`
    ready batches ahead of the train step. num_workers = 0 is the
    synchronous path; both give the same batches in the same order (the
    sampler fixes the order, the dataset's per-sample generators the
    augmentation)."""

    def __init__(self, dataset, batch_size: int, subdivisions: int = 1,
                 shuffle: bool = True, seed: int = 2020, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 prepare_fn=None, num_workers: int = 0, prefetch: int = 2,
                 point_format: str = "float32", device: Device = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.subdivisions = subdivisions
        self.sampler = EpochSampler(len(dataset), shuffle, seed, process_index, process_count)
        self.drop_last = drop_last
        self.prepare_fn = prepare_fn or prepare_train_batch
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        if point_format not in ("float32", "uint16"):
            raise ValueError(f"point_format must be 'float32' or 'uint16'; got {point_format!r}")
        self.point_format = point_format
        self.device = resolve_device(device)

    def __len__(self):
        per_step = self.batch_size * self.subdivisions
        n = len(range(self.sampler.process_index, len(self.dataset), self.sampler.process_count))
        return n // per_step if self.drop_last else -(-n // per_step)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _iter_samples(self):
        """Raw samples in sampler order; pooled reads when num_workers > 0,
        at most 2 x num_workers in flight."""
        if self.num_workers <= 0:
            for idx in self.sampler:
                yield self.dataset[idx]
            return
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        idx_iter = iter(self.sampler)
        with ThreadPoolExecutor(self.num_workers) as ex:
            pending = deque()

            def submit():
                idx = next(idx_iter, None)
                if idx is None:
                    return False
                pending.append(ex.submit(self.dataset.__getitem__, idx))
                return True

            for _ in range(2 * self.num_workers):
                if not submit():
                    break
            while pending:
                sample = pending.popleft().result()
                submit()
                yield sample

    def _iter_batches(self):
        per_step = self.batch_size * self.subdivisions
        chunk = []
        for sample in self._iter_samples():
            chunk.append(sample)
            if len(chunk) == per_step:
                yield self._collate(chunk)
                chunk = []
        if chunk and not self.drop_last:
            # the tail as a smaller batch, never padded by repetition
            yield self._collate(chunk, batch_size=len(chunk), subdivisions=1)

    def __iter__(self):
        if self.num_workers <= 0:
            yield from self._iter_batches()
            return
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        errors = []
        stop = threading.Event()

        def produce():
            try:
                for batch in self._iter_batches():
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # reaches the consumer
                errors.append(e)
            finally:
                while True:  # the sentinel must land even with the queue full
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        if stop.is_set():
                            break

        t = threading.Thread(target=produce, daemon=True, name="loader-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # the consumer may leave mid-epoch: unblock and retire the producer
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=60.0)
        if errors:
            raise errors[0]

    def _collate(self, samples, batch_size=None, subdivisions=None):
        points = np.stack([s.points for s in samples])
        if self.point_format == "uint16":
            points = quantize_points_uint16(points).view(np.int16)
        dev = self.device
        as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        bev, targets = self.prepare_fn(
            as_dev(points),
            as_dev(np.stack([s.valid for s in samples])),
            as_dev(np.stack([s.labels for s in samples])),
            as_dev(np.asarray([s.n_labels for s in samples], np.int32)),
            as_dev(np.asarray([getattr(s, "hflipped", False) for s in samples])),
        )
        s = subdivisions if subdivisions is not None else self.subdivisions
        b = batch_size if batch_size is not None else self.batch_size
        reshape = lambda t: t.reshape((s, b) + tuple(t.shape[1:]))  # noqa: E731
        return {"bev": reshape(bev), "targets": {k: reshape(v) for k, v in targets.items()}}


def _check_batch(configs, process_count: int) -> None:
    if configs.runtime.batch_size % process_count != 0:
        raise ValueError(f"batch_size {configs.runtime.batch_size} must divide evenly over "
                         f"{process_count} processes")
    if configs.data.dataset not in ("kitti", "argoverse"):
        raise ValueError(f"--dataset {configs.data.dataset}: expected kitti or argoverse")


def _loader_device(configs, device: Device):
    if device is not None:
        return device
    return "cpu" if configs.runtime.platform == "cpu" else None


def _create_argoverse_loader(configs, mode: str, process_index: int, process_count: int,
                             device: Device):
    """`--dataset argoverse`: the Argoverse dataset and loader pair
    (argoverse_dataloader.py), with no augmentation and no hflip."""
    from sfa3d_tpu_torch.data.argoverse import ArgoverseDataset, ArgoverseTrainLoader

    train = mode == "train"
    dataset = ArgoverseDataset(configs.data.dataset_dir, mode=mode, num_samples=configs.data.num_samples,
                               max_objects=configs.data.max_objects)
    return ArgoverseTrainLoader(
        dataset,
        batch_size=configs.runtime.batch_size // process_count,
        subdivisions=max(1, configs.optim.effective_batch // configs.runtime.batch_size) if train else 1,
        shuffle=train,
        seed=configs.runtime.seed,
        drop_last=train,
        process_index=process_index,
        process_count=process_count,
        num_workers=configs.data.num_workers,
        device=_loader_device(configs, device),
    )


def create_train_loader(configs, dataset_cls=None, process_index: int = 0,
                        process_count: int = 1, device: Device = None):
    """The training loader of a TrainConfig: the dataset with the reference
    augmentation and hflip, and S = effective_batch // batch_size
    micro-batches a step (`--dataset argoverse`: the Argoverse pair, without
    augmentation). `device` defaults to the CPU under `--platform cpu`,
    else cuda."""
    from sfa3d_tpu_torch.data.augment import default_train_aug
    from sfa3d_tpu_torch.data.kitti import KittiDataset

    _check_batch(configs, process_count)
    if dataset_cls is None and configs.data.dataset == "argoverse":
        return _create_argoverse_loader(configs, "train", process_index, process_count, device)
    dataset = (dataset_cls or KittiDataset)(
        configs.data.dataset_dir,
        mode="train",
        lidar_aug=default_train_aug(configs.data.aug_prob, configs.data.rotation_limit,
                                    configs.data.scaling_range),
        hflip_prob=configs.data.hflip_prob,
        num_samples=configs.data.num_samples,
        max_objects=configs.data.max_objects,
        seed=configs.runtime.seed,
    )
    return KittiTrainLoader(
        dataset,
        batch_size=configs.runtime.batch_size // process_count,
        subdivisions=max(1, configs.optim.effective_batch // configs.runtime.batch_size),
        seed=configs.runtime.seed,
        process_index=process_index,
        process_count=process_count,
        num_workers=configs.data.num_workers,
        point_format=configs.data.point_format,
        device=_loader_device(configs, device),
    )


def create_val_loader(configs, dataset_cls=None, process_index: int = 0,
                      process_count: int = 1, device: Optional[Device] = None):
    """The validation loader: no augmentation, no flip, S = 1, in order,
    with the tail kept as a smaller batch."""
    from sfa3d_tpu_torch.data.kitti import KittiDataset

    _check_batch(configs, process_count)
    if dataset_cls is None and configs.data.dataset == "argoverse":
        return _create_argoverse_loader(configs, "val", process_index, process_count, device)
    dataset = (dataset_cls or KittiDataset)(
        configs.data.dataset_dir, mode="val", lidar_aug=None, hflip_prob=0.0,
        num_samples=configs.data.num_samples, max_objects=configs.data.max_objects,
    )
    return KittiTrainLoader(
        dataset, batch_size=configs.runtime.batch_size // process_count,
        subdivisions=1, shuffle=False, drop_last=False,
        process_index=process_index, process_count=process_count,
        device=_loader_device(configs, device),
    )
