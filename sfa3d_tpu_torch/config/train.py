"""Typed training configuration of the port: the port's own copy of
`sfa3d_tpu/config/train.py` (one frozen dataclass tree and one CLI parser
with the reference flag names and defaults).

Flags that name work with no counterpart in the port are parsed as in the
JAX package and then refused by `refuse_unported` with a
NotImplementedError, never ignored: `--compilation_cache` (XLA's
executable cache) and a mesh larger than the visible GPUs.
`--imagenet_pretrained` merges a torchvision ImageNet ResNet into the
backbone (`models/port.py::load_imagenet_backbone`; `--imagenet_weights`,
or the torch hub cache, never a download); `--profile_dir DIR` writes a
`torch.profiler` trace of the training loop into DIR; `--arch` takes
fpn_resnet_* (KFPN) and resnet_* (the deconv CenterNet).
`--mesh_shape N` trains data-parallel over N ranks
(`parallel/mesh.py`; None, as in JAX, takes every device: the visible GPUs
on cuda, one rank on the CPU); on cuda without SFA3D_DIST a mesh larger
than the visible GPUs is refused (NCCL refuses two ranks on one GPU). `--val_ap`
runs the KITTI AP evaluator (`cli/eval.py`) at each checkpoint (with
`--dataset argoverse` it warns and skips, as the JAX trainer does).

`--platform cpu` asks for the CPU; without it training runs on `cuda`.
`--compute_dtype bfloat16` (the default) runs the forward and backward
under `torch.autocast(dtype=torch.bfloat16)` with float32 parameters;
`float32` is strict float32.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Output heads of the KFPN detector."""

    hm_cen: int = 3
    cen_offset: int = 2
    direction: int = 2
    z_coor: int = 1
    dim: int = 3

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str = "fpn_resnet_18"
    num_layers: int = 18
    head_conv: int = 64
    heads: HeadSpec = dataclasses.field(default_factory=HeadSpec)
    imagenet_pretrained: bool = False
    imagenet_weights: Optional[str] = None
    # bfloat16 activations under autocast; params stay float32
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset: str = "kitti"
    dataset_dir: str = "./dataset/kitti"
    input_size: Tuple[int, int] = (608, 608)
    hm_size: Tuple[int, int] = (152, 152)
    down_ratio: int = 4
    num_classes: int = 3
    max_objects: int = 50
    max_points: int = 65536
    hflip_prob: float = 0.5
    num_samples: Optional[int] = None
    num_workers: int = 4
    # "uint16" halves the host -> device point bytes (dequantized on the
    # device); float32 is the parity default
    point_format: str = "float32"
    aug_prob: float = 0.66  # OneOf(rotation, scaling) probability
    rotation_limit: float = 0.7853981633974483  # pi/4
    scaling_range: Tuple[float, float] = (0.95, 1.05)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer_type: str = "adam"  # or "sgd" (nesterov)
    lr: float = 1e-3
    # accepted for flag parity; dead in the reference too (the cosine
    # schedule's 0.1 * lr floor is the effective minimum)
    minimum_lr: float = 1e-7
    momentum: float = 0.949
    weight_decay: float = 0.0
    lr_type: str = "cosin"  # cosin | multi_step | one_cycle
    steps: Tuple[int, ...] = (150, 180)
    # effective global batch kept by gradient accumulation ("subdivisions")
    effective_batch: int = 64
    # parameter EMA, d(t) = ema_decay * (1 - exp(-t / ema_tau)); 0 disables
    ema_decay: float = 0.0
    ema_tau: float = 2000.0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    seed: int = 2020
    saved_fn: str = "fpn_resnet_18"
    root_dir: str = "./"
    batch_size: int = 16
    num_epochs: int = 300
    start_epoch: int = 1
    print_freq: int = 50
    tensorboard_freq: int = 50
    checkpoint_freq: int = 2
    no_val: bool = False
    evaluate: bool = False
    pretrained_path: Optional[str] = None
    resume_path: Optional[str] = None
    auto_resume: bool = False
    keep_checkpoints: int = 0
    mesh_shape: Optional[int] = None
    profile_dir: Optional[str] = None
    platform: Optional[str] = None  # "cpu" asks for the CPU; None runs on cuda
    val_ap: bool = False
    val_ap_samples: Optional[int] = None
    compilation_cache: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    K: int = 50
    peak_thresh: float = 0.2
    nms_kernel: int = 3


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)

    @property
    def checkpoints_dir(self) -> str:
        return os.path.join(self.runtime.root_dir, "checkpoints", self.runtime.saved_fn)

    @property
    def logs_dir(self) -> str:
        return os.path.join(self.runtime.root_dir, "logs", self.runtime.saved_fn)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch training (the JAX package's flags)")
    p.add_argument("--seed", type=int, default=2020)
    p.add_argument("--saved_fn", type=str, default="fpn_resnet_18", metavar="FN")
    p.add_argument("--root-dir", dest="root_dir", type=str, default="./", metavar="PATH")
    p.add_argument("--arch", type=str, default="fpn_resnet_18", metavar="ARCH")
    p.add_argument("--pretrained_path", type=str, default=None, metavar="PATH")
    p.add_argument("--imagenet_pretrained", action="store_true")
    p.add_argument("--imagenet_weights", type=str, default=None, metavar="PATH")
    p.add_argument("--hflip_prob", type=float, default=0.5)
    p.add_argument("--aug_prob", type=float, default=0.66)
    p.add_argument("--no-val", dest="no_val", action="store_true")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--point_format", default="float32", choices=["float32", "uint16"])
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--print_freq", type=int, default=50, metavar="N")
    p.add_argument("--tensorboard_freq", type=int, default=50, metavar="N")
    p.add_argument("--checkpoint_freq", type=int, default=2, metavar="N")
    p.add_argument("--start_epoch", type=int, default=1, metavar="N")
    p.add_argument("--num_epochs", type=int, default=300, metavar="N")
    p.add_argument("--lr_type", type=str, default="cosin")
    p.add_argument("--lr", type=float, default=0.001, metavar="LR")
    p.add_argument("--minimum_lr", type=float, default=1e-7, metavar="MIN_LR")
    p.add_argument("--momentum", type=float, default=0.949, metavar="M")
    p.add_argument("-wd", "--weight_decay", type=float, default=0.0, metavar="WD")
    p.add_argument("--optimizer_type", type=str, default="adam", metavar="OPTIMIZER")
    p.add_argument("--steps", nargs="*", default=[150, 180])
    p.add_argument("--ema_decay", type=float, default=0.0, metavar="D")
    p.add_argument("--ema_tau", type=float, default=2000.0, metavar="T")
    p.add_argument("--effective_batch", type=int, default=64)
    p.add_argument("--mesh_shape", type=int, default=None)
    p.add_argument("--profile_dir", type=str, default=None, metavar="DIR")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--resume_path", type=str, default=None, metavar="PATH")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--keep_checkpoints", type=int, default=0, metavar="N")
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--dataset", type=str, default="kitti", choices=["kitti", "argoverse"])
    p.add_argument("--dataset_dir", type=str, default=None)
    p.add_argument("--compute_dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    p.add_argument("--val_ap", action="store_true")
    p.add_argument("--val_ap_samples", type=int, default=None, metavar="N")
    p.add_argument("--compilation_cache", default=None, metavar="DIR", nargs="?", const="")
    return p


def _visible_gpus() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def mesh_size(cfg: TrainConfig) -> int:
    """The ranks --mesh_shape asks for: the number, or (None, JAX's "every
    device") the visible GPUs on cuda and one rank on the CPU."""
    n = cfg.runtime.mesh_shape
    if n is not None:
        return n
    return 1 if cfg.runtime.platform == "cpu" else max(1, _visible_gpus())


def refuse_unported(cfg: TrainConfig) -> TrainConfig:
    """Raise NotImplementedError for a setting whose work the port has not
    taken yet; returns `cfg` otherwise."""
    rt = cfg.runtime
    if rt.mesh_shape is not None and rt.mesh_shape < 1:
        raise ValueError(f"--mesh_shape {rt.mesh_shape}: a mesh needs at least one device")
    refused = [
        (rt.mesh_shape is not None and rt.mesh_shape > 1 and rt.platform != "cpu"
         and not os.environ.get("SFA3D_DIST") and rt.mesh_shape > _visible_gpus(),
         f"--mesh_shape {rt.mesh_shape}: a mesh larger than the {_visible_gpus()} visible GPUs "
         "(NCCL refuses two ranks on one GPU; --platform cpu runs CPU ranks)"),
        (rt.compilation_cache is not None,
         "--compilation_cache: the XLA compilation cache has no counterpart in the port"),
    ]
    for hit, msg in refused:
        if hit:
            raise NotImplementedError(msg)
    return cfg


def parse_train_configs(argv=None) -> TrainConfig:
    """CLI -> TrainConfig; refuses the settings the port has not taken."""
    args = _build_parser().parse_args(argv)
    num_layers = int(args.arch.split("_")[-1]) if args.arch.split("_")[-1].isdigit() else 18
    dataset_dir = args.dataset_dir or os.path.join(args.root_dir, "dataset", args.dataset)
    return refuse_unported(TrainConfig(
        model=ModelConfig(
            arch=args.arch,
            num_layers=num_layers,
            compute_dtype=args.compute_dtype,
            imagenet_pretrained=args.imagenet_pretrained,
            imagenet_weights=args.imagenet_weights,
        ),
        data=DataConfig(
            dataset=args.dataset,
            dataset_dir=dataset_dir,
            hflip_prob=args.hflip_prob,
            aug_prob=args.aug_prob,
            num_samples=args.num_samples,
            num_workers=args.num_workers,
            point_format=args.point_format,
        ),
        optim=OptimConfig(
            optimizer_type=args.optimizer_type,
            lr=args.lr,
            minimum_lr=args.minimum_lr,
            momentum=args.momentum,
            weight_decay=args.weight_decay,
            lr_type=args.lr_type,
            steps=tuple(int(s) for s in args.steps),
            effective_batch=args.effective_batch,
            ema_decay=args.ema_decay,
            ema_tau=args.ema_tau,
        ),
        runtime=RuntimeConfig(
            seed=args.seed,
            saved_fn=args.saved_fn,
            root_dir=args.root_dir,
            batch_size=args.batch_size,
            num_epochs=args.num_epochs,
            start_epoch=args.start_epoch,
            print_freq=args.print_freq,
            tensorboard_freq=args.tensorboard_freq,
            checkpoint_freq=args.checkpoint_freq,
            no_val=args.no_val,
            evaluate=args.evaluate,
            pretrained_path=args.pretrained_path,
            resume_path=args.resume_path,
            auto_resume=args.auto_resume,
            keep_checkpoints=args.keep_checkpoints,
            mesh_shape=args.mesh_shape,
            profile_dir=args.profile_dir,
            platform=args.platform,
            val_ap=args.val_ap,
            val_ap_samples=args.val_ap_samples,
            compilation_cache=args.compilation_cache,
        ),
        decode=DecodeConfig(K=args.K, peak_thresh=args.peak_thresh),
    ))
