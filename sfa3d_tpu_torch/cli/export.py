"""`python -m sfa3d_tpu_torch.cli export`: export the detector (or the whole
fusion program) to one artifact with the weights baked in
(`runtime/export.py`), the counterpart of `sfa3d_tpu/cli/export.py`.

Examples:
  # the detector, symbolic batch, on the GPU (the default platform):
  python -m sfa3d_tpu_torch.cli export --pretrained_path Model.pth -o model.sfa3dt
  # the fusion program at a fixed batch of 8:
  python -m sfa3d_tpu_torch.cli export --fused --batch 8 \\
      --yolo_weights yolov8n.pt -o fused.sfa3dt
  # a CPU artifact:
  python -m sfa3d_tpu_torch.cli export --platform cpu -o model_cpu.sfa3dt
  # run one (no model code needed beyond the loader):
  python - <<'PY'
  from sfa3d_tpu_torch.runtime.export import load_exported
  art = load_exported("model.sfa3dt")
  out = art.call(points, valid)   # shapes per art.manifest["inputs"]
  PY

An artifact runs on the one device it was exported on (`--platform`,
default cuda, which raises without a GPU).
"""

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="sfa3d_tpu_torch export",
        description="export the pipeline to a torch.export artifact",
    )
    p.add_argument("--pretrained_path", type=str, default=None,
                   help="KFPN checkpoint (.pth); RANDOM weights with a warning if absent")
    p.add_argument("--use_ema", action="store_true",
                   help="bake the EMA weights of a training checkpoint into the artifact")
    p.add_argument("--arch", type=str, default="fpn_resnet_18")
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--batch", type=int, default=None,
                   help="fixed batch size; default: symbolic (any batch)")
    p.add_argument("--max_points", type=int, default=None,
                   help="per-scan point budget baked into the artifact "
                        "(default: MAX_POINTS_FILTERED=32768, the host-filtered "
                        "budget every serving path pads to)")
    p.add_argument("--platforms", type=str, default=None,
                   help="the one platform to export for (cpu or cuda); an artifact "
                        "of the port holds one platform, not a list")
    p.add_argument("--fused", action="store_true",
                   help="export the whole fusion program (SFA3D + YOLOv8n + "
                        "Bayesian fusion + Gaussian NMS)")
    p.add_argument("--yolo_weights", type=str, default=None,
                   help="ultralytics-layout yolov8 .pt for --fused; random weights if absent")
    p.add_argument("--img_hw", type=int, nargs=2, default=(375, 1242), metavar=("H", "W"),
                   help="camera frame size baked into a fused artifact's letterbox "
                        "geometry (default: KITTI 375 1242)")
    p.add_argument("--letterbox", type=int, default=640,
                   help="YOLO input size baked into a fused artifact (stride-32 multiple)")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="the device the program is exported on and runs on; default cuda")
    p.add_argument("-o", "--out", type=str, required=True)
    return p


def _platform(args) -> str:
    """The one export device from --platform and --platforms."""
    chosen = args.platform
    if args.platforms is not None:
        names = [n.strip() for n in args.platforms.split(",") if n.strip()]
        if len(names) != 1 or names[0] not in ("cpu", "cuda"):
            raise SystemExit(
                f"--platforms {args.platforms!r}: an artifact of sfa3d_tpu_torch holds one "
                "platform, cpu or cuda (export once per platform)")
        if chosen is not None and chosen != names[0]:
            raise SystemExit(f"--platform {chosen} and --platforms {names[0]} disagree")
        chosen = names[0]
    return chosen or "cuda"


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from sfa3d_tpu_torch.config import kitti as cnf
    from sfa3d_tpu_torch.detector import Detector
    from sfa3d_tpu_torch.runtime.export import export_detector, export_fused, save_exported

    device = _platform(args)
    max_points = args.max_points or cnf.MAX_POINTS_FILTERED
    if args.pretrained_path is None:
        print("WARNING: no --pretrained_path given; using RANDOM weights", file=sys.stderr)
    model = Detector(arch=args.arch, checkpoint=args.pretrained_path, device=device,
                     use_ema=args.use_ema).model

    if args.fused:
        from sfa3d_tpu_torch.models.yolov8 import YOLOv8, load_yolo_checkpoint

        if args.yolo_weights:
            # sized from the checkpoint's own shapes (stock COCO-80 .pt or
            # the framework's 3-class trained export)
            yolo = load_yolo_checkpoint(args.yolo_weights)
        else:
            yolo = YOLOv8(scale="n").init_weights(torch.Generator().manual_seed(1))
        exported, manifest = export_fused(
            model, yolo.to(device).eval(), batch=args.batch, max_points=max_points,
            img_hw=tuple(args.img_hw), letterbox=args.letterbox,
        )
    else:
        exported, manifest = export_detector(
            model, K=args.K, peak_thresh=args.peak_thresh, batch=args.batch,
            max_points=max_points,
        )

    save_exported(args.out, exported, manifest)
    size = os.path.getsize(args.out)
    print(f"wrote {args.out}: kind={manifest['kind']} "
          f"platforms={manifest['platforms']} batch="
          f"{args.batch if args.batch else 'symbolic'} ({size/1e6:.1f} MB)")
    return manifest


if __name__ == "__main__":
    main()
