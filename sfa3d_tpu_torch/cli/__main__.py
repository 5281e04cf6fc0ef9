"""Subcommand dispatcher of the port: python -m sfa3d_tpu_torch.cli <command> [args...].

It lists the commands the port has, every command of the JAX package's
dispatcher."""

import importlib
import sys

COMMANDS = {
    "train": ("sfa3d_tpu_torch.cli.train", "KITTI (or Argoverse) KFPN training on one GPU"),
    "yolo-train": ("sfa3d_tpu_torch.cli.yolo_train", "train the YOLOv8 camera detector (2D boxes)"),
    "eval": ("sfa3d_tpu_torch.cli.eval", "KITTI 3D/BEV AP evaluation on the val split"),
    "serve": ("sfa3d_tpu_torch.cli.serve", "batched JSON detection server (stdio/TCP)"),
    "export": ("sfa3d_tpu_torch.cli.export", "AOT torch.export artifact (weights baked in)"),
    "argoverse-test": ("sfa3d_tpu_torch.cli.argoverse_test", "Argoverse pipeline runner"),
    "test": ("sfa3d_tpu_torch.cli.test", "inference + BEV/camera composites on the test split"),
    "fuse": ("sfa3d_tpu_torch.cli.fuse", "camera-LiDAR fusion (nms / weighted / bayesian)"),
    "demo": ("sfa3d_tpu_torch.cli.demo", "raw-drive video demo (front or --two_sides)"),
    "track": ("sfa3d_tpu_torch.cli.track", "3D multi-object tracking video over a raw drive"),
    "slam": ("sfa3d_tpu_torch.cli.slam", "fusion under per-frame SLAM calibration sources"),
    "stereo-calib": ("sfa3d_tpu_torch.cli.stereo_calib", "targetless stereo self-calibration"),
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m sfa3d_tpu_torch.cli <command> [args...]\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:15s} {desc}")
        sys.exit(0)
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd} (choose from {', '.join(COMMANDS)})")
        sys.exit(2)
    module_name, _ = COMMANDS[cmd]
    return importlib.import_module(module_name).main(argv[1:])


if __name__ == "__main__":
    main()
