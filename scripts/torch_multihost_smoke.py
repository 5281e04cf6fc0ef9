"""One process of a multi-process training smoke of the PyTorch port (the
port's counterpart of scripts/multihost_smoke.py), under SFA3D_DIST.

Launch N copies (distinct SFA3D_PROCESS_ID), e.g.:

  for i in 0 1; do
    SFA3D_DIST=1 SFA3D_COORDINATOR=127.0.0.1:8476 \\
    SFA3D_NUM_PROCESSES=2 SFA3D_PROCESS_ID=$i \\
    python scripts/torch_multihost_smoke.py [--platform cpu] &
  done; wait

Each process is one rank (NCCL on the card by default, rank i on cuda:i,
raising without a GPU as every entry point of the port does; gloo with
--platform cpu) and feeds its OWN local slice of the global batch
(KFPN-18 at 64 x 64, 2 frames a rank, as the loader's process sharding
delivers it) to the data-parallel train step: global BatchNorm
statistics, global loss normalizers and summed gradients, so every process
must print IDENTICAL losses. Prints one JSON line. Driven by
tests/test_torch_mesh_cli.py.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.parallel import (create_train_state, make_mesh, make_train_step, maybe_init_distributed,
                                          replicate)
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    device = resolve_device(args.platform)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ.get("SFA3D_NUM_PROCESSES", "1"))))
    if not maybe_init_distributed(device=device):
        raise SystemExit("SFA3D_DIST is not set: start one copy per process with SFA3D_DIST=1 (see above)")
    try:
        mesh = make_mesh(device=device)
        hw, hm, k, b_local = 64, 16, 8, 2
        model = create_model("fpn_resnet_18")
        model.init_weights(torch.Generator().manual_seed(0))
        model = model.to(mesh.device)
        tx = create_optimizer(OptimConfig(), num_epochs=2, steps_per_epoch=4)
        state = replicate(mesh, create_train_state(model, tx))
        step = make_train_step(model, tx, compute_dtype="float32", mesh=mesh)

        rng = np.random.default_rng(100 + mesh.rank)  # this rank's local slice of the global batch
        obj_mask = np.zeros((1, b_local, k), np.float32)
        obj_mask[..., :2] = 1
        hm_gt = np.zeros((1, b_local, hm, hm, 3), np.float32)
        hm_gt[:, :, 4, 4, 0] = 1.0
        targets = {
            "hm_cen": hm_gt,
            "cen_offset": rng.uniform(0, 1, (1, b_local, k, 2)).astype(np.float32),
            "direction": rng.uniform(-1, 1, (1, b_local, k, 2)).astype(np.float32),
            "z_coor": rng.uniform(0, 4, (1, b_local, k, 1)).astype(np.float32),
            "dim": rng.uniform(0.5, 4, (1, b_local, k, 3)).astype(np.float32),
            "indices_center": rng.integers(0, hm * hm, (1, b_local, k)).astype(np.int64),
            "obj_mask": obj_mask,
        }
        batch = {"bev": torch.from_numpy(rng.uniform(0, 1, (1, b_local, 3, hw, hw)).astype(np.float32)).to(mesh.device),
                 "targets": {key: torch.from_numpy(v).to(mesh.device) for key, v in targets.items()}}
        losses = []
        for _ in range(args.steps):
            state, stats = step(state, batch)
            losses.append(float(stats["total_loss"]))
        print(json.dumps({
            "process": mesh.rank,
            "process_count": mesh.world_size,
            "backend": torch.distributed.get_backend(),
            "device": str(mesh.device),
            "losses": losses,
            "jax_imported": any(m == "jax" or m.startswith(("jax.", "sfa3d_tpu.")) for m in sys.modules),
        }), flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
