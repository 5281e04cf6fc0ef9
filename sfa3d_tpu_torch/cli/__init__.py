"""Command-line entry points of the port (`python -m sfa3d_tpu_torch.cli.train`, or
through the dispatcher: `python -m sfa3d_tpu_torch.cli <command>`)."""
