"""Calibration and the camera<->LiDAR transforms the fusion path needs; the
port of the parts of `sfa3d_tpu/geometry/` that the projection uses."""
