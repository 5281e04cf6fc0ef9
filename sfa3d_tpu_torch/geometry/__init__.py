"""Calibration and the camera <-> LiDAR transforms; the port of the parts of
`sfa3d_tpu/geometry/` that the projection and the training data use."""
