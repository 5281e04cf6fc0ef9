"""KITTI constants used by the serving paths.

The port's own copy of the values in `sfa3d_tpu/config/kitti.py` (class map,
front BEV boundary, raster size, point budgets, the dataset-average
calibration); the port imports nothing of the JAX package.
"""

import numpy as np

ID_TO_CLASS_NAME = {0: "Pedestrian", 1: "Car", 2: "Cyclist"}

NUM_CLASSES = 3

# Front BEV detection range in the velodyne frame (meters).
boundary = {
    "minX": 0.0,
    "maxX": 50.0,
    "minY": -25.0,
    "maxY": 25.0,
    "minZ": -2.73,
    "maxZ": 1.27,
}

bound_size_x = boundary["maxX"] - boundary["minX"]
bound_size_y = boundary["maxY"] - boundary["minY"]
bound_size_z = boundary["maxZ"] - boundary["minZ"]

BEV_WIDTH = 608  # raster columns, across the y axis (-25m .. 25m)
BEV_HEIGHT = 608  # raster rows, across the x axis (0m .. 50m)
DISCRETIZATION = (boundary["maxX"] - boundary["minX"]) / BEV_HEIGHT

# Dataset-average calibration matrices (reference kitti_config.py:64-87),
# used when no per-frame calibration file is given.
Tr_velo_to_cam = np.array(
    [
        [7.49916597e-03, -9.99971248e-01, -8.65110297e-04, -6.71807577e-03],
        [1.18652889e-02, 9.54520517e-04, -9.99910318e-01, -7.33152811e-02],
        [9.99882833e-01, 7.49141178e-03, 1.18719929e-02, -2.78557062e-01],
        [0, 0, 0, 1],
    ]
)

R0 = np.array(
    [
        [0.99992475, 0.00975976, -0.00734152, 0],
        [-0.0097913, 0.99994262, -0.00430371, 0],
        [0.00729911, 0.0043753, 0.99996319, 0],
        [0, 0, 0, 1],
    ]
)

P2 = np.array(
    [
        [719.787081, 0.0, 608.463003, 44.9538775],
        [0.0, 719.787081, 174.545111, 0.1066855],
        [0.0, 0.0, 1.0, 3.0106472e-03],
        [0.0, 0.0, 0.0, 0],
    ]
)

# Fixed-shape budgets for the padded point tensors fed to the BEV raster.
MAX_POINTS = 65536  # raw, unfiltered scans (the raster does the filtering)
MAX_POINTS_FILTERED = 32768  # host-prefiltered scans
