"""KITTI constants used by the LiDAR serving path.

The port's own copy of the values in `sfa3d_tpu/config/kitti.py` (class map,
front BEV boundary, raster size, point budgets); the port imports nothing of
the JAX package.
"""

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

# Fixed-shape budgets for the padded point tensors fed to the BEV raster.
MAX_POINTS = 65536  # raw, unfiltered scans (the raster does the filtering)
MAX_POINTS_FILTERED = 32768  # host-prefiltered scans
