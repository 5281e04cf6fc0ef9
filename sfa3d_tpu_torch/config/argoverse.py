"""Argoverse v1 constants.

The port's own copy of the values in `sfa3d_tpu/config/argoverse.py`
(reference config/argoverse_config.py:8-50): the 100 m x 100 m ego-frame
boundary, class maps, the 608 x 608 detector crop and the point budget.
"""

BEV_WIDTH = 608
BEV_HEIGHT = 608
DISCRETIZATION = 0.1  # meters per BEV pixel

# Ego/lidar-frame detection range (x forward, y left, z up).
boundary = {
    "minX": -50.0,
    "maxX": 50.0,
    "minY": -50.0,
    "maxY": 50.0,
    "minZ": -3.0,
    "maxZ": 5.0,
}

bound_size_x = boundary["maxX"] - boundary["minX"]
bound_size_y = boundary["maxY"] - boundary["minY"]
bound_size_z = boundary["maxZ"] - boundary["minZ"]

CLASS_NAME_TO_ID = {
    "VEHICLE": 0,
    "PEDESTRIAN": 1,
    "BICYCLE": 2,
}

ID_TO_CLASS_NAME = {v: k for k, v in CLASS_NAME_TO_ID.items()}

NUM_CLASSES = 3

colors = {
    0: (255, 0, 0),
    1: (0, 255, 0),
    2: (0, 0, 255),
}

MAX_POINTS = 131072  # Argoverse scans cover a 100m x 100m area
