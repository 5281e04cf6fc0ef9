"""Training data of the port: synthetic KITTI scenes, the KITTI reader,
LiDAR augmentation and the loader that builds device batches."""
