"""Configuration constants of the PyTorch port."""
