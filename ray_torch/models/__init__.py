"""Models of the PyTorch port (mirrors ray_tpu.models)."""
