"""Serving of the PyTorch port (mirrors ray_tpu.serve)."""
