"""Observability of the PyTorch port (mirrors ray_tpu.observability)."""
