"""Hand-written GPU kernels of the port and their plain PyTorch versions
(mirrors ray_tpu.ops)."""
