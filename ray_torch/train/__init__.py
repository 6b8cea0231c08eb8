"""Training of the PyTorch port (mirrors ray_tpu.train): the one-device
train step ``spmd`` and its optimizer math ``optim``."""
