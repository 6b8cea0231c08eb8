"""The runtime core of the PyTorch port (mirrors ray_tpu.core). So far it
holds only the request deadline carrier (``deadline``)."""
