"""The runtime core of the PyTorch port (mirrors ray_tpu.core). So far it
holds the request deadline carrier (``deadline``) and the runtime config
(``config``: ``Config``, ``get_config``, ``reset_config``)."""

from ray_torch.core.config import Config, get_config, reset_config

__all__ = ["Config", "get_config", "reset_config"]
