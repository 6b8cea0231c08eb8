"""ray_torch.serve.llm — LLM serving of the PyTorch port (mirrors
ray_tpu.serve.llm).

Public surface:
- LLMConfig  — model + engine sizing knobs (the reference's field names)
- LLMEngine  — the continuous-batching engine over the paged KV cache
- LLMServer  — OpenAI-shaped endpoints over one engine
"""

from ray_torch.serve.llm.config import LLMConfig
from ray_torch.serve.llm.engine import LLMEngine
from ray_torch.serve.llm.llm_server import LLMServer

__all__ = ["LLMConfig", "LLMEngine", "LLMServer"]
