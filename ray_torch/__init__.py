"""ray_torch — the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper (H100).

The port is a package of its own: it imports ``torch``, ``numpy`` and the
standard library, and never ``jax`` or anything of ``ray_tpu`` (a test
enforces this). Where it needs a JAX-free module of the reference (the
serving config, the tokenizer, the page allocator, the engine profiler) it
keeps its own copy, laid out under the same path as the reference so a
reader finds each counterpart (``ray_torch/models/llama.py`` <->
``ray_tpu/models/llama.py``).

Every entry point runs on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do); asking for ``"cuda"`` on a machine
without a card raises instead of falling back.
"""

from ray_torch._device import resolve_device

__all__ = ["resolve_device"]
