"""Tokenizers for the LLM serving path.

The reference gets tokenization from vLLM/HF transformers
(python/ray/llm/_internal/serve/deployments/llm/vllm/vllm_engine.py). Here:
- ByteTokenizer: dependency-free byte-level tokenizer (ids 0..255 are raw
  bytes; specials above). Default for tests and zero-egress environments.
- HF tokenizer: loaded from a LOCAL path via transformers when configured
  (no network access is assumed anywhere).
"""

from __future__ import annotations


class ByteTokenizer:
    """Byte-level: token id == byte value; BOS/EOS/PAD above 255."""

    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259
    eos_token_id = EOS
    bos_token_id = BOS

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        data = bytes(i for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers tokenizer from a local directory (no downloads)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = self._tok.vocab_size
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = self._tok.bos_token_id

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=True)


def get_tokenizer(spec: str):
    if spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
