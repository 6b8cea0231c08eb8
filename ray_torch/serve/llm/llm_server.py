"""LLMServer: OpenAI-shaped endpoints over the continuous-batching engine —
the in-process part of ``ray_tpu/serve/llm/llm_server.py``.

One server owns one engine. Request and response dicts have the reference
server's shape (``text_completion`` / ``chat.completion`` objects, ``usage``
counts, streaming chunks from an async generator). Attribution is ported:
each response (a stream's final chunk) carries the engine's per-request
stage waterfall under ``ray_tpu.stages``, and a request id bound with
``ray_torch.observability.attribution.set_request_id`` in the caller's
context becomes the engine's request id. Wrapping it as a serve
deployment (``build_llm_deployment``) waits until the port has its own
serve layer; continuation (failover), routing hooks and the SLO exemplar
shipping wait with it.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Any

from ray_torch.observability import attribution
from ray_torch.serve.llm.config import LLMConfig
from ray_torch.serve.llm.engine import LLMEngine


def _chat_prompt(messages: list[dict]) -> str:
    """Minimal chat template (role-tagged concatenation)."""
    parts = []
    for m in messages:
        parts.append(f"<|{m.get('role', 'user')}|>{m.get('content', '')}")
    parts.append("<|assistant|>")
    return "".join(parts)


class LLMServer:
    """Callable server over one engine, which it builds and starts."""

    def __init__(self, llm_config: LLMConfig | dict, params=None,
                 rng_seed: int = 0):
        if isinstance(llm_config, dict):
            llm_config = LLMConfig(**llm_config)
        self.cfg = llm_config
        self.engine = LLMEngine(llm_config, params=params, rng_seed=rng_seed)
        self.engine.start()

    def shutdown(self) -> None:
        self.engine.shutdown()

    # ---- OpenAI-shaped endpoints --------------------------------------
    def completions(self, payload: dict) -> Any:
        prompt = payload.get("prompt", "")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        params = self._sampling(payload)
        if payload.get("stream"):
            return self._stream_completion(prompt, params, chat=False)
        out = self.engine.generate(prompt, **params)
        return self._completion_response(out, chat=False)

    def chat(self, payload: dict) -> Any:
        prompt = _chat_prompt(payload.get("messages", []))
        params = self._sampling(payload)
        if payload.get("stream"):
            return self._stream_completion(prompt, params, chat=True)
        out = self.engine.generate(prompt, **params)
        return self._completion_response(out, chat=True)

    def models(self) -> dict:
        return {"object": "list",
                "data": [{"id": self.cfg.model_id, "object": "model",
                          "owned_by": "ray_torch"}]}

    # ---- plumbing ------------------------------------------------------
    @staticmethod
    def _sampling(payload: dict) -> dict:
        out = {}
        if payload.get("max_tokens") is not None:
            out["max_tokens"] = int(payload["max_tokens"])
        if payload.get("temperature") is not None:
            out["temperature"] = float(payload["temperature"])
        if payload.get("top_k") is not None:
            out["top_k"] = int(payload["top_k"])
        # a request id bound in the caller's context (an ingress-assigned
        # X-Request-Id) becomes the engine's, so the stage record and the
        # client's logs correlate
        rid = attribution.get_request_id()
        if rid:
            out["request_id"] = rid
        return out

    def _completion_response(self, out: dict, chat: bool) -> dict:
        oid = f"cmpl-{uuid.uuid4().hex[:24]}"
        if chat:
            choice = {"index": 0, "finish_reason": "stop",
                      "message": {"role": "assistant", "content": out["text"]}}
            obj = "chat.completion"
        else:
            choice = {"index": 0, "finish_reason": "stop",
                      "text": out["text"]}
            obj = "text_completion"
        resp = {
            "id": oid, "object": obj, "created": int(time.time()),
            "model": self.cfg.model_id, "choices": [choice],
            "usage": {
                "prompt_tokens": out.get("num_prompt_tokens", 0),
                "completion_tokens": out.get("num_generated_tokens", 0),
                "total_tokens": out.get("num_prompt_tokens", 0)
                + out.get("num_generated_tokens", 0),
            },
            # engine-side timing under the reference server's key, so a
            # client reads both servers' responses the same way
            "ray_tpu": {"ttft_s": out.get("ttft_s"),
                        "latency_s": out.get("latency_s"),
                        "queue_wait_s": out.get("queue_wait_s"),
                        "request_id": out.get("request_id"),
                        "stages": out.get("stages") or []},
        }
        if out.get("error"):
            resp["error"] = {"message": str(out["error"])}
        return resp

    async def _stream_completion(self, prompt: str, params: dict,
                                 chat: bool):
        """Async generator of OpenAI stream chunks (SSE payloads minus
        framing). The poll sleep yields the event loop, so N streaming
        requests drain concurrently."""
        t0 = time.monotonic()
        n_prompt = len(self.engine.tokenizer.encode(prompt)) \
            if isinstance(prompt, str) else len(prompt)
        rid = self.engine.submit(prompt, **params)
        oid = f"cmpl-{uuid.uuid4().hex[:24]}"
        obj = "chat.completion.chunk" if chat else "text_completion"
        ntok = 0
        ttft = None
        try:
            while True:
                d = self.engine.drain(rid)
                # gate on TOKENS, not decoded text: the byte tokenizer can
                # decode a batch to "" and the chunk must still go out
                toks = list(d.get("tokens") or ())
                text = d.get("text", "")
                if toks:
                    if ttft is None:
                        ttft = time.monotonic() - t0
                    ntok += len(toks)
                    if chat:
                        delta = {"delta": {"content": text}, "index": 0,
                                 "finish_reason": None}
                    else:
                        delta = {"text": text, "index": 0,
                                 "finish_reason": None}
                    yield {"id": oid, "object": obj,
                           "model": self.cfg.model_id, "choices": [delta],
                           "token_ids": toks}
                if d["done"]:
                    err = d.get("error")
                    reason = "error" if err else "stop"
                    fin = ({"delta": {}, "index": 0, "finish_reason": reason}
                           if chat else
                           {"text": "", "index": 0, "finish_reason": reason})
                    final = {"id": oid, "object": obj,
                             "model": self.cfg.model_id, "choices": [fin],
                             "usage": {"prompt_tokens": n_prompt,
                                       "completion_tokens": ntok,
                                       "total_tokens": n_prompt + ntok},
                             "ray_tpu": {"ttft_s": ttft,
                                         "latency_s": time.monotonic() - t0,
                                         "queue_wait_s":
                                         d.get("queue_wait_s"),
                                         "request_id": d.get("request_id"),
                                         "stages": d.get("stages") or []}}
                    if err:
                        final["error"] = {"message": str(err)}
                    yield final
                    return
                await asyncio.sleep(0.01)
        finally:
            # abandoned stream (generator closed early): stop burning a
            # batch slot and reap the engine entry
            self.engine.cancel(rid)

    # raw engine access
    def generate(self, prompt: str, **kw) -> dict:
        return self.engine.generate(prompt, **kw)

    def submit(self, prompt: str, **kw) -> str:
        return self.engine.submit(prompt, **kw)

    def drain(self, request_id: str) -> dict:
        return self.engine.drain(request_id)

    def engine_stats(self) -> dict:
        return self.engine.engine_stats()

    def check_health(self) -> bool:
        return self.engine._loop_thread is not None \
            and self.engine._loop_thread.is_alive()

    # ---- HTTP-style dispatch ---------------------------------------------
    def handle_http(self, path: str, method: str, payload: Any) -> Any:
        path = "/" + path.strip("/")
        if path.endswith("/chat/completions"):
            return self.chat(payload if isinstance(payload, dict) else {})
        if path.endswith("/completions"):
            return self.completions(
                payload if isinstance(payload, dict) else {})
        if path.endswith("/models"):
            return self.models()
        if path.endswith("/stats"):
            return self.engine_stats()
        return {"error": {"message": f"no route for {path}", "code": 404}}
