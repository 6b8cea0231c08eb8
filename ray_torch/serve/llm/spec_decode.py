"""N-gram draft proposal for speculative decoding (prompt lookup): the
port's own copy of ``ray_tpu/serve/llm/spec_decode.py``.

Speculative decoding (Leviathan et al. 2023) verifies several drafted
tokens in ONE model pass; with greedy sampling the accepted output is
provably identical to step-by-step decoding, so the only question is where
drafts come from. Here they come for free: prompt-lookup / n-gram drafting
(Saxena 2023) — if the tokens just generated end with an n-gram that
already occurred earlier in the slot's prompt+output, the tokens that
followed that earlier occurrence are a cheap guess at what follows now.
Repetitive workloads (code, extraction, multi-turn chat quoting context)
accept most of the draft; adversarial text accepts none and the engine
degrades to ordinary decode.

Everything in this module is host-side Python over small int lists —
zero device work, zero new compiled programs. The engine owns one
``NGramProposer`` per in-flight request and asks it for a draft before
each verify round (engine.py ``_step`` spec path).

The index is incremental: every position of the context is indexed at
most once (per n-gram size), so the amortized cost per generated token is
O(spec_ngram_max), independent of context length — no quadratic suffix
scans on long generations.
"""

from __future__ import annotations


class NGramProposer:
    """Per-request suffix-match draft proposer.

    Maintains, for every n in [1, ngram_max], a dict mapping each n-gram
    of the context to the position AFTER its most recent occurrence
    (the draft continuation start). ``propose`` looks up the context's
    current suffix, longest n first — a longer match is stronger evidence
    the continuation repeats.

    Positions are indexed lazily up to ``len(ctx) - 1`` (an n-gram ending
    at the final position has no continuation yet), so the suffix's own
    occurrence never shadows an earlier one.
    """

    def __init__(self, ngram_max: int, draft_len: int):
        self.ngram_max = max(1, int(ngram_max))
        self.draft_len = max(1, int(draft_len))
        # n -> {ngram tuple -> continuation start position}
        self._index: list[dict] = [dict() for _ in range(self.ngram_max + 1)]
        self._indexed = 0  # positions with an indexed n-gram ENDING there

    def _extend(self, ctx: list[int]) -> None:
        """Index n-grams ending at positions [_indexed, len(ctx) - 1);
        the last position is left for the next call (its continuation
        doesn't exist yet)."""
        hi = len(ctx) - 1
        for end in range(self._indexed, hi):
            for n in range(1, self.ngram_max + 1):
                lo = end - n + 1
                if lo < 0:
                    break
                self._index[n][tuple(ctx[lo: end + 1])] = end + 1
        self._indexed = max(self._indexed, hi)

    def propose(self, ctx: list[int]) -> list[int]:
        """Draft up to ``draft_len`` tokens continuing ``ctx`` (the slot's
        prompt + generated tokens). Empty list = no draft (no suffix
        n-gram recurs); the engine then decodes this slot normally."""
        if len(ctx) < 2:
            return []
        self._extend(ctx)
        t = len(ctx)
        for n in range(min(self.ngram_max, t - 1), 0, -1):
            start = self._index[n].get(tuple(ctx[t - n:]))
            if start is None or start >= t:
                continue
            draft = ctx[start: start + self.draft_len]
            if draft:
                return list(draft)
        return []


def accept_length(draft: list[int], verified: list[int]) -> int:
    """Longest prefix of ``draft`` matched by the verify pass's
    step-by-step (greedy) outputs ``verified`` — the number of drafted
    tokens that are BIT-IDENTICAL to what ordinary decode would have
    produced. verified[i] is the model's token after consuming draft[:i],
    so draft[i] is acceptable iff it equals verified[i] AND every earlier
    draft token was accepted (a mismatch invalidates all later positions:
    their KV was computed from the wrong tokens)."""
    a = 0
    while a < len(draft) and a < len(verified) and draft[a] == verified[a]:
        a += 1
    return a
