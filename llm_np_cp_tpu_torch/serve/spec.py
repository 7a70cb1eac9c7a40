"""Host-side draft streams for speculative serving (port of
``llm_np_cp_tpu/serve/spec.py``; pure Python, copied as it is).

The serve engine's speculative mode is draft-then-verify folded into the
ONE unified-tick step: each speculating request proposes up to
``spec_k`` candidate tokens, the tick packs them as a ragged q-slice of
width ``k'+1`` (the verified input token plus the drafts) beside prefill
chunks and plain decode rows, and the step samples at EVERY packed
position by the engine's (seed, content-position) rule.  The longest
draft prefix matching those samples is accepted, so accepted streams are
token-identical to plain decode by construction, and a verify slice
reads each request's K/V blocks once for up to ``k+1`` emitted tokens.

The draft source is host-side prompt lookup (n-gram drafting over the
request's own token history): a model draft would cost k sequential
steps a tick.  It is strong where speculation pays (extractive spans:
quoting the prompt, code, structured output); where it is weak the
engine's per-request rolling-acceptance fallback turns the request back
into a plain decode row.

``DraftState`` is the per-slot draft stream: an incremental n-gram →
position index over prompt + generated tokens.  ``propose(k)`` returns
the continuation of the most recent PRIOR occurrence of the current
suffix n-gram (longest n first), ``extend`` appends newly accepted
tokens.  O(1) per token to maintain, O(ngram range) per proposal.
"""

from __future__ import annotations


class DraftState:
    """Prompt-lookup draft stream for one request.

    Keeps the request's token history (prompt + generated) and, for each
    n in ``[ngram_min, ngram_max]``, a map from n-gram → its latest two
    end positions.  The current suffix always maps to the history's own
    tail (it was registered when its last token arrived), so proposals
    read the PREVIOUS occurrence — the most recent place the stream has
    been before — and copy the tokens that followed it.
    """

    def __init__(self, ngram_max: int = 3, ngram_min: int = 2) -> None:
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"{ngram_min}..{ngram_max}"
            )
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self._ctx: list[int] = []
        # n → {ngram tuple → (previous end pos, latest end pos)}; an end
        # position is the index AFTER the n-gram (where its continuation
        # starts)
        self._index: dict[int, dict[tuple, tuple]] = {
            n: {} for n in range(ngram_min, ngram_max + 1)
        }

    @property
    def size(self) -> int:
        """Tokens consumed so far (callers extend with history[size:])."""
        return len(self._ctx)

    def extend(self, tokens) -> None:
        ctx = self._ctx
        for t in tokens:
            ctx.append(int(t))
            end = len(ctx)
            for n in range(self.ngram_min, self.ngram_max + 1):
                if end < n:
                    continue
                key = tuple(ctx[end - n:end])
                idx = self._index[n]
                prev = idx.get(key)
                idx[key] = (prev[1] if prev is not None else None, end)

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the current suffix, or []
        when the suffix has no prior occurrence (the request decodes
        plain this tick)."""
        if k <= 0:
            return []
        ctx = self._ctx
        end = len(ctx)
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if end < n:
                continue
            hit = self._index[n].get(tuple(ctx[end - n:end]))
            if hit is None:
                continue
            prev, latest = hit
            # the latest registration is the suffix itself (position ==
            # end); a prior occurrence is what we can copy forward from
            pos = latest if latest < end else prev
            if pos is None or pos >= end:
                continue
            # the continuation window [pos, pos+k) clips at the context
            # end when the match sits near the tail — i.e. the stream is
            # cycling with period end-pos.  Copy modularly so a tight
            # loop (the single-repeated-token case above all) still
            # yields k drafts instead of one per tick.
            period = end - pos
            return [ctx[pos + (i % period)] for i in range(k)]
        return []
