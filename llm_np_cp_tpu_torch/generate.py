"""Generation: prefill + decode loops (port of ``llm_np_cp_tpu/generate.py``).

The JAX package compiles the whole decode loop into one program
(``lax.scan`` / ``lax.while_loop``).  Here the loop is a Python loop of
single-token forwards with the same outputs: sequences that hit a stop
token keep feeding it (``_trim_after_stop`` normalises the tail), and
``early_stop`` leaves the loop once every row is done.  CUDA-graph
capture of the step is later work.

The decode tail under a greedy sampler with a float head is the fused
``sample_epilogue`` kernel (``epilogue_impl == "fused"``); the prefill
tail stays ``final_logits`` + ``Sampler``.  Draws use one
``torch.Generator`` per call, seeded with ``seed``.  ``GenerateResult``
timings synchronise the card before reading the clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from llm_np_cp_tpu_torch.cache import KVCache, align_capacity
from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.models.transformer import (
    epilogue_gate_error,
    forward,
    sample_epilogue_tail,
)
from llm_np_cp_tpu_torch.ops.sampling import Sampler

Params = dict[str, Any]


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray  # [B, num_generated]
    ttft_s: float  # time to first token (prefill + first sample)
    decode_tokens_per_s: float  # steady-state decode rate (per sequence)
    num_generated: int
    text: list[str] | None = None
    steps: int = 0  # decode steps actually executed


def _check_capacity(prompt_len: int, max_new_tokens: int, max_seq_len: int) -> None:
    need = prompt_len + max_new_tokens
    if need > max_seq_len:
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) = "
            f"{need} exceeds KV-cache capacity {max_seq_len}"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------------
# Building blocks
# ----------------------------------------------------------------------

def make_prefill_fn(
    config: ModelConfig, sampler: Sampler, attn_impl: str = "xla",
    *, device: str | torch.device = "cuda",
) -> Callable:
    """(params, prompt_ids, cache, gen, attn_mask=None, pad_offsets=None)
    → (first_token [B], cache, last logits [B, V]).  The cache is written
    in place.  attn_impl="flash" routes prefill attention through the
    flash kernel (prefill always starts from a fresh cache)."""

    def prefill(params, prompt_ids, cache, gen, attn_mask=None, pad_offsets=None):
        logits, cache = forward(
            params, prompt_ids, config, cache, logits_last_only=True,
            attn_mask=attn_mask, pad_offsets=pad_offsets, attn_impl=attn_impl,
            device=device,
        )
        return sampler(gen, logits[:, -1]), cache, logits[:, -1]

    return prefill


def make_ragged_prefill_step(config: ModelConfig, *, device: str | torch.device = "cuda") -> Callable:
    """(params, ids, cache, mask, pads) → (last_logits [B, V], cache) — one
    ragged (left-padded) prefill chunk at the cache's running offset."""

    def ragged_step(params, ids, cache, mask, pads):
        logits, cache = forward(
            params, ids, config, cache, logits_last_only=True,
            attn_mask=mask, pad_offsets=pads, attn_impl="xla", device=device,
        )
        return logits[:, -1], cache

    return ragged_step


def make_chunked_prefill_fn(
    config: ModelConfig,
    sampler: Sampler,
    chunk_size: int,
    attn_impl: str = "xla",
    *,
    device: str | torch.device = "cuda",
) -> Callable:
    """Same contract as ``make_prefill_fn``, but the prompt is consumed in
    chunks of ``chunk_size`` tokens.  ``attn_impl="flash"`` applies to the
    FIRST chunk only (the kernel needs a fresh cache); later chunks
    attend cached history on the plain path."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    ragged_step = make_ragged_prefill_step(config, device=device)

    def step(params, ids, cache, impl):
        logits, cache = forward(
            params, ids, config, cache, logits_last_only=True, attn_impl=impl,
            device=device,
        )
        return logits[:, -1], cache

    def prefill_chunked(params, prompt_ids, cache, gen, attn_mask=None, pad_offsets=None):
        ragged = attn_mask is not None or pad_offsets is not None
        if ragged and (attn_mask is None or pad_offsets is None):
            raise ValueError("ragged chunked prefill needs BOTH attn_mask and pad_offsets")
        if ragged and attn_impl != "xla":
            raise ValueError(
                f"attn_impl={attn_impl!r} does not support ragged batches; "
                "use attn_impl='xla'"
            )
        s = prompt_ids.shape[1]
        off, impl, last = 0, attn_impl, None
        while off < s:
            w = min(chunk_size, s - off)
            if ragged:
                last, cache = ragged_step(
                    params, prompt_ids[:, off:off + w], cache,
                    attn_mask[:, off:off + w], pad_offsets,
                )
            else:
                last, cache = step(params, prompt_ids[:, off:off + w], cache, impl)
            impl, off = "xla", off + w
        return sampler(gen, last), cache, last

    return prefill_chunked


def _make_sample_tail(config: ModelConfig, sampler: Sampler, fused_epilogue: bool) -> Callable:
    """``(params, gen, fwd_out) → next_tok [B]`` — the decode tail: the
    fused epilogue kernel over pre-final-norm hidden states, or the
    sampler over the last logits."""
    if not fused_epilogue:
        return lambda params, gen, logits: sampler(gen, logits[:, -1])
    return lambda params, gen, hid: sample_epilogue_tail(params, hid[:, -1], config)


def make_decode_step_fn(
    config: ModelConfig, sampler: Sampler, attn_impl: str = "xla",
    fused_epilogue: bool = False, *, device: str | torch.device = "cuda",
) -> Callable:
    """(params, tok [B], cache, gen, pad_offsets=None) → (next_tok [B],
    cache) — one token, the cache written in place."""
    sample_tail = _make_sample_tail(config, sampler, fused_epilogue)

    def step(params, tok, cache, gen, pad_offsets=None):
        out, cache = forward(
            params, tok[:, None], config, cache, logits_last_only=True,
            pad_offsets=pad_offsets, attn_impl=attn_impl,
            skip_logits=fused_epilogue, device=device,
        )
        return sample_tail(params, gen, out), cache

    return step


def make_decode_loop_fn(
    config: ModelConfig,
    sampler: Sampler,
    stop_tokens: tuple[int, ...] = (),
    attn_impl: str = "xla",
    early_stop: bool = False,
    fused_epilogue: bool = False,
    *,
    device: str | torch.device = "cuda",
) -> Callable:
    """(params, first_tok, cache, gen, num_steps, pad_offsets=None) →
    (tokens [B, num_steps], cache, steps_executed).

    Rows that hit a stop token keep feeding it.  early_stop=True (needs
    stop_tokens) leaves the loop once every row is done; unfilled tail
    slots hold 0 and ``_trim_after_stop`` normalises them, so outputs
    equal the fixed-trip loop's."""
    if early_stop and not stop_tokens:
        raise ValueError("early_stop requires stop_tokens")
    step = make_decode_step_fn(config, sampler, attn_impl, fused_epilogue, device=device)

    def decode_loop(params, first_tok, cache, gen, num_steps, pad_offsets=None):
        dev = first_tok.device
        stops = torch.tensor(stop_tokens, dtype=first_tok.dtype, device=dev) if stop_tokens else None
        done = (
            torch.isin(first_tok, stops) if stops is not None
            else torch.zeros(first_tok.shape, dtype=torch.bool, device=dev)
        )
        buf = torch.zeros((first_tok.shape[0], num_steps), dtype=torch.int32, device=dev)
        tok, i = first_tok, 0
        while i < num_steps:
            if early_stop and bool(done.all()):
                break
            nxt, cache = step(params, tok, cache, gen, pad_offsets)
            if stops is not None:
                nxt = torch.where(done, tok, nxt)
                done = done | torch.isin(nxt, stops)
            buf[:, i] = nxt
            tok, i = nxt, i + 1
        return buf, cache, i

    return decode_loop


# ----------------------------------------------------------------------
# High-level API
# ----------------------------------------------------------------------

class IncrementalDetok:
    """Incremental detokenization: decode the full id list on every push
    and emit only the delta, holding back while the tail may still
    change (a partial UTF-8 merge)."""

    def __init__(self, tokenizer: Any) -> None:
        self.tokenizer = tokenizer
        self.ids: list[int] = []
        self.emitted = ""

    def push(self, token_id: int) -> str | None:
        """Append one id; return the newly-stable text delta, if any."""
        self.ids.append(int(token_id))
        text = self.tokenizer.decode(self.ids, skip_special_tokens=True)
        if text.endswith("�"):
            return None
        delta, self.emitted = text[len(self.emitted):], text
        return delta or None

    def flush(self) -> str | None:
        """Emit any held-back tail (call once, after the last push)."""
        text = self.tokenizer.decode(self.ids, skip_special_tokens=True)
        delta = text[len(self.emitted):]
        self.emitted = text
        return delta or None


class Generator:
    """Prefill/decode for one (model, sampler) pair on ``device``.

    ``prefill_attn_impl="flash"`` runs prefill attention through the
    flash kernel, ``decode_attn_impl="flash_decode"`` runs each decode
    step's attention through the decode kernel, and a greedy sampler over
    a float head takes the fused epilogue kernel as its decode tail.
    There is no probe and no fallback: on the card a kernel launches or
    raises.
    """

    def __init__(
        self,
        params: Params,
        config: ModelConfig,
        *,
        sampler: Sampler | None = None,
        stop_tokens: tuple[int, ...] = (),
        cache_dtype: torch.dtype = torch.bfloat16,
        prefill_attn_impl: str = "xla",
        prefill_chunk: int | None = None,
        decode_attn_impl: str = "xla",
        early_stop: bool = False,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.sampler = sampler or Sampler()
        self.stop_tokens = tuple(stop_tokens)
        self.cache_dtype = cache_dtype
        if prefill_attn_impl not in ("xla", "flash"):
            raise ValueError(f"prefill_attn_impl must be 'xla' or 'flash', got {prefill_attn_impl!r}")
        if decode_attn_impl not in ("xla", "flash_decode"):
            raise ValueError(
                f"decode_attn_impl must be 'xla' or 'flash_decode', got {decode_attn_impl!r}"
            )
        dev = self.device
        if prefill_chunk:
            self._prefill = make_chunked_prefill_fn(
                config, self.sampler, prefill_chunk, prefill_attn_impl, device=dev
            )
        else:
            self._prefill = make_prefill_fn(config, self.sampler, prefill_attn_impl, device=dev)
        self.last_stream_stats: dict[str, Any] = {}
        self.epilogue_impl = (
            "fused" if epilogue_gate_error(params, config, self.sampler.kind) is None else "xla"
        )
        fused_epi = self.epilogue_impl == "fused"
        self._step = make_decode_step_fn(
            config, self.sampler, decode_attn_impl, fused_epilogue=fused_epi, device=dev
        )
        self._loop = make_decode_loop_fn(
            config, self.sampler, self.stop_tokens, decode_attn_impl,
            early_stop=early_stop, fused_epilogue=fused_epi, device=dev,
        )

    def _init_cache(self, batch: int, max_seq_len: int) -> KVCache:
        return KVCache.init(
            self.config, batch, align_capacity(max_seq_len),
            dtype=self.cache_dtype, device=self.device,
        )

    def _ids(self, ids: Any) -> torch.Tensor:
        t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return t[None, :] if t.ndim == 1 else t

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _run(
        self,
        prompt_ids: torch.Tensor,
        max_new_tokens: int,
        max_seq_len: int | None,
        seed: int,
        attn_mask: torch.Tensor | None = None,
        pad_offsets: torch.Tensor | None = None,
    ) -> GenerateResult:
        """Prefill, then the decode loop."""
        b, s = prompt_ids.shape
        max_seq_len = max_seq_len or s + max_new_tokens
        _check_capacity(s, max_new_tokens, max_seq_len)
        gen = self._generator(seed)
        cache = self._init_cache(b, max_seq_len)

        _sync(self.device)
        t0 = time.perf_counter()
        tok0, cache, _ = self._prefill(self.params, prompt_ids, cache, gen, attn_mask, pad_offsets)
        _sync(self.device)
        t1 = time.perf_counter()

        first = tok0.cpu().numpy()[:, None]
        if max_new_tokens > 1:
            rest, cache, steps = self._loop(
                self.params, tok0, cache, gen, max_new_tokens - 1, pad_offsets
            )
            _sync(self.device)
            t2 = time.perf_counter()
            tokens = np.concatenate([first, rest.cpu().numpy()], axis=1)
            rate = steps / (t2 - t1) if steps > 0 else float("nan")
        else:
            tokens, rate, steps = first, float("nan"), 0

        tokens = _trim_after_stop(tokens, self.stop_tokens)
        return GenerateResult(
            tokens=tokens,
            ttft_s=t1 - t0,
            decode_tokens_per_s=rate,
            num_generated=tokens.shape[1],
            steps=steps,
        )

    def generate(
        self,
        prompt_ids: Any,
        max_new_tokens: int,
        *,
        max_seq_len: int | None = None,
        seed: int = 0,
    ) -> GenerateResult:
        """Generate for a [B, S] (or [S]) batch of equal-length prompts."""
        return self._run(self._ids(prompt_ids), max_new_tokens, max_seq_len, seed)

    @staticmethod
    def left_pad(
        prompts: list[np.ndarray | list[int]],
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """prompts → (ids [B, S] zero-left-padded, mask [B, S] valid,
        pads [B] per-row pad counts)."""
        arrs = [np.asarray(p, dtype=np.int32).reshape(-1) for p in prompts]
        if not arrs:
            raise ValueError("left_pad needs at least one prompt")
        empty = [i for i, a in enumerate(arrs) if a.size == 0]
        if empty:
            raise ValueError(f"empty prompt at index {empty[0]}")
        s = max(a.size for a in arrs)
        b = len(arrs)
        ids = np.zeros((b, s), dtype=np.int32)
        mask = np.zeros((b, s), dtype=bool)
        pads = np.zeros(b, dtype=np.int32)
        for i, a in enumerate(arrs):
            pads[i] = s - a.size
            ids[i, pads[i]:] = a
            mask[i, pads[i]:] = True
        return ids, mask, pads

    def generate_ragged(
        self,
        prompts: list[np.ndarray | list[int]],
        max_new_tokens: int,
        *,
        max_seq_len: int | None = None,
        seed: int = 0,
    ) -> GenerateResult:
        """Batch generation over prompts of different lengths: left-padded,
        with per-row ``pad_offsets`` keeping positions and masks exact."""
        ids, mask, pads = self.left_pad(prompts)
        dev = self.device
        return self._run(
            self._ids(ids), max_new_tokens, max_seq_len, seed,
            attn_mask=torch.as_tensor(mask, device=dev),
            pad_offsets=torch.as_tensor(pads, dtype=torch.int64, device=dev),
        )

    def generate_many(
        self,
        prompts: list[np.ndarray | list[int]],
        max_new_tokens: int,
        *,
        batch_size: int = 8,
        max_seq_len: int | None = None,
        seed: int = 0,
    ) -> list[GenerateResult]:
        """Dynamic batching: prompts grouped longest-first into ragged
        batches of ``batch_size``; one GenerateResult per prompt, in the
        caller's order."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        order = sorted(range(len(prompts)), key=lambda i: -len(np.asarray(prompts[i]).reshape(-1)))
        results: list[GenerateResult | None] = [None] * len(prompts)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            res = self.generate_ragged(
                [prompts[i] for i in idx], max_new_tokens,
                max_seq_len=max_seq_len, seed=seed + start,
            )
            for row, i in enumerate(idx):
                results[i] = GenerateResult(
                    tokens=res.tokens[row:row + 1],
                    ttft_s=res.ttft_s,
                    decode_tokens_per_s=res.decode_tokens_per_s,
                    num_generated=res.num_generated,
                    steps=res.steps,
                )
        return results  # type: ignore[return-value]

    def stream(
        self,
        prompt_ids: Any,
        max_new_tokens: int,
        *,
        max_seq_len: int | None = None,
        seed: int = 0,
    ) -> Iterator[int]:
        """Yield token ids one at a time (batch size 1)."""
        prompt_ids = self._ids(prompt_ids)
        if prompt_ids.shape[0] != 1:
            raise ValueError("streaming supports batch size 1")
        s = prompt_ids.shape[1]
        max_seq_len = max_seq_len or s + max_new_tokens
        _check_capacity(s, max_new_tokens, max_seq_len)
        gen = self._generator(seed)
        cache = self._init_cache(1, max_seq_len)
        tok, cache, _ = self._prefill(self.params, prompt_ids, cache, gen)
        t = int(tok[0])
        yield t
        for _ in range(max_new_tokens - 1):
            if t in self.stop_tokens:
                return
            tok, cache = self._step(self.params, tok, cache, gen)
            t = int(tok[0])
            yield t

    def stream_text(
        self,
        tokenizer: Any,
        prompt: str,
        max_new_tokens: int,
        *,
        seed: int = 0,
        echo: Callable[[str], None] | None = None,
    ) -> str:
        """Streaming text generation with incremental detokenization."""
        prompt_ids = tokenizer(prompt, return_tensors="np")["input_ids"][0]
        detok = IncrementalDetok(tokenizer)
        t0 = time.perf_counter()
        ttft = None
        for t in self.stream(prompt_ids, max_new_tokens, seed=seed):
            if ttft is None:
                ttft = time.perf_counter() - t0
            delta = detok.push(t)
            if echo and delta:
                echo(delta)
        tail = detok.flush()
        if echo and tail:
            echo(tail)
        self.last_stream_stats = {
            "tokens": len(detok.ids),
            "ttft_s": ttft,
            "duration_s": time.perf_counter() - t0,
        }
        return detok.emitted


def _trim_after_stop(tokens: np.ndarray, stop_tokens: tuple[int, ...]) -> np.ndarray:
    """Replace everything after the first stop token with that stop token."""
    if not stop_tokens:
        return tokens
    out = tokens.copy()
    for b in range(out.shape[0]):
        hits = np.isin(out[b], stop_tokens).nonzero()[0]
        if hits.size:
            out[b, hits[0]:] = out[b, hits[0]]
    return out
