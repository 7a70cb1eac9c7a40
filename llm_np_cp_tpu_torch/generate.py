"""Generation: prefill + decode loops (port of ``llm_np_cp_tpu/generate.py``).

The JAX package compiles each decode step into one program
(``make_decode_step_fn`` / ``make_decode_loop_fn`` under ``jax.jit``).
Here the decode step is a function over static buffers that the cache
owns (the input token, the ``done`` rows, the pad offsets), reading its
write slot and positions from the cache's device offset, and
``graphs.CapturedStep`` runs it: on the card it is captured as a CUDA
graph once per static shape — (batch, cache capacity, ragged or not)
within one step function, whose attention impl, tail, sampler and cache
dtype are fixed — and replayed with one launch per token; on the CPU
the same function runs eagerly, which is what the tests compare with
the JAX package.  The loop stays a Python loop with the same outputs:
sequences that hit a stop token keep feeding it (the ``where`` / ``isin``
update is inside the step, ``_trim_after_stop`` normalises the tail),
and ``early_stop`` reads ``done.all()`` back once per step to leave the
loop once every row is done.  Prefill stays eager: its shape is the
prompt's.

The decode tail under a greedy sampler with a float or int8 head is the fused
``sample_epilogue`` kernel (``epilogue_impl == "fused"``); the prefill
tail stays ``final_logits`` + ``Sampler``.  A sampled kind is keyed as
the JAX package keys it (``random``): ``PRNGKey(seed)`` splits into the
prefill's key and the loop's, and the loop's splits into one key a step,
which the step reads from a static buffer at a step index on the card
(the host hands a replay no key), so captured and eager steps draw the
JAX package's tokens.  A ``Generator`` keeps one cache per (batch,
capacity) and resets it per call (validity bitmap and offsets), so its
graphs replay the same addresses.  ``GenerateResult`` timings
synchronise the card before reading the clock.

Under a mesh (``Generator(mesh=)``, ``parallel/``) every rank builds the
Generator over its own shards and makes the same calls: each rank runs
its block of the batch rows when they divide over "data" (every row
otherwise), the forward runs tensor parallel over "model" (and ring
prefill over "seq"), a sampled kind draws its rows' share of the whole
batch's bits (``row0``), and the tokens are all-gathered over "data", so
every rank returns the whole batch's.  A decode step under a multi-rank
mesh runs eagerly: its gloo collectives cannot be captured into a CUDA
graph (and NCCL capture is not wired up).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from llm_np_cp_tpu_torch import random
from llm_np_cp_tpu_torch.cache import KVCache, align_capacity
from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.graphs import CapturedStep
from llm_np_cp_tpu_torch.models.transformer import (
    epilogue_gate_error,
    forward,
    sample_epilogue_tail,
)
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.parallel.collectives import all_gather
from llm_np_cp_tpu_torch.parallel.ring_attention import check_ring_mesh
from llm_np_cp_tpu_torch.parallel.sharding import DATA_AXIS, Mesh, local_kv_heads

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
    *, device: str | torch.device = "cuda", mesh: Mesh | None = None,
) -> Callable:
    """(params, prompt_ids, cache, key, attn_mask=None, pad_offsets=None,
    row0=0) → (first_token [B], cache, last logits [B, V]).  The cache is
    written in place.  attn_impl="flash" routes prefill attention through
    the flash kernel, "ring" through ring attention over ``mesh``'s "seq"
    axis (prefill always starts from a fresh cache).  ``row0``: the first
    of these rows in the whole batch (a data-parallel rank's rows)."""

    def prefill(params, prompt_ids, cache, key, attn_mask=None, pad_offsets=None, row0=0):
        logits, cache = forward(
            params, prompt_ids, config, cache, logits_last_only=True,
            attn_mask=attn_mask, pad_offsets=pad_offsets, attn_impl=attn_impl,
            device=device, mesh=mesh,
        )
        return sampler(key, logits[:, -1], row0), cache, logits[:, -1]

    return prefill


def make_ragged_prefill_step(config: ModelConfig, *, device: str | torch.device = "cuda",
                             mesh: Mesh | None = None) -> Callable:
    """(params, ids, cache, mask, pads) → (last_logits [B, V], cache) — one
    ragged (left-padded) prefill chunk at the cache's running offset."""

    def ragged_step(params, ids, cache, mask, pads):
        logits, cache = forward(
            params, ids, config, cache, logits_last_only=True,
            attn_mask=mask, pad_offsets=pads, attn_impl="xla", device=device, mesh=mesh,
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
    mesh: Mesh | None = None,
) -> Callable:
    """Same contract as ``make_prefill_fn``, but the prompt is consumed in
    chunks of ``chunk_size`` tokens.  ``attn_impl="flash"`` or ``"ring"``
    applies to the FIRST chunk only (both need a fresh cache); later
    chunks attend cached history on the plain path."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    ragged_step = make_ragged_prefill_step(config, device=device, mesh=mesh)

    def step(params, ids, cache, impl):
        logits, cache = forward(
            params, ids, config, cache, logits_last_only=True, attn_impl=impl,
            device=device, mesh=mesh,
        )
        return logits[:, -1], cache

    def prefill_chunked(params, prompt_ids, cache, key, attn_mask=None, pad_offsets=None,
                        row0=0):
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
        return sampler(key, last, row0), cache, last

    return prefill_chunked


def _make_sample_tail(config: ModelConfig, sampler: Sampler, fused_epilogue: bool,
                      mesh: Mesh | None = None) -> Callable:
    """``(params, key, fwd_out, row0) → next_tok [B]`` — the decode tail:
    the fused epilogue kernel over pre-final-norm hidden states (merged
    over the "model" axis's vocab shards under a mesh), or the sampler
    over the last logits."""
    if not fused_epilogue:
        return lambda params, key, logits, row0: sampler(key, logits[:, -1], row0)
    return lambda params, key, hid, row0: sample_epilogue_tail(params, hid[:, -1], config, mesh)


@dataclasses.dataclass(eq=False)
class _StepState:
    """One decode step's static buffers over one cache: the input token
    (the step writes its sample back here), the rows that hit a stop
    token, the ragged batch's pad offsets, a sampled kind's keys (one a
    step) and the index of the next, and the step runner."""

    cache: KVCache
    params: Params
    tok: torch.Tensor  # [B] int32
    done: torch.Tensor  # [B] bool
    pads: torch.Tensor | None  # [B] int64 (ragged batches)
    stops: torch.Tensor | None
    keys: torch.Tensor | None  # [capacity, 2] int32 (sampled kinds)
    step: torch.Tensor | None  # [1] int64: the next step's row of keys
    row0: int = 0  # these rows' first row in the whole batch (data parallel)
    run: CapturedStep | None = None


def _make_step_body(config: ModelConfig, sampler: Sampler, attn_impl: str,
                    fused_epilogue: bool, device: torch.device,
                    mesh: Mesh | None = None) -> Callable:
    """``body(st)``: one token through the decoder from ``st.tok`` at the
    cache's device offset, the sample written back to ``st.tok`` (rows
    already ``done`` keep their token, and a stop token marks its row
    done), a sampled kind drawing under ``st.keys[st.step]`` and moving
    the index on.  It moves the device offsets alone: a replay runs no
    Python, so the caller advances the host count."""
    sample_tail = _make_sample_tail(config, sampler, fused_epilogue, mesh)

    def body(st: _StepState) -> None:
        n = st.cache.length
        out, _ = forward(
            st.params, st.tok[:, None], config, st.cache, logits_last_only=True,
            pad_offsets=st.pads, attn_impl=attn_impl, skip_logits=fused_epilogue,
            device=device, mesh=mesh,
        )
        st.cache.length = n
        key = None
        if st.keys is not None:
            key = st.keys.index_select(0, st.step)[0]
            st.step += 1
        nxt = sample_tail(st.params, key, out, st.row0)
        if st.stops is not None:
            nxt = torch.where(st.done, st.tok, nxt)
            st.done |= torch.isin(nxt, st.stops)
        st.tok.copy_(nxt)

    return body


def _step_state(body: Callable, sampler: Sampler, stop_tokens: tuple[int, ...], params: Params,
                cache: KVCache, ragged: bool, row0: int = 0, eager: bool = False) -> _StepState:
    """The cache's static step for ``body`` over ``params``, built at the
    first call with these inputs (``eager``: never captured)."""
    key = (body, id(params), ragged, row0)
    st = cache.steps.get(key)
    if st is None:
        dev, b = cache.k.device, cache.k.shape[1]
        draws = sampler.kind != "greedy"
        st = _StepState(
            cache=cache, params=params,
            tok=torch.zeros(b, dtype=torch.int32, device=dev),
            done=torch.zeros(b, dtype=torch.bool, device=dev),
            pads=torch.zeros(b, dtype=torch.int64, device=dev) if ragged else None,
            stops=(torch.tensor(stop_tokens, dtype=torch.int32, device=dev)
                   if stop_tokens else None),
            keys=(torch.zeros((cache.max_seq_len, 2), dtype=torch.int32, device=dev)
                  if draws else None),
            step=torch.zeros(1, dtype=torch.int64, device=dev) if draws else None,
            row0=row0,
        )
        st.run = CapturedStep(lambda: body(st), dev,
                              f"decode_step[B={b}, S={cache.max_seq_len}]", eager=eager)
        cache.steps[key] = st
    return st


def _advance(st: _StepState) -> None:
    """Run the step once (eagerly, or its graph) and advance the host
    count as the step advanced the device offset."""
    cache = st.cache
    if cache.length + 1 > cache.max_seq_len:
        raise ValueError(
            f"writing 1 token at offset {cache.length} exceeds KV-cache "
            f"capacity {cache.max_seq_len}"
        )
    st.run()
    cache.length += 1


def _load_inputs(st: _StepState, tok: torch.Tensor, pad_offsets: torch.Tensor | None,
                 keys: torch.Tensor | None) -> None:
    """The step's inputs into its static buffers: the token, the pads
    and, for a sampled kind, the keys of the steps to come ``[n, 2]``."""
    st.tok.copy_(tok)
    if st.pads is not None:
        st.pads.copy_(pad_offsets)
    if st.keys is not None:
        if keys is None:
            raise ValueError("a sampled decode step needs a key")
        st.keys[:keys.shape[0]].copy_(keys)
        st.step.zero_()


def _multi_rank(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.plan.num_devices > 1


def make_decode_step_fn(
    config: ModelConfig, sampler: Sampler, attn_impl: str = "xla",
    fused_epilogue: bool = False, *, device: str | torch.device = "cuda",
    mesh: Mesh | None = None,
) -> Callable:
    """(params, tok [B], cache, key, pad_offsets=None, row0=0) →
    (next_tok [B], cache) — one token drawn under ``key`` (None for
    greedy), the cache written in place.  The step is built over the
    cache's static buffers and, on the card, captured at its first call
    and replayed after (under a multi-rank mesh: run eagerly)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    body = _make_step_body(config, sampler, attn_impl, fused_epilogue, dev, mesh)

    def step(params, tok, cache, key, pad_offsets=None, row0=0):
        st = _step_state(body, sampler, (), params, cache, pad_offsets is not None, row0,
                         _multi_rank(mesh))
        _load_inputs(st, tok, pad_offsets, None if key is None else key[None])
        _advance(st)
        return st.tok.clone(), cache

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
    mesh: Mesh | None = None,
) -> Callable:
    """(params, first_tok, cache, key, num_steps, pad_offsets=None, row0=0)
    → (tokens [B, num_steps], cache, steps_executed).

    A sampled kind draws step i under ``split(key, num_steps)[i]``, as
    the JAX loop does (``decode_loop.run_keys`` takes those keys
    ``[num_steps, 2]`` as they are).  Rows that hit a stop token keep
    feeding it.  early_stop=True (needs stop_tokens) leaves the loop once
    every row is done; unfilled tail slots hold 0 and
    ``_trim_after_stop`` normalises them, so outputs equal the
    fixed-trip loop's.  Every step is the one static step of the cache
    (captured on the card at the first, replayed after; under a
    multi-rank mesh, eager).  ``row0``: these rows' first row in the
    whole batch."""
    if early_stop and not stop_tokens:
        raise ValueError("early_stop requires stop_tokens")
    dev = mesh.device if mesh is not None else resolve_device(device)
    body = _make_step_body(config, sampler, attn_impl, fused_epilogue, dev, mesh)
    draws = sampler.kind != "greedy"

    def run_keys(params, first_tok, cache, keys, num_steps, pad_offsets=None, row0=0):
        st = _step_state(body, sampler, stop_tokens, params, cache, pad_offsets is not None,
                         row0, _multi_rank(mesh))
        _load_inputs(st, first_tok, pad_offsets, keys)
        if st.stops is not None:
            st.done.copy_(torch.isin(st.tok, st.stops))
        buf = torch.zeros((first_tok.shape[0], num_steps), dtype=torch.int32,
                          device=first_tok.device)
        i = 0
        while i < num_steps:
            if early_stop and bool(st.done.all()):
                break
            _advance(st)
            buf[:, i] = st.tok
            i += 1
        return buf, cache, i

    def decode_loop(params, first_tok, cache, key, num_steps, pad_offsets=None, row0=0):
        keys = random.split(key, num_steps) if draws and num_steps > 0 else None
        return run_keys(params, first_tok, cache, keys, num_steps, pad_offsets, row0)

    decode_loop.run_keys = run_keys
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
    a float or int8 (quant.py ``"q"``) head takes the fused epilogue kernel
    as its decode tail.
    There is no probe and no fallback: on the card a kernel launches or
    raises, and a decode step captures and replays its graph or raises.
    ``compile_counts()`` reports the decode-step graphs captured (on the
    CPU, the static steps built), one per (batch, capacity, ragged)
    the Generator has served.

    ``mesh`` (``parallel.sharding.make_mesh``): ``params`` are this rank's
    shards (``shard_params``) and every rank of the mesh makes the same
    calls with the same (whole-batch) inputs; see the module docstring.
    ``prefill_attn_impl="ring"`` needs a "seq" axis of at least 2.  The
    decode steps of a multi-rank mesh run eagerly, and
    ``compile_counts()["decode_step_eager"]`` counts them.
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
        mesh: Mesh | None = None,
    ) -> None:
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.mesh = mesh
        self.params = params
        self.config = config
        self.sampler = sampler or Sampler()
        self.stop_tokens = tuple(stop_tokens)
        self.cache_dtype = cache_dtype
        if prefill_attn_impl not in ("xla", "flash", "ring"):
            raise ValueError(
                f"prefill_attn_impl must be 'xla', 'flash' or 'ring', got {prefill_attn_impl!r}")
        if prefill_attn_impl == "ring":
            check_ring_mesh(mesh, "prefill_attn_impl='ring'")
        if decode_attn_impl not in ("xla", "flash_decode"):
            raise ValueError(
                f"decode_attn_impl must be 'xla' or 'flash_decode', got {decode_attn_impl!r}"
            )
        dev = self.device
        if prefill_chunk:
            self._prefill = make_chunked_prefill_fn(
                config, self.sampler, prefill_chunk, prefill_attn_impl, device=dev, mesh=mesh
            )
        else:
            self._prefill = make_prefill_fn(config, self.sampler, prefill_attn_impl, device=dev,
                                            mesh=mesh)
        self.last_stream_stats: dict[str, Any] = {}
        self.epilogue_impl = (
            "fused" if epilogue_gate_error(params, config, self.sampler.kind) is None else "xla"
        )
        fused_epi = self.epilogue_impl == "fused"
        # one cache per (batch, capacity): the decode steps' graphs
        # replay their addresses
        self._caches: dict[tuple[int, int], KVCache] = {}
        self._loop = make_decode_loop_fn(
            config, self.sampler, self.stop_tokens, decode_attn_impl,
            early_stop=early_stop, fused_epilogue=fused_epi, device=dev, mesh=mesh,
        )

    def _cache(self, batch: int, max_seq_len: int) -> KVCache:
        """The Generator's cache for (batch, aligned capacity), reset to
        empty: no slot valid, both offsets 0.  The slabs keep the last
        call's values; nothing reads a slot the bitmap does not mark."""
        key = (batch, align_capacity(max_seq_len))
        cache = self._caches.get(key)
        if cache is None:
            cache = self._caches[key] = KVCache.init(
                self.config, batch, key[1], dtype=self.cache_dtype, device=self.device,
                kv_heads=local_kv_heads(self.config, self.mesh))
        else:
            cache.valid.zero_()
            cache.set_length(0)
        return cache

    def compile_counts(self) -> dict[str, int]:
        """``{"decode_step": n}``: the decode-step graphs captured so far
        (on the CPU, the static steps built) — one per (batch, capacity,
        ragged) served, and no more on a repeat of the same shapes.  Under
        a multi-rank mesh, whose steps run eagerly (no graph),
        ``"decode_step_eager"`` counts the steps built instead."""
        steps = [st.run for c in self._caches.values() for st in c.steps.values()]
        if _multi_rank(self.mesh):
            return {"decode_step": 0, "decode_step_eager": sum(r.calls > 0 for r in steps)}
        return {"decode_step": sum(r.compiled for r in steps)}

    def graph_steps(self) -> list[CapturedStep]:
        """Every decode step the Generator has built (capture time,
        pool bytes and replays are on each)."""
        return [st.run for c in self._caches.values() for st in c.steps.values()]

    def _ids(self, ids: Any) -> torch.Tensor:
        t = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        return t[None, :] if t.ndim == 1 else t

    def _rows(self, b: int) -> tuple[int, int]:
        """``(lo, hi)``: the batch rows this rank runs — its block when the
        rows divide over "data", else every row (each data rank runs the
        whole batch)."""
        dp = self.mesh.size(DATA_AXIS) if self.mesh is not None else 1
        if dp == 1 or b % dp:
            return 0, b
        lo = self.mesh.index(DATA_AXIS) * (b // dp)
        return lo, lo + b // dp

    def _gather_rows(self, tokens: np.ndarray, b: int) -> np.ndarray:
        """Every data rank's rows of ``tokens``, in batch order."""
        if self._rows(b) == (0, b):
            return tokens
        t = torch.as_tensor(tokens, device=self.device)
        return all_gather(t, self.mesh, DATA_AXIS, dim=0).cpu().numpy()

    def _key(self, seed: int) -> torch.Tensor | None:
        """``PRNGKey(seed)`` on the card for a sampled kind; greedy draws
        nothing."""
        return None if self.sampler.kind == "greedy" else random.PRNGKey(seed, self.device)

    def _run(
        self,
        prompt_ids: torch.Tensor,
        max_new_tokens: int,
        max_seq_len: int | None,
        seed: int,
        attn_mask: torch.Tensor | None = None,
        pad_offsets: torch.Tensor | None = None,
    ) -> GenerateResult:
        """Prefill, then the decode loop (this rank's rows under a mesh)."""
        b_all, s = prompt_ids.shape
        lo, hi = self._rows(b_all)
        if (lo, hi) != (0, b_all):
            prompt_ids = prompt_ids[lo:hi]
            attn_mask = None if attn_mask is None else attn_mask[lo:hi]
            pad_offsets = None if pad_offsets is None else pad_offsets[lo:hi]
        b = hi - lo
        max_seq_len = max_seq_len or s + max_new_tokens
        _check_capacity(s, max_new_tokens, max_seq_len)
        key = self._key(seed)
        k_pre, k_loop = (None, None) if key is None else random.split(key)
        cache = self._cache(b, max_seq_len)

        _sync(self.device)
        t0 = time.perf_counter()
        tok0, cache, _ = self._prefill(self.params, prompt_ids, cache, k_pre, attn_mask,
                                       pad_offsets, row0=lo)
        _sync(self.device)
        t1 = time.perf_counter()

        first = tok0.cpu().numpy()[:, None]
        if max_new_tokens > 1:
            rest, cache, steps = self._loop(
                self.params, tok0, cache, k_loop, max_new_tokens - 1, pad_offsets, row0=lo
            )
            _sync(self.device)
            t2 = time.perf_counter()
            tokens = np.concatenate([first, rest.cpu().numpy()], axis=1)
            rate = steps / (t2 - t1) if steps > 0 else float("nan")
        else:
            tokens, rate, steps = first, float("nan"), 0

        tokens = self._gather_rows(_trim_after_stop(tokens, self.stop_tokens), b_all)
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
        # JAX's stream: ``key, k = split(key)`` before the prefill and
        # before every step
        key = self._key(seed)
        k = None
        if key is not None:
            key, k = random.split(key)
        cache = self._cache(1, max_seq_len)
        tok, cache, _ = self._prefill(self.params, prompt_ids, cache, k)
        t = int(tok[0])
        yield t
        for _ in range(max_new_tokens - 1):
            if t in self.stop_tokens:
                return
            if key is not None:
                key, k = random.split(key)
            # one step of the decode loop: the same static step (and graph)
            # as generate's at this shape
            nxt, cache, _ = self._loop.run_keys(self.params, tok, cache,
                                                None if k is None else k[None], 1)
            tok = nxt[:, 0]
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
