"""Speculative decoding: draft-and-verify generation (port of
``llm_np_cp_tpu/speculative.py``).

A cheap *draft* model proposes γ tokens autoregressively; the *target*
model scores all of them in ONE forward; accepted prefixes keep the
target's exact output distribution by the Leviathan et al. rule:

    accept dᵢ with prob min(1, p(dᵢ)/q(dᵢ));
    on the first rejection resample from norm(max(p − q, 0));
    if all γ are accepted, sample a bonus token from p — so every round
    emits 1 to γ+1 tokens, distributed as decoding with the target
    alone (greedy: the same tokens).

p and q are the *filtered* sampler distributions
(``Sampler.filtered_logits``), so min-p / top-k / top-p speculation is
exact too.  Rows of a batch accept different prefix lengths: both caches
carry a per-row ``[B]`` offset (``_per_row`` broadcasts a scalar one at
the first round, as JAX's ``_as_rows`` does) and ``truncate`` rolls each
row back to its accepted inputs on the card.

The JAX package runs every round of a generation in one
``lax.while_loop``.  Here one round — γ+1 draft forwards, one verify
forward of γ+1 tokens, accept/resample, the rollback of both caches and
the loop's bookkeeping (output window, stop tokens, counts) — is a
function over static buffers that ``graphs.CapturedStep`` captures as a
CUDA graph on the card (one per batch, γ, capacity, sampler and stop
set; eager on the CPU), and the host loop makes one fetch a round (each
row's total and done flag) to decide whether to run another.  A round
reads nothing back and holds no host tensor.  Its draws are keyed as the
JAX package keys them (``random``): the generation's key sits in a
static buffer and each round takes ``key, kr = split(key)`` on the card,
then ``kd, ku, kc = split(kr, 3)`` — the draft draws under ``split(kd,
γ+1)``, the accept uniforms under ``ku``, the correction under ``kc`` —
so a sampled round draws the JAX package's tokens.
The host's cache ``length`` is the bound over the rows still writing,
set from each fetch; capacity is sized once, up front, as in JAX.

The default draft is the int8-quantized target (``quant.py``), "self
speculation"; ``truncated_draft`` gives a layer-prefix draft; a separate
small model sharing the vocabulary can be passed.  Draft and verify
forwards use the plain attention path, as the JAX package's default
``"xla"`` does: no kernel of ``ops/cuda`` runs here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from llm_np_cp_tpu_torch import random
from llm_np_cp_tpu_torch.cache import KVCache, align_capacity, truncate
from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.generate import (
    Generator,
    _check_capacity,
    _sync,
    _trim_after_stop,
    make_chunked_prefill_fn,
    make_prefill_fn,
)
from llm_np_cp_tpu_torch.graphs import CapturedStep
from llm_np_cp_tpu_torch.models.transformer import forward
from llm_np_cp_tpu_torch.ops.sampling import Sampler

Params = dict[str, Any]


@dataclasses.dataclass
class SpecResult:
    tokens: np.ndarray  # [num_generated] (1-D prompt) or [B, num_generated]
    ttft_s: float
    decode_tokens_per_s: float  # aggregate over rows (== per-seq at bs=1)
    num_generated: int
    rounds: int
    acceptance_rate: float  # accepted draft tokens / proposed (active rows)
    tokens_per_round: float  # mean per active row


def truncated_draft(
    params: Params,
    config: ModelConfig,
    num_layers: int,
    *,
    bits: int | None = None,
) -> tuple[Params, ModelConfig]:
    """Layer-skip self-draft: the first ``num_layers`` decoder layers of
    the target plus its embedding, final norm and head (views, no copy),
    optionally quantized to ``bits``.  The draft shares the target's
    vocabulary by construction; the accept/resample rule keeps the
    output the target's whatever the draft's quality."""
    if not 0 < num_layers <= config.num_hidden_layers:
        raise ValueError(
            f"num_layers must be in 1..{config.num_hidden_layers}, got {num_layers}"
        )
    draft = dict(params)
    draft["layers"] = {
        name: {k: v[:num_layers] for k, v in t.items()} if isinstance(t, dict) else t[:num_layers]
        for name, t in params["layers"].items()
    }
    draft_config = dataclasses.replace(config, num_hidden_layers=num_layers)
    if bits is not None:
        from llm_np_cp_tpu_torch.quant import quantize_params

        draft = quantize_params(draft, bits=bits)
    return draft, draft_config


def _per_row(cache: KVCache, batch: int) -> KVCache:
    """Give ``cache`` a ``[B]`` offset (broadcasting a scalar one); the
    steps built over its old offset go with it."""
    if cache.offset.ndim == 0:
        cache.offset = cache.offset.expand(batch).clone()
        cache.steps.clear()
    return cache


def _spec_round_core(
    draft_params: Params,
    target_params: Params,
    t0: torch.Tensor,
    dcache: KVCache,
    tcache: KVCache,
    key: torch.Tensor,
    *,
    draft_config: ModelConfig,
    target_config: ModelConfig,
    gamma: int,
    sampler: Sampler,
    draft_sampler: Sampler,
    active: torch.Tensor | None = None,
    pad_offsets: torch.Tensor | None = None,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One speculative round, batched over rows, both caches (per-row
    offsets) updated in place.

    t0: [B] int32 — each row's verified input token.  Every row drafts γ
    tokens and verifies them in one target forward; row b accepts its
    own prefix length n_b and both caches roll back to its accepted
    inputs t0..d_{n_b}.  ``active``: [B] bool — rows already done count
    0 and roll back to where they started.  ``pad_offsets``: [B] left
    pads of a ragged batch, threaded into every forward.  ``key``: the
    round's key ``[2]``, split as JAX's ``_spec_round_core`` splits it.

    Returns (emitted [B, γ+1] (the first count_b real per row), count
    [B] int32, next_t0 [B] int32).  Moves the caches' host ``length``
    by γ+1 (each forward advances it): the caller owns that bound.
    """
    b = t0.shape[0]
    kd, ku, kc = random.split(key, 3)
    t_base = tcache.offset.clone()
    d_base = dcache.offset.clone()

    # draft: γ+1 steps — the extra step's proposal is discarded, but it
    # leaves the draft cache covering every verified input, so the
    # rollback target base+n+1 always exists
    tok, drafts, qprobs = t0, [], []
    for k in random.split(kd, gamma + 1):
        logits, _ = forward(draft_params, tok[:, None], draft_config, dcache,
                            logits_last_only=True, pad_offsets=pad_offsets, device=device)
        fl = draft_sampler.filtered_logits(logits[:, -1])  # [B, V]
        tok = random.categorical(k, fl)
        drafts.append(tok)
        qprobs.append(torch.softmax(fl, dim=-1))
    d = torch.stack(drafts[:gamma], dim=1)  # [B, γ] proposals d_1..d_γ
    qp = torch.stack(qprobs, dim=1)  # [B, γ+1, V]

    # target: verify every proposal in one forward
    inp = torch.cat([t0[:, None], d], dim=1)  # [B, γ+1]
    tlogits, _ = forward(target_params, inp, target_config, tcache,
                         pad_offsets=pad_offsets, device=device)
    p = torch.softmax(sampler.filtered_logits(tlogits), dim=-1)  # [B, γ+1, V]

    # accept/reject (the multiplied form: q(d) > 0, d was drawn from q)
    dl = d.long()[..., None]
    p_d = p[:, :gamma].gather(-1, dl)[..., 0]
    q_d = qp[:, :gamma].gather(-1, dl)[..., 0]
    u = random.uniform(ku, (b, gamma))
    accept = u * q_d < p_d  # [B, γ]
    n = torch.where(accept.all(dim=-1), gamma,
                    torch.argmin(accept.to(torch.int32), dim=-1))  # [B], first rejection

    # correction (n < γ: the residual norm(max(p − q, 0))) or bonus
    # (n == γ: plain p), one rule with q's row γ zeroed: that row is the
    # discarded extra draft step's and must not leak into the bonus
    qp[:, gamma] = 0.0
    idx = n[:, None, None].expand(b, 1, p.shape[-1])
    p_n = p.gather(1, idx)[:, 0]
    residual = torch.clamp_min(p_n - qp.gather(1, idx)[:, 0], 0.0)
    total = residual.sum(dim=-1, keepdim=True)
    dist = torch.where(total > 0, residual / torch.clamp_min(total, 1e-38), p_n)
    c = random.categorical(kc, torch.log(dist + 1e-38))

    emitted = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    emitted.scatter_(1, n[:, None], c[:, None])
    count = (n + 1).to(torch.int32)
    next_t0 = c
    if active is not None:
        count = torch.where(active, count, 0)
        next_t0 = torch.where(active, c, t0)

    # roll both caches back to the accepted inputs t0..d_n, per row
    truncate(tcache, t_base + count)
    truncate(dcache, d_base + count)
    return emitted, count, next_t0


def make_spec_round_fn(
    draft_config: ModelConfig,
    target_config: ModelConfig,
    gamma: int,
    sampler: Sampler,
    draft_sampler: Sampler | None = None,
    *,
    device: str | torch.device = "cuda",
) -> Callable:
    """One speculative round, run eagerly (the granular API).

    (draft_params, target_params, t0 [B], dcache, tcache, key) →
    (emitted [B, γ+1] (the first ``count_b`` of each row real), count
    [B], dcache, tcache, next_t0 [B]).  Both caches are updated in place
    and given per-row offsets at the first round; their host ``length``
    advances by γ+1 a round, an upper bound."""
    dev = resolve_device(device)

    def spec_round(draft_params, target_params, t0, dcache, tcache, key):
        b = t0.shape[0]
        emitted, count, next_t0 = _spec_round_core(
            draft_params, target_params, t0, _per_row(dcache, b), _per_row(tcache, b), key,
            draft_config=draft_config, target_config=target_config, gamma=gamma,
            sampler=sampler, draft_sampler=draft_sampler or sampler, device=dev,
        )
        return emitted, count, dcache, tcache, next_t0

    return spec_round


@dataclasses.dataclass(eq=False)
class _LoopState:
    """A generation's static buffers over one (target, draft) cache pair:
    the round's input tokens, each row's done flag, emitted total and
    active rounds, the accepted / proposed sums, the output rows (one
    slot per cache slot: the last round's window always fits), the
    budget, the pad offsets of a ragged batch, the [2, B] (total, done)
    rows the host fetches once a round, and the generation's key, which
    each round splits and moves on."""

    tok: torch.Tensor  # [B] int32
    done: torch.Tensor  # [B] bool
    total: torch.Tensor  # [B] int32
    rounds: torch.Tensor  # [B] int32
    sums: torch.Tensor  # [2] int32: accepted, proposed
    buf: torch.Tensor  # [B, capacity] int32
    max_new: torch.Tensor  # 0-d int32
    pads: torch.Tensor | None  # [B] int64
    stops: torch.Tensor | None
    sync: torch.Tensor  # [2, B] int32
    key: torch.Tensor  # [2] int32
    run: CapturedStep | None = None


def make_spec_decode_fn(
    draft_config: ModelConfig,
    target_config: ModelConfig,
    gamma: int,
    sampler: Sampler,
    draft_sampler: Sampler | None = None,
    stop_tokens: tuple[int, ...] = (),
    *,
    device: str | torch.device = "cuda",
) -> Callable:
    """Every speculative round of a generation: the round is captured on
    the card at its first call per (batch, capacity, ragged) and
    replayed after; the host fetches each row's (total, done) once a
    round.  Rows that reach their budget or a stop token freeze (count
    0, caches pinned) while the rest go on.

    (draft_params, target_params, t0 [B], dcache, tcache, key, max_new,
    pad_offsets=None) → (buf [B, max_new+γ+1] (the first ``total_b``
    real per row, t0 included), total [B], rounds [B] (rounds each row
    was active in), accepted, proposed (summed over active rows),
    dcache, tcache) — tensors on the device.  Both caches are updated in
    place (per-row offsets from the first round).
    """
    dev = resolve_device(device)
    dsampler = draft_sampler or sampler
    arange_w = torch.arange(gamma + 1, device=dev)

    def body(st: _LoopState, draft_params, target_params, dcache, tcache) -> None:
        active = (st.total < st.max_new) & ~st.done
        nd, nt = dcache.length, tcache.length
        ks = random.split(st.key)  # JAX's ``key, kr = split(key)``
        st.key.copy_(ks[0])
        emitted, count, nxt = _spec_round_core(
            draft_params, target_params, st.tok, dcache, tcache, ks[1],
            draft_config=draft_config, target_config=target_config, gamma=gamma,
            sampler=sampler, draft_sampler=dsampler, active=active, pad_offsets=st.pads,
            device=dev,
        )
        dcache.length, tcache.length = nd, nt
        # the whole γ+1 window at each row's total; slots past count_b
        # are overwritten next round (a frozen row's clamp lands past
        # its budget)
        idx = torch.clamp_max(st.total.long()[:, None] + arange_w, st.buf.shape[1] - 1)
        st.buf.scatter_(1, idx, emitted)
        if st.stops is not None:
            real = arange_w[None, :] < count[:, None]
            st.done |= (real & torch.isin(emitted, st.stops)).any(dim=1)
        st.total += count
        st.rounds += active.to(torch.int32)
        st.sums[0] += torch.clamp_min(count - 1, 0).sum(dtype=torch.int32)
        st.sums[1] += gamma * active.sum(dtype=torch.int32)
        st.tok.copy_(nxt)
        st.sync[0].copy_(st.total)
        st.sync[1].copy_(st.done)

    def state(tcache: KVCache, dcache: KVCache, draft_params, target_params,
              ragged: bool) -> _LoopState:
        key = (body, id(draft_params), id(target_params), id(dcache), ragged)
        st = tcache.steps.get(key)
        if st is None:
            b, cap = tcache.k.shape[1], tcache.max_seq_len

            def z(*shape, dtype=torch.int32):
                return torch.zeros(shape, dtype=dtype, device=dev)

            st = _LoopState(
                tok=z(b), done=z(b, dtype=torch.bool), total=z(b), rounds=z(b), sums=z(2),
                buf=z(b, cap), max_new=z(), pads=z(b, dtype=torch.int64) if ragged else None,
                stops=(torch.tensor(stop_tokens, dtype=torch.int32, device=dev)
                       if stop_tokens else None),
                sync=z(2, b), key=z(2),
            )
            st.run = CapturedStep(
                lambda: body(st, draft_params, target_params, dcache, tcache), dev,
                f"spec_round[B={b}, gamma={gamma}, S={cap}]")
            tcache.steps[key] = st
        return st

    def spec_decode(draft_params, target_params, t0, dcache, tcache, key, max_new,
                    pad_offsets=None):
        b = t0.shape[0]
        _per_row(dcache, b)
        _per_row(tcache, b)
        # every row's length after prefill; an active row holds fewer than
        # max_new tokens and writes γ+1 slots past them, so this one check
        # covers every round (a frozen row's writes clamp inside)
        base = tcache.length
        need = base + max_new + gamma + 1
        if need > tcache.max_seq_len or need > dcache.max_seq_len:
            raise ValueError(
                f"prompt ({base}) + max_new ({max_new}) + gamma + 1 = {need} exceeds the "
                f"caches' capacity ({tcache.max_seq_len}, {dcache.max_seq_len})")
        st = state(tcache, dcache, draft_params, target_params, pad_offsets is not None)
        st.key.copy_(key)
        st.tok.copy_(t0)
        st.done.copy_(torch.isin(t0, st.stops) if st.stops is not None
                      else torch.zeros_like(st.done))
        st.total.fill_(1)
        st.rounds.zero_()
        st.sums.zero_()
        st.buf.zero_()
        st.buf[:, 0] = t0
        st.max_new.fill_(max_new)
        if st.pads is not None:
            st.pads.copy_(pad_offsets)
        st.sync[0].copy_(st.total)
        st.sync[1].copy_(st.done)
        while True:
            sync = st.sync.cpu().numpy()  # the round's one fetch
            act = (sync[0] < max_new) & (sync[1] == 0)
            if not act.any():
                break
            # the host bound over the rows still writing
            tcache.length = dcache.length = base + int(sync[0][act].max()) - 1
            st.run()
        tcache.length = dcache.length = base + int(sync[0].max()) - 1
        return (st.buf[:, :max_new + gamma + 1].clone(), st.total.clone(), st.rounds.clone(),
                st.sums[0].clone(), st.sums[1].clone(), dcache, tcache)

    return spec_decode


class SpeculativeGenerator:
    """Prefill + speculative rounds for one (target, draft, sampler) on
    ``device`` (``"cuda"`` by default; raises without a card unless
    ``"cpu"``).

    Batched: a [B, S] prompt runs B speculative streams; rows accept
    draft prefixes independently through per-row cache offsets, so a
    slow row never rolls back a fast one.  1-D prompts keep the batch-1
    surface.  ``draft_params`` defaults to the int8-quantized target
    (self speculation; the target itself when it is already quantized);
    a separate draft must share the vocabulary.  ``compile_counts()``
    reports the round graphs captured (on the CPU, the round steps
    built): one per (batch, capacity, ragged, stop set) served.
    """

    def __init__(
        self,
        params: Params,
        config: ModelConfig,
        *,
        draft_params: Params | None = None,
        draft_config: ModelConfig | None = None,
        gamma: int = 4,
        sampler: Sampler | None = None,
        draft_sampler: Sampler | None = None,
        cache_dtype: torch.dtype = torch.bfloat16,
        prefill_chunk: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        if draft_params is None:
            from llm_np_cp_tpu_torch.quant import is_quantized, quantize_params

            if is_quantized(params["layers"].get("q_proj")):
                # the target is already int8: nothing cheaper to derive;
                # a perfect draft still pipelines γ+1 tokens a round
                draft_params = params
            else:
                draft_params = quantize_params(params)
        self.params = params
        self.config = config
        self.draft_params = draft_params
        self.draft_config = draft_config or config
        self.gamma = gamma
        self.sampler = sampler or Sampler()
        self.cache_dtype = cache_dtype
        dev = self.device
        if prefill_chunk:
            self._prefill_t = make_chunked_prefill_fn(config, self.sampler, prefill_chunk,
                                                      device=dev)
            self._prefill_d = make_chunked_prefill_fn(self.draft_config, self.sampler,
                                                      prefill_chunk, device=dev)
        else:
            self._prefill_t = make_prefill_fn(config, self.sampler, device=dev)
            self._prefill_d = make_prefill_fn(self.draft_config, self.sampler, device=dev)
        self._draft_sampler = draft_sampler
        self._loops: dict[tuple[int, ...], Callable] = {}  # one per stop-token set
        # one (target, draft) cache pair per (batch, capacity): the round
        # graphs replay their addresses
        self._caches: dict[tuple[int, int], tuple[KVCache, KVCache]] = {}

    def _loop(self, stop_tokens: tuple[int, ...]) -> Callable:
        if stop_tokens not in self._loops:
            self._loops[stop_tokens] = make_spec_decode_fn(
                self.draft_config, self.config, self.gamma, self.sampler,
                self._draft_sampler, stop_tokens, device=self.device,
            )
        return self._loops[stop_tokens]

    def _cache_pair(self, batch: int, capacity: int) -> tuple[KVCache, KVCache]:
        """The (target, draft) caches for (batch, capacity), reset to
        empty: no slot valid, every offset 0."""
        pair = self._caches.get((batch, capacity))
        if pair is None:
            pair = self._caches[(batch, capacity)] = tuple(
                KVCache.init(c, batch, capacity, dtype=self.cache_dtype, device=self.device)
                for c in (self.config, self.draft_config))
        else:
            for c in pair:
                c.valid.zero_()
                c.set_length(0)
        return pair

    def compile_counts(self) -> dict[str, int]:
        """``{"spec_round": n}``: the round graphs captured so far (on the
        CPU, the round steps built) — no more on a repeat of the same
        shapes."""
        return {"spec_round": sum(st.run.compiled for st in self._steps())}

    def graph_steps(self) -> list[CapturedStep]:
        """Every round step built (capture time, pool bytes and replays
        are on each)."""
        return [st.run for st in self._steps()]

    def _steps(self) -> list[_LoopState]:
        return [st for t, _ in self._caches.values() for st in t.steps.values()]

    def _ids(self, ids: Any) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def generate(
        self,
        prompt_ids: Any,
        max_new_tokens: int,
        *,
        max_seq_len: int | None = None,
        seed: int = 0,
        stop_tokens: tuple[int, ...] = (),
    ) -> SpecResult:
        ids = self._ids(prompt_ids)
        squeeze = ids.ndim == 1
        if squeeze:
            ids = ids[None, :]
        return self._run(ids, max_new_tokens, max_seq_len, seed, tuple(stop_tokens),
                         squeeze=squeeze)

    def generate_ragged(
        self,
        prompts: list[np.ndarray | list[int]],
        max_new_tokens: int,
        *,
        max_seq_len: int | None = None,
        seed: int = 0,
        stop_tokens: tuple[int, ...] = (),
    ) -> SpecResult:
        """Speculative generation over prompts of different lengths: rows
        pad on the LEFT (``Generator.left_pad``), and per-row pad offsets
        keep positions and masks exact through every draft and verify
        forward, so each row behaves as if it ran alone."""
        ids, mask, pads = Generator.left_pad(prompts)
        return self._run(
            self._ids(ids), max_new_tokens, max_seq_len, seed, tuple(stop_tokens),
            attn_mask=torch.as_tensor(mask, device=self.device),
            pad_offsets=torch.as_tensor(pads, dtype=torch.int64, device=self.device),
        )

    def _run(
        self,
        prompt_ids: torch.Tensor,
        max_new_tokens: int,
        max_seq_len: int | None,
        seed: int,
        stop_tokens: tuple[int, ...],
        *,
        attn_mask: torch.Tensor | None = None,
        pad_offsets: torch.Tensor | None = None,
        squeeze: bool = False,
    ) -> SpecResult:
        b, s = prompt_ids.shape
        # a round overshoots by up to γ+1 tokens before rollback trims it
        max_seq_len = max_seq_len or s + max_new_tokens + self.gamma + 1
        _check_capacity(s, max_new_tokens + self.gamma + 1, max_seq_len)
        tcache, dcache = self._cache_pair(b, align_capacity(max_seq_len))
        key, kp = random.split(random.PRNGKey(seed, self.device))

        _sync(self.device)
        t0 = time.perf_counter()
        tok, tcache, _ = self._prefill_t(self.params, prompt_ids, tcache, kp, attn_mask,
                                         pad_offsets)
        self._prefill_d(self.draft_params, prompt_ids, dcache, kp, attn_mask, pad_offsets)
        # both prefills (the draft's included) land in TTFT
        _sync(self.device)
        ttft = time.perf_counter() - t0

        t_dec = time.perf_counter()
        buf, total, rounds, accepted, proposed, _, _ = self._loop(stop_tokens)(
            self.draft_params, self.params, tok, dcache, tcache, key, max_new_tokens,
            pad_offsets,
        )
        buf = buf.cpu().numpy()
        decode_s = time.perf_counter() - t_dec
        total = total.cpu().numpy()
        rounds_b = rounds.cpu().numpy()
        accepted, proposed = int(accepted), int(proposed)

        tokens = buf[:, :max_new_tokens].astype(np.int32)
        # the rate over the tokens RETURNED (a final round can overshoot
        # max_new_tokens by up to γ per row; those are trimmed)
        n_dec_b = np.minimum(total, max_new_tokens) - 1
        n_dec = int(n_dec_b.sum())
        if stop_tokens:
            tokens = _trim_after_stop(tokens, stop_tokens)
        if squeeze:
            tokens = tokens[0]
            if stop_tokens:
                hits = np.isin(tokens, stop_tokens).nonzero()[0]
                if hits.size:
                    tokens = tokens[: hits[0] + 1]
        act = rounds_b > 0
        return SpecResult(
            tokens=tokens,
            ttft_s=ttft,
            decode_tokens_per_s=n_dec / decode_s if decode_s > 0 else float("nan"),
            num_generated=tokens.shape[-1],
            rounds=int(rounds_b.max()),
            acceptance_rate=accepted / proposed if proposed else 0.0,
            # mean over rows of (tokens emitted / rounds active): rows
            # that finish early do not deflate it
            tokens_per_round=(
                float(np.mean(n_dec_b[act] / rounds_b[act])) if act.any() else 0.0
            ),
        )
