"""Speculative decoding in the port against the JAX package, on the CPU.

Offline: the port's ``SpeculativeGenerator`` (its rounds run eagerly
here, the function the card captures) against the JAX
``SpeculativeGenerator`` and the port's own ``Generator``, on the same
numpy-made float32 weights: greedy tokens identical for every draft
(the int8 self-draft, ``truncated_draft``, a separate model), batched,
ragged and chunked, with stop tokens; sampled speculation keeps the
target's distribution.  Served: ``ServeEngine(spec_k=...)`` against the
JAX spec engine and the port's plain unified tick on repetitive
(tiled) prompts, where prompt lookup drafts.  Also the pieces: the
draft stream, the planner's draft budget, block growth for drafts,
per-row cache offsets, writes, ``truncate`` and ``forward``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import cache as jcache
from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu import speculative as jspec
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve.block_pool import FreeList as JFreeList
from llm_np_cp_tpu.serve.scheduler import Request as JRequest
from llm_np_cp_tpu.serve.scheduler import Scheduler as JScheduler
from llm_np_cp_tpu.serve.spec import DraftState as JDraftState
from llm_np_cp_tpu_torch import cache as tcache
from llm_np_cp_tpu_torch import random as trandom
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch import speculative as tspec
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.generate import Generator
from llm_np_cp_tpu_torch.models import transformer as ttf
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve.block_pool import FreeList
from llm_np_cp_tpu_torch.serve.scheduler import Request, Scheduler
from llm_np_cp_tpu_torch.serve.spec import DraftState
from sampled_parity import assert_prefix_parity, spec_margins
from tick_clock import clocked

# logits compared across the two packages, float32
ATOL = 1e-4


def np_params(cfg, seed, scale=0.15):
    """Random float32 weights as numpy, in the layout both packages share."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln_") or name == "final_norm":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        k: {n: leaf(n, s) for n, s in v.items()} if k == "layers" else leaf(k, v)
        for k, v in param_shapes(cfg).items()
    }


def pair(seed=0, **overrides):
    """(port config, port params, JAX config, JAX params) on the same weights."""
    cfg = tiny_config("llama", **overrides)
    npp = np_params(cfg, seed)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def llama():
    return pair(0)


@pytest.fixture(scope="module")
def tiny():
    """The JAX package's own seeded init (``init_params``, the weights of
    its spec-serving tests), handed to both packages as numpy: a random
    model whose greedy streams fall into the cycles prompt lookup
    drafts."""
    cfg = tiny_config("llama")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    npp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg,
                                                    dtype=jnp.float32))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


@pytest.fixture(scope="module")
def other_draft():
    """A second, unrelated model of the same shapes: a draft that is
    wrong most of the time."""
    return pair(99)


def prompts_of(cfg, seed, b, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, n)).astype(np.int32)


def tiled_prompts(rng, vocab, lens, pattern=4):
    """Repetitive prompts (a random pattern tiled to length): prompt
    lookup's case, so verify rounds really run."""
    return [np.resize(rng.integers(1, vocab, size=pattern).astype(np.int32), n) for n in lens]


def port_spec(models, **kw):
    cfg, tp = models[:2]
    kw.setdefault("sampler", Sampler("greedy"))
    return tspec.SpeculativeGenerator(tp, cfg, cache_dtype=torch.float32, device="cpu", **kw)


def jax_spec(models, **kw):
    _, _, jcfg, jp = models
    kw.setdefault("sampler", JSampler("greedy"))
    return jspec.SpeculativeGenerator(jp, jcfg, cache_dtype=jnp.float32, **kw)


def plain_tokens(models, prompts, n, **kw):
    cfg, tp = models[:2]
    gen = Generator(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32, device="cpu")
    return gen.generate(prompts, n, **kw).tokens


# ----------------------------------------------------------------------
# DraftState: the copied prompt-lookup stream
# ----------------------------------------------------------------------

def _streams():
    rng = np.random.default_rng(5)
    return {
        "small_vocab": rng.integers(0, 4, 40).tolist(),
        "cyclic_tail": [3, 9, 4] + [7, 7, 7, 7] + [1, 2] * 6,
        "no_match": list(range(1, 30)),
        "tiled_segment": np.resize(rng.integers(0, 50, 6), 31).tolist(),
    }


@pytest.mark.parametrize("ngram", [(3, 2), (4, 2), (2, 1)])
@pytest.mark.parametrize("name", list(_streams()))
def test_draft_state_proposals_match_jax(name, ngram):
    """The same stream fed in uneven pieces: after every piece both
    streams propose the same drafts for every k, cyclic tails and
    no-match streams included."""
    stream = _streams()[name]
    port, ref = DraftState(*ngram), JDraftState(*ngram)
    cut = 0
    for piece in (1, 2, 5, 3, 7, 1, 4, 8, 2, 30):
        chunk = stream[cut:cut + piece]
        cut += piece
        port.extend(chunk)
        ref.extend(chunk)
        assert port.size == ref.size
        for k in range(7):
            assert port.propose(k) == ref.propose(k), (name, cut, k)
    if name == "no_match":
        assert port.propose(4) == []
    if name == "cyclic_tail":
        assert len(port.propose(5)) == 5


def test_draft_state_rejects_bad_range():
    for args in ((1, 2), (3, 0)):
        with pytest.raises(ValueError, match="ngram") as port:
            DraftState(*args)
        with pytest.raises(ValueError, match="ngram") as ref:
            JDraftState(*args)
        assert str(port.value) == str(ref.value)
    assert serve.DraftState is DraftState


# ----------------------------------------------------------------------
# the planner's draft budget and block growth for drafts
# ----------------------------------------------------------------------

class _Alloc:
    num_free = 10_000

    def alloc(self, n):
        return list(range(n))

    def free(self, ids):
        pass


def _rows(req_cls, case):
    """Running requests of one planner case: decode rows with drafts,
    mid-prefill rows."""
    rng = np.random.default_rng(case)
    out = []
    for i in range(6):
        r = req_cls(req_id=i, prompt=np.ones(4 + i, np.int32), max_new_tokens=8)
        r.slot = i
        if rng.random() < 0.6:
            r.prefilled = True
            r.generated = [1]
            r.draft_len = int(rng.integers(0, 6))
        else:
            r.prefill_target = int(rng.integers(3, 30))
            r.prefill_done = int(rng.integers(0, r.prefill_target))
        out.append(r)
    return out


@pytest.mark.parametrize("budget", [6, 9, 13, 20, 40])
@pytest.mark.parametrize("case", range(4))
def test_plan_tick_draft_budget_matches_jax(case, budget):
    """Drafts spend what prefill leaves, oldest row first, and trim in
    place: the port's planner and the JAX one agree on the same rows."""
    port, ref = Scheduler(_Alloc(), max_slots=6, block_size=8), JScheduler(
        _Alloc(), max_slots=6, block_size=8)
    prow, jrow = _rows(Request, case), _rows(JRequest, case)
    port.running.extend(prow)
    ref.running.extend(jrow)
    pd, pp = port.plan_tick(budget, 8)
    jd, jp = ref.plan_tick(budget, 8)
    assert [r.req_id for r in pd] == [r.req_id for r in jd]
    assert [(r.req_id, n) for r, n in pp] == [(r.req_id, n) for r, n in jp]
    assert [r.draft_len for r in prow] == [r.draft_len for r in jrow]
    planned = len(pd) + sum(n for _, n in pp) + sum(r.draft_len for r in pd)
    assert planned <= max(budget, len(pd))


@pytest.mark.parametrize("free", [1, 3, 8])
def test_growth_covers_drafts_but_never_evicts_for_them(free):
    """Block growth covers cache_len + draft_len while blocks last, then
    trims the draft to the blocks it has; no request is preempted for a
    draft.  The port and the JAX scheduler agree."""
    def run(sched_cls, req_cls, fl_cls):
        fl = fl_cls(1 + 7 + free)  # block 0 is the scratch block
        sched = sched_cls(fl, max_slots=3, block_size=4)
        rows = []
        for i, (gen, draft) in enumerate(((5, 4), (2, 4), (7, 3))):
            r = req_cls(req_id=i, prompt=np.ones(3, np.int32), max_new_tokens=20)
            r.slot, r.prefilled, r.generated = i, True, [1] * gen
            r.block_ids = fl.alloc(-(-r.cache_len // 4))
            r.draft_len = draft
            rows.append(r)
        sched.running.extend(rows)
        pre = sched.ensure_decode_blocks()
        return ([r.req_id for r in pre], [(len(r.block_ids), r.draft_len) for r in rows],
                fl.num_free)

    got = run(Scheduler, Request, FreeList)
    assert got == run(JScheduler, JRequest, JFreeList)
    assert got[0] == []


# ----------------------------------------------------------------------
# per-row cache offsets: writes, truncate, forward
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_update_layer_per_row_offsets_match_jax(dtype):
    rng = np.random.default_rng(3)
    b, cap, kh, d = 3, 16, 2, 8
    k_new = rng.standard_normal((b, 4, kh, d)).astype(np.float32)
    v_new = rng.standard_normal((b, 4, kh, d)).astype(np.float32)
    offs = np.asarray([0, 5, 9], np.int32)
    if dtype == "int8":
        z = lambda shape, dt: np.zeros(shape, dt)  # noqa: E731
        slabs = [z((b, cap, kh, d), np.int8)] * 2 + [z((b, cap, kh), np.float32)] * 2
        got = tcache.update_layer_quantized(
            *(torch.from_numpy(s.copy()) for s in slabs), torch.from_numpy(k_new),
            torch.from_numpy(v_new), torch.from_numpy(offs))
        want = jcache.update_layer_quantized(
            *(jnp.asarray(s) for s in slabs), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(offs))
    else:
        slab = np.zeros((b, cap, kh, d), np.float32)
        got = tcache.update_layer(torch.from_numpy(slab.copy()), torch.from_numpy(slab.copy()),
                                  torch.from_numpy(k_new), torch.from_numpy(v_new),
                                  torch.from_numpy(offs))
        want = jcache.update_layer(jnp.asarray(slab), jnp.asarray(slab), jnp.asarray(k_new),
                                   jnp.asarray(v_new), jnp.asarray(offs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_truncate_per_row_matches_jax(llama):
    cfg, _, jcfg, _ = llama
    c = tspec._per_row(tcache.KVCache.init(cfg, 3, 16, torch.float32, device="cpu"), 3)
    c.valid[:] = True
    c.set_length(12)
    tcache.truncate(c, torch.tensor([3, 12, 0], dtype=torch.int32))
    j = jcache.KVCache.init(jcfg, 3, 16, dtype=jnp.float32)
    j = j._replace(valid=jnp.ones_like(j.valid), length=jnp.full((3,), 12, jnp.int32))
    j = jcache.truncate(j, jnp.asarray([3, 12, 0]))
    np.testing.assert_array_equal(c.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(c.offset.numpy(), np.asarray(j.length))
    assert c.length == 12  # the host bound stays
    with pytest.raises(ValueError, match="per-row"):
        scalar = tcache.KVCache.init(cfg, 3, 16, torch.float32, device="cpu")
        tcache.truncate(scalar, torch.tensor([1, 2, 3]))
    # a per-row write past the capacity clamps to the last slot
    slots = tcache.cache_slots(torch.tensor([2, 14], dtype=torch.int32), 2, 3, 16, "cpu")
    assert slots.tolist() == [[2, 3, 4], [14, 15, 15]]


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
@pytest.mark.parametrize("ragged", [False, True])
def test_forward_per_row_offsets_matches_jax(llama, cache_dtype, ragged):
    """Prefill, roll each row back to its own length, then a 3-token
    forward at per-row offsets: logits, slabs and validity equal the JAX
    forward over a [B] length."""
    cfg, tp, jcfg, jp = llama
    b, s, cap = 3, 9, 32
    ids = prompts_of(cfg, 1, b, s)
    pads = np.asarray([0, 3, 5], np.int32) if ragged else None
    mask = (np.arange(s)[None, :] >= pads[:, None]) if ragged else None
    kw = {} if not ragged else dict(pad_offsets=torch.from_numpy(pads).long(),
                                    attn_mask=torch.from_numpy(mask))
    jkw = {} if not ragged else dict(pad_offsets=jnp.asarray(pads), attn_mask=jnp.asarray(mask))
    tc = tspec._per_row(
        tcache.KVCache.init(cfg, b, cap, getattr(torch, cache_dtype), device="cpu"), b)
    jc = jcache.KVCache.init(jcfg, b, cap, dtype=getattr(jnp, cache_dtype))
    _, tc = ttf.forward(tp, torch.from_numpy(ids).long(), cfg, tc, device="cpu", **kw)
    _, jc = jtf.forward(jp, jnp.asarray(ids), jcfg, jc, **jkw)
    keep = np.asarray([9, 6, 7], np.int32)
    tcache.truncate(tc, torch.from_numpy(keep))
    jc = jcache.truncate(jc, jnp.asarray(keep))
    nxt = prompts_of(cfg, 2, b, 3)
    kw.pop("attn_mask", None)
    jkw.pop("attn_mask", None)
    got, tc = ttf.forward(tp, torch.from_numpy(nxt).long(), cfg, tc, device="cpu", **kw)
    want, jc = jtf.forward(jp, jnp.asarray(nxt), jcfg, jc, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc.offset.numpy(), np.asarray(jc.length))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    for name in ("k", "v", "k_scale", "v_scale"):
        t, j = getattr(tc, name), getattr(jc, name)
        if t is not None:
            # slots each row wrote (past its length the slabs keep stale values)
            live = np.asarray(jc.valid)
            np.testing.assert_allclose(t.float().numpy()[:, live], np.asarray(j, np.float32)[:, live],
                                       atol=ATOL, rtol=0)


# ----------------------------------------------------------------------
# offline speculation
# ----------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_greedy_self_draft_matches_jax_and_plain(llama, gamma):
    """The default draft (the int8-quantized target): the port's tokens
    equal the JAX generator's and the port's plain Generator's, with the
    same rounds and acceptance."""
    prompts = prompts_of(llama[0], 0, 2, 8)
    got = port_spec(llama, gamma=gamma).generate(prompts, 16)
    want = jax_spec(llama, gamma=gamma).generate(prompts, 16)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens, plain_tokens(llama, prompts, 16))
    assert (got.rounds, got.acceptance_rate, got.tokens_per_round) == (
        want.rounds, want.acceptance_rate, want.tokens_per_round)
    assert got.acceptance_rate > 0.5


@pytest.mark.parametrize("draft", ["truncated_1_int4", "truncated_2", "separate_model"])
def test_greedy_other_drafts_match_jax_and_plain(llama, other_draft, draft):
    cfg, tp, jcfg, jp = llama
    if draft == "separate_model":
        kw = dict(draft_params=other_draft[1])
        jkw = dict(draft_params=other_draft[3])
    else:
        n, bits = (1, 4) if draft == "truncated_1_int4" else (2, None)
        dp, dc = tspec.truncated_draft(tp, cfg, n, bits=bits)
        jdp, jdc = jspec.truncated_draft(jp, jcfg, n, bits=bits)
        kw, jkw = dict(draft_params=dp, draft_config=dc), dict(draft_params=jdp, draft_config=jdc)
    prompts = prompts_of(cfg, 4, 2, 7)
    got = port_spec(llama, gamma=3, **kw).generate(prompts, 14)
    want = jax_spec(llama, gamma=3, **jkw).generate(prompts, 14)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.tokens, plain_tokens(llama, prompts, 14))
    assert got.rounds == want.rounds


def test_truncated_draft_is_a_layer_prefix(llama):
    cfg, tp = llama[:2]
    dp, dc = tspec.truncated_draft(tp, cfg, 2)
    assert dc.num_hidden_layers == 2
    for name, leaf in dp["layers"].items():
        assert torch.equal(leaf, tp["layers"][name][:2])
        assert leaf.data_ptr() == tp["layers"][name].data_ptr()  # a view
    assert dp["embed_tokens"] is tp["embed_tokens"]
    qp, _ = tspec.truncated_draft(tp, cfg, 1, bits=8)
    assert qp["layers"]["q_proj"]["q"].shape[0] == 1
    for n in (0, cfg.num_hidden_layers + 1):
        with pytest.raises(ValueError, match="num_layers"):
            tspec.truncated_draft(tp, cfg, n)


def test_batched_rows_equal_solo_rows(llama, other_draft):
    """Rows accept different prefix lengths a round (per-row offsets):
    a batch of 4 gives each row's solo tokens."""
    prompts = prompts_of(llama[0], 6, 4, 8)
    spec = port_spec(llama, gamma=3, draft_params=other_draft[1])
    got = spec.generate(prompts, 18)
    assert got.tokens.shape == (4, 18)
    for r in range(4):
        np.testing.assert_array_equal(got.tokens[r], spec.generate(prompts[r], 18).tokens)


def test_ragged_and_chunked_prefill_match_jax(llama):
    cfg = llama[0]
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 5, 2)]
    got = port_spec(llama, gamma=2).generate_ragged(prompts, 12)
    want = jax_spec(llama, gamma=2).generate_ragged(prompts, 12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    chunked = port_spec(llama, gamma=2, prefill_chunk=3).generate_ragged(prompts, 12)
    np.testing.assert_array_equal(chunked.tokens, got.tokens)
    gen = Generator(llama[1], cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                    device="cpu")
    np.testing.assert_array_equal(got.tokens, gen.generate_ragged(prompts, 12).tokens)


def test_stop_tokens_freeze_rows_match_jax(llama):
    """A row that emits its stop token freezes while the others go on;
    the tail repeats the stop token, as the JAX generator's does."""
    prompts = prompts_of(llama[0], 7, 2, 8)
    free = plain_tokens(llama, prompts, 20)
    stop = int(free[0, 6])
    got = port_spec(llama, gamma=4).generate(prompts, 20, stop_tokens=(stop,))
    want = jax_spec(llama, gamma=4).generate(prompts, 20, stop_tokens=(stop,))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert stop in got.tokens[0]
    solo = port_spec(llama, gamma=4).generate(prompts[0], 20, stop_tokens=(stop,))
    assert solo.tokens[-1] == stop and stop not in solo.tokens[:-1]


def test_perfect_draft_acceptance_counts_active_rows_only(llama):
    prompts = prompts_of(llama[0], 9, 3, 8)
    spec = port_spec(llama, gamma=4, draft_params=llama[1])
    res = spec.generate(prompts, 21)
    assert res.acceptance_rate == 1.0 and res.rounds == 4 and res.tokens_per_round == 5.0
    # one round step per shape, none more on a repeat
    spec.generate(prompts, 21)
    assert spec.compile_counts() == {"spec_round": 1}
    spec.generate(prompts[0], 21)
    assert spec.compile_counts() == {"spec_round": 2}
    # capacity covers the prompt, the budget and a round's overshoot
    with pytest.raises(ValueError, match="capacity"):
        spec.generate(prompts, 21, max_seq_len=8 + 21 + 4)


def test_spec_round_fn_matches_jax(llama, other_draft):
    """One granular round (``make_spec_round_fn``): emitted tokens,
    counts and each row's rolled-back cache length equal JAX's."""
    cfg, tp, jcfg, jp = llama
    gamma, b, s = 3, 3, 6
    ids = prompts_of(cfg, 10, b, s)
    caches, jcaches = [], []
    for c, params, jparams in ((cfg, other_draft[1], other_draft[3]), (cfg, tp, jp)):
        tc = tcache.KVCache.init(c, b, 32, torch.float32, device="cpu")
        jc = jcache.KVCache.init(jcfg, b, 32, dtype=jnp.float32)
        ttf.forward(params, torch.from_numpy(ids).long(), c, tc, device="cpu")
        _, jc = jtf.forward(jparams, jnp.asarray(ids), jcfg, jc)
        caches.append(tc)
        jcaches.append(jc)
    t0 = np.asarray([5, 17, 200], np.int32)
    rnd = tspec.make_spec_round_fn(cfg, cfg, gamma, Sampler("greedy"), device="cpu")
    jrnd = jspec.make_spec_round_fn(jcfg, jcfg, gamma, JSampler("greedy"))
    em, cnt, dc, tc, nxt = rnd(other_draft[1], tp, torch.from_numpy(t0), *caches,
                               trandom.PRNGKey(0))
    jem, jcnt, jdc, jtc, jnxt = jrnd(other_draft[3], jp, jnp.asarray(t0), *jcaches,
                                     jax.random.PRNGKey(0))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    for row, n in enumerate(cnt.tolist()):
        np.testing.assert_array_equal(em[row, :n].numpy(), np.asarray(jem)[row, :n])
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_array_equal(tc.offset.numpy(), np.asarray(jtc.length))
    np.testing.assert_array_equal(dc.offset.numpy(), np.asarray(jdc.length))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jtc.valid))


@pytest.mark.parametrize("kind", ["min_p", "top_k", "cdf"])
def test_sampled_perfect_draft_accepts_everything(llama, kind):
    """draft == target: p == q, so min(1, p/q) == 1 for every sampler."""
    spec = port_spec(llama, gamma=4, draft_params=llama[1], sampler=Sampler(kind))
    res = spec.generate(prompts_of(llama[0], 3, 1, 8)[0], 11, seed=7)
    assert res.acceptance_rate == 1.0
    assert np.all((res.tokens >= 0) & (res.tokens < llama[0].vocab_size))


@pytest.mark.parametrize("draft", ["int8", "other"])
def test_min_p_spec_matches_jax(llama, other_draft, draft):
    """Min-p speculation keyed as the JAX package keys it (``key, kp =
    split(PRNGKey(seed))``, a round ``key, kr = split(key)``, then
    ``kd, ku, kc = split(kr, 3)``): the tokens, acceptance and rounds equal
    JAX's ``SpeculativeGenerator``'s, each row up to the JAX side's first
    near-tie (``sampled_parity.spec_margins`` replays JAX's rounds for
    the margins), with the int8 self-draft and with an unrelated draft
    (most drafts rejected: the correction draws decide)."""
    cfg, tp, jcfg, jp = llama
    kw = dict(gamma=3, sampler=Sampler("min_p", p_base=0.05))
    jkw = dict(gamma=3, sampler=JSampler("min_p", p_base=0.05))
    if draft == "other":
        kw["draft_params"], jkw["draft_params"] = other_draft[1], other_draft[3]
    port, ref = port_spec(llama, **kw), jax_spec(llama, **jkw)
    prompts = prompts_of(cfg, 5, 3, 8)
    jdraft = (ref.draft_params, ref.draft_config)
    for seed in (0, 7):
        got, want = port.generate(prompts, 16, seed=seed), ref.generate(prompts, 16, seed=seed)
        replay, margins = spec_margins((jp, jcfg), jdraft, jkw["sampler"], 3, prompts, 16, seed)
        assert_prefix_parity(want.tokens, replay, margins, f"JAX replay {draft} {seed}")
        assert assert_prefix_parity(want.tokens, got.tokens, margins,
                                    f"min_p spec {draft} {seed}") > 0
        if (got.tokens == want.tokens).all():
            assert (got.acceptance_rate, got.rounds) == (want.acceptance_rate, want.rounds)


def test_sampled_spec_preserves_target_distribution():
    """With an imperfect draft, the third token's marginal (the bonus
    position of an all-accepted γ=1 round, or a later round) matches
    plain target-only sampling: total variation under 0.12 over 400
    runs, as the JAX package's test holds its own."""
    cfg = tiny_config("llama", vocab_size=16, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                      head_dim=8)
    target = params_from_jax(np_params(cfg, 0, scale=0.5), device="cpu")
    draft = params_from_jax(np_params(cfg, 1, scale=0.5), device="cpu")
    prompt = np.asarray([3, 7, 1], dtype=np.int32)
    sampler = Sampler("cdf", temperature=1.5)
    plain = Generator(target, cfg, sampler=sampler, cache_dtype=torch.float32, device="cpu")
    spec = tspec.SpeculativeGenerator(target, cfg, draft_params=draft, gamma=1, sampler=sampler,
                                      cache_dtype=torch.float32, device="cpu")
    n_runs = 400
    counts_plain = np.zeros(cfg.vocab_size)
    counts_spec = np.zeros(cfg.vocab_size)
    for seed in range(n_runs):
        counts_plain[int(plain.generate(prompt, 3, seed=seed).tokens[0][2])] += 1
        counts_spec[int(spec.generate(prompt, 3, seed=seed + 10_000).tokens[2])] += 1
    tv = 0.5 * np.abs(counts_plain / n_runs - counts_spec / n_runs).sum()
    assert tv < 0.12, f"total-variation distance {tv:.3f} too large"
    assert len(np.flatnonzero(counts_plain)) > 3  # a real distribution, not a point


def test_offline_entry_points_default_to_the_card(llama):
    cfg, tp = llama[:2]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tspec.SpeculativeGenerator(tp, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.ServeEngine(tp, cfg, mixed_step="on", spec_k=4)


# ----------------------------------------------------------------------
# served speculation: ServeEngine(spec_k=...)
# ----------------------------------------------------------------------

def engine(models, spec_k, *, jax_engine=False, sampler="greedy", **kw):
    cfg, tp, jcfg, jp = models
    kw.setdefault("max_slots", 4)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("mixed_step", "on")
    int8 = kw.pop("int8", False)
    if jax_engine:
        return jserve.ServeEngine(jp, jcfg, sampler=JSampler(sampler), spec_k=spec_k,
                                  cache_dtype=jnp.int8 if int8 else jnp.float32, **kw)
    return serve.ServeEngine(tp, cfg, sampler=Sampler(sampler), spec_k=spec_k,
                             cache_dtype=torch.int8 if int8 else torch.float32, device="cpu",
                             **kw)


def tokens(eng):
    return {r.req_id: list(r.generated) for r in eng.scheduler.finished}


def submit_all(eng, prompts, max_new, speculative=True, **kw):
    for j, p in enumerate(prompts):
        eng.submit(p, max_new, seed=j, speculative=speculative, **kw)
    eng.run_until_complete()
    return tokens(eng)


def test_spec_trace_parity_32_requests(tiny):
    """The acceptance trace: 32 Poisson requests on tiled prompts, all
    speculative.  The port's spec engine gives the JAX spec engine's
    tokens and the port's plain engine's, in fewer ticks; drafting adds
    no step (one step and one fetch a tick); the metrics snapshot has
    the JAX engine's spec keys and values."""
    cfg = tiny[0]
    rng = np.random.default_rng(0)
    trace = serve.poisson_trace(rng, 32, rate_rps=40.0, prompt_len_range=(4, 14),
                                max_new_tokens=8, vocab_size=cfg.vocab_size)
    for item, p in zip(trace, tiled_prompts(rng, cfg.vocab_size,
                                            [t["prompt"].size for t in trace])):
        item["prompt"] = p
        item["speculative"] = True
    spec, plain = clocked(engine, tiny, 4), clocked(engine, tiny, 0)
    ref = clocked(engine, tiny, 4, jax_engine=True)
    snap = spec.replay_trace(trace)
    psnap = plain.replay_trace(trace)
    jsnap = ref.replay_trace(trace)
    assert snap["finished"] == psnap["finished"] == jsnap["finished"] == 32
    assert tokens(spec) == tokens(ref) == tokens(plain)
    spec_keys = {k for k in jsnap if k.startswith("spec_")}
    assert spec_keys == {k for k in snap if k.startswith("spec_")} == {
        "spec_drafted_tokens", "spec_accepted_tokens", "spec_rejected_tokens", "spec_rounds",
        "spec_accept_rate", "spec_accept_len_mean"}
    assert {k: snap[k] for k in spec_keys} == {k: jsnap[k] for k in spec_keys}
    assert snap["spec_drafted_tokens"] > 0 and snap["spec_accepted_tokens"] > 0
    assert not any(k.startswith("spec_") for k in psnap)
    assert snap["ticks"] < psnap["ticks"]
    assert spec.n_dispatches == spec.n_host_fetches <= snap["ticks"]
    # the ticks that packed some draft: a verify slice on each
    assert 0 < spec.n_verify_dispatches <= snap["spec_rounds"]
    assert spec.n_verify_dispatches < spec.n_dispatches and plain.n_verify_dispatches == 0
    assert 0 < spec.compile_counts()["mixed_step"] <= len(spec.mixed_buckets)
    assert spec.tick_token_budget == 4 * 5 + 2 * 8
    assert spec.pool.stats()["request_held"] == 0


def test_spec_int8_pool_parity(tiny):
    prompts = tiled_prompts(np.random.default_rng(11), tiny[0].vocab_size, (8, 12, 5), 3)
    kw = dict(int8=True, max_slots=3, num_blocks=24)
    spec = engine(tiny, 3, **kw)
    got = submit_all(spec, prompts, 6)
    assert spec.pool.pages.quantized
    assert got == submit_all(engine(tiny, 3, jax_engine=True, **kw), prompts, 6)
    assert got == submit_all(engine(tiny, 0, **kw), prompts, 6)
    assert spec.metrics.snapshot()["spec_drafted_tokens"] > 0


def test_spec_prefix_sharing_parity(tiny):
    prompts = tiled_prompts(np.random.default_rng(3), tiny[0].vocab_size, (20, 17), 5) * 3
    spec = engine(tiny, 4, enable_prefix_cache=True)
    assert submit_all(spec, prompts, 5) == submit_all(engine(tiny, 0), prompts, 5)
    snap = spec.metrics.snapshot()
    assert snap["prefix_blocks_hit"] > 0 and snap["spec_drafted_tokens"] > 0
    fl = spec.pool.free_list
    assert fl.num_free + fl.num_allocated == fl.capacity


def test_spec_eviction_requeue_parity(tiny):
    prompts = tiled_prompts(np.random.default_rng(7), tiny[0].vocab_size, (4, 5, 3), 3)
    spec = engine(tiny, 3, max_slots=2, num_blocks=6)
    got = submit_all(spec, prompts, 20)
    assert spec.scheduler.n_preemptions > 0, "pool not tight enough"
    assert got == submit_all(engine(tiny, 0, max_slots=2, num_blocks=6), prompts, 20)
    assert spec.pool.free_list.num_allocated == 0


def test_spec_abort_mid_verify(tiny):
    """An abort from the request's own token callback in the middle of an
    accept walk: the remaining verified samples are dropped, its blocks
    and draft stream go, and its peer's stream equals plain decode."""
    prompts = tiled_prompts(np.random.default_rng(9), tiny[0].vocab_size, (10, 9), 3)
    eng = engine(tiny, 4, max_slots=2)
    killed = []

    def kill_after_3(req, tok, delta):
        if len(req.generated) == 3:
            killed.append(req.req_id)
            eng.abort(req.req_id)

    r0 = eng.submit(prompts[0], 12, seed=0, speculative=True, callback=kill_after_3)
    r1 = eng.submit(prompts[1], 8, seed=1, speculative=True)
    eng.run_until_complete()
    assert killed == [r0.req_id] and r0.finish_reason == "aborted"
    assert len(r0.generated) == 3
    assert eng.pool.stats()["request_held"] == 0
    assert r0.req_id not in eng._draft_states
    ref = engine(tiny, 0)
    ref.submit(prompts[1], 8, seed=1, request_id=r1.req_id)
    ref.run_until_complete()
    assert r1.generated == tokens(ref)[r1.req_id]


def test_spec_rolling_acceptance_fallback(tiny):
    """An unsatisfiable acceptance floor turns requests back into plain
    decode rows after one window, tokens unchanged."""
    prompts = tiled_prompts(np.random.default_rng(13), tiny[0].vocab_size, (9, 8), 3)
    eng = engine(tiny, 3, spec_min_accept=2.0, spec_window=2)
    got = submit_all(eng, prompts, 10)
    finished = eng.scheduler.finished
    assert any(r.extra.get("spec_off") for r in finished)
    assert got == submit_all(engine(tiny, 0), prompts, 10)


def test_spec_stop_token_parity_and_terminal_draft_counted(tiny):
    """A drafted stop token ends the stream where plain decode does and
    counts as accepted: every emitted token is a first token, a decode
    row's base token or an accepted draft.  The JAX engine agrees."""
    prompts = tiled_prompts(np.random.default_rng(31), tiny[0].vocab_size, (9, 12), 3)
    stop = submit_all(engine(tiny, 0), prompts, 10, speculative=False)[0][-1]
    spec = engine(tiny, 4, stop_tokens=(stop,))
    got = submit_all(spec, prompts, 10)
    assert got == submit_all(engine(tiny, 0, stop_tokens=(stop,)), prompts, 10)
    ref = engine(tiny, 4, jax_engine=True, stop_tokens=(stop,))
    assert got == submit_all(ref, prompts, 10)
    assert any(r.finish_reason == "stop" for r in spec.scheduler.finished)
    snap = spec.metrics.snapshot()
    assert snap["spec_drafted_tokens"] > 0
    assert snap["spec_accepted_tokens"] == (
        snap["total_generated_tokens"] - (len(prompts) + snap["preemptions"])
        - snap["mixed_decode_tokens"])
    jsnap = ref.metrics.snapshot()
    assert snap["spec_accepted_tokens"] == jsnap["spec_accepted_tokens"]


def test_spec_validation_and_phase_split_rejection(tiny):
    cfg, tp = tiny[:2]
    kw = dict(num_blocks=16, block_size=8, max_seq_len=64, device="cpu")
    for bad, match in ((dict(spec_k=4, mixed_step="off"), "unified tick"),
                       (dict(spec_k=-1, mixed_step="on"), "spec_k"),
                       (dict(spec_k=31, mixed_step="on"), "spec_k"),
                       (dict(spec_k=2, spec_ngram=1, mixed_step="on"), "spec_ngram")):
        with pytest.raises(ValueError, match=match):
            serve.ServeEngine(tp, cfg, **bad, **kw)
    eng = serve.ServeEngine(tp, cfg, spec_k=30, mixed_step="on", **kw)
    assert eng._spec_w == 31
    # the opt-in is inert on an engine built without spec_k
    plain = engine(tiny, 0)
    plain.submit(np.ones(6, np.int32), 4, speculative=True)
    plain.run_until_complete()
    assert "spec_rounds" not in plain.metrics.snapshot()


def test_spec_no_new_step_across_verify_width_churn(tiny):
    """After warm-up builds every bucket's step, ticks whose verify widths
    churn (drafts 0..k per row, spec and plain rows, prefill overlap)
    build no step: the verify lanes are a static [R, k+1] extension."""
    eng = engine(tiny, 3)
    lens = (4, 18, 7, 11)
    eng.warmup(list(lens), max_new_tokens=8)
    warm = dict(eng.compile_counts())
    assert warm == {"mixed_step": len(eng.mixed_buckets)}
    built = set(eng._mixed_steps)
    prompts = tiled_prompts(np.random.default_rng(4), tiny[0].vocab_size, lens, 4)
    for rep in range(3):
        for i, p in enumerate(prompts):
            eng.submit(p, 3 + i, seed=rep * 10 + i, speculative=i % 2 == 0)
        eng.run_until_complete()
    assert eng.compile_counts() == warm and set(eng._mixed_steps) == built
    assert eng.metrics.snapshot()["spec_rounds"] > 0


@pytest.mark.parametrize("sampler", [Sampler("min_p", temperature=0.2), Sampler("top_k", top_k=2)],
                         ids=["min_p_t0.2", "top_k2"])
def test_spec_sampled_kind_equals_plain_sampled(tiny, sampler):
    """A sampled kind draws every verify position by the (seed, content
    position) rule: the spec stream equals the port's plain
    sampled stream token for token, drafts accepted or not."""
    prompts = tiled_prompts(np.random.default_rng(21), tiny[0].vocab_size, (10, 7, 13), 3)
    kw = dict(max_slots=4, num_blocks=48, block_size=8, max_seq_len=64, mixed_step="on",
              cache_dtype=torch.float32, device="cpu")
    spec = serve.ServeEngine(tiny[1], tiny[0], sampler=sampler, spec_k=4, **kw)
    plain = serve.ServeEngine(tiny[1], tiny[0], sampler=sampler, **kw)
    assert submit_all(spec, prompts, 16) == submit_all(plain, prompts, 16)
    assert spec.metrics.snapshot()["spec_rounds"] > 0
    # a sampled tick is captured per bucket like a greedy one
    assert 0 < spec.compile_counts()["mixed_step"] <= len(spec.mixed_buckets)


def test_spec_metrics_absent_without_rounds():
    m = serve.ServeMetrics()
    assert not any(k.startswith("spec_") for k in m.snapshot())
    m.on_spec(drafted=4, accepted=3)
    m.on_spec(drafted=2, accepted=0)
    jm = jserve.ServeMetrics()
    jm.on_spec(drafted=4, accepted=3)
    jm.on_spec(drafted=2, accepted=0)
    snap, jsnap = m.snapshot(), jm.snapshot()
    keys = {k for k in jsnap if k.startswith("spec_")}
    assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
    assert snap["spec_accept_len_mean"] == 1.5 and snap["spec_rejected_tokens"] == 3
