"""The port's host-RAM KV tier (``serve/host_tier.py`` and the engine's
spill / restore hooks) against the JAX package's, on the CPU in float32.

Both engines run the same numpy-made weights, with a capacity-starved
pool (12 blocks of 8 slots, the fixture shape of the JAX package's tier
tests) and prompts whose shareable prefixes outgrow it.  Both tiers pin
``policy = "always"`` and are drained after every request, so what the
writer threads have applied — and so every restore decision — is the
same on both sides: tokens and the prefix, eviction, tier and prefill
counters must then be equal, and the host blocks the two tiers hold
for one key agree to float32 rounding (``KV_TOL``).

Also here: the ``HostTier`` units (bit-exact round trip, LRU capacity
eviction and misses, the breakeven policy, a failed copy raising instead
of counting a miss or a drop, a threaded enqueue stress), the engine
gate, eviction counted without a tier, the below-breakeven fallback,
preemption churn with the tier on, ``spill_prefix_blocks`` into a second
engine, and a long tier-on churn that builds no new step.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve.host_tier import HostTier as JHostTier
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.models.transformer import param_shapes
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import host_tier as host_tier_mod
from llm_np_cp_tpu_torch.serve.block_pool import FreeList
from llm_np_cp_tpu_torch.serve.host_tier import HostTier, HostTierError
from llm_np_cp_tpu_torch.serve.prefix_cache import PrefixCache

# |port host block - JAX host block| for one key: float32 K/V computed by
# two implementations (summation order only)
KV_TOL = 1e-5

# the counters the parity tests hold equal, engine against engine
COUNTERS = ("prefix_blocks_hit", "prefix_evicted_blocks", "tier_spilled_blocks",
            "tier_restored_blocks", "mixed_prefill_tokens")

# leg → (mixed_step, decode_attn_impl) on both engines
LEGS = {"mixed": ("on", "xla"), "split_paged": ("off", "paged")}


def np_params(cfg, seed, scale=0.15):
    """Random float32 weights as numpy, in the layout both packages share."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln_") or name == "final_norm":
            base = 0.0 if cfg.rms_norm_unit_offset else 1.0
            return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        k: {n: leaf(n, s) for n, s in v.items()} if k == "layers" else leaf(k, v)
        for k, v in param_shapes(cfg).items()
    }


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
    """(port config, port params, JAX config, JAX params) on the same weights."""
    cfg = tiny_config("llama")
    npp = np_params(cfg, 0)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


def port_engine(models, tier=None, *, leg="mixed", int8=False, num_blocks=12, **kw):
    cfg, tp = models[:2]
    mixed, impl = LEGS[leg]
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    return serve.ServeEngine(
        tp, cfg, sampler=Sampler("greedy"), mixed_step=mixed, decode_attn_impl=impl,
        num_blocks=num_blocks, enable_prefix_cache=True, host_tier=tier,
        cache_dtype=torch.int8 if int8 else torch.float32, device="cpu", **kw)


def jax_engine(models, tier=None, *, leg="mixed", int8=False, num_blocks=12, **kw):
    jcfg, jp = models[2:]
    mixed, impl = LEGS[leg]
    kw.setdefault("max_slots", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    return jserve.ServeEngine(
        jp, jcfg, sampler=JSampler("greedy"), mixed_step=mixed, decode_attn_impl=impl,
        num_blocks=num_blocks, enable_prefix_cache=True, host_tier=tier,
        cache_dtype=jnp.int8 if int8 else jnp.float32, **kw)


def churn_prompts(rng, n=6, size=24):
    """Distinct prompts whose shareable prefix blocks outgrow the pool."""
    return [rng.integers(1, 50, size=size).astype(np.int32) for _ in range(n)]


def run_rounds(eng, prompts, rounds=2, max_new=4):
    """Each prompt in turn, run to completion, the tier drained after each
    (so what the writer applied is the same whatever its speed)."""
    for _ in range(rounds):
        for p in prompts:
            eng.submit(p, max_new)
            eng.run_until_complete()
            if eng.host_tier is not None:
                eng.host_tier.drain()


def tokens(eng):
    return {r.req_id: list(r.generated) for r in eng.scheduler.finished}


def counters(eng):
    snap = eng.metrics.snapshot()
    return {k: snap.get(k, 0) for k in COUNTERS}


# ----------------------------------------------------------------------
# HostTier units
# ----------------------------------------------------------------------

def test_host_tier_roundtrip_bit_identical():
    tier = HostTier(1 << 20)
    rng = np.random.default_rng(0)
    blocks = {bytes([i]) * 4: (rng.standard_normal((2, 8, 1, 4)).astype(np.float32),
                               rng.standard_normal((2, 8, 1, 4)).astype(np.float32))
              for i in range(4)}
    for key, (k, v) in blocks.items():
        # a strided view, as a pool block is: the spill copies it contiguous
        kk = torch.from_numpy(np.stack([k, k], axis=1))[:, 1]
        assert tier.enqueue_spill(key, kk, torch.from_numpy(v))
    assert tier.drain()
    assert len(tier) == 4 and tier.match(list(blocks)) == 4
    for i, (key, (k, v)) in enumerate(blocks.items()):
        (res,) = tier.take_restored([tier.enqueue_restore(key, i + 1, device="cpu")])
        blk_id, staged, dt, ready = res
        assert blk_id == i + 1 and dt >= 0.0 and ready is None
        np.testing.assert_array_equal(staged.k.numpy(), k)
        np.testing.assert_array_equal(staged.v.numpy(), v)
        assert staged.k_scale is None and staged.k.is_contiguous()
    st = tier.stats()
    assert st["spilled_blocks"] == 4 and st["restored_blocks"] == 4
    assert st["restored_bytes"] == st["spilled_bytes"] == 4 * 2 * 256
    assert st["restore_s_p99"] > 0.0
    tier.close()


def test_host_tier_lru_capacity_eviction_and_miss():
    one = torch.zeros((2, 8, 1, 4))  # 256 B a tensor
    tier = HostTier(256 * 2 * 3 + 1)  # room for 3 blocks
    keys = [bytes([i]) * 4 for i in range(5)]
    for i, key in enumerate(keys):
        tier.enqueue_spill(key, one + i, one - i)
    tier.drain()
    # LRU: the two oldest dropped to stay under capacity
    assert len(tier) == 3
    assert tier.match(keys[2:]) == 3 and not tier.contains(keys[0])
    assert tier.stats()["dropped_blocks"] == 2
    assert tier.resident_bytes <= tier.capacity_bytes
    # a restore of a dropped key is a MISS, not an error
    (res,) = tier.take_restored([tier.enqueue_restore(keys[0], 7, device="cpu")])
    assert res is None and tier.stats()["restore_misses"] == 1
    # a spill of a resident key queues nothing
    assert not tier.enqueue_spill(keys[2], one, one)
    tier.drain()
    assert tier.stats()["spilled_blocks"] == 5 and len(tier) == 3
    tier.close()


def test_host_tier_breakeven_policy():
    tier = HostTier(1 << 20)
    # unmeasured: the optimistic default (a restore is bit-identical)
    assert tier.breakeven_ratio(8) is None
    assert tier.should_restore(2, 8)
    tier.set_measured(restore_s_per_block=1e-4, prefill_tok_s=100.0)
    assert tier.breakeven_ratio(8) == pytest.approx(800.0)
    assert tier.should_restore(2, 8)
    tier.set_measured(restore_s_per_block=10.0, prefill_tok_s=1e9)
    assert tier.breakeven_ratio(8) < 1.0
    assert not tier.should_restore(2, 8)
    tier.policy = "always"
    assert tier.should_restore(2, 8)
    tier.policy = "never"
    assert not tier.should_restore(2, 8)
    # the EWMA refines, never jumps
    tier.policy = "auto"
    tier.note_prefill_rate(1e9)
    tier.note_prefill_rate(1.0)
    assert tier.prefill_tok_s < 1e9
    tier.close()


def test_host_tier_probe_measures_one_block():
    """The probe times a block-sized copy once per block size: bytes and
    a positive rate, kept for an engine of the same geometry."""
    tier = HostTier(1 << 20)
    shapes = [((2, 8, 1, 4), torch.float32)] * 2
    tier.ensure_probe(shapes, device="cpu")
    first = tier.restore_s_per_block
    assert first > 0 and tier.restore_gbps > 0
    assert tier._probed_bytes == 2 * 256
    tier.ensure_probe(shapes, device="cpu")
    assert tier.restore_s_per_block == first
    tier.close()


def test_host_tier_validation_and_engine_gate(llama):
    with pytest.raises(ValueError, match="capacity_bytes"):
        HostTier(0)
    tier = HostTier(1 << 20)
    with pytest.raises(ValueError, match="prefix_cache"):
        serve.ServeEngine(llama[1], llama[0], max_slots=2, num_blocks=12, block_size=8,
                          max_seq_len=64, cache_dtype=torch.float32, mixed_step="on",
                          host_tier=tier, device="cpu")
    # host_tier is ported: only the still-missing keyword (mesh_devices) refuses
    with pytest.raises(NotImplementedError, match="mesh_devices"):
        port_engine(llama, mesh_devices=[0])
    tier.close()


@pytest.mark.parametrize("where", ["spill", "restore"])
def test_failed_copy_raises_not_a_miss(monkeypatch, where):
    """A copy that fails on the writer thread is a fault: the next call
    into the tier raises it, and it is counted neither as a dropped block
    nor as a restore miss (the JAX tier turns both into misses)."""
    tier = HostTier(1 << 20)
    one = torch.ones((2, 8, 1, 4))
    if where == "restore":
        tier.enqueue_spill(b"k", one, one)
        tier.drain()

    def broken(*args):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(host_tier_mod, "_host_copy" if where == "spill" else "_stage", broken)
    if where == "spill":
        tier.enqueue_spill(b"k", one, one)
        with pytest.raises(HostTierError, match="copy failed"):
            tier.drain()
    else:
        ticket = tier.enqueue_restore(b"k", 3, device="cpu")
        with pytest.raises(HostTierError, match="copy failed"):
            tier.take_restored([ticket])
    # the fault sticks: every later call raises it
    with pytest.raises(HostTierError):
        tier.enqueue_spill(b"j", one, one)
    with pytest.raises(HostTierError):
        tier.check()
    st = tier.stats()
    assert st["dropped_blocks"] == 0 and st["restore_misses"] == 0
    tier.close()


def test_engine_tick_fails_on_a_failed_restore(llama, monkeypatch):
    """A restore copy that fails fails the engine's tick (no re-prefill)."""
    rng = np.random.default_rng(10)
    prompts = churn_prompts(rng)
    tier = HostTier(64 << 20)
    tier.policy = "always"
    eng = port_engine(llama, tier)
    run_rounds(eng, prompts, rounds=1)
    assert len(tier) > 0

    def broken(*args):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(host_tier_mod, "_stage", broken)
    with pytest.raises(HostTierError, match="copy failed"):
        run_rounds(eng, prompts, rounds=1)
    assert tier.stats()["restore_misses"] == 0
    tier.close()


def test_writer_serves_restores_before_queued_spills(monkeypatch):
    """A restore queued behind spills runs first (an admission waits on
    it): here the spill queued ahead of it would have LRU-dropped the
    block it restores, which FIFO order would turn into a miss."""
    one = torch.zeros((2, 8, 1, 4))
    tier = HostTier(256 * 2 * 2 + 1)  # room for 2 blocks
    tier.enqueue_spill(b"K", one + 1, one)
    tier.drain()
    started = threading.Event()
    copy = host_tier_mod._host_copy

    def slow_copy(a, stream):
        if float(a.flatten()[0]) == 7.0:
            started.set()
            threading.Event().wait(0.3)  # the writer is busy meanwhile
        return copy(a, stream)

    monkeypatch.setattr(host_tier_mod, "_host_copy", slow_copy)
    tier.enqueue_spill(b"slow", one + 7, one)
    assert started.wait(5)
    tier.enqueue_spill(b"X", one + 2, one)
    ticket = tier.enqueue_restore(b"K", 3, device="cpu")
    (res,) = tier.take_restored([ticket])
    assert res is not None and torch.equal(res[1].k, one + 1)
    tier.drain()
    assert tier.contains(b"K") and tier.contains(b"X") and not tier.contains(b"slow")
    assert tier.stats()["restore_misses"] == 0
    tier.close()


def test_host_tier_threaded_enqueue_stress():
    """Several threads spill and restore into one tier with a short
    switch interval: no lost update — every distinct key spills exactly
    once, every restore resolves, and the counters add up."""
    tier = HostTier(1 << 30)
    one = torch.ones((2, 8, 1, 4))
    n_threads, n_keys = 8, 64
    results: list[list] = [[] for _ in range(n_threads)]
    accepted = [0] * n_threads

    def worker(t):
        rng = np.random.default_rng(t)
        for _ in range(200):
            key = int(rng.integers(0, n_keys)).to_bytes(2, "little")
            if rng.random() < 0.5:
                accepted[t] += tier.enqueue_spill(key, one * key[0], one)
            else:
                results[t] += tier.take_restored([tier.enqueue_restore(key, 1, device="cpu")])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert tier.drain()
    st = tier.stats()
    assert st["spilled_blocks"] == sum(accepted) == len(tier) <= n_keys
    restores = [r for rs in results for r in rs]
    assert st["restored_blocks"] + st["restore_misses"] == len(restores)
    assert st["restored_blocks"] == sum(r is not None for r in restores)
    for r in restores:
        if r is not None:
            assert torch.equal(r[1].v, one)
    tier.close()


def test_tier_churn_stress_over_the_allocator():
    """The JAX package's host-level stress over FreeList + PrefixCache +
    HostTier (the allocator math the engine runs, minus the model): 2000
    random steps of registration, claims, decrefs, LRU reclaim with spill
    and restores into fresh blocks.  A restore never targets a free-listed
    block, the free list and the allocated set stay disjoint, and every
    restored payload is bit-identical to what spilled."""
    rng = np.random.default_rng(7)
    fl = FreeList(24)
    pc = PrefixCache(fl)
    tier = HostTier(48 * 2 * 64 * 4)
    truth: dict[bytes, torch.Tensor] = {}

    def on_reclaim(key, blk):
        tier.enqueue_spill(key, truth[key].clone(), truth[key] + 1)

    pc.on_reclaim = on_reclaim
    next_key = 0
    claims: list[int] = []

    def check_invariants():
        free = set(fl._free)
        assert free.isdisjoint(fl._ref), "free list overlaps allocated"
        assert 0 not in free, "scratch block leaked into the free list"

    for step in range(2000):
        op = rng.integers(0, 5)
        if op == 0:  # register fresh content
            ids = fl.alloc(1) or (pc.release(1) and fl.alloc(1))
            if ids:
                key = next_key.to_bytes(8, "little")
                next_key += 1
                truth[key] = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
                pc.register([key], ids)
                fl.free(ids)
        elif op == 1 and len(pc):  # a sharer claims, holds
            key = list(pc._entries)[int(rng.integers(0, len(pc)))]
            claims.extend(pc.claim([key]))
        elif op == 2 and claims:  # a sharer finishes
            fl.free([claims.pop(int(rng.integers(0, len(claims))))])
        elif op == 3:  # pool pressure: LRU reclaim spills
            pc.release(int(rng.integers(1, 3)))
        elif op == 4 and len(tier):  # restore into a claimed block
            keys = list(tier._wentries)
            key = keys[int(rng.integers(0, len(keys)))]
            ids = fl.alloc(1)
            if ids is None:
                pc.release(1)
                ids = fl.alloc(1)
            if ids:
                (res,) = tier.take_restored([tier.enqueue_restore(key, ids[0], device="cpu")])
                assert ids[0] not in fl._free
                if res is not None:
                    assert res[0] == ids[0]
                    assert torch.equal(res[1].k, truth[key])
                    assert torch.equal(res[1].v, truth[key] + 1)
                fl.free(ids)
        if step % 50 == 0:
            tier.drain()
            check_invariants()
    tier.drain()
    check_invariants()
    st = tier.stats()
    assert st["spilled_blocks"] > 50 and st["restored_blocks"] > 50
    assert sorted(pc.items()) == sorted(pc._entries.items())
    tier.close()


# ----------------------------------------------------------------------
# the engine against the JAX engine
# ----------------------------------------------------------------------

def test_prefix_eviction_counted_without_tier(llama):
    """Reclaim is counted with no tier attached, as the JAX engine counts
    it, and no tier series appears."""
    rng = np.random.default_rng(3)
    prompts = churn_prompts(rng)
    port, ref = port_engine(llama), jax_engine(llama)
    for eng in (port, ref):
        run_rounds(eng, prompts)
    snap, want = port.metrics.snapshot(), ref.metrics.snapshot()
    assert snap["prefix_evicted_blocks"] > 0
    assert snap["prefix_evicted_blocks"] == want["prefix_evicted_blocks"]
    assert snap["prefix_evicted_bytes"] == want["prefix_evicted_bytes"]
    assert "tier_spilled_blocks" not in snap
    assert tokens(port) == tokens(ref)


@pytest.mark.parametrize("leg,int8", [("mixed", False), ("split_paged", False),
                                      ("mixed", True), ("split_paged", True)],
                         ids=["mixed", "split_paged", "mixed_int8", "split_paged_int8"])
def test_tier_parity_with_jax_engine(llama, leg, int8):
    """Tier-on port and JAX engines on the same churn: equal tokens and
    counters; the restores cut prefill work against the tier-off port on
    the same requests; the tier's ledgers match its stats; and the host
    block each tier holds for a key agree (int8: scales to float32
    rounding, codes within one step)."""
    rng = np.random.default_rng(0)
    prompts = churn_prompts(rng)
    tier, jtier = HostTier(64 << 20), JHostTier(64 << 20)
    tier.policy = jtier.policy = "always"
    port = port_engine(llama, tier, leg=leg, int8=int8)
    ref = jax_engine(llama, jtier, leg=leg, int8=int8)
    off = port_engine(llama, None, leg=leg, int8=int8)
    for eng in (port, ref, off):
        run_rounds(eng, prompts)
    assert tokens(port) == tokens(ref) == tokens(off)
    got = counters(port)
    assert got == counters(ref)
    s_on, s_off, st = port.metrics.snapshot(), off.metrics.snapshot(), tier.stats()
    assert st["restored_blocks"] > 0 and st["restore_misses"] == 0
    if port.mixed:
        assert s_on["mixed_prefill_tokens"] < s_off["mixed_prefill_tokens"]
    assert s_on.get("prefix_hit_rate", 0.0) > s_off.get("prefix_hit_rate", 0.0)
    assert s_on["tier_restored_blocks"] == st["restored_blocks"]
    assert s_on["tier_restored_bytes"] == st["restored_bytes"]
    assert s_on["tier_spilled_blocks"] == st["spilled_blocks"]
    assert 0 < s_on["tier_spilled_blocks"] <= s_on["prefix_evicted_blocks"]
    assert s_on["tier_restore_s_p99"] > 0.0
    assert port.pool.stats()["request_held"] == 0
    assert set(tier._wentries) == set(jtier._wentries)
    for key, blk in tier._wentries.items():
        want = jtier._wentries[key]
        if int8:
            for a, b in ((blk.k, want.k), (blk.v, want.v)):
                assert np.abs(a.numpy().astype(np.int32) - b.astype(np.int32)).max() <= 1
            for a, b in ((blk.k_scale, want.k_scale), (blk.v_scale, want.v_scale)):
                np.testing.assert_allclose(a.numpy(), b, rtol=KV_TOL, atol=KV_TOL)
        else:
            np.testing.assert_allclose(blk.k.numpy(), want.k, rtol=0, atol=KV_TOL)
            np.testing.assert_allclose(blk.v.numpy(), want.v, rtol=0, atol=KV_TOL)
    # a restored block registered in the pool holds its host copy's bytes
    pages = port.pool.pages
    restored = [(k, b) for k, b in port.pool.prefix_cache.items() if tier.contains(k)]
    assert restored
    for key, b in restored:
        host = tier._wentries[key]
        for page, a in zip(pages, host):
            if page is not None:
                np.testing.assert_allclose(page[:, b].numpy(), a.numpy(), rtol=0,
                                           atol=0 if int8 else KV_TOL)
    tier.close()
    jtier.close()


@pytest.mark.parametrize("leg", list(LEGS))
def test_partial_restore_reprefills_the_tail(llama, leg, monkeypatch):
    """Every staged restore after the first of an admission misses (as a
    host entry that raced a capacity eviction would): the covered span
    shrinks to what landed, the tail re-prefills, and tokens and counters
    still equal the JAX engine's under the same misses."""
    def first_only(take):
        def take_restored(self, tickets, timeout=10.0):
            return [r if i == 0 else None for i, r in enumerate(take(self, tickets, timeout))]
        return take_restored

    monkeypatch.setattr(HostTier, "take_restored", first_only(HostTier.take_restored))
    monkeypatch.setattr(JHostTier, "take_restored", first_only(JHostTier.take_restored))
    rng = np.random.default_rng(11)
    prompts = churn_prompts(rng, size=32)
    tier, jtier = HostTier(64 << 20), JHostTier(64 << 20)
    tier.policy = jtier.policy = "always"
    port = port_engine(llama, tier, leg=leg, max_seq_len=96, num_blocks=14)
    ref = jax_engine(llama, jtier, leg=leg, max_seq_len=96, num_blocks=14)
    off = port_engine(llama, None, leg=leg, max_seq_len=96, num_blocks=14)
    for eng in (port, ref, off):
        run_rounds(eng, prompts)
    assert tokens(port) == tokens(ref) == tokens(off)
    assert counters(port) == counters(ref)
    st = tier.stats()
    # more blocks staged than landed: some span lost its tail
    assert 0 < port.metrics.snapshot()["tier_restored_blocks"] < st["restored_blocks"]
    assert port.pool.stats()["request_held"] == 0
    tier.close()
    jtier.close()


def test_tier_below_breakeven_falls_back_to_reprefill(llama):
    """A measured breakeven far below 1 declines every host hit: no
    restore, the skips counted, and exactly the tier-off prefill work."""
    rng = np.random.default_rng(1)
    prompts = churn_prompts(rng)
    tier = HostTier(64 << 20)
    on = port_engine(llama, tier)
    tier.set_measured(restore_s_per_block=100.0, prefill_tok_s=1e9)
    off = port_engine(llama)
    for eng in (on, off):
        run_rounds(eng, prompts)
    assert tokens(on) == tokens(off)
    st = tier.stats()
    assert st["restored_blocks"] == 0 and st["skipped_blocks"] > 0
    assert (on.metrics.snapshot()["mixed_prefill_tokens"]
            == off.metrics.snapshot()["mixed_prefill_tokens"])
    tier.close()


@pytest.mark.parametrize("leg", list(LEGS))
def test_tier_eviction_requeue_interplay(llama, leg):
    """Preemption churn on a starved pool with the tier on: requeued
    re-prefills may restore, every stream equals the tier-off engine's,
    and no block leaks."""
    rng = np.random.default_rng(5)
    prompts = churn_prompts(rng, n=4, size=20)
    legs = {}
    for name, tier in (("on", HostTier(64 << 20)), ("off", None)):
        # 8 allocatable blocks, two requests growing to 5 blocks each:
        # decode growth must preempt the youngest
        eng = port_engine(llama, tier, leg=leg, num_blocks=9)
        for _ in range(2):
            for p in prompts:
                eng.submit(p, 16)
            eng.run_until_complete()
            if tier is not None:
                tier.drain()
        legs[name] = eng
    on, off = legs["on"], legs["off"]
    assert tokens(on) == tokens(off)
    assert on.metrics.snapshot()["preemptions"] > 0
    assert on.host_tier.stats()["restored_blocks"] > 0
    assert on.pool.stats()["request_held"] == 0
    on.host_tier.close()


@pytest.mark.parametrize("leg", list(LEGS))
def test_spill_prefix_blocks_into_a_second_engine(llama, leg):
    """One engine ships its registered prefix blocks into a shared tier;
    a second engine then restores the whole shareable prefix of the same
    prompt and prefills only the last chunk, with the same tokens — as
    the JAX engines do."""
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, 50, size=24).astype(np.int32)
    got = {}
    for side, (make, tier) in {"port": (port_engine, HostTier(64 << 20)),
                               "jax": (jax_engine, JHostTier(64 << 20))}.items():
        src = make(llama, tier, leg=leg, num_blocks=24)
        dst = make(llama, tier, leg=leg, num_blocks=24)
        first = src.submit(prompt, 4)
        src.run_until_complete()
        n = src.spill_prefix_blocks()
        tier.drain()
        assert n == len(src.pool.prefix_cache) > 0 and tier.stats()["spilled_blocks"] == n
        assert src.spill_prefix_blocks() == 0  # resident: nothing re-queued
        again = dst.submit(prompt, 4)
        dst.run_until_complete()
        snap = dst.metrics.snapshot()
        shareable = again.n_shared_blocks * dst.block_size
        assert shareable > 0 and snap["tier_restored_blocks"] == again.n_shared_blocks
        if dst.mixed:
            assert snap["mixed_prefill_tokens"] == prompt.size - shareable <= dst.prefill_chunk
        assert again.generated == first.generated
        got[side] = (list(again.generated), again.n_shared_blocks, n,
                     {k: snap.get(k, 0) for k in COUNTERS})
        tier.close()
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("leg", list(LEGS))
def test_tier_churn_builds_no_new_step(llama, leg):
    """A few hundred tier-on ticks after warmup: spills and restores
    happen, and no step is built again — the tier's copies are eager
    operations between steps (the JAX engine's restore_block and
    slice_block stay at one compile each)."""
    rng = np.random.default_rng(4)
    prompts = churn_prompts(rng)
    tier = HostTier(64 << 20)
    eng = port_engine(llama, tier, leg=leg)
    eng.warmup([int(p.size) for p in prompts], max_new_tokens=16)
    warm = eng.compile_counts()
    steps = {id(s) for s in eng.graph_steps()}
    ticks0 = eng.metrics.snapshot()["ticks"]
    run_rounds(eng, prompts, rounds=3, max_new=16)
    snap = eng.metrics.snapshot()
    assert snap["ticks"] - ticks0 >= 200
    assert tier.stats()["restored_blocks"] > 0 and tier.stats()["spilled_blocks"] > 0
    assert eng.compile_counts() == warm
    if eng.mixed:
        assert {id(s) for s in eng.graph_steps()} == steps
        assert set(warm) == {"mixed_step"}
    else:
        assert len(eng.graph_steps()) == 1 and set(warm) == {"decode_step"}
    tier.close()
