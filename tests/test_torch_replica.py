"""The engine fleet in the port (``serve/replica.py``: ``PrefixRouter``,
``ReplicaSet``, ``ReplicaRunner``) against the JAX package's, on the CPU
in float32, and the launch counts that several tick threads share.

The router's affinity keys and verdicts are byte-equal to the JAX
router's on the same prompts and loads.  Fleets of both packages on the
same numpy weights: the 32-request trace over 2 replicas equals a single
port engine and the JAX ``ReplicaSet`` token for token; shared-prompt
traffic stays 100 % block-local; queue pressure spills; one replica's
recovery while its peer serves; mismatched geometry raises; block
shipping through a shared host tier (restores > 0, fewer prefill
tokens); elastic scale-down under load and ``add_replica`` joining with
every bucket its source captured.  Over HTTP: a 2-replica fleet behind
``HttpServer`` (tokens, ``/healthz``, the replica-labelled scrape), a
replica crash drained to its peer (``degraded``, tokens unchanged), and
the same-version preference of a mid-roll drain.  The JAX file's DP x TP
composition is the mesh slice's (not ported).
"""

import asyncio
import dataclasses
import json
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve import faults as jfaults
from llm_np_cp_tpu.serve.host_tier import HostTier as JHostTier
from llm_np_cp_tpu_torch import graphs, serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import faults
from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
from llm_np_cp_tpu_torch.serve.http.server import HttpServer
from test_torch_http import np_params, run
from tick_clock import TickClock, clocked

pytestmark = pytest.mark.http


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_global_injector():
    yield
    faults.install(None)
    jfaults.install(None)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config("llama")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    npp = np_params(cfg, 0)
    return types.SimpleNamespace(cfg=cfg, tp=params_from_jax(npp, device="cpu"),
                                 jcfg=jcfg, jp=jax.tree.map(jnp.asarray, npp))


def engine(pkg, m, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("num_blocks", 48)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_seq_len", 64)
    kw.setdefault("mixed_step", "on")
    if pkg == "port":
        return serve.ServeEngine(m.tp, m.cfg, sampler=Sampler("greedy"),
                                 cache_dtype=torch.float32, device="cpu", **kw)
    return jserve.ServeEngine(m.jp, m.jcfg, sampler=JSampler(kind="greedy"),
                              cache_dtype=jnp.float32, **kw)


def fleet(pkg, m, n, *, spill_queue_depth=4, clock=None, **kw):
    """``clock``: one ``TickClock`` shared by (and watching) every replica."""
    S = serve if pkg == "port" else jserve
    if clock is not None:
        kw["clock"] = clock
    engines = [engine(pkg, m, **kw) for _ in range(n)]
    if clock is not None:
        clock.watch(*engines)
    return S.ReplicaSet(engines, spill_queue_depth=spill_queue_depth)


def streams(x):
    if isinstance(x, (serve.ReplicaSet, jserve.ReplicaSet)):
        return [list(r.generated) for r in x.finished]
    return [list(r.generated) for r in sorted(x.scheduler.finished, key=lambda r: r.req_id)]


def trace(m, seed, n, lens, new, distinct=None):
    return serve.poisson_trace(np.random.default_rng(seed), n, rate_rps=40.0,
                               prompt_len_range=lens, max_new_tokens=new,
                               vocab_size=m.cfg.vocab_size, distinct_prompts=distinct)


# ----------------------------------------------------------------------
# PrefixRouter, byte for byte
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bs,chunk", [(8, 8), (8, 16), (16, 24), (128, 256)])
def test_router_affinity_keys_match_jax(bs, chunk):
    """Affinity keys and the reusable chains equal the JAX router's on
    prompts of every length around the share unit, and the key is the
    deepest ``prefix_block_keys`` entry where a block is shareable."""
    port = serve.PrefixRouter(4, block_size=bs, prefill_chunk=chunk)
    ref = jserve.PrefixRouter(4, block_size=bs, prefill_chunk=chunk)
    rng = np.random.default_rng(bs + chunk)
    shared = 0
    for n in list(range(1, 4 * chunk + 3)) + [600, 1100]:
        p = rng.integers(1, 50000, size=n).astype(np.int32)
        got, want = port.affinity_chain(p), ref.affinity_chain(p)
        assert got == want
        if got[1] is not None:
            keys, w = got[1]
            shared += 1
            assert got[0] == keys[-1] == serve.prefix_block_keys(p, w - n, bs, len(keys))[-1]
    assert shared > 0
    long = np.arange(1, 3 * chunk + 1, dtype=np.int32)
    tail = long.copy()
    tail[-1] += 1
    assert port.affinity_key(tail) == port.affinity_key(long)  # past the shareable span


@pytest.mark.parametrize("spill", [None, 1, 3])
def test_router_verdicts_match_jax(spill):
    """A seeded walk of routes (new and repeated keys, loads, queue depths,
    deaths), forgets and grows gives the JAX router's verdicts and
    counters."""
    port = serve.PrefixRouter(3, block_size=8, prefill_chunk=8, spill_queue_depth=spill)
    ref = jserve.PrefixRouter(3, block_size=8, prefill_chunk=8, spill_queue_depth=spill)
    rng = np.random.default_rng(17)
    keys = [bytes([i]) * 32 for i in range(10)]
    for step in range(400):
        n = port.n
        if step == 200:
            port.grow(4)
            ref.grow(4)
            n = 4
        if rng.random() < 0.05:
            i = int(rng.integers(n))
            assert port.forget_replica(i) == ref.forget_replica(i)
            continue
        loads = rng.integers(0, 6, size=n).tolist()
        qd = rng.integers(0, 5, size=n).tolist()
        alive = (rng.random(n) < 0.85).tolist()
        if not any(alive):
            alive[int(rng.integers(n))] = True
        key = keys[int(rng.integers(len(keys)))]
        got = port.route(key, loads=loads, queue_depths=qd, alive=alive)
        assert got == ref.route(key, loads=loads, queue_depths=qd, alive=alive)
        assert alive[got[0]]
        assert port.sticky_owner(key) == ref.sticky_owner(key)
    assert (port.routed, port.spilled) == (ref.routed, ref.spilled)
    assert port.routed > 0 and (spill is None) == (port.spilled == 0)
    with pytest.raises(RuntimeError, match="no alive replica"):
        port.route(keys[0], loads=[0] * 4, alive=[False] * 4)
    with pytest.raises(ValueError, match="cannot shrink"):
        port.grow(2)


# ----------------------------------------------------------------------
# ReplicaSet against one engine and the JAX fleet
# ----------------------------------------------------------------------

def test_fleet_trace_parity_32_requests(tiny):
    """2 replicas reproduce one engine's streams on a 32-request Poisson
    trace, equal to the JAX ``ReplicaSet``'s token for token, with the
    same routing counters and per-replica placement."""
    tr = trace(tiny, 0, 32, (3, 14), 6)
    single = clocked(engine, "port", tiny)
    snap1 = single.replay_trace(tr)
    out = {}
    for pkg in ("port", "jax"):
        f = fleet(pkg, tiny, 2, clock=TickClock())
        snap = f.replay_trace(tr)
        out[pkg] = (streams(f), snap["router_routed"], snap["router_spilled"],
                    [r.extra["replica"] for r in f.finished], snap["finished"],
                    snap["total_generated_tokens"])
    assert out["port"] == out["jax"]
    got, routed, spilled, _, finished, total = out["port"]
    assert got == streams(single) and finished == 32 and routed + spilled == 32
    assert total == snap1["total_generated_tokens"]


def test_shared_prompt_trace_100pct_block_local(tiny):
    """32 requests over 8 distinct prompts route 100 % block-locally: no
    spill, each prompt on one replica, the fleet's prefix hits equal to
    one engine's — as the JAX fleet routes them."""
    tr = trace(tiny, 3, 32, (18, 30), 5, distinct=8)
    single = clocked(engine, "port", tiny, enable_prefix_cache=True, num_blocks=96)
    snap1 = single.replay_trace(tr)
    assert snap1["prefix_blocks_hit"] > 0
    out = {}
    for pkg in ("port", "jax"):
        f = fleet(pkg, tiny, 4, spill_queue_depth=None, enable_prefix_cache=True,
                  num_blocks=96, clock=TickClock())
        snap = f.replay_trace(tr)
        owners: dict[bytes, set] = {}
        for i, e in enumerate(f.engines):
            for r in e.scheduler.finished:
                owners.setdefault(r.prompt.tobytes(), set()).add(i)
        out[pkg] = (streams(f), snap["router_spilled"], snap["prefix_blocks_hit"],
                    sorted((k, sorted(v)) for k, v in owners.items()))
    assert out["port"] == out["jax"]
    got, spilled, hits, owners = out["port"]
    assert got == streams(single) and spilled == 0 and hits == snap1["prefix_blocks_hit"]
    assert len(owners) == 8 and all(len(v) == 1 for _, v in owners)


def test_spill_relieves_queue_pressure(tiny):
    """A hot prefix hammering one replica spills to the idle peer, which
    really runs the spilled requests (same counts as the JAX fleet)."""
    prompt = np.arange(1, 25, dtype=np.int32)
    out = {}
    for pkg in ("port", "jax"):
        f = fleet(pkg, tiny, 2, spill_queue_depth=2, enable_prefix_cache=True)
        for _ in range(10):
            f.submit(prompt, 4, seed=0)
        f.run_until_complete()
        out[pkg] = (f.router.spilled, [len(e.scheduler.finished) for e in f.engines],
                    streams(f))
    assert out["port"] == out["jax"]
    assert out["port"][0] > 0 and all(out["port"][1])


def test_replica_recovery_while_peers_serve(tiny):
    """Kill one replica mid-trace, let its peer tick on, restart it
    (``clone_fresh`` retires the dead engine; teacher-forced recovery):
    every stream equals an undisturbed fleet's and the JAX fleet's, and
    the dead replica's prefixes re-home meanwhile."""
    tr = trace(tiny, 7, 16, (18, 30), 6, distinct=4)
    undisturbed = fleet("port", tiny, 2, spill_queue_depth=None, enable_prefix_cache=True)
    for t in tr:
        undisturbed.submit(t["prompt"], t["max_new_tokens"], seed=t.get("seed", 0))
    undisturbed.run_until_complete()
    out = {}
    for pkg in ("port", "jax"):
        f = fleet(pkg, tiny, 2, spill_queue_depth=None, enable_prefix_cache=True)
        for t in tr:
            f.submit(t["prompt"], t["max_new_tokens"], seed=t.get("seed", 0))
        for _ in range(3):
            f.step()
        dead = f.engines[0]
        inflight = f.kill_replica(0)
        assert inflight
        for _ in range(3):
            f.step()
        re_homed = f.submit(tr[0]["prompt"], 2, seed=tr[0].get("seed", 0))
        assert f.alive[re_homed.extra["replica"]]
        f.abort(re_homed.req_id)
        f.restart_replica(0)
        if pkg == "port":
            assert dead.retired and f.engines[0] is not dead
        f.run_until_complete()
        out[pkg] = streams(f)
    assert out["port"] == out["jax"] == streams(undisturbed)


def test_replica_set_rejects_mismatched_geometry(tiny):
    with pytest.raises(ValueError, match="geometry"):
        serve.ReplicaSet([engine("port", tiny), engine("port", tiny, block_size=16)])
    with pytest.raises(ValueError, match="at least one"):
        serve.ReplicaSet([])


@pytest.mark.parametrize("how", ["rehome", "spill"])
def test_fleet_block_shipping_through_shared_tier(tiny, how):
    """A drain (``remove_replica``) or a spill verdict ships the affine
    replica's prefix blocks through the shared host tier: the new home
    restores them (restores > 0) and prefills fewer tokens than a fleet
    without the tier, with the same tokens — as the JAX fleet does."""
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, 50, size=24).astype(np.int32)
    blockers_p = [rng.integers(1, 50, size=20) for _ in range(3)]
    out = {}
    for pkg in ("port", "jax"):
        for tiered in (False, True):
            tier_cls = serve.HostTier if pkg == "port" else JHostTier
            tier = tier_cls(64 << 20) if tiered else None
            f = fleet(pkg, tiny, 2, spill_queue_depth=1 if how == "spill" else 4,
                      enable_prefix_cache=True, num_blocks=24, host_tier=tier)
            first = f.submit(prompt, 4)
            src = first.extra["replica"]
            f.run_until_complete()
            if how == "rehome":
                f.remove_replica(src)
            else:
                for b in blockers_p:
                    f.submit(b, 4, replica=src)
            again = f.submit(prompt, 4)
            dst = again.extra["replica"]
            assert dst != src and (how == "rehome" or again.extra.get("spilled"))
            pf0 = f.engines[dst].metrics.snapshot()["mixed_prefill_tokens"]
            if tier is not None:
                tier.drain()
            f.run_until_complete()
            snap = f.engines[dst].metrics.snapshot()
            out[pkg, tiered] = (list(again.generated) == list(first.generated),
                                snap["mixed_prefill_tokens"] - pf0,
                                snap.get("tier_restored_blocks", 0) > 0)
            if tier is not None:
                tier.close()
    assert out["port", True] == out["jax", True] and out["port", False] == out["jax", False]
    same, pf_tier, restored = out["port", True]
    assert same and restored and pf_tier < out["port", False][1]


def test_elastic_scale_down_under_load(tiny):
    """``remove_replica`` with streams in flight: each completes on a peer
    with the unrolled tokens (equal to the JAX fleet's), the removed
    replica is retired and never routed to again."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 256, size=int(rng.integers(4, 14))) for _ in range(12)]
    control = fleet("port", tiny, 3)
    for i, p in enumerate(prompts):
        control.submit(p, 6, seed=i)
    control.run_until_complete()
    out = {}
    for pkg in ("port", "jax"):
        f = fleet(pkg, tiny, 3)
        for i, p in enumerate(prompts):
            f.submit(p, 6, seed=i)
        for _ in range(2):
            f.step()
        victim = next(i for i, e in enumerate(f.engines) if e._requests)
        drained = f.remove_replica(victim)
        assert drained and f.alive[victim] is False
        f.run_until_complete()
        post = f.submit(prompts[0], 2, seed=50)
        f.run_until_complete()
        assert post.extra["replica"] != victim
        snap = f.snapshot()
        out[pkg] = (victim, drained, streams(f)[:12], snap["alive_replicas"], snap["finished"])
        if pkg == "port":
            assert f.engines[victim].retired
    assert out["port"] == out["jax"]
    assert out["port"][2] == streams(control) and out["port"][3:] == (2, 13)


def test_add_replica_captures_before_routing(tiny):
    """A spilling 2-replica fleet grows by a clone of a live replica: the
    source keeps serving (not retired), the clone has captured every
    bucket its source captured before the router names it (and carries
    fresh metrics, no journal), takes first-sight traffic, and no capture
    happens in any replica while the new traffic is served."""
    f = fleet("port", tiny, 2, spill_queue_depth=2, enable_prefix_cache=True)
    for e in f.engines:
        e.warmup([3], max_new_tokens=4)
    hot = np.arange(1, 25, dtype=np.int32)
    for _ in range(10):
        f.submit(hot, 4, seed=0)
    f.run_until_complete()
    assert f.router.spilled > 0
    counts = dict(f.engines[0].compile_counts())
    idx = f.add_replica()
    new = f.engines[idx]
    assert idx == 2 and f.alive == [True] * 3 and not f.engines[0].retired
    assert dict(new.compile_counts()) == counts
    assert new.metrics is not f.engines[0].metrics and new.journal is None
    assert new.metrics.snapshot()["lifecycle_actions"] == {"add_replica": 1}
    runs = {id(r): r.calls for e in f.engines for r in e.graph_steps()}
    rng = np.random.default_rng(3)
    homes = {f.submit(rng.integers(1, 256, size=9), 3, seed=i).extra["replica"]
             for i in range(6)}
    f.run_until_complete()
    assert idx in homes
    assert all(dict(e.compile_counts()) == counts for e in f.engines)
    assert set(runs) <= {id(r) for e in f.engines for r in e.graph_steps()}


# ----------------------------------------------------------------------
# the HTTP fleet
# ----------------------------------------------------------------------

def direct(m, prompts, n):
    eng = engine("port", m)
    reqs = [eng.submit(p, n) for p in prompts]
    eng.run_until_complete()
    return [list(r.generated) for r in reqs]


def test_http_replica_fleet_e2e(tiny):
    """2 replicas behind ``HttpServer``: 8 concurrent streams finish with a
    single engine's tokens, ``/healthz`` lists the replicas, the scrape
    carries replica-labelled series and the router's counters, and both
    replicas served."""
    engines = [engine("port", tiny) for _ in range(2)]
    runner = serve.ReplicaRunner(engines, spill_queue_depth=None)
    rng = np.random.default_rng(21)
    ps = [list(map(int, rng.integers(1, 256, size=n))) for n in (5, 9, 5, 12, 7, 9, 4, 11)]

    async def main():
        srv = HttpServer(engines[0], model_id="tiny", drain_timeout=10.0, runner=runner)
        await srv.start("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        st, body = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
        payload = json.loads(body)
        assert st == 200 and payload["status"] == "ok"
        assert [r["replica"] for r in payload["replicas"]] == [0, 1]
        assert [r["state"] for r in payload["replicas"]] == ["ok", "ok"]
        results = await asyncio.gather(*(astream_completion(
            srv.host, srv.port, {"prompt": p, "max_tokens": 4, "stream": True}) for p in ps))
        for want, res in zip(direct(tiny, ps, 4), results):
            assert res["finish_reason"] == "length" and res["token_ids"] == want
        st, scrape = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/metrics")
        text = scrape.decode()
        assert 'llm_serve_requests_finished_total{replica="0"}' in text
        assert 'llm_serve_requests_finished_total{replica="1"}' in text
        assert 'llm_serve_ttft_seconds_bucket{le="+Inf",replica="0"}' in text
        routed = int(next(ln.split()[-1] for ln in text.splitlines()
                          if ln.startswith("llm_serve_router_routed_total")))
        assert routed == len(ps)
        fin = {ln.split()[-1] for ln in text.splitlines()
               if ln.startswith("llm_serve_requests_finished_total")}
        assert fin and fin != {"0"}
        st, _ = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/debug/slo")
        assert st == 404
        srv.begin_drain()
        await srv.serve_until_shutdown()

    run(main(), timeout=120)
    assert sum(len(e.scheduler.aborted) + runner.replicas[i].inflight
               for i, e in enumerate(engines)) == 0


def test_http_replica_crash_drains_to_peer(tiny):
    """A ``tick_crash`` on one replica (no restart budget) while its peer
    serves: the dead replica's streams are drained to the peer and finish
    with a single engine's tokens, the peer's own streams are unchanged,
    ``/healthz`` reads ``degraded`` with the dead replica ``crashed``, and
    new work routes around it."""
    inj = serve.FaultInjector("tick_crash@3")
    engines = [engine("port", tiny, fault_injector=inj if i == 0 else None) for i in range(2)]
    runner = serve.ReplicaRunner(engines, spill_queue_depth=None)
    rng = np.random.default_rng(5)
    ps = [list(map(int, rng.integers(1, 256, size=10))) for _ in range(6)]
    want = direct(tiny, ps, 8)

    async def main():
        srv = HttpServer(engines[0], model_id="tiny", drain_timeout=10.0, runner=runner)
        await srv.start("127.0.0.1", 0)
        loop = asyncio.get_running_loop()
        results = await asyncio.gather(*(astream_completion(
            srv.host, srv.port, {"prompt": p, "max_tokens": 8, "stream": True}) for p in ps))
        for w, res in zip(want, results):
            assert res["finish_reason"] == "length" and res["token_ids"] == w
        st, body = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/healthz")
        payload = json.loads(body)
        assert st == 200 and payload["status"] == "degraded"
        assert [r["state"] for r in payload["replicas"]] == ["crashed", "ok"]
        assert runner.serving_engines() == [engines[1]]
        res = await astream_completion(srv.host, srv.port,
                                       {"prompt": ps[0], "max_tokens": 8, "stream": True})
        assert res["token_ids"] == want[0]
        srv.begin_drain()
        await srv.serve_until_shutdown()

    run(main(), timeout=120)
    assert inj.injected_total == 1


def test_http_drain_prefers_same_version_peer(tiny):
    """A mid-roll drain adopts streams onto a peer still on the draining
    replica's version when one exists, else onto any live peer."""
    runner = serve.ReplicaRunner([engine("port", tiny) for _ in range(3)])
    runner.replicas[0].engine.weights_version = 1  # already rolled
    rec = {"rid": 1, "prompt": [7] * 6, "tokens": [3], "max_tokens": 6, "seed": 0}
    assert runner._drain_dead(1, [dict(rec)], prefer_version=0) == {1}
    assert runner._owner[1] == 2
    runner._dead.discard(1)
    runner.replicas[2].engine.weights_version = 1
    assert runner._drain_dead(1, [dict(rec, rid=2)], prefer_version=0) == {2}
    assert runner._owner[2] in (0, 2)


# ----------------------------------------------------------------------
# launch counts shared by tick threads
# ----------------------------------------------------------------------

def test_launch_counts_exact_under_threads():
    """Wrappers count through one lock: more threads than cores adding at
    once, switching every few microseconds, lose nothing (the
    read-modify-write a bare ``+=`` does would)."""
    import os
    import sys

    fn = da.ragged_paged_attention
    before = fn.launches
    n_threads, per = (os.cpu_count() or 4) + 4, 5000

    def hammer():
        for _ in range(per):
            _common.count(fn, "launches")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        assert fn.launches - before == n_threads * per
    finally:
        sys.setswitchinterval(interval)
        fn.launches = before


def test_launch_recording_is_per_thread():
    """A capture's record (``recording``) holds its own thread's counts
    only: a peer thread counting meanwhile moves the real counter, and
    the recording thread's counts land in the record, not the counter."""
    fn = da.ragged_paged_attention
    before = fn.launches
    inside, peer_done = threading.Event(), threading.Event()

    def peer():
        inside.wait(5.0)
        for _ in range(500):
            _common.count(fn, "launches")
        peer_done.set()

    t = threading.Thread(target=peer)
    t.start()
    with _common.recording() as moves:
        inside.set()
        for _ in range(16):
            _common.count(fn, "launches")
        _common.count(fn, "combine_launches", 2)
        peer_done.wait(5.0)
        with pytest.raises(RuntimeError, match="nest"):
            with _common.recording():
                pass
    t.join(10.0)
    assert not t.is_alive()
    assert moves == {(fn, "launches"): 16, (fn, "combine_launches"): 2}
    assert fn.launches - before == 500
    fn.launches = before
    # a replay adds its record through the same lock; on the CPU a step
    # runs eagerly and counts nothing of its own
    step = graphs.CapturedStep(lambda: None, torch.device("cpu"), "probe")
    step()
    assert step.compiled and graphs.TOTALS["captures"] >= 0
