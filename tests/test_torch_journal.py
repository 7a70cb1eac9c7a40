"""The port's durable request journal (``serve/journal.py``), request log
(``serve/request_log.py``) and their engine and runner hooks, against the
JAX package's, on the CPU in float32.

Journal files cross packages: what the port writes replays under the JAX
``scan_journal`` to the same state (and the JAX package's under the
port's), record for record; a torn tail is truncated on reopen, a
corrupt frame stops replay, compaction replays the same, and the chaos
sites drop and count a batch in both.  The same trace through the port's
and the JAX engine writes the same journal records and request-log
lines.  A journal a dead engine (of either package) left behind replays
on a fresh runner, whose streams a Last-Event-ID resume then follows
token for token; and a real server process killed by its ``proc_kill``
site leaves a journal that resumes every stream.
"""

import asyncio
import dataclasses
import json
import os
import struct
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu import serve as jserve
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.serve import journal as jjournal
from llm_np_cp_tpu.serve import request_log as jrequest_log
from llm_np_cp_tpu.serve.faults import FaultInjector as JFaultInjector
from llm_np_cp_tpu.serve.scheduler import Request as JRequest
from llm_np_cp_tpu_torch import serve
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import journal, request_log
from llm_np_cp_tpu_torch.serve.faults import FaultInjector
from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
from llm_np_cp_tpu_torch.serve.http.server import HttpServer
from llm_np_cp_tpu_torch.serve.scheduler import Request
from test_torch_http import np_params

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# package → (journal module, request_log module, Request class, injector)
PKGS = {"port": (journal, request_log, Request, FaultInjector),
        "jax": (jjournal, jrequest_log, JRequest, JFaultInjector)}
NEW_TOKENS = 8


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
    """(port config, port params, JAX config, JAX params, numpy params)."""
    cfg = tiny_config("llama")
    npp = np_params(cfg, 0)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    return (cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp),
            npp)


def mk_req(pkg, rid, prompt, max_tokens=8, seed=0, generated=(), deadline=None, **extra):
    req = PKGS[pkg][2](req_id=rid, prompt=np.asarray(prompt, np.int32),
                       max_new_tokens=max_tokens, seed=seed)
    req.generated = list(generated)
    req.deadline = deadline
    req.speculative = extra.pop("speculative", False)
    req.tenant = extra.pop("tenant", "default")
    req.extra.update(extra)
    return req


def write_history(pkg, path, **kw):
    """One journal history through ``pkg``'s RequestJournal: admissions
    (one with a deadline, a trace, lineage, a spec opt-in, a weight
    version and a tenant), watermarks, a recovery re-admission, a
    terminal and an unknown rid's terminal."""
    j = PKGS[pkg][0].RequestJournal(path, **kw)
    a = mk_req(pkg, 3, [1, 2, 3], max_tokens=6, seed=9, deadline=130.0, trace="ab" * 16,
               replays=1, drains=2, weights_version=4, speculative=True, tenant="team-a")
    b = mk_req(pkg, 4, [5, 6], max_tokens=5, seed=2)
    j.admit(a, now=100.0)
    j.admit(b, now=100.0)
    a.generated += [7, 8]
    b.generated += [1]
    j.end_tick([a, b])
    b.generated += [2, 3]
    j.end_tick([a, b])
    j.terminal(4, "length")
    j.terminal(5, "stop")
    a2 = mk_req(pkg, 3, [1, 2, 3], max_tokens=6, seed=9, generated=[7, 8, 9],
                trace="ab" * 16, replays=2, drains=2, weights_version=4, speculative=True,
                tenant="team-a")
    j.admit(a2, now=100.0)
    assert j.flush(5.0)
    j.close()
    return j


def records(path, mod):
    """The journal's records with the wall-clock fields dropped."""
    out = []
    for rec in mod.iter_records(path):
        rec = dict(rec)
        rec.pop("wall", None)
        rec.pop("deadline_wall", None)
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Files across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_journal_files_replay_across_packages(tmp_path, writer, reader):
    """A history written by one package scans under the other to the same
    live state, valid prefix and epoch, record for record; both packages
    write the same records; and the reader's reopen continues it."""
    path = str(tmp_path / "j")
    write_history(writer, path)
    wmod, rmod = PKGS[writer][0], PKGS[reader][0]
    assert rmod.scan_journal(path) == wmod.scan_journal(path)
    state, end, epoch = rmod.scan_journal(path)
    assert end == os.path.getsize(path) and epoch == 1
    assert list(state) == [3] and state[3]["tokens"] == [7, 8, 9]
    assert (state[3]["spec"], state[3]["tenant"], state[3]["replays"], state[3]["wv"]) == (
        True, "team-a", 2, 4)
    assert records(path, rmod) == records(path, wmod)
    other = str(tmp_path / "other")
    write_history(reader, other)
    assert records(other, rmod) == records(path, wmod)
    reopened = rmod.RequestJournal(path)
    assert reopened.epoch == 2
    replay = reopened.replay()
    assert [r["rid"] for r in replay] == [3] and replay[0]["prompt"].tolist() == [1, 2, 3]
    reopened.terminal(3, "length")
    assert reopened.flush(5.0)
    reopened.close()
    assert wmod.scan_journal(path)[0] == {}


@pytest.mark.parametrize("writer,reopener", [("port", "port"), ("jax", "port"),
                                             ("port", "jax")])
@pytest.mark.parametrize("damage", ["torn", "corrupt"])
def test_damaged_tail_stops_replay_and_is_truncated(tmp_path, writer, reopener, damage):
    """A kill -9 mid-write leaves a torn frame, and a flipped byte fails
    its CRC: replay keeps the valid prefix in both packages, and a reopen
    truncates the file to it before appending."""
    path = str(tmp_path / "j")
    j = PKGS[writer][0].RequestJournal(path)
    j.admit(mk_req(writer, 1, [4, 5]), now=0.0)
    assert j.flush(5.0)
    good = os.path.getsize(path)
    j.admit(mk_req(writer, 2, [6, 7]), now=0.0)
    assert j.flush(5.0)
    j.close()
    if damage == "torn":
        with open(path, "ab") as f:
            f.write(struct.pack("<II", 500, 123) + b"torn")
        keep = [1, 2]
        good = os.path.getsize(path) - 12
    else:
        data = bytearray(open(path, "rb").read())
        data[data.rindex(b'"rid":2') + 7] ^= 0xFF
        open(path, "wb").write(bytes(data))
        keep = [1]
    for mod in (journal, jjournal):
        state, valid_end, _ = mod.scan_journal(path)
        assert sorted(state) == keep and valid_end == good
    j2 = PKGS[reopener][0].RequestJournal(path)
    assert os.path.getsize(path) <= good + 64  # truncated, plus the new epoch
    j2.admit(mk_req(reopener, 9, [3]), now=0.0)
    assert j2.flush(5.0)
    j2.close()
    for mod in (journal, jjournal):
        assert sorted(mod.scan_journal(path)[0]) == keep + [9]


def test_compaction_replays_the_same_under_both(tmp_path):
    """Past ``compact_bytes`` the writer rewrites the file as one admission
    per live request: both packages' replay of it equals the full
    history's, and the file stays bounded by the live set."""
    path = str(tmp_path / "j")
    j = journal.RequestJournal(path, compact_bytes=512)
    req = mk_req("port", 1, [3] * 4, max_tokens=10_000, trace="cd" * 16, replays=1)
    done = mk_req("port", 2, [5], max_tokens=10_000)
    j.admit(req, now=0.0)
    j.admit(done, now=0.0)
    for i in range(300):
        req.generated.append(i % 50)
        j.end_tick([req])
        if i == 10:
            j.terminal(2, "aborted")
    assert j.flush(10.0)
    assert j.stats()["compactions"] >= 1
    j.close()
    for mod in (journal, jjournal):
        state, _, _ = mod.scan_journal(path)
        assert list(state) == [1] and state[1]["tokens"] == [i % 50 for i in range(300)]
        assert state[1]["trace"] == "cd" * 16 and state[1]["replays"] == 1
    assert os.path.getsize(path) < 8 * 512


def test_chaos_sites_degrade_as_in_jax(tmp_path):
    """``journal_write`` drops a batch and ``journal_fsync`` fails a sync:
    both counted, serving continues, and the counts and surviving state
    equal the JAX journal's under the same spec."""
    out = {}
    for pkg in PKGS:
        jmod, _, _, inj_cls = PKGS[pkg]
        path = str(tmp_path / pkg)
        j = jmod.RequestJournal(path, fault_injector=inj_cls("journal_write@2;journal_fsync@4"))
        for rid in range(6):
            j.admit(mk_req(pkg, rid, [1 + rid]), now=0.0)
            assert j.flush(5.0)
        stats = j.stats()
        j.close()
        # the epoch record's wall time makes bytes_written vary by a digit
        out[pkg] = ({k: v for k, v in stats.items() if k not in ("fsync_p99_s", "bytes_written")},
                    sorted(jmod.scan_journal(path)[0]))
    assert out["port"] == out["jax"]
    assert out["port"][0]["write_errors"] == 1 and out["port"][0]["fsync_errors"] == 1
    assert len(out["port"][1]) == 5


def test_deadline_resumes_the_remaining_wall_budget(tmp_path):
    path = str(tmp_path / "j")
    j = journal.RequestJournal(path)
    j.admit(mk_req("port", 1, [2, 3], deadline=130.0), now=100.0)
    assert j.flush(5.0)
    j.close()
    remaining = journal.RequestJournal(path).replay()[0]["deadline_wall"] - time.time()
    assert 25.0 < remaining <= 30.0


# ---------------------------------------------------------------------------
# The request log's record
# ---------------------------------------------------------------------------

def timed(pkg, **kw):
    req = mk_req(pkg, 7, [1, 2, 3, 4], max_tokens=5, generated=[9, 8, 7], **kw)
    req.submit_time, req.admit_time, req.first_token_time, req.finish_time = 1.0, 1.5, 2.0, 3.0
    req.prefill_s = 0.25
    req.n_shared_blocks, req.n_preemptions = 2, 1
    return req


RECORDS = {
    "finished": lambda pkg: timed(pkg),
    "recovered": lambda pkg: timed(pkg, trace="ef" * 16, replays=2, drains=1,
                                   weights_version=3, tenant="team-b", spilled=True),
    "untimed": lambda pkg: mk_req(pkg, 8, [5], generated=[1]),
    "arrival_wall": lambda pkg: timed(pkg, arrival_wall=0.5),
}


@pytest.mark.parametrize("case", list(RECORDS))
@pytest.mark.parametrize("reason", ["length", "aborted"])
def test_request_record_matches_jax(case, reason):
    got = request_log.request_record(RECORDS[case]("port"), reason=reason, clock=lambda: 4.0)
    want = jrequest_log.request_record(RECORDS[case]("jax"), reason=reason, clock=lambda: 4.0)
    assert got.pop("ts") > 0 and want.pop("ts") > 0
    assert got == want


def test_request_log_file_reads_as_jax_reads_it(tmp_path):
    log = request_log.RequestLog(str(tmp_path / "r.jsonl"))
    recs = [request_log.request_record(RECORDS[c]("port"), reason="stop") for c in RECORDS]
    for rec in recs:
        log.emit(rec)
    assert log.flush(5.0)
    log.close()
    with open(log.path, "a") as f:
        f.write('{"torn": ')
    assert request_log.read_request_log(log.path) == jrequest_log.read_request_log(log.path) \
        == json.loads(json.dumps(recs))
    assert log.stats() == {"records": len(recs), "write_errors": 0}


# ---------------------------------------------------------------------------
# Engine hooks
# ---------------------------------------------------------------------------

def engines(models, pkg, tmp_path, **kw):
    """``pkg``'s engine with a journal and a request log, the same geometry."""
    cfg, tp, jcfg, jp = models[:4]
    jmod, rmod = PKGS[pkg][:2]
    jl = jmod.RequestJournal(str(tmp_path / f"{pkg}.journal"))
    rl = rmod.RequestLog(str(tmp_path / f"{pkg}.requests"))
    geo = dict(max_slots=2, num_blocks=32, block_size=8, max_seq_len=64, mixed_step="on",
               journal=jl, request_log=rl, **kw)
    if pkg == "jax":
        return jserve.ServeEngine(jp, jcfg, sampler=JSampler("greedy"),
                                  cache_dtype=jnp.float32, **geo)
    return serve.ServeEngine(tp, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                             device="cpu", **geo)


def plain_engine(models, **kw):
    cfg, tp = models[:2]
    return serve.ServeEngine(tp, cfg, sampler=Sampler("greedy"), max_slots=2, num_blocks=32,
                             block_size=8, max_seq_len=64, mixed_step="on",
                             cache_dtype=torch.float32, device="cpu", **kw)


def uninterrupted(models, prompts):
    """Prompt j's tokens (seeded j) from an uninterrupted port run, by seed."""
    ref = plain_engine(models)
    for j, p in enumerate(prompts):
        ref.submit(p, NEW_TOKENS, seed=j)
    ref.run_until_complete()
    return {r.seed: list(r.generated) for r in ref.scheduler.finished}


def prompts_of(seed, lens=(6, 11, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in lens]


def test_engine_writes_the_jax_engines_records(llama, tmp_path):
    """The same submissions through both engines: the journals hold the
    same admissions, per-tick watermarks and terminals, and the request
    logs the same lines apart from wall time and phase timings."""
    prompts = prompts_of(1)
    out = {}
    for pkg in PKGS:
        eng = engines(llama, pkg, tmp_path)
        for j, p in enumerate(prompts):
            eng.submit(p, NEW_TOKENS, seed=j, trace_id=f"{j:032x}")
        eng.step()
        eng.abort(2)
        eng.run_until_complete()
        eng.journal.close()
        eng.request_log.close()
        lines = [{k: v for k, v in ln.items() if k not in ("ts", "phases")}
                 for ln in PKGS[pkg][1].read_request_log(eng.request_log.path)]
        out[pkg] = records(eng.journal.path, PKGS[pkg][0]), lines
    assert out["port"] == out["jax"]
    recs, lines = out["port"]
    assert [r["t"] for r in recs].count("wm") > 1 and [r["t"] for r in recs].count("fin") == 3
    assert sorted(ln["reason"] for ln in lines) == ["aborted", "length", "length"]


@pytest.mark.http
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_replays_on_a_fresh_runner_then_resumes(llama, tmp_path, writer):
    """An engine (of either package) abandoned mid-decode leaves its
    journal; a fresh port runner replays it teacher-forced at
    construction, each client resumes by Last-Event-ID with exactly its
    missing suffix, and a finished stream stays re-readable.  The clean
    drain leaves an empty replay set."""
    prompts = prompts_of(2)
    want = uninterrupted(llama, prompts)
    dead = engines(llama, writer, tmp_path)
    reqs = [dead.submit(p, NEW_TOKENS, seed=j) for j, p in enumerate(prompts)]
    for _ in range(4):
        dead.step()
    partial = {r.req_id: list(r.generated) for r in reqs}
    assert any(partial.values()) and not all(len(t) == NEW_TOKENS for t in partial.values())
    dead.journal.close()  # the process dies here: no terminal reaches the file
    dead.request_log.close()

    jl = journal.RequestJournal(dead.journal.path)
    eng = plain_engine(llama, journal=jl)

    async def main():
        srv = HttpServer(eng, model_id="tiny", drain_timeout=10.0)
        assert srv.runner.journal_replayed == len(reqs)
        await srv.start("127.0.0.1", 0)
        outs = await asyncio.gather(*(astream_completion(
            srv.host, srv.port, {"model": "tiny", "request_id": f"cmpl-{r.req_id}",
                                 "last_event_id": len(partial[r.req_id]), "stream": True},
            timeout=60) for r in reqs))
        loop = asyncio.get_running_loop()
        _, prom = await loop.run_in_executor(None, http_get, srv.host, srv.port, "/metrics")
        again = await astream_completion(
            srv.host, srv.port, {"model": "tiny", "request_id": f"cmpl-{reqs[0].req_id}",
                                 "last_event_id": 0, "stream": True}, timeout=30)
        snap = eng.metrics.snapshot()
        srv.begin_drain()
        await srv.serve_until_shutdown()
        return outs, prom.decode(), again, snap

    outs, prom, again, snap = asyncio.run(asyncio.wait_for(main(), timeout=120))
    for r, res in zip(reqs, outs):
        assert res["finish_reason"] == "length"
        assert partial[r.req_id] + res["token_ids"] == want[r.seed]
    assert again["token_ids"] == want[reqs[0].seed]
    assert f"llm_serve_journal_replayed_total {len(reqs)}" in prom
    assert "llm_serve_journal_resumed_total 3" in prom
    assert "llm_serve_journal_fsync_p99_s" in prom and "llm_serve_journal_epoch 2" in prom
    assert snap["recovered"] == sum(len(t) < NEW_TOKENS for t in partial.values())
    assert journal.scan_journal(jl.path)[0] == {}


CHILD = r"""
import sys
import numpy as np, torch
torch.set_num_threads(1)
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.serve import FaultInjector, RequestJournal, ServeEngine
from llm_np_cp_tpu_torch.serve.http.server import serve_forever

weights, journal_path, port_file = sys.argv[1:4]
flat = np.load(weights)
npp = {}
for key in flat.files:
    head, _, leaf = key.partition("/")
    if leaf:
        npp.setdefault(head, {})[leaf] = flat[key]
    else:
        npp[head] = flat[key]
cfg = tiny_config("llama")
eng = ServeEngine(params_from_jax(npp, device="cpu"), cfg, sampler=Sampler("greedy"),
                  max_slots=2, num_blocks=32, block_size=8, max_seq_len=64, mixed_step="on",
                  cache_dtype=torch.float32, device="cpu",
                  journal=RequestJournal(journal_path, sync_admissions=True),
                  fault_injector=FaultInjector("proc_kill@5"))
serve_forever(eng, model_id="tiny", host="127.0.0.1", port=0, port_file=port_file)
"""


@pytest.mark.http
def test_proc_kill_leaves_a_journal_that_resumes_every_stream(llama, tmp_path):
    """A real server process SIGKILLs itself at its fifth busy tick
    (``proc_kill@5``) with streams in flight: nothing drains or flushes,
    yet the journal on disk replays on a fresh runner and every client
    resumes its stream by Last-Event-ID to the uninterrupted tokens."""
    npp = llama[4]
    flat = {f"{k}/{n}": v for k, sub in npp.items() if isinstance(sub, dict)
            for n, v in sub.items()}
    flat.update({k: v for k, v in npp.items() if not isinstance(v, dict)})
    np.savez(tmp_path / "w.npz", **flat)
    jpath, pfile = str(tmp_path / "j"), str(tmp_path / "port")
    prompts = prompts_of(3)
    want = uninterrupted(llama, prompts)

    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path / "w.npz"), jpath,
                              pfile], env=env, stderr=subprocess.PIPE)
    try:
        t_end = time.time() + 60
        while not os.path.exists(pfile) and child.poll() is None and time.time() < t_end:
            time.sleep(0.05)
        host, port = open(pfile).read().split()

        async def clients():
            return await asyncio.gather(*(astream_completion(
                host, int(port), {"prompt": [int(t) for t in p], "max_tokens": NEW_TOKENS,
                                  "seed": j, "stream": True}, timeout=60)
                for j, p in enumerate(prompts)), return_exceptions=True)

        cut = asyncio.run(clients())
        assert child.wait(timeout=60) == -9
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        child.stderr.close()
    got = {j: (r["token_ids"], r.get("stream_id")) if isinstance(r, dict) else ([], None)
           for j, r in enumerate(cut)}
    assert all(len(t) < NEW_TOKENS for t, _ in got.values())

    jl = journal.RequestJournal(jpath)
    live = {rec["seed"]: rec["rid"] for rec in jl.replay()}
    assert sorted(live) == [0, 1, 2] and jl.epoch == 2
    eng = plain_engine(llama, journal=jl)

    async def resume():
        srv = HttpServer(eng, model_id="tiny", drain_timeout=10.0)
        await srv.start("127.0.0.1", 0)
        outs = {}
        for seed, rid in live.items():
            outs[seed] = await astream_completion(
                srv.host, srv.port, {"request_id": f"cmpl-{rid}", "stream": True,
                                     "last_event_id": len(got[seed][0])}, timeout=60, retries=20, backoff_s=0.05)
        srv.begin_drain()
        await srv.serve_until_shutdown()
        return outs

    outs = asyncio.run(asyncio.wait_for(resume(), timeout=120))
    for seed, res in outs.items():
        assert res["finish_reason"] == "length"
        assert got[seed][0] + res["token_ids"] == want[seed]


@pytest.mark.http
def test_a_client_holds_only_journaled_tokens(llama, tmp_path):
    """With the journal's writer held back 0.3 s a batch, a client that
    cuts its stream after three events finds every token it holds
    already in the journal file: stream events wait for the journal
    (write-ahead delivery), so a ``kill -9`` never leaves a client
    holding a token the restarted server would have to regenerate (in
    bf16 a regenerated token can differ from it).  The stream still
    runs to the uninterrupted tokens."""
    prompt = prompts_of(4)[0]
    want = uninterrupted(llama, [prompt])[0]
    jl = journal.RequestJournal(str(tmp_path / "j"))
    write = jl._writer_batch

    def held_back(batch):
        time.sleep(0.3)
        write(batch)

    jl._writer_batch = held_back
    eng = plain_engine(llama, journal=jl)
    body = {"model": "tiny", "prompt": [int(t) for t in prompt], "max_tokens": NEW_TOKENS,
            "seed": 0, "stream": True}

    async def main():
        srv = HttpServer(eng, model_id="tiny", drain_timeout=10.0)
        await srv.start("127.0.0.1", 0)
        cut = await astream_completion(srv.host, srv.port, body, timeout=60,
                                       disconnect_after=3)
        on_disk = list(journal.iter_records(jl.path))
        full = await astream_completion(srv.host, srv.port, body, timeout=60)
        srv.begin_drain()
        await srv.serve_until_shutdown()
        return cut, on_disk, full

    cut, on_disk, full = asyncio.run(asyncio.wait_for(main(), timeout=120))
    rid = int(cut["stream_id"].rsplit("-", 1)[1])
    # the request's tokens in the file, finished or not (a tiny model
    # may have run to its end before the writer's first batch)
    durable = [t for rec in on_disk if rec["t"] == "adm" and rec["rid"] == rid
               for t in rec["tokens"]]
    durable += [t for rec in on_disk if rec["t"] == "wm"
                for r, _, toks in rec["rows"] if r == rid for t in toks]
    assert cut["token_ids"], cut
    assert durable[:len(cut["token_ids"])] == cut["token_ids"], (durable, cut["token_ids"])
    assert full["finish_reason"] == "length" and full["token_ids"] == want


@pytest.mark.http
def test_a_stream_that_ended_before_the_kill_resumes(llama, tmp_path):
    """A request whose ``fin`` reached the journal before a ``kill -9``
    leaves the replay set, yet its client may lack the tail (write-ahead
    delivery sends it only after the ``fin`` is on disk).  A fresh runner
    parks it: a Last-Event-ID resume gets the missing suffix and the
    finish, a fresh request never takes its id, and a stream drained to
    a peer is not parked (404)."""
    jl = journal.RequestJournal(str(tmp_path / "j"))
    done = mk_req("port", 5, [3, 1, 4], max_tokens=6, seed=2)
    drained = mk_req("port", 6, [2, 7], max_tokens=6, seed=3)
    jl.admit(done, now=0.0)
    jl.admit(drained, now=0.0)
    done.generated += [11, 12, 13, 14, 15, 16]
    drained.generated += [21, 22]
    jl.end_tick([done, drained])
    jl.terminal(5, "length")
    jl.terminal(6, "drained")
    assert jl.flush(5.0)
    jl.close()

    jl = journal.RequestJournal(jl.path)
    assert jl.replay() == [] and [r["rid"] for r in jl.replay_finished()] == [5, 6]
    eng = plain_engine(llama, journal=jl)

    async def main():
        srv = HttpServer(eng, model_id="tiny", drain_timeout=10.0)
        await srv.start("127.0.0.1", 0)
        tail = await astream_completion(srv.host, srv.port, {
            "model": "tiny", "request_id": "cmpl-5", "last_event_id": 2, "stream": True},
            timeout=30)
        gone = await astream_completion(srv.host, srv.port, {
            "model": "tiny", "request_id": "cmpl-6", "last_event_id": 2, "stream": True},
            timeout=30)
        fresh = await astream_completion(srv.host, srv.port, {
            "model": "tiny", "prompt": [1, 2, 3], "max_tokens": 2, "stream": True}, timeout=30)
        srv.begin_drain()
        await srv.serve_until_shutdown()
        return tail, gone, fresh

    tail, gone, fresh = asyncio.run(asyncio.wait_for(main(), timeout=120))
    assert tail["token_ids"] == [13, 14, 15, 16] and tail["finish_reason"] == "length"
    assert gone["status"] == 404
    assert int(fresh["stream_id"].rsplit("-", 1)[1]) > 6
