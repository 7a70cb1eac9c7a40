"""The port's command line (``llm_np_cp_tpu_torch.cli``) against the JAX
package's (``llm_np_cp_tpu.cli``), on the CPU in float32.

One argv drives both CLIs: the JAX one with ``--backend=tpu`` (JAX on the
CPU, its Pallas kernels in interpret mode), the port's with
``--backend=cpu`` (its kernels' plain versions).  Both load the same
weights (the JAX ``init_params``, as numpy, converted) through a swapped
``_load``, and both use ``FakeTokenizer``, whose ``decode`` is lossless
(one character a token id), so equal text is equal tokens.  Greedy text
must be equal; sampled text equal up to the JAX side's first near-tie
(``sampled_parity``); the a8 weight modes up to one int8 rounding step.
Also here: the numpy oracle backend, ``serve-bench --json``, the ``serve``
subcommand over HTTP, every rejection with the JAX message, the three
parsers' flags and defaults, ``load_model``, and ``utils/profiling``.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_np_cp_tpu.cli as jcli
from llm_np_cp_tpu import config as jconfig
from llm_np_cp_tpu.backends import numpy_ref as jnumpy_ref
from llm_np_cp_tpu.models import transformer as jtf
from llm_np_cp_tpu.ops.sampling import Sampler as JSampler
from llm_np_cp_tpu.quant import quantize_params as jquantize_params
from llm_np_cp_tpu_torch import cli as tcli
from llm_np_cp_tpu_torch.backends import numpy_ref as tnumpy_ref
from llm_np_cp_tpu_torch.config import tiny_config
from llm_np_cp_tpu_torch.convert import params_from_jax
from llm_np_cp_tpu_torch.parallel.launch import run_ranks
from llm_np_cp_tpu_torch.utils import loading as tloading
from llm_np_cp_tpu_torch.utils import profiling
from mesh_ranks import BASE, FakeTokenizer, cli_in_rank
from sampled_parity import assert_prefix_parity, generate_margins, stream_margins


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REAL_LOAD = tcli._load


def token_ids(text: str) -> list[int]:
    return [ord(c) - BASE for c in text]


@pytest.fixture(scope="module")
def weights():
    """(port config, port params, JAX config, JAX params): the JAX
    ``init_params`` weights, as numpy, on both sides."""
    cfg = tiny_config("llama")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    npp = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jcfg,
                                                   dtype=jnp.float32))
    return cfg, params_from_jax(npp, device="cpu"), jcfg, jax.tree.map(jnp.asarray, npp)


@pytest.fixture
def clis(monkeypatch, weights):
    """Both CLIs' ``_load`` swapped for the shared weights; ``run(argv)``
    → (JAX text, port text) of one argv (the JAX CLI with
    ``--backend=tpu``, the port's with ``--backend=cpu``)."""
    cfg, tp, jcfg, jp = weights
    monkeypatch.setattr(jcli, "_load", lambda args: (FakeTokenizer(), jp, jcfg))
    monkeypatch.setattr(tcli, "_load", lambda args: (FakeTokenizer(), tp, cfg))

    def run(argv, backend="cpu"):
        jax_backend = "numpy" if backend == "numpy" else "tpu"
        return (jcli.run([f"--backend={jax_backend}", *argv]),
                tcli.run([f"--backend={backend}", *argv]))

    return run


COMMON = ["--max-tokens=8", "--dtype=f32", "--prompt=hello there"]

# greedy runs: the printed text must be equal
GREEDY = {
    "stream": [],
    "no_stream": ["--no-stream"],
    "metrics": ["--no-stream", "--metrics"],
    "flash_and_decode_kernels": ["--no-stream", "--attn-impl=flash", "--decode-attn=pallas"],
    "flash_prefill_alias": ["--no-stream", "--flash-prefill"],
    "prefill_chunk": ["--no-stream", "--prefill-chunk=3"],
    "early_stop": ["--no-stream", "--early-stop"],
    "cache_int8": ["--no-stream", "--cache-dtype=int8"],
    "max_seq_len": ["--no-stream", "--max-seq-len=40"],
    "quantize_int8": ["--no-stream", "--quantize=int8"],
    "quantize_int4": ["--no-stream", "--quantize=int4"],
    "top_k_1": ["--no-stream", "--sampler=top_k", "--top-k=1"],
    "top_p_0": ["--no-stream", "--sampler=top_p", "--top-p=0"],
    "speculative_int8": ["--speculative=2", "--metrics"],
    "speculative_int4": ["--speculative=2", "--draft=int4"],
    "speculative_trunc": ["--speculative=2", "--draft=trunc1"],
    "speculative_trunc_int4": ["--speculative=3", "--draft=trunc2_int4"],
    "speculative_trunc_quantized_target": ["--speculative=2", "--draft=trunc2",
                                           "--quantize=int8"],
    "speculative_prefill_chunk": ["--speculative=2", "--prefill-chunk=3"],
}


@pytest.mark.parametrize("extra", list(GREEDY.values()), ids=list(GREEDY))
def test_greedy_text_matches_jax(clis, extra, capsys):
    sampler = [] if any(a.startswith("--sampler") for a in extra) else ["--sampler=greedy"]
    want, got = clis([*COMMON, *sampler, *extra])
    assert len(token_ids(want)) > 0
    assert got == want
    out = capsys.readouterr()
    assert out.out.count(got) >= 2  # both printed it
    if "--metrics" in extra:
        assert ("accept" if "--speculative=2" in extra else "tok/s") in out.err


# sampled runs: equal up to the JAX side's first near-tie
SAMPLED = {
    "min_p_stream": (["--sampler=min_p", "--p-base=0.05"], JSampler("min_p", p_base=0.05)),
    "min_p": (["--sampler=min_p", "--no-stream"], JSampler("min_p")),
    "top_k": (["--sampler=top_k", "--top-k=5", "--no-stream"], JSampler("top_k", top_k=5)),
    "top_p": (["--sampler=top_p", "--top-p=0.8", "--no-stream", "--temperature=1.5"],
              JSampler("top_p", top_p=0.8, temperature=1.5)),
}


@pytest.mark.parametrize("case", list(SAMPLED))
@pytest.mark.parametrize("seed", [1, 7])
def test_sampled_text_matches_jax(clis, weights, case, seed):
    extra, sampler = SAMPLED[case]
    _, _, jcfg, jp = weights
    want, got = clis([*COMMON, f"--seed={seed}", *extra])
    w, g = token_ids(want), token_ids(got)
    prompt = FakeTokenizer()("hello there")["input_ids"]
    if "--no-stream" in extra:
        margins = generate_margins(jp, jcfg, sampler, prompt, np.asarray([w]), seed)
    else:
        margins = stream_margins(jp, jcfg, sampler, prompt[0], w, seed)[None]
    assert assert_prefix_parity([w], [g], margins, f"{case} seed {seed}") > 0


# A8_FLIP: the a8 modes quantize every layer's activations per row, and a
# hidden value ~1e-6 apart on the two sides (the libraries' summation
# order) can round to int8 values one step apart; such a flip moves the
# logits by up to 0.1 at this size (tests/test_torch_quant.py,
# test_forward_matches_jax).  A token may therefore differ where the JAX
# side's top-2 logit gap is within that, and nowhere else
# (ROADMAP.md queue 3, "int8 cache and W8A8 / W4A8 parity").
A8_FLIP = 0.1


@pytest.mark.parametrize("mode", ["int8_a8", "int4_a8"])
def test_a8_text_matches_jax_up_to_one_int8_step(clis, weights, mode):
    _, _, jcfg, jp = weights
    want, got = clis([*COMMON, "--sampler=greedy", "--no-stream", f"--quantize={mode}"])
    w, g = token_ids(want), token_ids(got)
    d = next((t for t, (x, y) in enumerate(zip(w, g)) if x != y), None)
    if d is None:
        assert len(g) == len(w)
        return
    qp = jquantize_params(jp, bits=4 if mode.startswith("int4") else 8, act_quant=True)
    prompt = FakeTokenizer()("hello there")["input_ids"][0].tolist()
    logits, _ = jtf.forward(qp, jnp.asarray([prompt + w[:d]], jnp.int32), jcfg, None)
    last = np.asarray(logits)[0, -1]
    assert last[w[d]] - last[g[d]] <= A8_FLIP, (mode, d, w, g)


PROMPTS = ["hi", "hello", "hello wo", "yo yo", "a"]
# the batch runs that run inside ranks (``mesh_in_ranks``)
BATCH_IN_RANKS = ("mesh_batch_size",)
BATCH = {
    "one_batch": [],
    "batch_size": ["--batch-size=2", "--metrics"],
    "prefill_chunk": ["--prefill-chunk=3"],
    "batch_size_prefill_chunk": ["--batch-size=3", "--prefill-chunk=2"],
    "speculative": ["--speculative=2", "--metrics"],
    "mesh_batch_size": ["--batch-size=2", "--mesh=2,1,2", "--metrics"],
}


def batch_argv(prompts_file, extra: list[str]) -> list[str]:
    return ["--sampler=greedy", "--max-tokens=5", "--dtype=f32",
            f"--prompts-file={prompts_file}", *extra]


@pytest.mark.parametrize("name", list(BATCH))
def test_prompts_file_matches_jax(clis, mesh_in_ranks, name, capsys):
    extra = BATCH[name]
    argv = batch_argv(mesh_in_ranks["prompts_file"], extra)
    if name in BATCH_IN_RANKS:
        want, (got, err) = jcli.run(["--backend=tpu", *argv]), mesh_in_ranks[name]
    else:
        want, got = clis(argv)
        err = capsys.readouterr().err
    assert got == want and len(got.split("\n")) == len(PROMPTS)
    if "--metrics" in extra:
        assert ("in 3 batches" if "--batch-size=2" in extra
                else "speculative ragged batch of 5") in err


@pytest.mark.parametrize("no_cache", [False, True], ids=["cache", "no_cache"])
def test_numpy_backend_matches_jax_and_the_torch_path(clis, no_cache):
    argv = [*COMMON[:1], "--prompt=hello there", "--sampler=greedy"] + (
        ["--no-cache"] if no_cache else [])
    want, got = clis(argv, backend="numpy")
    assert got == want
    _, torch_text = clis([*argv, "--dtype=f32"])
    assert got == torch_text


@pytest.mark.parametrize("sampler", ["min_p", "top_k", "top_p", "cdf"])
def test_numpy_backend_samplers_match_jax(clis, sampler):
    """The oracle's draws come from numpy's generator on both sides."""
    want, got = clis(["--max-tokens=6", f"--sampler={sampler}", "--seed=3", "--prompt=hi"],
                     backend="numpy")
    assert got == want


def test_numpy_ref_matches_jax_numpy_ref(weights):
    _, tp, jcfg, jp = weights
    cfg = weights[0]
    npp = jax.tree.map(np.asarray, jp)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    got, cache = tnumpy_ref.forward_np(npp, ids, cfg, tnumpy_ref.NpKVCache())
    want, _ = jnumpy_ref.forward_np(npp, ids, jcfg, jnumpy_ref.NpKVCache())
    np.testing.assert_array_equal(got, want)
    assert cache.num_items() == 7
    for use_cache in (True, False):
        assert (tnumpy_ref.greedy_generate_np(npp, ids[:1], cfg, 5, use_cache)
                == jnumpy_ref.greedy_generate_np(npp, ids[:1], jcfg, 5, use_cache))


# ----------------------------------------------------------------------
# serve-bench and serve
# ----------------------------------------------------------------------

SERVE_BENCH = {
    "unified": [],
    "split_paged": ["--mixed-step=off", "--attn-impl=paged"],
    "split_gather_decode_kernel": ["--mixed-step=off", "--decode-attn=pallas"],
    "prefix_cache": ["--prefix-cache", "--distinct-prompts=2", "--num-blocks=64",
                     "--prompt-len=24"],
    "speculative": ["--speculative-serve", "--spec-k=3", "--distinct-prompts=2"],
    "replicas": ["--replicas=2"],
}

# snapshot values that do not depend on the tick schedule (the replay's
# virtual clock follows the wall clock, so ticks, timings, queue depths
# and the prefill / decode split may differ between the two runs)
# the port's snapshot also derives each request's time per output token
# (serve/metrics.py; the JAX package has no such key)
PORT_ONLY_KEYS = {f"tpot_s_{s}" for s in ("p50", "p90", "p99", "mean")}
SCHEDULE_FREE = ("submitted", "finished", "aborted", "rejected", "total_generated_tokens",
                 "finish_reasons")


def _engines(monkeypatch, module) -> list:
    """Record every engine ``module._build_serve_engine`` builds."""
    built, orig = [], module._build_serve_engine

    def build(*a, **k):
        out = orig(*a, **k)
        built.append(out[0])
        return out

    monkeypatch.setattr(module, "_build_serve_engine", build)
    return built


def _finished(engines) -> dict:
    """Each finished trace request's tokens by (prompt, seed)."""
    return {(tuple(np.asarray(r.prompt).tolist()), r.seed): list(r.generated)
            for e in engines for r in e.scheduler.finished}


@pytest.mark.parametrize("extra", list(SERVE_BENCH.values()), ids=list(SERVE_BENCH))
def test_serve_bench_json_matches_jax(clis, monkeypatch, capsys, extra):
    argv = ["serve-bench", "--requests=6", "--rate=50", "--prompt-len=16", "--max-tokens=4",
            "--slots=2", "--block-size=8", "--seed=1", "--dtype=f32", "--cache-dtype=f32",
            "--json", *extra]
    jeng, teng = _engines(monkeypatch, jcli), _engines(monkeypatch, tcli)
    jcli.run(argv)
    want = json.loads(capsys.readouterr().out.strip().rsplit("\n", 1)[-1])
    out = tcli.run([argv[0], "--backend=cpu", *argv[1:]])
    printed = capsys.readouterr().out
    got = json.loads(printed.strip().rsplit("\n", 1)[-1])
    assert want.keys() <= got.keys() and got.keys() - want.keys() <= PORT_ONLY_KEYS, (
        set(got) ^ set(want))
    for k in SCHEDULE_FREE:
        assert got.get(k) == want.get(k), k
    assert got["finished"] == 6
    assert _finished(teng) == _finished(jeng) and len(_finished(teng)) >= 6
    assert "[serve-bench] 6 requests" in out
    if "--speculative-serve" in extra:
        assert "speculative serving ACTIVE: k=3" in printed
    if "--replicas=2" in extra:
        assert "-- replica 1 --" in out and "topo=2 replicas x (single chip)" in out


def test_serve_bench_observability_flags(clis, tmp_path, capsys):
    """The observability flags end to end, as the JAX CLI test drives them."""
    from llm_np_cp_tpu_torch.serve import read_request_log

    rl, tr = tmp_path / "requests.jsonl", tmp_path / "trace.json"
    out = tcli.run([
        "serve-bench", "--backend=cpu", "--requests=4", "--rate=50", "--prompt-len=8",
        "--max-tokens=3", "--slots=2", "--block-size=8", "--seed=1", "--dtype=f32",
        "--slo-ttft=30", "--slo-tpot=30", f"--request-log={rl}", "--tick-sentinel",
        f"--trace-out={tr}", "--roofline", "--tenants",
        f"--jax-profile={tmp_path / 'prof'}",
    ])
    printed = capsys.readouterr().out
    for banner in ("SLO accounting ACTIVE", "request log ACTIVE", "tick sentinel ACTIVE",
                   "tracing ACTIVE", "roofline telemetry ACTIVE: grading dispatches "
                   "against 3350 GB/s", "tenant accounting ACTIVE", "trace events"):
        assert banner in printed, banner
    assert "slo: attainment" in out
    lines = read_request_log(str(rl))
    assert len(lines) == 4 and all(ln["reason"] == "length" for ln in lines)
    assert json.loads(tr.read_text())["traceEvents"]
    assert (tmp_path / "prof" / profiling.TRACE_FILE).exists()


def _serve(tmp_path, argv, tokenizer=None):
    """``serve`` on a worker thread; → (thread, host, port)."""
    pf = tmp_path / "port"
    th = threading.Thread(target=tcli.run, args=([
        "serve", "--backend=cpu", "--port=0", "--prompt-len=16", "--max-tokens=8",
        "--slots=2", "--block-size=8", "--dtype=f32", "--cache-dtype=f32",
        f"--port-file={pf}", "--exit-after-s=6", "--request-timeout=5", *argv],),
        kwargs=dict(tokenizer=tokenizer), daemon=True)
    th.start()
    deadline = time.time() + 120
    while not (pf.exists() and pf.read_text().endswith("\n")) and time.time() < deadline:
        time.sleep(0.05)
    assert pf.exists(), "server never wrote --port-file"
    host, port = pf.read_text().split()
    return th, host, int(port)


def _jax_greedy(weights, prompt, n) -> list[int]:
    from llm_np_cp_tpu.generate import Generator as JGenerator

    _, _, jcfg, jp = weights
    gen = JGenerator(jp, jcfg, sampler=JSampler("greedy"), cache_dtype=jnp.float32)
    return np.asarray(gen.generate(np.asarray(prompt), n).tokens)[0].tolist()


@pytest.mark.http
def test_serve_stdlib_client_round_trip(monkeypatch, tmp_path, weights, capsys):
    """``serve`` with the caller's tokenizer, as the JAX CLI test drives
    it: /healthz, a string-prompt completion (tokens equal to the JAX
    Generator's), /metrics, and the timed drain."""
    from llm_np_cp_tpu_torch.serve.http.client import http_get, post_completion

    cfg, tp, _, _ = weights
    monkeypatch.setattr(tcli, "_load", lambda args: (args.tokenizer, tp, cfg))
    th, host, port = _serve(tmp_path, ["--sampler=greedy"], tokenizer=FakeTokenizer())
    st, body = http_get(host, port, "/healthz")
    assert st == 200 and json.loads(body)["status"] == "ok"
    st, obj = post_completion(host, port, {"prompt": "hello", "max_tokens": 4})
    assert st == 200
    choice = obj["choices"][0]
    assert choice["finish_reason"] == "length"
    want = _jax_greedy(weights, FakeTokenizer()("hello")["input_ids"][0], 4)
    assert choice["token_ids"] == want
    assert choice["text"] == FakeTokenizer().decode(want)
    st, body = http_get(host, port, "/metrics")
    assert st == 200 and b"llm_serve_requests_finished_total" in body
    th.join(timeout=60)
    assert not th.is_alive(), "serve did not drain on --exit-after-s"
    printed = capsys.readouterr().out
    assert "listening on http://" in printed and "drained, bye" in printed


@pytest.mark.http
@pytest.mark.parametrize("replicas", [1, 2])
def test_serve_without_tokenizer_answers_token_ids(monkeypatch, tmp_path, weights, replicas):
    """No tokenizer: token-id prompts are served (unary and SSE, tokens
    equal to the JAX Generator's), by one engine or a fleet of two behind
    the prefix router; a string prompt gets the protocol's 400."""
    import asyncio

    from llm_np_cp_tpu_torch.serve.http.client import (astream_completion, http_get,
                                                        post_completion)

    cfg, tp, _, _ = weights
    monkeypatch.setattr(tcli, "_load", lambda args: (args.tokenizer, tp, cfg))
    th, host, port = _serve(tmp_path, ["--sampler=greedy", f"--replicas={replicas}"])
    st, body = http_get(host, port, "/healthz")
    assert st == 200 and len(json.loads(body).get("replicas", [None])) == replicas
    prompt = [5, 17, 42, 99, 3, 7]
    want = _jax_greedy(weights, prompt, 6)
    st, obj = post_completion(host, port, {"prompt": prompt, "max_tokens": 6})
    assert st == 200 and obj["choices"][0]["token_ids"] == want
    res = asyncio.run(astream_completion(host, port, {"prompt": prompt, "max_tokens": 6},
                                         timeout=30.0))
    assert res["status"] == 200 and res["token_ids"] == want
    st, obj = post_completion(host, port, {"prompt": "hello", "max_tokens": 4})
    assert st == 400
    th.join(timeout=60)
    assert not th.is_alive()


# ----------------------------------------------------------------------
# rejections
# ----------------------------------------------------------------------

# argvs both CLIs reject with SystemExit before generating (tests/test_cli.py
# and the checks at the head of the JAX ``run``)
REJECTED = {
    "quantize_numpy": ["--backend=numpy", "--quantize=int8"],
    "bad_draft": ["--speculative=2", "--draft=bogus", "--max-tokens=2", "--dtype=f32"],
    "typo_draft": ["--speculative=2", "--draft=trunk8", "--max-tokens=2", "--dtype=f32"],
    "draft_without_speculative": ["--draft=int4", "--max-tokens=2", "--dtype=f32"],
    "int4_draft_quantized_target": ["--speculative=2", "--quantize=int8",
                                    "--draft=trunc2_int4", "--max-tokens=2", "--dtype=f32"],
    "speculative_decode_attn": ["--speculative=2", "--max-tokens=2", "--dtype=f32",
                                "--decode-attn=pallas"],
    "speculative_flash_prefill": ["--speculative=2", "--max-tokens=2", "--dtype=f32",
                                  "--flash-prefill"],
    "speculative_attn_flash": ["--speculative=2", "--max-tokens=2", "--dtype=f32",
                               "--attn-impl=flash"],
    "speculative_batch_size": ["--speculative=2", "--max-tokens=2", "--dtype=f32",
                               "--batch-size=2"],
    "speculative_early_stop": ["--speculative=2", "--max-tokens=2", "--dtype=f32",
                               "--early-stop"],
    "negative_batch_size": ["--batch-size=-1"],
    "prompts_file_numpy": ["--backend=numpy", "--prompts-file=PF"],
    "prompts_file_flash": ["--prompts-file=PF", "--attn-impl=flash"],
    "prompts_file_empty": ["--prompts-file=EMPTY", "--dtype=f32"],
    "serve_bench_block_size": ["serve-bench", "--block-size=12"],
    "serve_bench_spec_split": ["serve-bench", "--requests=2", "--prompt-len=8",
                               "--max-tokens=2", "--slots=2", "--block-size=8",
                               "--speculative-serve", "--mixed-step=off"],
    "serve_bench_spec_k": ["serve-bench", "--requests=2", "--prompt-len=8", "--max-tokens=2",
                           "--slots=2", "--block-size=8", "--speculative-serve",
                           "--spec-k=0"],
    "serve_bench_replicas": ["serve-bench", "--requests=2", "--prompt-len=8",
                             "--max-tokens=2", "--slots=2", "--block-size=8",
                             "--replicas=0"],
    "serve_bench_budget": ["serve-bench", "--slots=4", "--tick-token-budget=2"],
    "serve_bench_distinct": ["serve-bench", "--distinct-prompts=-1"],
    "serve_bench_trace_ring": ["serve-bench", "--trace-ring=-1"],
    "serve_bench_slo_target": ["serve-bench", "--slo-target=1.5"],
    "serve_bench_slo_ttft": ["serve-bench", "--slo-ttft=-1"],
    "serve_bench_chaos_spec": ["serve-bench", "--chaos-spec=nowhere@1"],
    "serve_bench_kv_tier": ["serve-bench", "--kv-tier=host", "--block-size=8"],
    "serve_block_size": ["serve", "--block-size=12"],
    "serve_max_queue": ["serve", "--max-queue=-1"],
    "serve_request_timeout": ["serve", "--request-timeout=-2"],
    "serve_tick_deadline": ["serve", "--tick-deadline=-1"],
    "serve_max_restarts": ["serve", "--max-restarts=-1"],
}


def _rejection(run, argv):
    with pytest.raises(SystemExit) as e:
        run(argv)
    return str(e.value.code)


@pytest.mark.parametrize("argv", list(REJECTED.values()), ids=list(REJECTED))
def test_rejections_match_jax(clis, tmp_path, argv):
    """The port raises the JAX message; the one deliberate change is the
    backend's name ("the tpu backend" is "the torch backend")."""
    (tmp_path / "p.txt").write_text("hello\n")
    (tmp_path / "empty.txt").write_text("\n")
    argv = [a.replace("PF", str(tmp_path / "p.txt")).replace("EMPTY", str(tmp_path / "empty.txt"))
            for a in argv]
    if argv[0] in ("serve", "serve-bench"):  # the JAX subcommands have no --backend
        jargv, targv = argv, [argv[0], "--backend=cpu", *argv[1:]]
    elif any(a.startswith("--backend") for a in argv):
        jargv = targv = argv
    else:
        jargv, targv = ["--backend=tpu", *argv], ["--backend=cpu", *argv]
    want, got = _rejection(jcli.run, jargv), _rejection(tcli.run, targv)
    assert got == want.replace("the tpu backend", "the torch backend")


# generation over a mesh: the JAX CLI runs on its 8-device virtual CPU
# mesh, the port the plan's gloo ranks; the same text, or the same
# rejection.  "mesh" spawns its ranks from the CLI; the runs named in
# MESH_IN_RANKS run inside ranks already running (``mesh_in_ranks``)
MESH_RUNS = {
    "mesh": ["--mesh=1,1,2"],
    "ring": ["--attn-impl=ring"],
    "speculative_ring": ["--speculative=2", "--attn-impl=ring"],
    "ring_on_mesh": ["--mesh=1,2,2", "--attn-impl=ring", "--no-stream"],
    "quantize_int8_mesh": ["--quantize=int8", "--mesh=2,1,2", "--no-stream"],
    "training_axes": ["--mesh=pipe=2,model=2"],
    "malformed_mesh": ["--mesh=1,2"],
}
MESH_IN_RANKS = ("ring_on_mesh", "quantize_int8_mesh")
INSIDE_RANKS = [*COMMON, "--sampler=greedy", "--mesh=1,1,2", "--no-stream"]


def mesh_argv(name: str) -> list[str]:
    return [*COMMON, "--sampler=greedy", *MESH_RUNS[name]]


@pytest.fixture(scope="module")
def mesh_in_ranks(weights, tmp_path_factory):
    """Launched as ranks already (``WORLD_SIZE`` set, the group running,
    as under torchrun), the CLI builds its mesh in place and spawns
    nothing.  One spawned group a world size runs every such argv (the
    CLI's ``--backend=cpu``): ``{name: (rank 0's text, its stderr)}``,
    after checking that every rank returned rank 0's text; and
    ``"prompts_file"``, the batch runs' prompts."""
    from llm_np_cp_tpu_torch.parallel.sharding import parse_mesh_spec

    cfg, tp, _, _ = weights
    pf = tmp_path_factory.mktemp("mesh_cli") / "prompts.txt"
    pf.write_text("\n".join(PROMPTS) + "\n")
    runs = {"inside_running_ranks": INSIDE_RANKS,
            **{n: mesh_argv(n) for n in MESH_IN_RANKS},
            **{n: batch_argv(pf, BATCH[n]) for n in BATCH_IN_RANKS}}
    by_world: dict[int, list[str]] = {}
    for name, argv in runs.items():
        spec = next(a.split("=", 1)[1] for a in argv if a.startswith("--mesh="))
        by_world.setdefault(parse_mesh_spec(spec).num_devices, []).append(name)
    out = {"prompts_file": pf}
    for world, names in sorted(by_world.items()):
        ranks = run_ranks(cli_in_rank, world, [["--backend=cpu", *runs[n]] for n in names],
                          tp, cfg)
        for i, name in enumerate(names):
            assert all(r[i][0] == ranks[0][i][0] for r in ranks), name
            out[name] = ranks[0][i]
    return out


@pytest.mark.parametrize("name", list(MESH_RUNS))
def test_mesh_runs_match_jax(clis, mesh_in_ranks, name, capsys):
    argv = mesh_argv(name)
    try:
        want = jcli.run(["--backend=tpu", *argv])
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            tcli.run(["--backend=cpu", *argv])
        assert str(got.value.code) == str(e.code)
        return
    assert len(token_ids(want)) > 0
    if name in MESH_IN_RANKS:
        assert mesh_in_ranks[name][0] == want
        return
    got = tcli.run(["--backend=cpu", *argv])
    assert got == want
    assert capsys.readouterr().out.count(got) >= 2  # both printed it


def test_mesh_cli_inside_running_ranks_matches_jax(clis, mesh_in_ranks):
    """Inside running ranks, rank 0's text (every rank's) is the JAX
    CLI's."""
    want = jcli.run(["--backend=tpu", *INSIDE_RANKS])
    assert mesh_in_ranks["inside_running_ranks"][0] == want


def test_mesh_refusals(clis):
    """What the port refuses under a mesh: a plan the config does not
    divide (JAX's ValueError), ``--speculative`` (not ported: item 8c)
    and, on CUDA, more ranks than cards (JAX's device-count message; no
    card here, so the device check itself is asserted)."""
    with pytest.raises(ValueError, match="not divisible by model=3"):
        tcli.run(["--backend=cpu", "--mesh=1,1,3", *COMMON])
    with pytest.raises(NotImplementedError, match="item 8c"):
        tcli.run(["--backend=cpu", "--mesh=1,1,2", "--speculative=2", *COMMON])
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan, device_count_error

    have = torch.cuda.device_count()
    assert device_count_error(MeshPlan(model=2 + have), None, None) == (
        f"plan needs {2 + have} devices, have {have}")


SERVE_MESH = {
    "serve_bench_tp": ["serve-bench", "--mesh", "model=2"],
    "serve_bench_dp": ["serve-bench", "--mesh", "data=2"],
    "serve_bench_overcommit": ["serve-bench", "--mesh", "model=8", "--replicas=4"],
    "serve_tp": ["serve", "--mesh", "model=2"],
}


# what each serve mesh argv does before the load: the tensor-parallel
# serve-bench reaches it (the ranks load nothing themselves), the rest
# raise with the JAX CLI's message or name the ROADMAP item of what is not
# ported
SERVE_MESH_BEFORE_LOAD = {
    "serve_bench_tp": (AssertionError, "the model loaded"),
    "serve_bench_dp": (SystemExit, "tensor-parallel only"),
    "serve_bench_overcommit": (NotImplementedError, "--replicas 4 .*queue 1 item 8c"),
    "serve_tp": (NotImplementedError, "serve: --mesh 'model=2' .*queue 1 item 8c"),
}


@pytest.mark.parametrize("argv", list(SERVE_MESH.values()), ids=list(SERVE_MESH))
def test_parallel_flags_raise_before_load(monkeypatch, argv, request):
    """The serve meshes are checked before any model loads: a
    tensor-parallel ``serve-bench`` goes on to the load, a data axis
    raises the JAX CLI's message, and ``--replicas`` with ``--mesh`` and
    HTTP ``serve --mesh`` raise NotImplementedError naming the ROADMAP
    item (8c)."""
    def no_load(args):
        raise AssertionError("the model loaded")

    monkeypatch.setattr(tcli, "_load", no_load)
    exc, match = SERVE_MESH_BEFORE_LOAD[request.node.callspec.id]
    with pytest.raises(exc, match=match):
        tcli.run(argv[:1] + ["--backend=cpu"] + argv[1:])


SERVE_BENCH_MESH = ["serve-bench", "--backend=cpu", "--requests=6", "--rate=50",
                    "--prompt-len=12", "--max-tokens=4", "--slots=2", "--block-size=8",
                    "--dtype=f32", "--cache-dtype=f32", "--prefix-cache"]


@pytest.fixture(scope="module")
def serve_bench_tp(weights):
    """``serve-bench --mesh model=2`` inside two running ranks
    (``WORLD_SIZE`` set): each rank's printed text and served tokens."""
    from mesh_ranks import serve_bench_in_rank

    cfg, tp, _, _ = weights
    return run_ranks(serve_bench_in_rank, 2, SERVE_BENCH_MESH + ["--mesh", "model=2"], tp, cfg)


def test_serve_bench_mesh_matches_one_rank(monkeypatch, weights, serve_bench_tp, capsys):
    """``serve-bench --mesh model=2``: inside running ranks, rank 0 prints
    the banner and the report (``topo=`` the mesh), rank 1 prints
    nothing, and every rank's tokens equal the one-rank replay's; spawned
    from the CLI, the ranks' banner and report come back and print
    here."""
    from mesh_ranks import serve_bench_in_rank

    cfg, tp, _, _ = weights
    desc = "tp=2 over 2 gloo ranks on cpu (kv-sharded)"
    (text0, tokens0), (text1, tokens1) = serve_bench_tp
    assert f"[serve-bench] mesh ACTIVE: {desc}" in text0
    assert f"topo={desc}" in text0 and "6 finished" in text0
    assert text1 == ""
    _, one_rank = serve_bench_in_rank(None, SERVE_BENCH_MESH, tp, cfg)
    assert len(one_rank) == 6 and tokens0 == tokens1 == one_rank
    monkeypatch.setattr(tcli, "_load", lambda args: (None, tp, cfg))
    out = tcli.run(SERVE_BENCH_MESH + ["--mesh", "model=2"])
    printed = capsys.readouterr().out
    assert f"[serve-bench] mesh ACTIVE: {desc}" in printed
    assert out in printed and f"topo={desc}" in out


def test_cli_serve_mesh_validation(clis):
    """Mesh / replica errors fire before the model load with the JAX
    CLI's messages (non-TP axes, a bad replica count, more devices than
    the host has: on ``--backend cuda`` a rank needs a card), and
    ``--replicas`` with ``--mesh`` names item 8c."""
    base = ["serve-bench", "--requests=2", "--prompt-len=8", "--max-tokens=2", "--slots=2",
            "--block-size=8"]
    for extra in (["--mesh", "data=2"], ["--replicas=0"]):
        with pytest.raises(SystemExit) as want:
            jcli.run(base + extra)
        with pytest.raises(SystemExit) as got:
            tcli.run(base + ["--backend=cpu"] + extra)
        assert str(got.value.code) == str(want.value.code)
    have = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=(
            f"serve-bench: --mesh/--replicas need {2 * (have + 1)} devices "
            rf"\(1 replicas x {2 * (have + 1)}\), have {have}")):
        tcli.run(base + ["--backend=cuda", "--mesh", f"model={2 * (have + 1)}"])
    with pytest.raises(NotImplementedError, match="item 8c"):
        tcli.run(base + ["--backend=cpu", "--mesh", "model=2", "--replicas=2"])
    for flag in ("--speculative-serve", "--auto-actions", "--realtime"):
        with pytest.raises(NotImplementedError, match=f"{flag} under --mesh.*item 8c"):
            tcli.run(base + ["--backend=cpu", "--mesh", "model=2", flag])


def test_backend_names(monkeypatch, weights):
    """``tpu`` names the port's backends; ``cuda`` without a card raises
    (never carries on on the CPU); a text run without a tokenizer says
    where the tokenizer comes from."""
    cfg, tp, _, _ = weights
    for argv in (["--backend=tpu"], ["serve-bench", "--backend=tpu"],
                 ["serve", "--backend=tpu"]):
        with pytest.raises(SystemExit, match="--backend cuda"):
            tcli.run(argv)
    monkeypatch.setattr(tcli, "_load", lambda args: (args.tokenizer, tp, cfg))
    for backend in ("cpu", "numpy"):
        with pytest.raises(SystemExit, match="tokenizer from the caller"):
            tcli.run([f"--backend={backend}", "--max-tokens=2"])
    if not torch.cuda.is_available():
        for argv in (["--max-tokens=2"], ["serve-bench"], ["serve"]):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                tcli.run(argv, tokenizer=FakeTokenizer())


# ----------------------------------------------------------------------
# parsers
# ----------------------------------------------------------------------

# flags whose default or choices the port changes: --backend (cuda / cpu /
# numpy for tpu / numpy) and --hbm-gbps (the H100's 3350 GB/s for the TPU's 819)
PORT_DEFAULTS = {"--backend", "--hbm-gbps"}


def _flags(parser) -> dict:
    return {a.option_strings[-1]: (a.default, a.choices)
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name", ["build_parser", "build_serve_parser",
                                  "build_http_serve_parser"])
def test_parser_flags_and_defaults_match_jax(name):
    want = _flags(getattr(jcli, name)("m"))
    got = _flags(getattr(tcli, name)("m"))
    assert want.keys() <= got.keys(), want.keys() - got.keys()
    for flag, spec in want.items():
        if flag not in PORT_DEFAULTS:
            assert got[flag] == spec, flag
    assert set(got) - set(want) <= {"--backend", "--jax-profile"}
    if name != "build_parser":
        assert getattr(tcli, name)("m").parse_args([]).hbm_gbps == 3350.0


# ----------------------------------------------------------------------
# load_model and the command on a checkpoint directory
# ----------------------------------------------------------------------

def _write_checkpoint(path, cfg, params) -> None:
    """``params`` (port layout) as an HF checkpoint: config.json and one
    safetensors file with HF key names and [out, in] projections."""
    from safetensors.numpy import save_file

    layer_map, top_map = tloading._key_maps(cfg)
    out = {}
    for hf_key, (name, transpose) in top_map.items():
        if name in params:
            a = params[name].numpy()
            out[hf_key] = np.ascontiguousarray(a.T if transpose else a)
    for suffix, (name, transpose) in layer_map.items():
        if name in params["layers"]:
            for i in range(cfg.num_hidden_layers):
                a = params["layers"][name][i].numpy()
                out[f"model.layers.{i}.{suffix}"] = np.ascontiguousarray(a.T if transpose else a)
    save_file(out, str(path / "model.safetensors"))
    hf = {k: getattr(cfg, k) for k in (
        "model_type", "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "head_dim", "max_position_embeddings",
        "rope_theta", "rms_norm_eps", "tie_word_embeddings")}
    (path / "config.json").write_text(json.dumps(hf))


def test_load_model_reads_a_checkpoint_directory(tmp_path, weights):
    cfg, tp, _, _ = weights
    _write_checkpoint(tmp_path, cfg, tp)
    tok = FakeTokenizer()
    got_tok, params, got_cfg = tloading.load_model(tmp_path, dtype=torch.float32, device="cpu",
                                                   tokenizer=tok)
    want, _ = tloading.load_params(tmp_path, dtype=torch.float32, device="cpu")
    assert got_tok is tok and got_cfg == cfg
    for k in ("embed_tokens", "final_norm"):
        assert torch.equal(params[k], want[k]) and torch.equal(params[k], tp[k])
    for k, v in params["layers"].items():
        assert torch.equal(v, want["layers"][k]) and torch.equal(v, tp["layers"][k])
    assert tloading.load_model(tmp_path, device="cpu")[0] is None
    missing = tmp_path / "meta-llama" / "Llama-3.2-1B"
    with pytest.raises(FileNotFoundError, match="Llama-3.2-1B"):
        tloading.load_model(missing, device="cpu")
    with pytest.raises(FileNotFoundError, match="not a local checkpoint directory"):
        tloading.load_model(tmp_path / "config.json", device="cpu")


def test_cli_loads_the_checkpoint_directory(tmp_path, clis, weights, monkeypatch):
    """The real ``_load`` (``--model DIR``) gives the swapped-in weights'
    text, and the JAX CLI's."""
    cfg, tp, _, _ = weights
    _write_checkpoint(tmp_path, cfg, tp)
    argv = [*COMMON, "--sampler=greedy", "--no-stream"]
    want, swapped = clis(argv)
    monkeypatch.setattr(tcli, "_load", REAL_LOAD)
    got = tcli.run(["--backend=cpu", f"--model={tmp_path}", *argv], tokenizer=FakeTokenizer())
    assert got == swapped == want


# ----------------------------------------------------------------------
# utils/profiling
# ----------------------------------------------------------------------

def test_profiling_trace_timing_and_stopwatch(tmp_path, capsys):
    with profiling.trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert "traceEvents" in json.loads((tmp_path / "prof" / profiling.TRACE_FILE).read_text())

    @profiling.timing
    def work(n):
        return torch.ones(n) * 2

    profiling.enable_timing(True)
    try:
        assert work(3).tolist() == [2.0, 2.0, 2.0]
    finally:
        profiling.enable_timing(False)
    assert "[timing] " in capsys.readouterr().out and work(2).shape == (2,)
    assert capsys.readouterr().out == ""
    sw = profiling.Stopwatch()
    sw.mark("a")
    sw.mark("b", result={"x": torch.ones(2)})
    assert sw.span("a", "b") >= 0
