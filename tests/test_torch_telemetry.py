"""Roofline telemetry in the port (``serve/telemetry.py``, the metrics'
roofline series, the request log's cost block and the engine's billing
hooks) against the JAX package's, on the CPU in float32.

The same seeded weights and trace go through both ``ServeEngine``s
(``observe_parity``: unified, phase-split with its eager prefill chunks,
speculative with verify slices, and host-tier legs): every graded tick's
planned bill — K/V read and written, weight bytes, FLOPs — is exactly
equal, so are the phase-split prefill records and each request's
attributed bytes, and ``finish`` grades equal bills at equal walls to
equal ``roofline_util`` / ``mfu``.  Attribution conserves against the
ledgers, the closed-form byte model equals the JAX tile walk, and
the hardware constants are the card's.
"""

import pathlib
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import observe_parity as op
from llm_np_cp_tpu import quant as jquant
from llm_np_cp_tpu.serve import metrics as jmetrics
from llm_np_cp_tpu.serve import request_log as jrequest_log
from llm_np_cp_tpu.serve import telemetry as jtel
from llm_np_cp_tpu_torch import quant
from llm_np_cp_tpu_torch.serve import metrics, request_log, telemetry

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny tensors gain nothing from intra-op threads, and beside
    other test workers the threads only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hardware_constants_are_the_cards():
    """3350 GB/s and 989 TFLOP/s (H100 SXM), and no TPU constant left
    anywhere in the port."""
    assert (telemetry.HBM_GBPS_DEFAULT, telemetry.PEAK_TFLOPS_DEFAULT) == (3350.0, 989.0)
    tpu = re.compile(r"(?<![\d.])(819|197)(\.0)?(?![\d.])")
    for path in (ROOT / "llm_np_cp_tpu_torch").rglob("*.py"):
        assert not tpu.search(path.read_text()), path


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_model_constants_equal_jax(quantized):
    """The params-derived constants: streamed bytes, the tied head's
    re-read, an embedding row, the FLOP parameters (quantized weights:
    the payloads and scales)."""
    cfg, tp, jcfg, jp = op.models()
    if quantized:
        tp = quant.quantize_params(tp, bits=8)
        jp = jquant.quantize_params(jp, bits=8)
    got = telemetry.TelemetryModel(cfg, tp)
    want = jtel.TelemetryModel(jcfg, jp, hbm_gbps=3350.0, peak_tflops=989.0)
    for key in ("stream_bytes", "lm_head_bytes", "embed_row_bytes", "n_flop_params",
                "hbm_gbps", "peak_tflops"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.weight_bytes(37, 3) == want.weight_bytes(37, 3)
    with pytest.raises(ValueError, match="hbm_gbps"):
        telemetry.TelemetryModel(cfg, tp, hbm_gbps=0)


@pytest.mark.parametrize("leg", list(op.LEGS))
def test_tick_bills_equal_jax(leg):
    """Per graded tick: kind, tokens, K/V read and written, weight bytes
    and FLOPs exactly the JAX engine's (tokens equal too); the phase-split
    prefill records as well."""
    got, want = op.run(leg, True), op.run(leg, False)
    assert got["tokens"] == want["tokens"]
    assert got["costs"] and got["costs"] == want["costs"]
    assert got["prefills"] == want["prefills"]
    if leg == "split":
        assert got["prefills"] and all(p["roofline"] is False for p in got["prefills"])
    if leg == "spec":
        # verify slices were billed: a tick carried more tokens than rows
        assert any(c["tokens"] > 4 for c in got["costs"])


@pytest.mark.parametrize("leg", list(op.LEGS))
def test_request_attribution_equals_jax_and_conserves(leg):
    """Each request's attributed bytes equal the JAX engine's to 1e-9
    relative; per-request sums (device time included) equal the metrics'
    ledgers, and the ledgers' bytes equal the JAX engine's."""
    got, want = op.run(leg, True), op.run(leg, False)
    assert [r.req_id for r in got["requests"]] == [r.req_id for r in want["requests"]]
    for a, b in zip(got["requests"], want["requests"]):
        for key in ("kv_bytes_read", "kv_bytes_written", "weight_bytes_amortized"):
            assert getattr(a, key) == pytest.approx(getattr(b, key), rel=1e-9, abs=0), key
        assert a.device_time_s > 0.0
    snap, jsnap = got["snapshot"], want["snapshot"]
    for key, total in (("kv_bytes_read", "kv_read_bytes_total"),
                       ("kv_bytes_written", "kv_write_bytes_total"),
                       ("weight_bytes_amortized", "weight_bytes_total"),
                       ("device_time_s", "device_time_s_total")):
        assert sum(getattr(r, key) for r in got["requests"]) == pytest.approx(
            snap[total], rel=1e-9)
        if key != "device_time_s":
            assert snap[total] == pytest.approx(jsnap[total], rel=1e-12)
    assert snap["roofline_ticks"] == jsnap["roofline_ticks"] == len(got["costs"])
    assert snap["hbm_gbps"] == 3350.0


def test_finish_grades_equal_bills_equally():
    """The same bill at the same wall: every field of the record equal."""
    cfg, tp, jcfg, jp = op.models()
    got_model = telemetry.TelemetryModel(cfg, tp)
    want_model = jtel.TelemetryModel(jcfg, jp, hbm_gbps=3350.0, peak_tflops=989.0)
    for cost, wall in zip(op.run("mixed", True)["costs"], (0.003, 1e-4, 2.5, 1e-12)):
        assert got_model.finish(cost, wall) == want_model.finish(cost, wall)
    rec = got_model.finish(op.run("mixed", True)["costs"][0], 0.004)
    assert rec["roofline_util"] == pytest.approx(rec["achieved_gbps"] / 3350.0)
    total = rec["kv_read_bytes"] + rec["kv_write_bytes"] + rec["weight_bytes"]
    assert rec["deficit_us"] == pytest.approx((0.004 - total / 3350e9) * 1e6)


@pytest.mark.parametrize("leg", ["mixed", "spec", "split"])
def test_kv_gauge_closed_form_equals_model(leg, monkeypatch):
    """The one byte model the engine's every-tick ``kv_bytes_tick`` gauge
    (``per_request=False``) and telemetry's bill share — closed form in
    the unified tick — equals the JAX package's per-q-tile walk, total and
    per request, on every call of a run."""
    cfg, _, jcfg, _ = op.models()
    seen = []
    real_mixed, real_split = telemetry.mixed_tick_kv_read, telemetry.split_tick_kv_read

    def as_jax(eng):
        return SimpleNamespace(
            config=jcfg, cache_dtype=np.dtype(np.float32), _q_tile=eng._kv_geom["q_tile"],
            ragged_attn_impl="pallas", block_size=eng.block_size,
            decode_attn_impl=eng.decode_attn_impl, max_seq_len=eng.max_seq_len,
            scheduler=eng.scheduler)

    def mixed(eng, decode_rows, prefill_segs, *, per_request=True):
        got = real_mixed(eng, decode_rows, prefill_segs, per_request=per_request)
        want = jtel.mixed_tick_kv_read(as_jax(eng), decode_rows, prefill_segs,
                                       per_request=per_request)
        seen.append((per_request, got, want))
        return got

    def split(eng, running, *, per_request=True):
        got = real_split(eng, running, per_request=per_request)
        want = jtel.split_tick_kv_read(as_jax(eng), running, per_request=per_request)
        seen.append((per_request, got, want))
        return got

    monkeypatch.setattr(telemetry, "mixed_tick_kv_read", mixed)
    monkeypatch.setattr(telemetry, "split_tick_kv_read", split)
    op.drive(op.build(True, leg), leg)
    assert all(got == want for _, got, want in seen)
    gauge = [got for per_request, got, _ in seen if not per_request]
    bills = [got for per_request, got, _ in seen if per_request]
    assert gauge and bills and all(per == {} for _, per in gauge)
    assert any(total > 0 for total, _ in gauge) and any(per for _, per in bills)


def test_tier_prefill_rate_seeded_from_the_model():
    """With telemetry attached, a host tier's recompute side starts from
    the byte model's prefill rate, as the JAX engine seeds it."""
    cfg, tp, jcfg, jp = op.models()
    tier, jtier = op.HostTier(1 << 20), op.JHostTier(1 << 20)
    eng = op.serve.ServeEngine(
        tp, cfg, max_slots=2, num_blocks=12, block_size=8, max_seq_len=64, mixed_step="on",
        enable_prefix_cache=True, host_tier=tier, cache_dtype=torch.float32, device="cpu",
        telemetry=telemetry.TelemetryModel(cfg, tp))
    op.jserve.ServeEngine(
        jp, jcfg, max_slots=2, num_blocks=12, block_size=8, max_seq_len=64, mixed_step="on",
        enable_prefix_cache=True, host_tier=jtier, cache_dtype=jnp.float32,
        telemetry=jtel.TelemetryModel(jcfg, jp, hbm_gbps=3350.0, peak_tflops=989.0))
    assert tier.prefill_tok_s == pytest.approx(jtier.prefill_tok_s, rel=1e-12)
    assert tier.prefill_tok_s > 0
    assert eng.metrics.snapshot()["tier_breakeven_ratio"] > 0.0
    tier.close()
    jtier.close()


def test_tier_tick_args_equal_jax():
    """The tier leg's ticks carry the tier byte flow in their args, equal
    to the JAX engine's (the staging time aside: it is measured)."""
    names = op.tracing.MIXED_TICK_PHASES
    got = op.ticks(op.run("tier", True)["events"], names)
    want = op.ticks(op.run("tier", False)["events"], names)
    keys = ("tier_spill_bytes", "tier_restore_bytes")
    assert [tuple(t["args"][k] for k in keys) for t, _ in got] == [
        tuple(t["args"][k] for k in keys) for t, _ in want]
    assert any(t["args"]["tier_restore_bytes"] for t, _ in got)
    assert any(t["args"]["tier_spill_bytes"] for t, _ in got)


def _fed(mod):
    """A package's ServeMetrics fed the same telemetry records, terminal
    and anomalies."""
    m = mod.ServeMetrics(clock=lambda: 5.0)
    m.t_start = 1.0
    for i, util in enumerate((0.002, 0.3, 0.95, 1.2)):
        m.on_telemetry(dict(kind="mixed", roofline=True, tokens=9, device_time_s=0.01 * (i + 1),
                            kv_read_bytes=1e6 * i, kv_write_bytes=2e5, weight_bytes=3e9,
                            achieved_gbps=util * 3350.0, roofline_util=util, mfu=util / 50,
                            deficit_us=100.0 * i, hbm_gbps=3350.0))
    m.on_telemetry(dict(kind="prefill", roofline=False, tokens=64, device_time_s=0.5,
                        kv_read_bytes=0.0, kv_write_bytes=7e5, weight_bytes=2e9,
                        hbm_gbps=3350.0))
    m.on_anomaly("host_sync")
    m.on_anomaly("roofline_deficit")
    m.on_anomaly("host_sync")
    m.on_tick(queue_depth=1, occupancy=0.5, active_slots=3, preemptions_total=0,
              kv_bytes=4096, prefill_tokens=5, decode_tokens=3)
    return m


def test_scrape_and_format_equal_jax():
    """The roofline, anomaly and device-ledger series of ``prometheus()``
    and the roofline line of ``format()`` equal the JAX scrape's (names,
    labels, values, the utilization histogram)."""
    got, want = _fed(metrics), _fed(jmetrics)
    assert metrics.ROOFLINE_UTIL_BUCKETS == jmetrics.ROOFLINE_UTIL_BUCKETS
    assert got.prometheus() == want.prometheus()
    text = got.prometheus()
    for name in ("device_bytes_total", "roofline_util_hist_bucket", "anomaly_ticks_total",
                 "hbm_gbps_target", "roofline_gbps_quantile", "mfu"):
        assert f"llm_serve_{name}" in text
    assert got.format().splitlines()[-1] == want.format().splitlines()[-1]
    assert got.format().splitlines()[-1].startswith("roofline:")
    snap = got.snapshot()
    assert snap["anomaly_ticks"] == {"host_sync": 2, "roofline_deficit": 1}
    assert snap["device_time_s_total"] == pytest.approx(0.1 + 0.5)


def test_request_log_cost_block_equals_jax():
    """The canonical record's cost block (and the rest of it) equals the
    JAX record for the same request; none without a measured cost."""
    def req(**cost):
        return SimpleNamespace(
            req_id=4, extra={"trace": "ab" * 16}, finish_time=9.0, submit_time=1.0,
            admit_time=1.5, first_token_time=2.0, prefill_s=0.25, prompt_len=11,
            generated=[1, 2, 3], n_shared_blocks=1, n_preemptions=0, tenant="team-a",
            finish_reason="length", kv_bytes_read=cost.get("r", 0.0),
            kv_bytes_written=cost.get("w", 0.0), weight_bytes_amortized=cost.get("a", 0.0),
            device_time_s=cost.get("t", 0.0))

    for r in (req(r=1234.56, w=99.0, a=3.3e9, t=0.0123456789), req()):
        got = request_log.request_record(r, reason="length", clock=lambda: 9.0)
        want = jrequest_log.request_record(r, reason="length", clock=lambda: 9.0)
        got.pop("ts"), want.pop("ts")
        assert got == want
    assert "cost" in request_log.request_record(req(t=0.5), reason="length")
    assert "cost" not in request_log.request_record(req(), reason="length")


def test_engine_log_lines_carry_cost_and_verdict(tmp_path):
    """A traced engine's request log: every line has the cost block and an
    SLO verdict (the metrics' policy), its cost equal to the request's."""
    eng = op.build(True, "mixed")
    log = request_log.RequestLog(str(tmp_path / "reqs.jsonl"))
    eng.request_log = log
    op.drive(eng, "mixed")
    log.close()
    records = {r["rid"]: r for r in request_log.read_request_log(str(tmp_path / "reqs.jsonl"))}
    reqs = list(eng.scheduler.finished) + list(eng.scheduler.aborted)
    assert len(records) == len(reqs)
    for r in reqs:
        rec = records[r.req_id]
        assert rec["cost"]["kv_bytes_read"] == round(r.kv_bytes_read, 1)
        assert rec["slo"]["ok"] is (r.finish_reason != "aborted")
    assert np.isclose(sum(rec["cost"]["device_time_s"] for rec in records.values()),
                      eng.metrics.snapshot()["device_time_s_total"], rtol=1e-6)
