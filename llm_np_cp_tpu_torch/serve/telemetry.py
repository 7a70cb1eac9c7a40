"""Device roofline telemetry: per-tick byte accounting and per-request
cost attribution (port of ``llm_np_cp_tpu/serve/telemetry.py``).

An analytic byte/FLOP model of each dispatch, combined with the measured
dispatch → host-sync wall of the same tick, gives the achieved GB/s, the
roofline utilization against ``hbm_gbps`` and an MFU estimate:

- **weight traffic**: every dispatch streams the decoder stack once
  (layers, final norm, lm_head; a tied lm_head re-reads the embedding
  matrix), plus one embedding row per packed token;
- **KV traffic**: reads from the planned tick composition (each q tile's
  visible blocks, window-aware per layer, verify slices included), writes
  one K/V column per packed token per layer; int8 pools count their
  float32 scale pages;
- **FLOPs**: ``2 * active_params * tokens`` (attention FLOPs left out: the
  model is for the MFU trend);
- **sampling-tail traffic**: a logits tail materializes ``[rows, V]``
  float32 logits (written, read back); the fused ``sample_epilogue`` pays
  nothing.

The model is the JAX package's arithmetic, so its bytes equal that
engine's on the same trace.  Two things differ on the card: the wall is
the dispatch → fetch wall on the host (a CUDA graph launch, then the
token fetch's wait on the device), not a device time; and at NSPLIT > 1
the split-KV kernels write and read partials that the model does not
bill.

**Cost attribution**: KV bytes are exact per request; weight bytes and
device time are shared by token share.  The engine accumulates them on
``Request`` (``kv_bytes_read`` / ``kv_bytes_written`` /
``weight_bytes_amortized`` / ``device_time_s``), the request log carries
them and ``TenantLedger`` bills them; per-request sums equal the tick
totals (the split path's gathering impls read every padded slot: that
overhead is split evenly across the live rows).

Everything here is host-side arithmetic: attaching a ``TelemetryModel``
adds no device operation and no capture, and every engine hook is one
``is None`` check.  The model is immutable after construction, so
``clone_fresh`` rebuilds share it; all accumulation lives in
``ServeMetrics`` (under its lock) and on ``Request``.
"""

from __future__ import annotations

from typing import Any

import torch

# The HBM roofline the utilization is graded against, GB/s, and the peak
# dense bf16 tensor-core rate for the MFU estimate, TFLOP/s: the H100 SXM
# data sheet's (the card: NVIDIA H100 80GB HBM3, 700.00 W), as
# chip_smoke.py bounds every kernel.  Override per deployment.
HBM_GBPS_DEFAULT = 3350.0
PEAK_TFLOPS_DEFAULT = 989.0


def _leaves(tree: Any):
    """The tensor leaves of a params tree (quantized entries are
    ``{"q", "scale"}`` subtrees)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _per_slot_bytes(config: Any, cache_itemsize: int) -> int:
    """K+V bytes one cache slot costs per layer (int8 pools stream
    their f32 scale pages alongside the quantized blocks)."""
    b = config.num_key_value_heads * config.head_dim * cache_itemsize * 2
    if cache_itemsize == 1:  # int8 pool: per-slot f32 scales, K and V
        b += config.num_key_value_heads * 4 * 2
    return b


def _floor_sum(n: int, m: int, a: int, b: int) -> int:
    """``sum((a * i + b) // m for i in range(n))`` for non-negative a, b
    in O(log m) steps (the Euclid-like floor sum)."""
    total = 0
    while True:
        if a >= m:
            total += n * (n - 1) // 2 * (a // m)
            a %= m
        if b >= m:
            total += n * (b // m)
            b %= m
        y_max = a * n + b
        if y_max < m:
            return total
        n, b = divmod(y_max, m)
        m, a = a, m


def _segment_kv_slots(pad: int, start: int, n: int, *, block_size: int, q_tile: int,
                      window: int | None, n_layers: int, n_sliding: int) -> int:
    """Cache slots (summed over layers) the ragged kernel reads for one
    row's segment of ``n`` query tokens from position ``start``: each
    q tile reads the blocks from its row's first (``pad``) through the
    one holding its last query, a sliding layer only those from its
    window's first.  The JAX model's per-tile sum in closed form, so a
    tick costs O(rows), not O(tiles)."""
    bs, qb = block_size, q_tile
    m = -(-n // qb)
    # sum over tiles of (last query // bs): the tiles before the last
    # end at start + (k + 1) * qb - 1, the last at start + n - 1
    last_blocks = _floor_sum(m - 1, bs, qb, start + qb - 1) + (start + n - 1) // bs
    full = last_blocks - m * (pad // bs) + m
    windowed = 0
    if n_sliding:
        # tile k's window starts at max(pad, start + k * qb - window + 1):
        # at pad for the first k0 tiles, then on an arithmetic run
        k0 = min(m, max(0, (pad + window - 1 - start) // qb + 1))
        first_blocks = k0 * (pad // bs)
        if m > k0:
            first_blocks += _floor_sum(m - k0, bs, qb, start - window + 1 + k0 * qb)
        windowed = last_blocks - first_blocks + m
    return ((n_layers - n_sliding) * full + n_sliding * windowed) * bs


def mixed_tick_kv_read(
    eng: Any,
    decode_rows: list,
    prefill_segs: list,
    *,
    per_request: bool = True,
) -> tuple[int, dict[int, int]]:
    """K/V bytes one unified tick's ragged kernel reads — total and per
    request: each q tile streams its row's visible blocks, window-aware
    per layer (the JAX kernel's tile reads; the port's ragged kernel
    uses the same ``RAGGED_Q_TILE`` geometry), summed per segment in
    closed form.  The partials that the port's split-KV kernel writes
    and its combine reads at NSPLIT > 1 are not counted, as the JAX model
    has no such traffic.  A speculating decode row's verify slice
    (``draft_len`` extra q positions) counts when the caller runs the
    model before the accept walk resets ``draft_len``; the engine's
    every-tick ``kv_bytes_tick`` gauge calls it after the walk with
    ``per_request=False``, which skips the per-row dict."""
    per_slot = _per_slot_bytes(eng.config, eng.cache_dtype.itemsize)
    geom = eng._kv_geom
    per: dict[int, int] = {}
    total = 0
    for r in decode_rows:
        b = _segment_kv_slots(r.pad, r.cache_len - 1, 1 + r.draft_len, **geom) * per_slot
        total += b
        if per_request:
            per[r.req_id] = b
    for r, n in prefill_segs:
        b = _segment_kv_slots(r.pad, r.pad + r.prefill_done, n, **geom) * per_slot
        total += b
        if per_request:
            per[r.req_id] = b
    return total, per


def split_tick_kv_read(
    eng: Any, running: list, *, per_request: bool = True,
) -> tuple[int, dict[int, float]]:
    """K/V bytes one phase-split decode dispatch reads — total and per
    request (the engine's every-tick ``kv_bytes_tick`` gauge calls it with
    ``per_request=False``, which skips the per-row dict).  The gather
    impls materialize the full padded [B, S_max] view including DEAD
    slots; that fixed overhead is split evenly across the live rows
    (attribution must conserve, and there is no request to bill padding
    to).  The paged kernel streams only each row's visible blocks, so its
    attribution is exact."""
    per_slot = _per_slot_bytes(eng.config, eng.cache_dtype.itemsize)
    geom = eng._kv_geom
    n_layers = geom["n_layers"]
    if eng.decode_attn_impl != "paged":
        total = (eng.scheduler.max_slots * eng.max_seq_len
                 * n_layers * per_slot)
        if not per_request:
            return total, {}
        share = total / len(running) if running else 0.0
        return total, {r.req_id: share for r in running}
    bs, win, n_sliding = geom["block_size"], geom["window"], geom["n_sliding"]
    per: dict[int, float] = {}
    total_f = 0.0
    for r in running:
        nb_hi = -(-r.cache_len // bs)
        full = (nb_hi - r.pad // bs) * bs
        slot_layers = (n_layers - n_sliding) * full
        if n_sliding:
            pad_eff = max(r.pad, r.cache_len - win)
            slot_layers += n_sliding * (nb_hi - pad_eff // bs) * bs
        b = slot_layers * per_slot
        total_f += b
        if per_request:
            per[r.req_id] = b
    return int(total_f), per


def _epilogue_logits_bytes(eng: Any, sample_rows: int) -> float:
    """HBM traffic of the step's sampling tail: the logits tail
    materializes ``[sample_rows, V]`` float32 logits (written by the
    lm_head product, read back by the sampler — 8 bytes a pair, every
    slot including inactive ones: the step samples at its full static
    width).  The fused ``sample_epilogue`` keeps them on chip, so it pays
    zero."""
    if getattr(eng, "epilogue_impl", "xla") == "fused":
        return 0.0
    return float(sample_rows * eng.config.vocab_size * 4 * 2)


class TelemetryModel:
    """The analytic cost model, frozen at engine-build time from the
    params tree and config.  Methods take the engine (geometry and
    composition live there); the model itself holds no mutable state,
    so ``clone_fresh`` rebuilds and fleet replicas share one instance.
    """

    def __init__(
        self,
        config: Any,
        params: Any,
        *,
        hbm_gbps: float = HBM_GBPS_DEFAULT,
        peak_tflops: float = PEAK_TFLOPS_DEFAULT,
    ) -> None:
        if hbm_gbps <= 0:
            raise ValueError(f"hbm_gbps must be > 0, got {hbm_gbps}")
        if peak_tflops <= 0:
            raise ValueError(
                f"peak_tflops must be > 0, got {peak_tflops}"
            )
        self.hbm_gbps = float(hbm_gbps)
        self.peak_tflops = float(peak_tflops)
        total_b = total_n = 0
        for leaf in _leaves(params):
            total_b += int(leaf.nbytes)
            total_n += leaf.numel()
        # the embed entry may itself be a subtree (quantize_params turns
        # it into {"q", "scale"}) — sum its leaves like the total does
        embed = params.get("embed_tokens") if isinstance(params, dict) \
            else None
        embed_b = embed_n = 0
        for leaf in _leaves(embed):
            embed_b += int(leaf.nbytes)
            embed_n += leaf.numel()
        # bytes every dispatch streams: the decoder stack + final norm
        # (+ the untied lm_head, already a leaf); the embedding table is
        # GATHERED (one row per token), not streamed
        self.stream_bytes = total_b - embed_b
        # a tied lm_head re-reads the full embedding matrix for logits
        tied = bool(getattr(config, "tie_word_embeddings", False))
        self.lm_head_bytes = embed_b if tied else 0
        self.embed_row_bytes = (
            embed_b // max(config.vocab_size, 1) if embed_b else 0
        )
        # parameters that do a multiply-add per token (MFU numerator)
        self.n_flop_params = (total_n - embed_n) + (embed_n if tied else 0)

    # ------------------------------------------------------------------
    def weight_bytes(self, tokens: int, n_dispatches: int = 1) -> int:
        """HBM weight traffic for ``n_dispatches`` forward dispatches
        covering ``tokens`` packed tokens."""
        return (n_dispatches * (self.stream_bytes + self.lm_head_bytes)
                + tokens * self.embed_row_bytes)

    def _cost(self, kind: str, rows: list, kv_read: float,
              n_dispatches: int = 1,
              tail_bytes: float = 0.0) -> dict[str, Any]:
        tokens = sum(t for _, t, _, _ in rows)
        return {
            "kind": kind,
            "tokens": tokens,
            "kv_read_bytes": kv_read,
            "kv_write_bytes": float(sum(w for _, _, _, w in rows)),
            # the sampling tail's logits traffic (zero when fused)
            # rides the weight term: same streamed-per-dispatch shape,
            # and attribution/conservation follow unchanged
            "weight_bytes": float(
                self.weight_bytes(tokens, n_dispatches) + tail_bytes
            ),
            "flops": 2.0 * self.n_flop_params * tokens,
            "rows": rows,
        }

    def mixed_tick_cost(self, eng: Any, decode_rows: list,
                        prefill_segs: list) -> dict[str, Any]:
        """The unified tick's planned byte/FLOP bill.  Must run BEFORE
        the dispatch's accept walk (verify lanes live in ``draft_len``
        only until then)."""
        kv_read, per_read = mixed_tick_kv_read(eng, decode_rows,
                                               prefill_segs)
        wslot = (_per_slot_bytes(eng.config, eng.cache_dtype.itemsize)
                 * eng.config.num_hidden_layers)
        rows = []
        for r in decode_rows:
            t = 1 + r.draft_len
            rows.append((r, t, float(per_read[r.req_id]),
                         float(t * wslot)))
        for r, n in prefill_segs:
            rows.append((r, n, float(per_read[r.req_id]),
                         float(n * wslot)))
        return self._cost(
            "mixed", rows, float(kv_read),
            tail_bytes=_epilogue_logits_bytes(
                eng, eng.scheduler.max_slots * eng._spec_w
            ),
        )

    def split_tick_cost(self, eng: Any, running: list) -> dict[str, Any]:
        """The phase-split decode dispatch's bill (prefill dispatches
        are attributed separately via ``prefill_cost`` — they are
        per-request by construction)."""
        kv_read, per_read = split_tick_kv_read(eng, running)
        wslot = (_per_slot_bytes(eng.config, eng.cache_dtype.itemsize)
                 * eng.config.num_hidden_layers)
        rows = [
            (r, 1, float(per_read[r.req_id]), float(wslot))
            for r in running
        ]
        return self._cost(
            "decode", rows, float(kv_read),
            tail_bytes=_epilogue_logits_bytes(
                eng, eng.scheduler.max_slots
            ),
        )

    # ------------------------------------------------------------------
    def finish(self, cost: dict[str, Any],
               device_time_s: float) -> dict[str, Any]:
        """Combine a planned cost with the measured dispatch→host-sync
        wall of the same tick → the telemetry record the metrics/trace/
        sentinel planes consume."""
        total = (cost["kv_read_bytes"] + cost["kv_write_bytes"]
                 + cost["weight_bytes"])
        dev = max(float(device_time_s), 1e-9)
        achieved_gbps = total / dev / 1e9
        ideal_s = total / (self.hbm_gbps * 1e9)
        return {
            "kind": cost["kind"],
            "roofline": True,
            "tokens": cost["tokens"],
            "device_time_s": float(device_time_s),
            "kv_read_bytes": cost["kv_read_bytes"],
            "kv_write_bytes": cost["kv_write_bytes"],
            "weight_bytes": cost["weight_bytes"],
            "achieved_gbps": achieved_gbps,
            "roofline_util": achieved_gbps / self.hbm_gbps,
            "mfu": cost["flops"] / dev / (self.peak_tflops * 1e12),
            # the sentinel's food: wall past the roofline-ideal wall for
            # this tick's bytes, in µs — utilization drops = deficit
            # grows, so EWMA baselining flags persistent regressions
            "deficit_us": max(dev - ideal_s, 0.0) * 1e6,
            "hbm_gbps": self.hbm_gbps,
        }

    def attribute(self, cost: dict[str, Any],
                  device_time_s: float) -> None:
        """Apportion one tick's bill to its requests: KV bytes exact
        per row, weight bytes and device time by token share.  Sums
        conserve (test-pinned)."""
        total_tokens = cost["tokens"]
        if total_tokens <= 0:
            return
        wb = cost["weight_bytes"]
        for req, t, kv_read, kv_write in cost["rows"]:
            frac = t / total_tokens
            req.kv_bytes_read += kv_read
            req.kv_bytes_written += kv_write
            req.weight_bytes_amortized += wb * frac
            req.device_time_s += device_time_s * frac

    def prefill_cost(self, eng: Any, req: Any,
                     device_time_s: float) -> dict[str, Any]:
        """Split-path prefill attribution: the chunk dispatches are
        per-request already, so their whole bill lands on ``req`` and
        the returned record feeds the metrics TOTALS only
        (``roofline: False`` — a chunk window includes host Python, so
        it must not pollute the per-tick roofline gauges).  The chunk
        attention reads the temp cache, not the pool; that traffic is
        deliberately out of the model (both the request and the totals
        skip it, so conservation holds)."""
        shared_slots = req.n_shared_blocks * eng.block_size
        w = eng._prefill_width(req)
        fresh_tokens = w - shared_slots  # pads embed-gather too
        n_chunks = max(fresh_tokens // eng.prefill_chunk, 0)
        wslot = (_per_slot_bytes(eng.config, eng.cache_dtype.itemsize)
                 * eng.config.num_hidden_layers)
        fresh_slots = (
            (len(req.block_ids) - req.n_shared_blocks) * eng.block_size
        )
        kv_write = float(fresh_slots * wslot)
        weight = float(self.weight_bytes(fresh_tokens,
                                         n_dispatches=n_chunks))
        req.kv_bytes_written += kv_write
        req.weight_bytes_amortized += weight
        req.device_time_s += device_time_s
        return {
            "kind": "prefill",
            "roofline": False,
            "tokens": fresh_tokens,
            "device_time_s": float(device_time_s),
            "kv_read_bytes": 0.0,
            "kv_write_bytes": kv_write,
            "weight_bytes": weight,
            "hbm_gbps": self.hbm_gbps,
        }
