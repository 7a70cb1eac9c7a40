#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llm_np_cp_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — card name and count, torch/CUDA versions, power limit, and
   the time to build the kernels from ``llm_np_cp_tpu_torch/csrc``.
2. kernels — each kernel against its plain PyTorch version on the card,
   in bfloat16, at the main path's shapes and at wider ones: max error
   against the stated tolerance, kernel / plain / library-call times
   (CUDA events over many launches after warm-up) and the bound.  The
   prefill kernel (``flash_attention``, up to 4096-token prompts at
   Llama-3.2-1B, Llama-3.1-8B and Gemma-2-2B widths) records its own
   device time (torch.profiler), SDPA's beside it and the achieved
   TFLOP/s, and each of its cases shows that its check catches the plain
   version with one visible kv tile dropped.  The
   two split-KV decode kernels (slab and paged) record each case's NSPLIT
   and their kernels' own device time (torch.profiler), and their combine
   is held alone against its plain version on each split kernel's
   partials, with a dropped split that the check must catch.  The
   epilogue (float and int8 heads, tied and untied, Llama-3.2-1B,
   Gemma-2 and Llama-3.1-8B widths) records its device time too, and
   each of its cases plants row 0's best column at V-1 and row 1's at 0
   and checks those tokens exactly.  ``softmax`` (on no model path, as in
   the JAX package) is timed here too.  The threefry kernels
   (``csrc/threefry.cu``, jax.random's bits on the card): their words and
   draws against known answers made from jax by the CPU tests
   (``KNOWN_ANSWERS``), ``threefry2x32`` against its plain version on the
   tick's row keys and a [4, 128256] draw, and ``categorical`` on 8, 4
   and 40 rows of 128256 and 8 of 256000, tokens equal (flips under a
   1e-5 top-2 margin count as ties), with the exponential race the port
   drew with before timed beside it.
3. main path — Llama-3.2-1B at full width and depth on seeded random
   bf16 weights: ``Generator.generate`` (flash prefill, decode kernel,
   fused epilogue), ``generate_ragged`` and ``stream``, then one
   ``generate`` on a B=1 x 4096-token prompt (its TTFT); launch counts
   must equal what the path implies, and a teacher-forced cache-less
   plain forward must agree with every chosen token.
   Every decode step of these runs (and every unified tick of leg A
   below) is a captured CUDA graph: each shape's first step runs eagerly
   and is captured (the engine's ``warmup`` captures every bucket), every
   later one is a replay, which the launch counts see (each replay adds
   the kernels its graph captured); the script requires that every step
   was a replay or such a first step.
4. profile — torch.profiler over one more ``generate``: device time by
   kernel and the device's busy share of the wall time.
4b. graphs — each kind of captured step against the same step function
   run eagerly (``graphs.eager_steps``), identical tokens required: the
   main path's Generator, the decode loop with xla attention or the
   logits tail, a min-p Generator (the captured draws against the eager
   draws of the same seed, every step a replay) and, on the serve
   trace's requests submitted at once, the unified tick of leg A (greedy
   and min-p) and the phase-split decode step of leg B (paged,
   flash_decode and xla decode attention, and paged with min-p; one
   graph an engine); each graph's capture time, pool bytes and replays.
5. serve — the same model behind ``ServeEngine.replay_trace`` on a
   32-request Poisson trace, in two legs: A, the unified tick
   (``ragged_paged_attention`` + its combine when NSPLIT > 1 + fused
   epilogue), and B, the phase-split tick with the paged decode
   (``paged_decode_attention`` + its combine when NSPLIT > 1 + fused
   epilogue; its decode step a captured graph); both legs again with
   min-p (the logits tail, each tick's row keys ``fold_in(PRNGKey(seed),
   position)`` and the categorical draw on the card); leg A once more at
   long context (4 requests of 1024-1536 tokens), where the ragged plan
   splits.  Per leg: every request finished, launch counts equal what the
   ticks imply, one host fetch per dispatching tick, every step a graph
   replay and no capture in the timed replay, every token teacher-forced
   against a cache-less plain forward (min-p: inside the sampler's
   support there), and wall time, tok/s, ticks, dispatches, TTFT and
   TPOT.  A float32 run of both
   legs must match the offline ``generate_ragged`` token for token (or
   differ only at a near-tie), and torch.profiler traces a short leg-A
   replay.
6. quant — the same model quantized on the card (``quantize_params``) in
   each of int8, int8_a8, int4 and int4_a8: ``Generator.generate`` with
   the int8-head epilogue as the decode tail (launch counts equal what
   the path implies: one int8 epilogue launch per decode step, no float
   one), every token teacher-forced against a cache-less plain forward
   over the same quantized params, TTFT and decode rate beside the bf16
   main path's, ``param_bytes`` and ``quant_quality`` against the bf16
   model (recorded, not gated); float32 int8 and int8_a8 runs (the int8
   gap must be ~0: summation order only; W8A8 keeps its activation
   rounding noise); a torch.profiler trace of an int8 ``generate``; and
   one unified-tick ``replay_trace`` of the serve trace with int8
   weights (16 ragged + 1 int8 epilogue launches per tick).
7. spec — speculative decoding on the same model.  Offline,
   ``SpeculativeGenerator`` (B=4 x 128-token prompts, 64 new tokens,
   gamma=4) with the int8 self-draft and with an 8-layer
   ``truncated_draft``: every token teacher-forced against a cache-less
   plain forward, the tokens equal to the plain ``Generator``'s or first
   apart at a near-tie, no attention or epilogue kernel launched (the
   draft and verify forwards take the plain attention path, as in the
   JAX package) and only the round's keyed draws, every round a
   graph replay after a warm-up, the captured rounds' tokens equal to an
   eager run's; decode rate beside the plain ``Generator``'s, TTFT,
   acceptance, tokens a round.  Served, ``ServeEngine(spec_k=4)`` leg A
   on the serve trace's arrivals with every prompt a random 32-token
   segment tiled to 128 tokens and 64 new tokens, submitted
   ``speculative=True``: every request
   finished and teacher-forced, drafts drafted and accepted, one host
   fetch per dispatching tick, no graph beyond the buckets, 16 ragged
   launches and 1 epilogue launch per tick, the captured ticks' tokens
   equal to an eager run's, and a float32 run of spec and plain leg A
   equal token for token or apart only at a near-tie; tok/s, TPOT, TTFT
   and ticks beside plain leg A on the same trace at the same tick
   budget, and the ticks that carried a verify slice.
8. tier — the host-RAM KV tier on the JAX package's
   ``serve_prefix_tiered`` shape: the same model behind the engine, 48
   requests at 16 req/s cycling 24 distinct 512-token prompts, 64 new
   tokens, 8 slots, 128-slot blocks, 256-token chunks and a 14-block pool
   against a 48-block prefix working set.  On identical arrivals: (a) the
   unified tick without a tier, (b) with a 4 GiB ``HostTier``, (c) as (b)
   with the int8 pool, (d) the phase split with the paged decode and the
   tier.  Per leg: every request finished and teacher-forced, launch
   counts equal what the steps imply, one host fetch a step, every step a
   replay and no capture in the timed replay; tier legs: no restore miss,
   the spill / restore ledgers equal the tier's own stats, restore latency
   p50/p99, the probe's GB/s and the breakeven ratio.  (b) must dispatch
   fewer prefill tokens than (a) at a higher prefix hit rate, with (a)'s
   tokens or apart first at a near-tie.  A block spilled and restored into
   another block id comes back bit-exact, and ``spill_prefix_blocks`` lets
   a second engine sharing the tier prefill only a prompt's last chunk.
9. http — the HTTP front end (``serve/http``) on the JAX bench's
   ``serve_http_poisson`` shape: the same model behind the engine (8
   slots, 128-slot blocks, 256-token chunks, the unified tick, greedy), 32
   requests at 16 req/s with 128-512-token prompts (``poisson_trace``
   seeded 13) and 64 new tokens.  On one warmed engine, four legs in the
   order direct, HTTP, HTTP, direct: the direct
   ``replay_trace(realtime=True)``, and the same arrivals through the
   server started in process by ``run_server`` (the coroutine
   ``serve_forever`` runs) with one ``astream_completion`` client a
   request.  Every response 200; each request's tokens equal the first
   direct leg's or first apart at a near-tie, every HTTP request
   teacher-forced; every tick of every leg a graph replay with no capture
   (the HTTP legs' from the runner's thread); launch counts as the ticks
   imply; the ``/metrics`` scrape parses and its finished / submitted
   counters equal the snapshot; one more stream, cut after a few tokens,
   leaves ``request_held`` at 0.  Per leg: client-observed TTFT p50/p99,
   TPOT p50 and tok/s, and each tick's host wall and thread-CPU time on
   the thread that ran it (their difference, the time off the CPU inside
   the tick, is what the event loop's share of the GIL costs the HTTP
   legs), with the kv_bytes_tick gauge's host time.
9b. observe — the observability plane (``serve/{tracing,slo,telemetry,
   otel,tenants}.py``) on the http phase's trace and engine: HTTP legs
   untraced, traced, traced without the OTLP exporter (twice), traced,
   untraced.  A traced leg carries a ``TraceRecorder`` (a ring), a
   ``TickSentinel``, an ``SLOTracker``, a ``TelemetryModel`` with the
   card's 3350 GB/s and 989 TFLOP/s, a ``TenantLedger`` over three
   tenants, a request log and an ``OtlpExporter`` feeding a stdlib
   collector on 127.0.0.1 that the phase runs.  Required: traced tokens
   equal to the untraced leg's or apart at a near-tie, every token
   teacher-forced; no capture, every tick a replay, launches as the ticks
   imply; one tick span a tick, its phases contiguous and covering it;
   ``0 < roofline_util < 1`` and ``mfu < 1`` on every graded tick; the
   ticks' byte args summing to the ledgers, and the request log's cost
   blocks and ``/debug/tenants``' per-tenant sums equal to them; every
   span the exporter counts received, none dropped; the ``/debug/trace``
   dump read by ``tools/summarize_trace.py`` (a subprocess).  Then a
   torch.profiler capture of traced ticks (``serve.mixed_dispatch``
   ranges; the dispatch → fetch wall against each tick's device span), a
   tenant leg whose in-flight cap throttles one tenant (429s counted as
   throttles and rejects), an OTLP leg against a closed port (errors and
   drops counted, no tick stalled), and traced against untraced on one
   composition: a phase-split leg (paged decode; ``TICK_PHASES``, the
   prefill chunks' records), a min-p leg (the threefry kernels) and a
   float32 leg — tokens identical, attribution conserving.  Per HTTP
   leg: tok/s, TTFT and TPOT p50, each tick's host wall and CPU time.
10. chaos — faults and supervised recovery (``serve/faults.py``, the
   runner's restart) on the JAX bench's ``serve_chaos_poisson`` shape,
   not cut: the http phase's model, trace and engine over HTTP
   (``run_server`` with ``max_restarts=3``, ``restart_backoff_s=0.2``,
   ``tick_deadline=60``), a clean leg and a leg under
   ``tick_crash@90;decode@40`` (both sites restart the engine in the
   port).  Per leg: every request answered with 64 tokens, restarts and
   each one's recovery latency, each rebuild's capture seconds and
   graph-pool bytes, peak reserved memory, client TTFT p50/p99 and TPOT
   p50, the scrape's ``requests_recovered_total`` and
   ``faults_injected_total``.  The chaos leg must restart at least twice,
   capture only in its rebuilds (every tick a replay, 16 ragged launches
   a tick or capture), replay no graph after its engine was retired, stay
   within one pool plus its graph pools of the clean leg's peak reserved
   memory, and give the clean leg's tokens or part from them at a
   near-tie, every token teacher-forced.  Float32 legs on the trace's
   first 8 requests (16 new tokens), greedy and min-p, under a crash and
   a hang past a 3 s ``tick_deadline``: two restarts, recovered streams
   equal to the clean leg's token for token.  The chaos legs run with a
   tracer and a sentinel: one ``engine-death`` instant and one
   ``restart`` span a restart, no tick span between a death and the end
   of its rebuild, and the sentinel's samples equal to the tick spans.
10b. cli — the port's command line (``llm_np_cp_tpu_torch.cli``) over
   an HF checkpoint directory that the phase writes under
   ``smoke_out/cli/`` (config.json, two safetensors shards and their
   index, written here: the card's machine has no ``safetensors``) from
   the seeded weights, and loads back through ``--model`` (``load_model``;
   it must equal the seeded weights), with a byte-level stand-in
   tokenizer (``ByteTokenizer``) passed as ``cli.run(..., tokenizer=)``.
   Seven legs through ``cli.run`` in process: (a) greedy ``--no-stream
   --attn-impl flash --decode-attn pallas --metrics --jax-profile``
   (flash, the decode kernel and its combine, the epilogue; the profiler's
   trace must name the three kernels), (b) the default streamed min-p run
   with ``--seed`` (the threefry kernels), (c) ``--quantize int8`` greedy
   (the int8-head epilogue), (d) ``--prompts-file`` of four uneven prompts
   with ``--batch-size 2``, (e) ``--speculative 4 --draft trunc4``, (f)
   ``serve-bench --requests 32 --rate 16 --json`` (the ragged kernel and
   the epilogue; all 32 finished) and (g) the same with ``--mixed-step off
   --attn-impl paged`` (the paged decode kernel).  Each leg's launch
   counts must equal what its flags imply (a, c, f, g by formula; b, d, e:
   the same work run directly through the library), and its tokens must
   equal a direct ``Generator`` / ``SpeculativeGenerator`` / ``ServeEngine``
   run on the same loaded params (f and g: or first apart at a near-tie,
   their schedules following the wall clock), greedy ones teacher-forced
   and min-p ones inside the sampler's support.  Then ``python -m
   llm_np_cp_tpu_torch.cli serve`` as a child process with ``--journal``:
   ``/healthz`` ok, two unary and two SSE token-id completions equal to an
   in-process engine's on the same weights, and after SIGTERM a drain and
   exit 0.  Recorded: each leg's launches, TTFT and tok/s as ``--metrics``
   and ``--json`` report them, the checkpoint's write and load seconds.
   Last, ``--mesh 1,1,2`` on ``--backend cuda`` must refuse with JAX's
   ``plan needs 2 devices, have 1`` on one card (NCCL wants a card a
   rank; the mesh phase shares one card over gloo instead).
11. restart — the durable journal's ``kill -9`` resume on the JAX bench's
   ``serve_restart_poisson`` shape: the server runs in a child process
   (``python -m llm_np_cp_tpu_torch.cli serve`` over the cli phase's
   checkpoint, with ``--journal`` and ``--chaos-spec``).  A plain leg and a journaled leg
   on the same arrivals (their tok/s, the journal's fsync p99), then a
   journaled child that SIGKILLs itself at its 90th busy tick
   (``proc_kill@90``); a new child on the same port and journal replays
   it, and every client resumes by Last-Event-ID.  Required: exit by
   SIGKILL, 32 of 32 streams complete with 64 tokens (none resent), the
   journal replayed, every stream teacher-forced and equal to the plain
   leg's or apart at a near-tie; recorded: restart to first resumed token
   as the clients saw it (the new child's start, weights and captures
   included) and ``journal_replayed_total``.
12. moe — Mixtral-8x7B's published widths (``ModelConfig.from_hf_dict``
   of its config.json: 8 experts, 2 a token, untied 4096 x 32000 head)
   at 4 of its 32 layers on seeded random bf16 weights (~12.3 GB; 32
   layers would not fit the card; 8 until the mesh phase's serve legs
   needed the time), its expert stacks drawn and quantized
   a layer at a time.  Offline ``generate`` / ``generate_ragged`` /
   ``stream`` with launch counts and graph replays (TTFT, decode rate),
   each run again eagerly with its routes recorded: identical tokens
   required, then route-pinned teacher forcing (``pinned_forced``: the
   cache-less plain forward takes the path's experts and drops, so that
   a near-tied route bf16 rounding flips cannot cascade; output logits
   within ``MOE_TEACHER_TOL``, router logits within ``MOE_ROUTER_TOL``,
   ~3x the plain path's own floor), a gate without drops
   (capacity factor E / k = 4.0) and recorded at the published 2.0; a
   model with one expert's down projection zeroed must fail it.  The
   serve trace through legs A, B and A with min-p at 2.0 (launches,
   fetches, replays, tok/s, TTFT, TPOT); each leg's requests, and leg
   A's without drops, submitted at once through a captured and an eager
   engine (identical tokens; routes dropped per tick; leg A's requests
   route-pinned teacher-forced, a gate without drops).  The four weight
   modes without drops (``param_bytes``, peak reserved bytes while
   quantizing, decode rate, captured = eager, route-pinned teacher
   forcing) and an int8 unified-tick replay; a float32 2-layer run whose
   legs A and B equal the offline ``generate_ragged``; a profile
   splitting device time among routing, slot positions, dispatch,
   expert products, combine, attention kernels and epilogue.
12b. train — training on the card through ``llm_np_cp_tpu_torch.train.run``
   (the user's ``python -m llm_np_cp_tpu_torch.train``): Llama-3.2-1B at
   full width and depth in float32 (the CLI's default dtype), seeded
   weights, 8 x 128 tokens of the fixed synthetic corpus, 6 steps: each
   step's loss and tok/s, the first loss beside ln(vocab), peak reserved
   memory; then the same weights and batches through the library's
   pieces (``causal_lm_loss``, ``loss_and_grads``, ``AdamW.update``),
   each step's device time split into forward, backward and optimizer
   (CUDA events) and the achieved TFLOP/s (6·N·tokens plus attention);
   then the checkpoint round trip of the whole state (params and both
   moments) after step 4: write and read seconds and bytes, and step 5
   from the continued and the restored state, whose losses must agree
   within 1e-6.  No kernel of the port is on this path (the plain
   attention, as the JAX loss).
13. mesh — generation over a mesh (``parallel/``, ``Generator(mesh=)``):
   one spawned group of 4 ranks, all on cuda:0, joined over gloo (every
   collective stages its CUDA tensor through host memory; the decode
   steps run eagerly), Llama-3.2-1B at full widths and depth on the main
   path's seeded bf16 weights.  Leg a: seq 2 x model 2, ring prefill of a
   2047-token prompt (padded to 2048 over the seq axis) and 32 greedy
   tokens; leg b: data 2 x model 2 at B=4 x 128, greedy and min-p; leg c:
   leg b's greedy run on int8 weights.  Every leg: the ranks return the
   same tokens, greedy tokens teacher-forced against the one-rank plain
   forward and its cached twin within ``TEACHER_TOL`` (min-p: inside the
   sampler's support), the first divergence from the one-rank
   ``Generator`` printed, every rank's launches (flash prefill,
   ``decode_attention`` and its combine, the epilogue merged over the
   vocab shards, min-p's categorical) equal to what the leg implies, and
   every collective host-staged; TTFT and tok/s as one card shared by 4
   ranks, not a multi-GPU figure.  Then, in the same group, the
   tensor-parallel ``ServeEngine(mesh_plan=MeshPlan(model=4))`` (8 of 32
   query heads, 2 of 8 KV heads, a 32064-row vocab shard a rank), eager
   ticks: leg s1, the unified tick, greedy, 16 requests of 64-256-token
   prompts cycling 8 with the prefix cache on, 32 new tokens, 8 slots,
   16-slot blocks; leg s2, the phase-split tick with the paged decode
   over an int8 pool, 8 requests.  Each: the ranks serve the same tokens,
   every rank's ragged / paged launches (and their combines) and fused
   epilogue equal to its dispatching steps' implication, no graph
   captured, the pool in 4 KV shards (``shard_stats``), every request
   teacher-forced against the cache-less plain forward (s2: over an int8
   cache), its first divergence from a one-rank engine on the same trace
   printed with the plain top-2 gap there; TTFT / TPOT / tok/s of the
   shared card.  The kernel phase holds each kernel at a rank's shapes
   too (16 of 32 heads, half the tied head with its row maxima; at
   model=4, the ragged serve tick at 8/2 heads, the paged int8 decode and
   the epilogue on a quarter of the head).  Last in the same group, two
   training legs on the train phase's float32 weights and batches, 2
   steps each: t1 ``data=2,model=2`` (``make_train_step(mesh=)``) and t2
   ``pipe=2,model=2`` with 2 microbatches (``make_pp_train_step``), their
   losses within 2e-4 of the train phase's, each rank's collective
   counts and step walls (gloo staging on a shared card, not a
   multi-GPU figure).
14. the ``kernels`` summary line (each row with its ``moe_launches`` and
   ``mesh_launches``), the
   card's ``nvidia-smi`` name and power limit, and last the result line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Exits non-zero, printing no result, when no CUDA card is visible.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the checkout this script runs from (smoke_out/ under it is gitignored)
ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth and
# bf16 tensor-core rate — the bound of each kernel case.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# float32 outside the tensor cores: softmax's exp/sum/scale
F32_FLOPS_PER_S = 67e12

# bf16 attention outputs: |kernel - plain| <= ATTN_TOL * (1 + |plain|),
# two bf16 ulps (2^-6 relative) at the output's own magnitude.  The decode
# kernels (slab, paged, ragged) and the combine are held to ATTN_TOL times
# each head row's largest |plain| instead (attn_err_rows): over S visible
# slots their outputs are ~sqrt(e / S) in size, below the 1 + |plain| floor.
# The prefill kernel is held to both (flash_err).
ATTN_TOL = 2.0 ** -6
EPILOGUE_TOL = 1e-3  # float32 logits: summation order and norm rounding
# bf16 logits after 16 layers: the kernel path against plain references.
# The seeded model's logit std is ~0.9; the plain cached twin alone is up
# to ~0.04 from the cache-less reference, and a different rounding order
# in attention moves near-tied argmaxes by up to ~0.1.  Exactness is held
# by the float32 run below, where the gap must be ~0.
TEACHER_TOL = 0.15
# the same check with float32 weights, activations and cache: kernels and
# plain references then differ only in summation order
F32_TEACHER_TOL = 2e-3
F32_STEPS = 16

DECODE_STEPS = 64
STREAM_TOKENS = 8
# the main path's long prompt: B=1, flash prefill bound by operations
LONG_PROMPT, LONG_NEW_TOKENS = 4096, 8

# the serve phase: Llama-3.2-1B behind the engine, the trace and pool of
# its issue (32 requests at 40 req/s, prompts 16-200 tokens, 32 new
# tokens each; 8 slots, 16-slot blocks, 64-token prefill chunks)
SERVE_REQUESTS = 32
SERVE_NEW_TOKENS = 32
SERVE_PROMPTS = (16, 200)
SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK = 8, 16, 64
F32_SERVE_REQUESTS, F32_SERVE_TOKENS = 8, 16
# the spec phase: gamma of the offline rounds, the truncated draft's
# layers, spec_k of the served leg, the served prompts' tiled segment
# (extractive traffic: quoting, code edits, structured output) and new
# tokens: a random model's greedy stream rarely copies its prompt, and
# prompt lookup drafts only once the stream repeats itself, which a
# longer stream does more often
SPEC_GAMMA, SPEC_DRAFT_LAYERS, SPEC_K = 4, 8, 4
SPEC_SEGMENT, SPEC_PROMPT, SPEC_NEW_TOKENS = 32, 128, 64
# leg A at long context, where the ragged kernel's plan splits the bands
# (and launches the combine): 4 requests of 1024-1536-token prompts
LONG_SERVE_REQUESTS, LONG_SERVE_PROMPTS, LONG_SERVE_TOKENS = 4, (1024, 1536), 16
SERVE_LEGS = {
    "A_mixed": dict(mixed_step="on"),
    "B_split_paged": dict(mixed_step="off", decode_attn_impl="paged"),
}
# the served samplers: greedy (the fused epilogue) and min-p, the
# reference's live sampler (its default p_base), through the logits tail
# and the keyed categorical draw
SERVE_SAMPLERS = {"greedy": {}, "min_p": dict(p_base=0.1)}

# the tier phase: the JAX package's serve_prefix_tiered workload
# (bench.py SERVE_TIER_CONFIGS) — 48 requests at 16 req/s cycling 24
# distinct 512-token prompts, 64 new tokens, 8 slots, 128-slot blocks,
# 256-token prefill chunks, a deliberately starved 14-block pool (13
# usable, against a 48-block prefix working set) and a 4 GiB host tier
TIER_REQUESTS, TIER_RATE, TIER_PROMPT, TIER_DISTINCT, TIER_NEW = 48, 16.0, 512, 24, 64
TIER_SLOTS, TIER_BLOCK, TIER_CHUNK, TIER_BLOCKS = 8, 128, 256, 14
TIER_BYTES = 4 << 30
# leg → (engine keywords, tier on, int8 pool)
TIER_LEGS = {
    "a_mixed_off": (dict(mixed_step="on"), False, False),
    "b_mixed_tier": (dict(mixed_step="on"), True, False),
    "c_mixed_tier_int8": (dict(mixed_step="on"), True, True),
    "d_split_paged_tier": (dict(mixed_step="off", decode_attn_impl="paged"), True, False),
}

# the http phase: the JAX bench's serve_http_poisson (bench.py:178-181,
# its trace at bench.py:2027-2033) — 32 requests at 16 req/s, prompts
# 128-512 tokens, 64 new tokens, 8 slots, 128-slot blocks, 256-token
# chunks; the trace seeded 13
HTTP_REQUESTS, HTTP_RATE, HTTP_PROMPTS, HTTP_NEW, HTTP_SEED = 32, 16.0, (128, 512), 64, 13
HTTP_SLOTS, HTTP_BLOCK, HTTP_CHUNK = 8, 128, 256
# tokens the disconnect check's stream reads before it hangs up
HTTP_CUT_AFTER = 3
# the scrape's sample lines: the JAX package's own pattern
PROM_LINE = r"[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?[0-9.]+(e[+-]?[0-9]+)?"

# the chaos phase: the JAX bench's serve_chaos_poisson (bench.py:196-200,
# run at bench.py:2189-2351), not cut — the http phase's model, trace and
# pool, supervised (max_restarts 3, backoff 0.2 s, tick_deadline 60 s)
# under a tick-thread crash at the 90th busy tick and a dispatch fault at
# the 40th dispatch; clients retry 4 times (backoff 0.1 s), as the
# bench's do.  Then a float32 leg on the trace's first 8 requests (16 new
# tokens) under a crash and a hang past a short tick_deadline, greedy and
# min-p, whose recovered streams must equal the clean ones exactly.
CHAOS_SPEC, CHAOS_DEADLINE, CHAOS_BACKOFF, CHAOS_RESTARTS = (
    "tick_crash@90;decode@40", 60.0, 0.2, 3)
F32_CHAOS_REQUESTS, F32_CHAOS_TOKENS = 8, 16
F32_CHAOS_SPEC, F32_CHAOS_DEADLINE = "tick_crash@6;tick_hang@12=6", 3.0
# the restart phase: the JAX bench's serve_restart_poisson (bench.py:285-
# 287, run at bench.py:2354-): the same trace and model, the server the
# port's ``cli serve`` in a child process that SIGKILLs itself at its
# 90th busy tick (--chaos-spec proc_kill@90); a new child on the same
# port and --journal replays it, and every client resumes by
# Last-Event-ID
RESTART_KILL_TICK = 90

# the quant phase: quantize_params keywords per weight mode, and the
# greedy continuation quant_quality compares with the bf16 model
QUANT_MODES = {
    "int8": dict(bits=8, act_quant=False),
    "int8_a8": dict(bits=8, act_quant=True),
    "int4": dict(bits=4, act_quant=False),
    "int4_a8": dict(bits=4, act_quant=True),
}
QUALITY_STEPS = 32
# the W8A8 / W4A8 modes quantize every projection's input rows to int8
# on the fly: any rounding difference upstream (summation order, even in
# float32) moves some activation across an int8 rounding boundary, and
# the flip carries through the layers.  The plain path alone (cached
# twin against the cache-less forward, no kernels) measured gaps of
# 0.23-0.28 in bf16 and 0.19 in float32 in these modes on an NVIDIA H100
# 80GB HBM3 (700 W), against 0.00-0.07 weight-only; the limit is ~3x
# that floor and still
# far below a wrong token's gap (logit std ~0.9)
A8_TEACHER_TOL = 0.8
# softmax outputs: two bf16 ulps at the output's own magnitude, or 1e-6
# in float32
SOFTMAX_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-6}

# jax.random's words and draws (jax 0.9.0, threefry2x32, partitionable,
# 64-bit types off), made from jax on the CPU by
# tests/test_torch_random.py::test_chip_smoke_known_answers_match_jax: the
# card has no jax, so the threefry kernels are held against these.  The
# categorical case's logits are ((i * 7919) % 1000) / 100 - 5 over the
# flat index i of [4, 128256] (exact in float32); its draws are at least
# 0.3 clear of a tie.
KNOWN_ANSWERS = {
    "seed": 42,
    "split3": [[1832780943, 270669613], [64467757, 2916123636], [2465931498, 255383827]],
    "fold_data": 123457, "fold_in": [2757193699, 325797471],
    "bits8": [2098992034, 2919706841, 2646866425, 2409546199, 1935504149, 2516274904,
              321304473, 3329172656],
    "uniform8_words": [1056585764, 1059981104, 1058915320, 1057988288, 1055308516, 1058405198,
                       1033450928, 1061580580],
    "categorical_shape": [4, 128256], "wide_index": [0, 1, 128255, 128256, 513023],
    "bits_wide": [2098992034, 2919706841, 4199866158, 342779515, 1060354040],
    "categorical": [34593, 82329, 74402, 38739],
    "categorical_rows": [123954, 100785, 77811, 9492],
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, markers: dict[str, str], iters: int = 20,
              attempts: int = 6) -> dict[str, float]:
    """Device time per call of ``fn`` by kernel (name → substring of the
    CUDA symbol), from torch.profiler over ``iters`` calls after warm-up:
    the kernels' own time, without the host's launch overhead that CUDA
    events around a short kernel also measure.  The tracer now and then
    loses a trace's device activity on the card, so a trace in which a
    marker reads 0 is taken again, up to ``attempts`` times; a kernel
    that is really not launched reads 0 every time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        got = {name: 0.0 for name in markers}
        for e in prof.key_averages():
            dev_us = getattr(e, "self_device_time_total", 0) or 0
            if e.device_type != DeviceType.CUDA or dev_us <= 0:
                continue
            for name, marker in markers.items():
                if marker in e.key:
                    got[name] += dev_us / 1e3 / iters
        if all(got.values()):
            break
    return got


def attn_err(out, ref) -> tuple[float, bool]:
    """(max |out - ref|, whether every element is within ATTN_TOL * (1 + |ref|))."""
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= ATTN_TOL * (1.0 + ref.float().abs())).all())
    return diff.max().item(), ok


def attn_err_rows(out, ref) -> tuple[float, bool]:
    """(max |out - ref|, whether every element is within ATTN_TOL times
    the largest |ref| of its head row, the last axis): a bf16 rounding
    of either side is at most one ulp of that row maximum, two to four
    ulps below the limit.  A fully masked row must be exactly zero."""
    diff = (out.float() - ref.float()).abs()
    lim = ATTN_TOL * ref.float().abs().amax(dim=-1, keepdim=True)
    return diff.max().item(), bool((diff <= lim).all())


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def reset_counts(kernels: dict) -> None:
    """Set every launch count to 0; ``kernels`` maps a name to its
    (wrapper, count attribute)."""
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)


def read_counts(kernels: dict) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in kernels.items()}


def float32_params(params: dict) -> dict:
    """A float param dict's float32 copy."""
    return {k: {n: t.float() for n, t in v.items()} if k == "layers" else v.float()
            for k, v in params.items()}


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def picked(specs, names) -> list[tuple[int, tuple]]:
    """``(index, spec)`` of every spec (``names`` None), or of those whose
    name (``spec[0]``) is in ``names``; the index seeds a case's inputs,
    so a case draws the same inputs either way."""
    return [(i, s) for i, s in enumerate(specs) if names is None or s[0] in names]


# name, B, S, H, K, D, softcap, window — the main path's shape first,
# then the long prompts where prefill attention is bound by operations:
# Llama-3.2-1B at 4096, Llama-3.1-8B's widths (D=128, also Llama-3.2-3B's
# and Qwen-2's), Gemma-2-2B with its real 4096-slot window
FLASH_SPECS = (
    ("llama1b_main_4x128", 4, 128, 32, 8, 64, None, None),
    ("llama1b_prefill_1x512", 1, 512, 32, 8, 64, None, None),
    ("gemma2_2b_1x512_softcap50_window128", 1, 512, 8, 4, 256, 50.0, 128),
    ("llama1b_prefill_1x4096", 1, 4096, 32, 8, 64, None, None),
    ("llama8b_prefill_1x2048_d128", 1, 2048, 32, 8, 128, None, None),
    ("gemma2_2b_1x4096_softcap50_window4096", 1, 4096, 8, 4, 256, 50.0, 4096),
    # the moe phase's prefill at Mixtral-8x7B's attention widths
    ("mixtral_prefill_4x128_d128", 4, 128, 32, 8, 128, None, None),
    # the mesh phase's per-rank prefill (data 2 x model 2: 2 of 4 rows,
    # 16 of 32 heads, 4 of 8 KV heads)
    ("llama1b_tp2_rank_2x128", 2, 128, 16, 4, 64, None, None),
)


def flash_inputs(torch, i: int):
    """(q, k, v, keywords) of ``FLASH_SPECS[i]``, bf16, seeded."""
    _, b, s, h, kh, d, cap, win = FLASH_SPECS[i]
    g = torch.Generator(device="cuda").manual_seed(i + 1)
    q = torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
    return q, k, v, dict(scale=d ** -0.5, logit_softcap=cap, window=win)


def flash_err(out, ref) -> tuple[float, bool]:
    """``attn_err_rows`` and ``attn_err`` together: within ATTN_TOL times
    both the head row's largest |plain| and 1 + |plain|."""
    err, rows_ok = attn_err_rows(out, ref)
    return err, rows_ok and attn_err(out, ref)[1]


def flash_dropped_tile(torch, fa, q, k, v, kw):
    """The plain version with one visible kv tile dropped: the last q
    tile's diagonal tile (the kernel's plan), gone from that q tile's
    rows.  A fault the check must catch."""
    from llm_np_cp_tpu_torch.ops.attention import causal_mask, gqa_attention

    s = q.shape[1]
    plan = fa.flash_plan(s, q.shape[3], q.dtype)
    q0, kv0 = (plan.q_tiles - 1) * plan.bq, (s - 1) // plan.bkv * plan.bkv
    pos = torch.arange(s, device=q.device)
    mask = causal_mask(pos[None, :], pos, window=kw["window"])
    mask[:, q0:, kv0:kv0 + plan.bkv] = False
    return gqa_attention(q, k, v, mask, scale=kw["scale"], logit_softcap=kw["logit_softcap"])


def flash_cases(torch, F, fa, sdpa_gqa: bool, names=None) -> list[dict]:
    """The prefill kernel on ``FLASH_SPECS`` (those in ``names``, if
    given): events ms, the kernel's own device time (profiler), SDPA's
    beside it where SDPA computes the same function (no softcap, no
    window), the bound and the achieved rate."""
    cases = []
    for i, (name, b, s, h, kh, d, cap, win) in picked(FLASH_SPECS, names):
        q, k, v, kw = flash_inputs(torch, i)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, **kw)
        err, ok = flash_err(out, ref)
        _, fault_passes = flash_err(flash_dropped_tile(torch, fa, q, k, v, kw), ref)
        del ref
        call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        ms = time_ms(torch, call, 50)
        dev = device_ms(torch, call, {"flash": "flash_kernel"})["flash"]
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
        lib_ms = lib_dev = None
        if cap is None and win is None and sdpa_gqa:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, scale=kw["scale"], enable_gqa=True)
            lib_ms = time_ms(torch, sdpa, 50)
            lib_dev = device_ms(torch, sdpa, {"all": ""})["all"]
        pairs = sum(min(r + 1, win or s) for r in range(s))
        flops = 4.0 * b * h * d * pairs
        nbytes = 2 * (2 * b * s * h * d + 2 * b * s * kh * d)
        bms, by = bound(nbytes, flops)
        plan = fa.flash_plan(s, d, q.dtype)
        cases.append(dict(kernel="flash_attention", case=name, max_abs_err=err, tol=ATTN_TOL,
                          tol_kind="relative to the head row's largest |plain| and to 1 + |plain|",
                          within_tol=ok and not fault_passes,
                          dropped_tile_caught=not fault_passes, ms=ms, device_ms=dev,
                          tflops=flops / dev / 1e9 if dev else None,
                          plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
                          bound_ms=bms, bound_by=by,
                          plan=dict(bq=plan.bq, bkv=plan.bkv, warps=plan.warps,
                                    smem_bytes=plan.smem_bytes)))
        del q, k, v, out
        torch.cuda.empty_cache()
    return cases


def decode_mask(torch, b: int, s: int):
    """Ragged rows: left pads on two rows, one short row, one full row."""
    pads = [0, 17, 40, 3]
    ends = [s, s, s, s // 3]
    mask = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    for r in range(b):
        mask[r, pads[r]:ends[r]] = True
    return mask


# the slab decode's two kernels by CUDA symbol: the split kernel and the
# split-KV combine (csrc/split_kv.cuh)
DECODE_MARKERS = {"decode_attention": "decode_kernel",
                  "decode_attention_combine": "combine_splits_kernel"}


# the slab decode's cases: name, B, S, H, K, D, int8 — the main path's
# shape first.  S is the Generator's slab (its live slots rounded up by
# align_capacity); B > 1 rows are ragged (``decode_mask``)
DECODE_SPECS = [
    ("llama1b_b4_s256_bf16_ragged", 4, 256, 32, 8, 64, False),
    ("llama1b_b4_s256_int8_ragged", 4, 256, 32, 8, 64, True),
    ("llama1b_b4_s4096_bf16_ragged", 4, 4096, 32, 8, 64, False),
    ("llama1b_b4_s4096_int8_ragged", 4, 4096, 32, 8, 64, True),
    ("llama1b_b1_s32768_bf16", 1, 32768, 32, 8, 64, False),
    # the moe phase at Mixtral-8x7B's attention widths: generate,
    # generate_ragged and the weight modes (B=4, 192 live of 256 slots),
    # and stream (B=1)
    ("mixtral_b4_s256_bf16_ragged", 4, 256, 32, 8, 128, False),
    ("mixtral_b1_s256_bf16", 1, 256, 32, 8, 128, False),
    # the mesh phase's per-rank decode (16 of 32 heads, 4 of 8 KV heads):
    # legs b and c (2 of 4 rows, 160 live of 256 slots) and leg a (the
    # 2047-token prompt's 2176-slot slab)
    ("llama1b_tp2_rank_b2_s256_bf16_ragged", 2, 256, 16, 4, 64, False),
    ("llama1b_tp2_rank_b1_s2176_bf16", 1, 2176, 16, 4, 64, False),
]


def decode_inputs(torch, spec: tuple, seed: int):
    """(q, k, v, mask) of a slab decode spec, bf16, seeded."""
    _, b, s, h, kh, d, _ = spec
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
    k = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((b, s, kh, d), generator=g, device="cuda").bfloat16()
    return q, k, v, decode_mask(torch, b, s)


def decode_cases(torch, F, da, quantize_kv, sdpa_gqa: bool, names=None) -> list[dict]:
    """The slab kernel on ``DECODE_SPECS`` (those in ``names``, if given).
    Each case records the NSPLIT that ``split_plan`` gives it on this
    card."""
    cases = []
    sms = da.sm_count(torch.device("cuda"))
    for _, spec in picked(DECODE_SPECS, names):
        name, b, s, h, kh, d, int8 = spec
        q, k, v, mask = decode_inputs(torch, spec, 100 + s + int8 + (0 if d == 64 else d))
        kw = dict(scale=d ** -0.5)
        if int8:
            k, ks = quantize_kv(k)
            v, vs = quantize_kv(v)
            kw.update(k_scale=ks, v_scale=vs)
        out = da.decode_attention(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, k, v, mask, **kw)
        err, ok = attn_err_rows(out, ref)
        ms = time_ms(torch, lambda: da.decode_attention(q, k, v, mask, **kw), 100)
        plain_ms = time_ms(torch, lambda: da.decode_attention_plain(q, k, v, mask, **kw), 10)
        lib_ms = lib_dev = None
        if not int8 and sdpa_gqa:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            am = mask[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                      scale=kw["scale"], enable_gqa=True)

            lib_ms = time_ms(torch, sdpa, 100)
            lib_dev = device_ms(torch, sdpa, {"all": ""})["all"]
        dev = device_ms(torch, lambda: da.decode_attention(q, k, v, mask, **kw), DECODE_MARKERS)
        nsplit = da.split_plan(b, kh, s, d, sms, h // kh)
        if (dev["decode_attention_combine"] > 0) != (nsplit > 1):
            raise AssertionError(f"{name}: NSPLIT {nsplit} but the profiler saw combine time "
                                 f"{dev['decode_attention_combine']} ms")
        visible = int(mask.sum().item())
        per_slot = kh * d * k.element_size() * 2 + (kh * 4 * 2 if int8 else 0)
        nbytes = 2 * 2 * b * h * d + visible * per_slot + b * s
        bms, by = bound(nbytes, 4.0 * h * d * visible)
        cases.append(dict(kernel="decode_attention", case=name, max_abs_err=err,
                          tol=ATTN_TOL, tol_kind="relative to the head row's largest |plain|",
                          within_tol=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          library_device_ms=lib_dev, bound_ms=bms, bound_by=by, nsplit=nsplit,
                          device_ms=sum(dev.values()), device_ms_by_kernel=dev))
    return cases


def combine_cases(torch, da, names=None) -> list[dict]:
    """The split-KV combine alone (``csrc/split_kv.cuh``) on the split
    kernel's own partials, against its plain version on the same partials:
    the bf16 ``DECODE_SPECS`` (the main path's shape first; those in
    ``names``, if given).  Each case
    also shows that its check sees a fault: the combine over the partials
    with the middle split dropped must fall outside the tolerance against
    the whole (``combine_case``)."""
    cases = []
    sms = da.sm_count(torch.device("cuda"))
    for _, spec in picked(DECODE_SPECS, names):
        name, b, s, h, kh, d, int8 = spec
        if int8:
            continue
        n = da.split_plan(b, kh, s, d, sms, h // kh)
        q, k, v, mask = decode_inputs(torch, spec, 500 + s + (0 if d == 64 else d))
        acc, m, l = da.decode_attention_split(q, k, v, mask, nsplit=n, scale=d ** -0.5)
        cases.append(combine_case(torch, da, "decode_attention_combine",
                                  f"{name.removesuffix('_ragged').removesuffix('_bf16')}"
                                  f"_nsplit{n}", acc, m, l))
    return cases


def combine_case(torch, da, kernel: str, name: str, acc, m, l) -> dict:
    """The combine on a split kernel's partials against its plain version,
    and the fault its check must see: the combine over the partials with
    the middle split dropped falls outside the tolerance against the whole."""
    from llm_np_cp_tpu_torch.ops.attention import NEG_INF

    n = m.shape[-2]
    out = da.combine_splits(acc, m, l, torch.bfloat16)
    ref = da.combine_splits_plain(acc, m, l, torch.bfloat16)
    err, ok = attn_err_rows(out, ref)
    dropped = [t.clone() for t in (acc, m, l)]
    for t, dead, axis in zip(dropped, (0.0, NEG_INF, 0.0), (-3, -2, -2)):
        t.select(axis, n // 2).fill_(dead)
    _, fault_passes = attn_err_rows(da.combine_splits(*dropped, torch.bfloat16), ref)
    ms = time_ms(torch, lambda: da.combine_splits(acc, m, l, torch.bfloat16), 100)
    plain_ms = time_ms(torch, lambda: da.combine_splits_plain(acc, m, l, torch.bfloat16), 20)
    nbytes = 4 * (acc.numel() + m.numel() + l.numel()) + 2 * out.numel()
    bms, by = bound(nbytes, 2.0 * acc.numel() + 4.0 * m.numel(), F32_FLOPS_PER_S)
    return dict(kernel=kernel, case=name, max_abs_err=err, tol=ATTN_TOL,
                tol_kind="relative to the head row's largest |plain|",
                within_tol=ok and not fault_passes, dropped_split_caught=not fault_passes,
                ms=ms, plain_ms=plain_ms,
                library_ms=None, library="none: no one PyTorch call merges partials",
                bound_ms=bms, bound_by=by, nsplit=n)


def check_tokens(torch, logits, got, tol: float) -> float:
    """Every row whose top-two plain logits differ by more than ``tol``
    must match exactly; on the other rows the kernel's token must be one
    of the tied ones.  Returns the largest logit gap of a chosen token."""
    top2 = torch.topk(logits, 2, dim=-1).values
    best = top2[:, 0]
    chosen = logits.gather(-1, got.long()[:, None])[:, 0]
    gap = (best - chosen)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    clear = (top2[:, 0] - top2[:, 1]) > tol
    if bool((clear & (got != want)).any()) or bool((gap > tol).any()):
        raise AssertionError(f"epilogue tokens {got.tolist()} vs plain {want.tolist()}, gaps {gap.tolist()}")
    return gap.max().item()


# the epilogue's cases: name, N, H, V, tied, softcap, unit_offset — the
# main path's shape first.  Llama-3.1-8B's head is untied ([H, V]).
EPILOGUE_SPECS = [
    ("llama1b_n4_tied", 4, 2048, 128256, True, None, False),
    ("gemma2_widths_n4_untied_softcap30_unitoffset", 4, 2304, 256000, False, 30.0, True),
    ("llama1b_n8_tied_serve_tick", 8, 2048, 128256, True, None, False),
    ("llama3_8b_n8_untied", 8, 4096, 128256, False, None, False),
    # Gemma-2-9B's and -27B's tied heads: the widest normed rows a block
    # keeps in shared memory (8 float32 rows: 112 KiB; 144 KiB would leave
    # one block an SM, so 27B's are kept as bf16)
    ("gemma2_9b_n8_tied_softcap30_unitoffset", 8, 3584, 256000, True, 30.0, True),
    ("gemma2_27b_n8_tied_softcap30_unitoffset", 8, 4608, 256000, True, 30.0, True),
    # the spec_k=4 tick: 8 slots x 5 sample columns
    ("llama1b_n40_tied_spec_tick", 40, 2048, 128256, True, None, False),
    # Mixtral-8x7B's untied bf16 head: the moe phase's generate rows and
    # its serve tick's 8 slots
    ("mixtral_n4_untied", 4, 4096, 32000, False, None, False),
    ("mixtral_n8_untied_serve_tick", 8, 4096, 32000, False, None, False),
    # a tensor-parallel rank's half of the tied head (64128 of 128256
    # rows): the mesh phase's 2 rows a rank, and 4 and 8
    ("llama1b_tp2_shard_n2_tied", 2, 2048, 64128, True, None, False),
    ("llama1b_tp2_shard_n4_tied", 4, 2048, 64128, True, None, False),
    ("llama1b_tp2_shard_n8_tied", 8, 2048, 64128, True, None, False),
    # the mesh phase's leg a: its one row on a model rank's half
    ("llama1b_tp2_shard_n1_tied", 1, 2048, 64128, True, None, False),
    # the mesh phase's serve legs: a model=4 rank's quarter of the tied
    # head (32064 rows) under a tick's 8 slots
    ("llama1b_tp4_shard_n8_tied", 8, 2048, 32064, True, None, False),
]
EPILOGUE_INT8_SPECS = [
    ("llama1b_n4_tied_int8", 4, 2048, 128256, True, None, False),
    ("llama1b_n8_tied_int8_serve_tick", 8, 2048, 128256, True, None, False),
    ("gemma2_widths_n4_untied_int8_softcap30_unitoffset", 4, 2304, 256000, False, 30.0, True),
    ("llama3_8b_n8_untied_int8", 8, 4096, 128256, False, None, False),
    ("gemma2_27b_n8_tied_int8_softcap30_unitoffset", 8, 4608, 256000, True, 30.0, True),
    # Mixtral-8x7B's untied head quantized: the moe phase's weight modes'
    # generate rows and its int8 serve tick's 8 slots
    ("mixtral_n4_untied_int8", 4, 4096, 32000, False, None, False),
    ("mixtral_n8_untied_int8_serve_tick", 8, 4096, 32000, False, None, False),
    # the mesh phase's leg c: a rank's half of the int8 tied head
    ("llama1b_tp2_shard_n2_tied_int8", 2, 2048, 64128, True, None, False),
]
EPILOGUE_MARKERS = {"sample_epilogue": "epilogue_"}
# how far a planted column's logit lies above its row's best random one:
# 50x EPILOGUE_TOL, and enough that an int8 head's rounding keeps it ahead
PLANT_MARGIN = 0.05


def epilogue_inputs(torch, norms, quantize_array, spec: tuple, i: int, int8: bool):
    """(x, gamma, w, keywords) of epilogue case ``i`` from ``spec``.  Row
    0's best column is planted at V-1 and row 1's (where N > 1) at 0:
    that row's normed
    vector scaled so that its logit lies ``PLANT_MARGIN`` above the row's
    best random logit.  The other rows see about 1/sqrt(H) of it, far
    below their own best; the planted row's token holds the vocab's first
    and last tiles, and a kernel that summed only part of H (one warp's
    slice of it) would lose the planted column's lead.  An int8 head is
    quantized on the card as ``quantize_params`` quantizes it (tied: per
    embedding row; untied: per lm_head column), its scales handed over as
    [1, V]."""
    name, n, hd, vocab, tied, cap, unit = spec
    g = torch.Generator(device="cuda").manual_seed((17 if int8 else 7) + i)
    x = torch.randn((n, hd), generator=g, device="cuda").bfloat16()
    gamma = (0.1 * torch.randn((hd,), generator=g, device="cuda") + (0.0 if unit else 1.0)).bfloat16()
    w = (0.02 * torch.randn((vocab, hd) if tied else (hd, vocab), generator=g, device="cuda")).bfloat16()
    xn = norms.rms_norm(x, gamma, eps=1e-6, unit_offset=unit)[:2].float()
    best = (xn @ (w.T if tied else w).float()).max(dim=-1).values
    for row, col in ((0, vocab - 1), (1, 0))[:n]:
        v = xn[row]
        planted = (v * ((best[row] + PLANT_MARGIN) / v.dot(v))).bfloat16()
        if tied:
            w[col] = planted
        else:
            w[:, col] = planted
    kw = dict(tied=tied, eps=1e-6, unit_offset=unit, logit_softcap=cap)
    if int8:
        wq = quantize_array(w, axis=-1 if tied else -2)
        del w
        w = wq["q"]
        kw["w_scale"] = wq["s"].reshape(1, -1)
    return x, gamma, w, kw


def plant_needs_full_sum(torch, xn, w, kw) -> bool:
    """True when rows 0 and 1's logits (row 0's alone at N = 1) summed
    over only the first eighth of H (one of the untied kernel's 8 warp
    slices) pick neither planted column: the planted tokens are exact
    only if every slice's dot arrives."""
    h8 = xn.shape[-1] // 8
    part = xn[:2, :h8].float() @ (w[:, :h8].T if kw["tied"] else w[:h8]).float()
    if "w_scale" in kw:
        part = part * kw["w_scale"]
    got = torch.argmax(part, dim=-1).tolist()
    planted = (w.shape[0 if kw["tied"] else 1] - 1, 0)
    return all(g != p for g, p in zip(got, planted))


def epilogue_library(torch, norms, x, gamma, w, kw):
    """One PyTorch call computing the epilogue's function on the normed
    rows: matmul + argmax (an int8 head dequantized to bf16 first)."""
    xn = norms.rms_norm(x, gamma, eps=kw["eps"], unit_offset=kw["unit_offset"])
    ws = kw.get("w_scale")
    if ws is not None:
        w = (w.float() * (ws.reshape(-1, 1) if kw["tied"] else ws)).bfloat16()
    wt = w.T if kw["tied"] else w
    return lambda: torch.argmax(torch.matmul(xn, wt), dim=-1)


def epilogue_cases(torch, se, norms, quantize_array, int8: bool, names=None) -> list[dict]:
    """The float-head (``sample_epilogue``) or int8-head
    (``sample_epilogue_int8``) cases (those in ``names``, if given); each
    head is freed after its case."""
    cases = []
    kernel = "sample_epilogue_int8" if int8 else "sample_epilogue"
    for i, spec in picked(EPILOGUE_INT8_SPECS if int8 else EPILOGUE_SPECS, names):
        name, n, hd, vocab, tied, cap, unit = spec
        x, gamma, w, kw = epilogue_inputs(torch, norms, quantize_array, spec, i, int8)
        got = se.sample_epilogue(x, gamma, w, **kw)
        torch.cuda.synchronize()
        xn = norms.rms_norm(x, gamma, eps=1e-6, unit_offset=unit)
        logits = xn.float() @ (w.float().T if tied else w.float())
        if int8:
            logits = logits * kw["w_scale"]
        if cap is not None:
            logits = torch.tanh(logits / cap) * cap
        err = check_tokens(torch, logits, got, EPILOGUE_TOL)
        if got[:2].tolist() != [vocab - 1, 0][:n]:
            raise AssertionError(f"{name}: planted best columns {[vocab - 1, 0][:n]}, "
                                 f"got {got[:2].tolist()}")
        want = torch.argmax(logits, -1).to(torch.int32)
        if {0, vocab - 1} & set(want[2:].tolist()):
            raise AssertionError(f"{name}: a planted column wins an unplanted row: {want.tolist()}")
        if not plant_needs_full_sum(torch, xn, w, kw):
            raise AssertionError(f"{name}: the planted columns win on an eighth of H")
        plain = se.sample_epilogue_plain(x, gamma, w, **kw)
        if not torch.equal(plain, want):
            raise AssertionError(f"{name}: sample_epilogue_plain disagrees with its own logits")
        # the row maximum a tensor-parallel head merges its shards by
        tok_m, best = se.sample_epilogue(x, gamma, w, return_max=True, **kw)
        plain_tok, plain_best = se.sample_epilogue_plain(x, gamma, w, return_max=True, **kw)
        torch.cuda.synchronize()
        max_err = (best - logits.amax(dim=-1)).abs().max().item()
        plain_max_err = (plain_best - logits.amax(dim=-1)).abs().max().item()
        if (not torch.equal(tok_m, got) or not torch.equal(plain_tok, want)
                or max(max_err, plain_max_err) > EPILOGUE_TOL):
            raise AssertionError(f"{name}: return_max: tokens {tok_m.tolist()} / "
                                 f"{got.tolist()}, max error {max_err}")
        del logits, xn
        call = lambda: se.sample_epilogue(x, gamma, w, **kw)  # noqa: E731
        ms = time_ms(torch, call, 50)
        dev = device_ms(torch, call, EPILOGUE_MARKERS)["sample_epilogue"]
        plain_ms = time_ms(torch, lambda: se.sample_epilogue_plain(x, gamma, w, **kw), 5)
        lib = epilogue_library(torch, norms, x, gamma, w, kw)
        lib_ms = time_ms(torch, lib, 50)
        lib_dev = device_ms(torch, lib, {"all": ""})["all"]
        del lib
        if int8:
            nbytes = vocab * hd + vocab * 4 + n * hd * 2 + hd * 2 + n * 4
        else:
            nbytes = vocab * hd * 2 + n * hd * 2 + hd * 2 + n * 4
        bms, by = bound(nbytes, 2.0 * n * hd * vocab)
        case = dict(kernel=kernel, case=name, max_abs_err=err, tol=EPILOGUE_TOL,
                    within_tol=err <= EPILOGUE_TOL, row_max_abs_err=max_err, ms=ms,
                    device_ms=dev,
                    plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_dev,
                    bound_ms=bms, bound_by=by)
        if int8:
            case["library"] = "matmul on the dequantized bf16 head + argmax"
        cases.append(case)
        del x, gamma, w, kw, call
        torch.cuda.empty_cache()
    return cases


SOFTMAX_SPECS = [
    # name, shape, dtype name: vocab rows (split over a thread-block
    # cluster), attention rows (a few rows a warp), and one row longer
    # than a cluster holds on chip (the two-read stream)
    ("vocab_8x128256_bf16", (8, 128256), "bfloat16"),
    ("vocab_8x128256_f32", (8, 128256), "float32"),
    ("attn_rows_16384x128_bf16", (4 * 32 * 128, 128), "bfloat16"),
    ("long_row_1x2097152_f32", (1, 2 ** 21), "float32"),
]
SOFTMAX_MARKERS = {"softmax": "softmax_"}


def softmax_inputs(torch, i: int):
    """SOFTMAX_SPECS[i]'s input, made on the card from a seed."""
    _, shape, dtype = SOFTMAX_SPECS[i]
    g = torch.Generator(device="cuda").manual_seed(400 + i)
    return (4.0 * torch.randn(shape, generator=g, device="cuda")).to(getattr(torch, dtype))


def softmax_cases(torch, sm) -> list[dict]:
    """Each of SOFTMAX_SPECS against the plain version: events, device
    time (torch.profiler) and ``torch.softmax``'s beside them."""
    cases = []
    for i, (name, _, dtype) in enumerate(SOFTMAX_SPECS):
        x = softmax_inputs(torch, i)
        out = sm.softmax(x)
        torch.cuda.synchronize()
        ref = sm.softmax_plain(x)
        diff = (out.float() - ref.float()).abs()
        tol = SOFTMAX_TOL[dtype]
        if dtype == "bfloat16":
            ok = bool((diff <= tol * ref.float().abs() + 1e-30).all())
        else:
            ok = bool((diff <= tol).all())
        call = lambda: sm.softmax(x)  # noqa: E731
        lib = lambda: torch.softmax(x, dim=-1)  # noqa: E731
        ms = time_ms(torch, call, 100)
        plain_ms = time_ms(torch, lambda: sm.softmax_plain(x), 20)
        lib_ms = time_ms(torch, lib, 100)
        dev = device_ms(torch, call, SOFTMAX_MARKERS)["softmax"]
        lib_dev = device_ms(torch, lib, {"all": ""})["all"]
        numel = x.numel()
        # each element read once and written once; ~4 float32 operations
        # (max, exp of the difference, sum, scale)
        bms, by = bound(2 * numel * x.element_size(), 4.0 * numel, F32_FLOPS_PER_S)
        cases.append(dict(kernel="softmax", case=name, max_abs_err=diff.max().item(), tol=tol,
                          tol_kind="relative to the output" if dtype == "bfloat16" else "absolute",
                          within_tol=ok, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          library="torch.softmax", bound_ms=bms, bound_by=by, device_ms=dev,
                          library_device_ms=lib_dev, bound_share=bms / dev if dev else None))
        del x, out, ref
    return cases


# ----------------------------------------------------------------------
# threefry2x32 (jax.random's bits) and the fused categorical draw
# ----------------------------------------------------------------------

# int32 issue of one H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
# (Hopper's SM has 64 INT32 units; the data sheet's boost clock)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations an element of csrc/threefry.cu: 20 rounds of (add,
# rotate, xor), 5 key injections of 2 adds, the 64-bit counter (2), the
# word's xor, and the uniform's shift and or
THREEFRY_OPS = 20 * 3 + 5 * 2 + 2 + 1 + 2
# a draw whose plain top-2 margin (gumbel + logits) is under this may
# flip between the kernel and the plain version (their logs may differ
# in the last bit): counted as a tie, not an error
CATEGORICAL_TIE = 1e-5
# name, N, V, row0: the min-p unified tick's 8 rows first (the path
# whose launches the summary counts), the min-p Generator's 4 rows, the
# spec_k=4 tick's 8 x 5 rows, and Gemma-2's vocab.  row0 > 0: under one
# key the N rows are rows row0... of a larger draw (a data-parallel
# rank's share)
CATEGORICAL_SPECS = (
    ("serve_tick_8x128256", 8, 128256, 0),
    ("generator_4x128256", 4, 128256, 0),
    ("spec_tick_40x128256", 40, 128256, 0),
    ("gemma2_vocab_8x256000", 8, 256000, 0),
    # the moe phase's min-p serve tick at Mixtral-8x7B's vocab
    ("mixtral_vocab_serve_tick_8x32000", 8, 32000, 0),
    # the mesh phase's min-p leg: data rank 1's rows 2..3 of the 4
    ("mesh_data_rank1_2x128256_row0_2", 2, 128256, 2),
)


def threefry_known_answers(torch, tr) -> dict:
    """The kernels' words and draws against jax's (``KNOWN_ANSWERS``)."""
    ka = KNOWN_ANSWERS
    key = tr.PRNGKey(ka["seed"], "cuda")

    def u32(t):
        return (t.cpu().long() & 0xFFFFFFFF).tolist()

    n, v = ka["categorical_shape"]
    flat = torch.arange(n * v, dtype=torch.int64, device="cuda")
    logits = (((flat * 7919) % 1000).double() / 100.0 - 5.0).float().view(n, v)
    got = dict(split3=u32(tr.split(key, 3)), fold_in=u32(tr.fold_in(key, ka["fold_data"])),
               bits8=u32(tr.random_bits(key, (8,))),
               uniform8_words=u32(tr.uniform(key, (8,)).view(torch.int32)),
               bits_wide=u32(tr.random_bits(key, (n, v)).reshape(-1)[ka["wide_index"]]),
               categorical=tr.categorical(key, logits).tolist(),
               categorical_rows=tr.categorical(tr.split(key, n), logits).tolist())
    return {k: dict(ok=g == ka[k]) for k, g in got.items()}


def threefry_cases(torch, tr, tfk, names=None) -> list[dict]:
    """``threefry2x32`` (the serve tick's row keys first: fold_in of 8
    seeds and positions; then the words of a [4, 128256] draw) and
    ``categorical`` (CATEGORICAL_SPECS) against their plain versions (the
    cases in ``names``, if given): words equal, tokens equal (flips under
    CATEGORICAL_TIE are ties); a draw at row0 > 0 also equal to those
    rows of the whole draw; events and device ms, the plain version's,
    the bound, and for the draw the exponential race the port drew with
    before (softmax, ``exponential_``, divide, argmax) as the
    yardstick."""
    known = threefry_known_answers(torch, tr)
    known_ok = all(v["ok"] for v in known.values())
    cases = []
    seeds = torch.arange(8, dtype=torch.int32, device="cuda") * 7919 + 5
    pos = torch.arange(8, dtype=torch.int32, device="cuda") * 61 + 100
    keys = tr.PRNGKey(seeds)
    for _, (name, n, cols, data, mode) in picked((
            ("serve_tick_row_keys_8", 8, 1, pos, tr.PAIR),
            ("words_4x128256", 4 * 128256, 4 * 128256, None, tr.BITS)), names):
        k = keys if data is not None else tr.PRNGKey(42, "cuda")
        call = lambda: tfk.threefry2x32(k, n, cols, data, mode)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        want = tr.words_plain(k, n, cols, data, mode)
        wrong = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        ok = wrong == 0 and known_ok
        out_bytes = got.numel() * 4
        bms, by = bound(k.numel() * 4 + (0 if data is None else n * 4) + out_bytes,
                        THREEFRY_OPS * n, INT32_OPS_PER_S)
        dev = device_ms(torch, call, {"k": "threefry2x32_kernel"})["k"]
        # max_abs_err: words that differ from the plain version's
        cases.append(dict(kernel="threefry2x32", case=name, max_abs_err=float(wrong),
                          words_equal=ok, known_answers=known, within_tol=ok,
                          ms=time_ms(torch, call, 100),
                          plain_ms=time_ms(torch, lambda: tr.words_plain(k, n, cols, data, mode),
                                           10),
                          library_ms=None, library="none: no PyTorch call draws jax's bits",
                          bound_ms=bms, bound_by=by, device_ms=dev,
                          bound_share=bms / dev if dev else None))

    def draw_check(k, logits, row0: int = 0, want=None) -> tuple[bool, int, int]:
        """(tokens equal but for ties, flips, flips at a tie) of the
        kernel's draw under keys ``k`` against ``want``, by default the
        plain version's."""
        n, v = logits.shape
        got = tfk.categorical(k, logits, row0)
        torch.cuda.synchronize()
        if want is None:
            want = tr.categorical_plain(k, logits, row0)
        top2 = torch.topk(tr.gumbel(k, (row0 + n, v))[row0:] + logits, 2).values
        ties = (top2[:, 0] - top2[:, 1]) < CATEGORICAL_TIE
        flips = got != want
        return bool((~flips | ties).all()), int(flips.sum()), int((flips & ties).sum())

    for i, (name, n, v, row0) in picked(CATEGORICAL_SPECS, names):
        g = torch.Generator(device="cuda").manual_seed(900 + i)
        whole = 3.0 * torch.randn((row0 + n, v), generator=g, device="cuda")
        logits = whole[row0:].contiguous()
        k = tr.PRNGKey(i, "cuda")
        checks = [draw_check(k, logits, row0), draw_check(tr.split(k, n), logits)]
        if row0:  # the same rows of the whole draw, as one rank of the batch sees them
            checks.append(draw_check(k, logits, row0, tfk.categorical(k, whole)[row0:]))
        del whole
        first = dict(ok=all(c[0] for c in checks) and known_ok, flips=sum(c[1] for c in checks),
                     ties_flipped=sum(c[2] for c in checks))
        call = lambda: tfk.categorical(k, logits, row0)  # noqa: E731
        race = lambda: torch.argmax(  # noqa: E731
            torch.softmax(logits, dim=-1) / torch.empty_like(logits).exponential_(), dim=-1)
        bms, by = bound(n * v * 4 + 8 + n * 4, THREEFRY_OPS * n * v, INT32_OPS_PER_S)
        dev = device_ms(torch, call, {"k": "categorical_"})["k"]
        # max_abs_err: tokens that differ from the plain version's, ties aside
        cases.append(dict(kernel="categorical", case=name,
                          max_abs_err=float(first["flips"] - first["ties_flipped"]),
                          tokens_equal=first["ok"], flips=first["flips"],
                          ties_flipped=first["ties_flipped"], tie_margin=CATEGORICAL_TIE,
                          keys="one key, and a key a row" + (
                              f"; rows {row0}.. of the whole draw" if row0 else ""),
                          row0=row0, within_tol=first["ok"], ms=time_ms(torch, call, 100),
                          plain_ms=time_ms(torch, lambda: tr.categorical_plain(k, logits, row0),
                                           10),
                          library_ms=None,
                          library="none: no PyTorch call draws jax's stream",
                          race_ms=time_ms(torch, race, 100),
                          race_device_ms=device_ms(torch, race, {"all": ""})["all"],
                          bound_ms=bms, bound_by=by, device_ms=dev,
                          bound_share=bms / dev if dev else None))
        del logits
    return cases


# the paged kernels' cases: a serve-shaped pool (rows with ragged lengths
# and left pads, random distinct blocks), Llama-3.2-1B widths first
SERVE_LENGTHS = [350, 37, 128, 201, 288, 64, 17, 300]
SERVE_PADS = [0, 11, 0, 55, 32, 0, 9, 0]


def make_pool(torch, quantize_kv, g, rows: int, mb: int, bs: int, kh: int, d: int, int8: bool):
    """(k pages, v pages, tables [rows, mb], scale kwargs) in bf16 (or int8
    + float32 scale pages); every row gets distinct random blocks."""
    nbp = rows * mb + 1
    k = torch.randn((nbp, bs, kh, d), generator=g, device="cuda").bfloat16()
    v = torch.randn((nbp, bs, kh, d), generator=g, device="cuda").bfloat16()
    perm = torch.randperm(nbp - 1, generator=g, device="cuda")[: rows * mb] + 1
    tables = perm.view(rows, mb).to(torch.int32)
    if not int8:
        return k, v, tables, {}
    k, ks = quantize_kv(k)
    v, vs = quantize_kv(v)
    return k, v, tables, dict(k_scale=ks, v_scale=vs)


def gathered(pages, tables):
    """Pool pages → the rows' contiguous [R, MB*BS, ...] views."""
    r, mb = tables.shape
    return pages[tables.long()].reshape(r, mb * pages.shape[1], *pages.shape[2:])


def sdpa_pregathered(torch, F, q, kv_views, mask, scale):
    """SDPA over already-gathered contiguous K/V: q [N, Sq, H, D], views
    [N, S, K, D], mask [N, Sq, S] bool."""
    k, v = kv_views
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask[:, None],
        scale=scale, enable_gqa=True)


# the paged decode's two kernels by CUDA symbol: the split kernel and the
# split-KV combine (csrc/split_kv.cuh)
PAGED_MARKERS = {"paged_decode_attention": "paged_decode_kernel",
                 "paged_decode_attention_combine": "combine_splits_kernel"}

LONG_LENGTHS = [4096, 3900, 3000, 2048, 4096, 1000, 3500, 4095]
LONG_PADS = [0, 100, 0, 48, 0, 0, 7, 0]
PAGED_SPECS = [
    # name, H, K, D, lengths, pads, softcap, window, int8 — serve shape first
    ("llama1b_serve_b8_bs16", 32, 8, 64, SERVE_LENGTHS, SERVE_PADS, None, None, False),
    ("llama1b_b8_s4096_bs16", 32, 8, 64, LONG_LENGTHS, LONG_PADS, None, None, False),
    ("llama1b_serve_b8_bs16_int8", 32, 8, 64, SERVE_LENGTHS, SERVE_PADS, None, None, True),
    # the window enters as row_pads = max(pads, lengths - window), as
    # the engine passes it on a sliding layer
    ("gemma2_widths_b8_bs16_softcap50_window128", 8, 4, 256, SERVE_LENGTHS, SERVE_PADS, 50.0,
     128, False),
    ("llama1b_b8_s4096_bs16_int8", 32, 8, 64, LONG_LENGTHS, LONG_PADS, None, None, True),
    # one long-context row: 2048 blocks of 16, ~67 MB of bf16 K/V
    ("llama1b_b1_s32768_bs16", 32, 8, 64, [32768], [0], None, None, False),
    # the moe phase's leg B at Mixtral-8x7B's attention widths (D=128)
    ("mixtral_serve_b8_bs16", 32, 8, 128, SERVE_LENGTHS, SERVE_PADS, None, None, False),
    # a model=4 rank's share (8 of 32 query heads on 2 of 8 KV heads) of
    # the mesh phase's serve leg s2: its int8 pool
    ("llama1b_tp4_rank_serve_b8_bs16_int8", 8, 2, 64, SERVE_LENGTHS, SERVE_PADS, None, None,
     True),
]


def paged_inputs(torch, quantize_kv, i: int):
    """PAGED_SPECS[i]'s inputs, made on the card from a seed: (the
    positional arguments of ``paged_decode_attention``, its keywords)."""
    name, h, kh, d, lengths, pads, cap, win, int8 = PAGED_SPECS[i]
    bs = SERVE_BLOCK
    g = torch.Generator(device="cuda").manual_seed(200 + i)
    b, mb = len(lengths), -(-max(lengths) // bs)
    k, v, tables, scales = make_pool(torch, quantize_kv, g, b, mb, bs, kh, d, int8)
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    row_pads = torch.tensor(pads, dtype=torch.int32, device="cuda")
    if win is not None:
        row_pads = torch.maximum(row_pads, lens - win)
    return (q, k, v, tables, lens, row_pads), dict(scale=d ** -0.5, logit_softcap=cap, **scales)


def paged_cases(torch, F, da, quantize_kv, sdpa_gqa: bool, names=None) -> list[dict]:
    """The paged decode (split-KV) at the serve shape and wider ones; each
    case records the NSPLIT that ``paged_split_plan`` gives it on this card
    and its kernels' own device time."""
    cases = []
    for i, (name, h, kh, d, _, _, cap, _, int8) in picked(PAGED_SPECS, names):
        args, kw = paged_inputs(torch, quantize_kv, i)
        q, k, v, tables, lens, row_pads = args
        b, mb = tables.shape
        bs = k.shape[1]
        out = da.paged_decode_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = da.paged_decode_attention_plain(*args, **kw)
        err, ok = attn_err_rows(out, ref)
        call = lambda: da.paged_decode_attention(*args, **kw)  # noqa: E731
        ms = time_ms(torch, call, 100)
        plain_ms = time_ms(torch, lambda: da.paged_decode_attention_plain(*args, **kw), 10)
        lib_ms = gather_ms = None
        if not int8 and cap is None and sdpa_gqa:
            views = (gathered(k, tables), gathered(v, tables))
            pos = torch.arange(mb * bs, device="cuda")
            mask = ((pos >= row_pads[:, None]) & (pos < lens[:, None]))[:, None, :]
            lib_ms = time_ms(torch, lambda: sdpa_pregathered(torch, F, q, views, mask, kw["scale"]), 100)
            gather_ms = time_ms(torch, lambda: (gathered(k, tables), gathered(v, tables)), 100)
            del views
        dev = device_ms(torch, call, PAGED_MARKERS)
        nsplit = da.paged_split_plan(q, k, tables)
        if (dev["paged_decode_attention_combine"] > 0) != (nsplit > 1):
            raise AssertionError(f"{name}: NSPLIT {nsplit} but the profiler saw combine time "
                                 f"{dev['paged_decode_attention_combine']} ms")
        visible = int((lens.clamp_max(mb * bs) - row_pads.clamp_min(0)).clamp_min(0).sum().item())
        per_slot = kh * d * k.element_size() * 2 + (kh * 4 * 2 if int8 else 0)
        nbytes = 2 * 2 * b * h * d + visible * per_slot + 4 * (b * mb + 2 * b)
        bms, by = bound(nbytes, 4.0 * h * d * visible)
        cases.append(dict(kernel="paged_decode_attention", case=name, max_abs_err=err,
                          tol=ATTN_TOL, tol_kind="relative to the head row's largest |plain|",
                          within_tol=ok, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, library="SDPA, pre-gathered" if lib_ms else None,
                          gather_ms=gather_ms, bound_ms=bms, bound_by=by, nsplit=nsplit,
                          device_ms=sum(dev.values()), device_ms_by_kernel=dev))
        del args, out, ref
    return cases


def paged_combine_cases(torch, da, quantize_kv) -> list[dict]:
    """The combine alone on the paged split kernel's own partials, against
    its plain version, with the dropped-split fault (``combine_case``): the
    serve shape first, then B=8 x 4096, the B=1 x 32768 row and the serve
    shape at Mixtral-8x7B's widths (the moe phase's leg B)."""
    cases = []
    for i in (0, 1, 5, 6):
        args, kw = paged_inputs(torch, quantize_kv, i)
        n = da.paged_split_plan(args[0], args[1], args[3])
        acc, m, l = da.paged_decode_attention_split(*args, nsplit=n, **kw)
        cases.append(combine_case(torch, da, "paged_decode_attention_combine",
                                  f"{PAGED_SPECS[i][0]}_nsplit{n}", acc, m, l))
    return cases


def ragged_layout(torch, segments: list[tuple[int, int, int]], width: int):
    """Pack (row, first cache slot, tokens) segments as the engine does:
    each on a RAGGED_Q_TILE boundary, dead tiles up to ``width`` tokens.
    Returns (tile_row, tile_qpos0, tile_qlen) int32 tensors and the [T]
    live-lane mask."""
    from llm_np_cp_tpu_torch.ops.cuda.decode_attention import RAGGED_Q_TILE as qt

    rows, qpos0, qlen, live = [], [], [], []
    for row, slot0, n in segments:
        for t in range(-(-n // qt)):
            m = min(qt, n - t * qt)
            rows.append(row)
            qpos0.append(slot0 + t * qt)
            qlen.append(m)
            live += [True] * m + [False] * (qt - m)
    while len(live) < width:
        rows.append(0)
        qpos0.append(0)
        qlen.append(0)
        live += [False] * qt
    meta = [torch.tensor(a, dtype=torch.int32, device="cuda") for a in (rows, qpos0, qlen)]
    return meta, torch.tensor(live, device="cuda")


# the ragged kernel's packed batches: (row, first cache slot, tokens)
# segments.  The serve shape: rows 0-5 decode one token each; row 6 runs
# its second 64-token prefill chunk, row 7 its first (the engine's 192
# bucket)
SERVE_SEGMENTS = ([(r, SERVE_LENGTHS[r] - 1, 1) for r in range(6)]
                  + [(6, SERVE_PADS[6] + 64, 64), (7, SERVE_PADS[7], 64)])
# leg A's steady state at long context: 8 decode rows at the paged
# B=8 x 4096 lengths
LONG_DECODE_SEGMENTS = [(r, LONG_LENGTHS[r] - 1, 1) for r in range(8)]
# the long mixed tick: 7 decode rows at up to 4096 and one 512-token
# prefill chunk at slots 3584-4095
MIXED_LONG_LENGTHS = LONG_LENGTHS[:7] + [4096]
MIXED_LONG_PADS = LONG_PADS[:7] + [0]
MIXED_LONG_SEGMENTS = LONG_DECODE_SEGMENTS[:7] + [(7, 3584, 512)]
# serve leg A's steady state: 8 decode rows within its 288-slot tables
LEG_A_LENGTHS = [232, 40, 150, 201, 288, 64, 17, 120]
LEG_A_SEGMENTS = [(r, LEG_A_LENGTHS[r] - 1, 1) for r in range(8)]
# a spec_k=4 verify tick: every row's input token and 4 drafts, a 5-token
# slice (one q tile) ending at its length
VERIFY_SEGMENTS = [(r, LEG_A_LENGTHS[r] - 5, 5) for r in range(8)]
LONG_VERIFY_SEGMENTS = [(r, LONG_LENGTHS[r] - 5, 5) for r in range(8)]
RAGGED_SPECS = [
    # name, H, K, D, softcap, window, int8, segments, row lengths, row
    # pads, packed width — the serve shape first
    ("llama1b_mixed_6dec_2x64pf", 32, 8, 64, None, None, False, SERVE_SEGMENTS, SERVE_LENGTHS,
     SERVE_PADS, 192),
    ("llama1b_mixed_6dec_2x64pf_int8", 32, 8, 64, None, None, True, SERVE_SEGMENTS,
     SERVE_LENGTHS, SERVE_PADS, 192),
    ("gemma2_widths_mixed_softcap50_window128", 8, 4, 256, 50.0, 128, False, SERVE_SEGMENTS,
     SERVE_LENGTHS, SERVE_PADS, 192),
    ("llama1b_decode8_4096", 32, 8, 64, None, None, False, LONG_DECODE_SEGMENTS, LONG_LENGTHS,
     LONG_PADS, 64),
    ("llama1b_decode8_4096_int8", 32, 8, 64, None, None, True, LONG_DECODE_SEGMENTS,
     LONG_LENGTHS, LONG_PADS, 64),
    # one long-context row: 2048 blocks of 16
    ("llama1b_decode1_32768", 32, 8, 64, None, None, False, [(0, 32767, 1)], [32768], [0], 8),
    ("llama1b_mixed_7dec4096_pf512", 32, 8, 64, None, None, False, MIXED_LONG_SEGMENTS,
     MIXED_LONG_LENGTHS, MIXED_LONG_PADS, 568),
    # the serve shape at Llama-3.1-8B's attention widths
    ("llama8b_widths_mixed_6dec_2x64pf", 32, 8, 128, None, None, False, SERVE_SEGMENTS,
     SERVE_LENGTHS, SERVE_PADS, 192),
    # serve leg A's decode-only tick: its 8 slots, its 288-slot tables
    ("llama1b_legA_decode8_288", 32, 8, 64, None, None, False, LEG_A_SEGMENTS, LEG_A_LENGTHS,
     SERVE_PADS, 64),
    # speculative verify ticks: 8 rows x 5-token verify slices, at leg A's
    # 288-slot tables and at up to 4096 slots (the prefill-tile path)
    ("llama1b_verify8x5_288", 32, 8, 64, None, None, False, VERIFY_SEGMENTS, LEG_A_LENGTHS,
     SERVE_PADS, 64),
    ("llama1b_verify8x5_4096", 32, 8, 64, None, None, False, LONG_VERIFY_SEGMENTS,
     LONG_LENGTHS, LONG_PADS, 64),
    # the moe phase's leg A decode-only tick at Mixtral-8x7B's attention
    # widths (D=128)
    ("mixtral_legA_decode8_288", 32, 8, 128, None, None, False, LEG_A_SEGMENTS, LEG_A_LENGTHS,
     SERVE_PADS, 64),
    # the serve shape at a model=4 rank's heads (8 of 32 query, 2 of 8
    # KV): the mesh phase's serve leg s1
    ("llama1b_tp4_rank_mixed_6dec_2x64pf", 8, 2, 64, None, None, False, SERVE_SEGMENTS,
     SERVE_LENGTHS, SERVE_PADS, 192),
]
RAGGED_MARKERS = {"ragged_paged_attention": "ragged_kernel",
                  "ragged_paged_attention_combine": "combine_splits_kernel"}


def ragged_inputs(torch, quantize_kv, i: int, spec: tuple | None = None):
    """RAGGED_SPECS[i]'s inputs (or ``spec``'s, seeded by i), made on the
    card from a seed: (the positional arguments of
    ``ragged_paged_attention``, its keywords, the [T] live-lane mask)."""
    name, h, kh, d, cap, win, int8, segments, lengths, pads, width = spec or RAGGED_SPECS[i]
    g = torch.Generator(device="cuda").manual_seed(300 + i)
    rows, mb = len(lengths), -(-max(lengths) // SERVE_BLOCK)
    k, v, tables, scales = make_pool(torch, quantize_kv, g, rows, mb, SERVE_BLOCK, kh, d, int8)
    meta, live = ragged_layout(torch, segments, width)
    q = torch.randn((live.numel(), h, d), generator=g, device="cuda").bfloat16()
    pad_t = torch.tensor(pads, dtype=torch.int32, device="cuda")
    window = win if win is not None else 1 << 30
    kw = dict(scale=d ** -0.5, logit_softcap=cap, **scales)
    return (q, k, v, tables, *meta, pad_t, window), kw, live


def ragged_bands(torch, args, live):
    """Each packed token's engine row, cache slot and band start [T]."""
    q, _, _, _, tile_row, tile_qpos0, _, pads, window = args
    lane = torch.arange(q.shape[0], device="cuda")
    row = tile_row.long()[lane // 8]
    slot = tile_qpos0.long()[lane // 8] + lane % 8
    lo = torch.maximum(pads.long()[row], slot - window + 1)
    return row, slot, lo


def ragged_library(torch, F, args, kw, live):
    """SDPA on each engine row's pre-gathered K/V view, its tokens as the
    query axis (zero-padded to the longest segment), and the gather by
    itself: (SDPA's call, the gather's call)."""
    q, k, v, tables = args[:4]
    row, slot, lo = ragged_bands(torch, args, live)
    rows, mb = tables.shape
    s = mb * k.shape[1]
    live_rows = row[live]
    n = torch.bincount(live_rows, minlength=rows)
    qmax = int(n.max().item())
    # token j of row r: its position in the packed axis (live tokens keep
    # their packed order, so a row's are consecutive)
    idx = torch.nonzero(live).flatten()
    first = torch.cumsum(n, 0) - n
    j = torch.arange(idx.numel(), device="cuda") - first[live_rows]
    qr = torch.zeros((rows, qmax, *q.shape[1:]), dtype=q.dtype, device="cuda")
    qr[live_rows, j] = q[idx]
    pos = torch.arange(s, device="cuda")
    mask = torch.zeros((rows, qmax, s), dtype=torch.bool, device="cuda")
    mask[live_rows, j] = (pos >= lo[idx, None]) & (pos <= slot[idx, None])
    views = (gathered(k, tables), gathered(v, tables))
    sdpa = lambda: sdpa_pregathered(torch, F, qr, views, mask, kw["scale"])  # noqa: E731
    gather = lambda: (gathered(k, tables), gathered(v, tables))  # noqa: E731
    return sdpa, gather


def ragged_bound(torch, args, live) -> tuple[float, str]:
    """The ragged case's bound: each row's slots read once (the union of
    its tokens' bands), q read and out written once, 4*H*D FLOPs per
    visible (token, slot) pair."""
    q, k, _, tables, _, _, _, pads, _ = args
    t, h, d = q.shape
    rows, mb = tables.shape
    kh = k.shape[2]
    row, slot, lo = ragged_bands(torch, args, live)
    span = torch.where(live, slot - lo + 1, 0)
    read = 0
    for r in range(rows):
        sel = live & (row == r)
        if bool(sel.any()):
            read += int((slot[sel].max() - lo[sel].min() + 1).item())
    int8 = k.dtype == torch.int8
    per_slot = kh * d * k.element_size() * 2 + (kh * 4 * 2 if int8 else 0)
    nbytes = 2 * 2 * t * h * d + read * per_slot + 4 * (rows * mb + rows + 3 * (t // 8))
    return bound(nbytes, 4.0 * h * d * int(span.sum().item()))


def ragged_cases(torch, F, da, quantize_kv, sdpa_gqa: bool, names=None) -> list[dict]:
    """The unified tick's kernel on each of RAGGED_SPECS: live lanes held
    to the plain version, dead lanes exactly zero, events and device time
    (the kernel and its combine), and SDPA on the rows' pre-gathered views
    beside each bf16 case without softcap."""
    cases = []
    for i, (name, *_, cap, _, int8, _, _, _, _) in picked(RAGGED_SPECS, names):
        args, kw, live = ragged_inputs(torch, quantize_kv, i)
        call = lambda: da.ragged_paged_attention(*args, **kw)  # noqa: E731
        out = call()
        torch.cuda.synchronize()
        ref = da.ragged_paged_attention_plain(*args, **kw)
        err, ok = attn_err_rows(out[live], ref[live])
        ok = ok and not bool(out[~live].any())
        del ref
        ms = time_ms(torch, call, 100)
        plain_ms = time_ms(torch, lambda: da.ragged_paged_attention_plain(*args, **kw), 5)
        torch.cuda.empty_cache()
        dev = device_ms(torch, call, RAGGED_MARKERS, attempts=1)
        lib_ms = gather_ms = lib_dev = None
        if not int8 and cap is None and sdpa_gqa:
            sdpa, gather = ragged_library(torch, F, args, kw, live)
            lib_ms = time_ms(torch, sdpa, 100)
            lib_dev = device_ms(torch, sdpa, {"all": ""})["all"]
            gather_ms = time_ms(torch, gather, 100)
            del sdpa, gather
        bms, by = ragged_bound(torch, args, live)
        nsplit = da.ragged_split_plan(args[0], args[1], args[3], args[8])
        cases.append(dict(kernel="ragged_paged_attention", case=name, max_abs_err=err,
                          tol=ATTN_TOL, tol_kind="relative to the head row's largest |plain|",
                          within_tol=ok, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, library="SDPA, pre-gathered rows" if lib_ms else None,
                          library_device_ms=lib_dev, gather_ms=gather_ms, bound_ms=bms,
                          bound_by=by, nsplit=nsplit, device_ms=sum(dev.values()),
                          device_ms_by_kernel=dev))
        del args, kw, out
        torch.cuda.empty_cache()
    return cases


def ragged_combine_cases(torch, da, quantize_kv) -> list[dict]:
    """The combine alone on the ragged kernel's own partials (rows: tile x
    kv head, 8 lanes x G heads), against its plain version, with the
    dropped-split fault (``combine_case``): the long decode rows (as leg A
    at long context splits) and the long row at their planned NSPLIT,
    then the serve shape's mixed tick at NSPLIT 2."""
    cases = []
    for i, n in ((3, None), (5, None), (0, 2)):
        args, kw, _ = ragged_inputs(torch, quantize_kv, i)
        n = n or da.ragged_split_plan(args[0], args[1], args[3], args[8])
        acc, m, l = da.ragged_paged_attention_split(*args, nsplit=n, **kw)
        cases.append(combine_case(torch, da, "ragged_paged_attention_combine",
                                  f"{RAGGED_SPECS[i][0]}_nsplit{n}", acc, m, l))
        del args, kw, acc, m, l
        torch.cuda.empty_cache()
    return cases


# ----------------------------------------------------------------------
# phase 3: the main path
# ----------------------------------------------------------------------

def _gap_share(step_logits, tokens) -> tuple[float, float]:
    """(largest logit gap of a chosen token below its row max, share of
    steps where the chosen token is the row argmax)."""
    chosen = step_logits.gather(-1, tokens[..., None])[..., 0]
    gap = (step_logits.amax(dim=-1) - chosen).max().item()
    share = (step_logits.argmax(dim=-1) == tokens).float().mean().item()
    return gap, share


def teacher_forced(torch, forward, KVCache, params, cfg, prompt_ids, tokens,
                   attn_mask=None, pad_offsets=None, tol=TEACHER_TOL) -> dict:
    """Hold the kernel path's tokens against two plain references, both
    fed the same ids: (a) one cache-less plain forward over prompt +
    generated ids, (b) the plain cached twin of the kernel path (prefill,
    then one plain single-token forward per step).  Every chosen token's
    logit must be within ``tol`` of the row max of both; the twin's
    own argmax against (a) shows the bf16 noise floor of the check."""
    b, s = prompt_ids.shape
    n = tokens.shape[1]
    tokens = tokens.long()
    prompt_ids = prompt_ids.long()
    ids = torch.cat([prompt_ids, tokens[:, :-1]], dim=1)
    mask = None
    if attn_mask is not None:
        mask = torch.cat([attn_mask, torch.ones_like(tokens[:, :-1], dtype=torch.bool)], dim=1)
    logits, _ = forward(params, ids, cfg, None, attn_mask=mask, pad_offsets=pad_offsets)
    full = logits[:, s - 1:s - 1 + n]  # [B, n, V]
    del logits
    cache = KVCache.init(cfg, b, s + n, params["final_norm"].dtype)
    step, cache = forward(params, prompt_ids, cfg, cache, attn_mask=attn_mask,
                          pad_offsets=pad_offsets, logits_last_only=True)
    twin = [step[:, -1]]
    for j in range(n - 1):
        step, cache = forward(params, tokens[:, j:j + 1], cfg, cache, pad_offsets=pad_offsets,
                              logits_last_only=True)
        twin.append(step[:, -1])
    twin = torch.stack(twin, dim=1)
    gap_full, share_full = _gap_share(full, tokens)
    gap_twin, share_twin = _gap_share(twin, tokens)
    floor_gap, floor_share = _gap_share(full, twin.argmax(dim=-1))
    out = dict(exact_share_vs_cacheless=share_full, max_gap_vs_cacheless=gap_full,
               exact_share_vs_plain_twin=share_twin, max_gap_vs_plain_twin=gap_twin,
               plain_twin_exact_share_vs_cacheless=floor_share,
               plain_twin_max_gap_vs_cacheless=floor_gap,
               logit_std=full.float().std().item(), tol=tol)
    out["ok"] = bool(torch.isfinite(full).all() and torch.isfinite(twin).all()) and max(gap_full, gap_twin) <= tol
    return out


def combines(torch, cfg, b: int, need: int) -> int:
    """1 when a decode step over a Generator cache of ``need`` slots
    (rounded up as the Generator rounds it) launches the combine, else 0."""
    from llm_np_cp_tpu_torch.cache import align_capacity
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da

    kh = cfg.num_key_value_heads
    n = da.split_plan(b, kh, align_capacity(need), cfg.head_dim,
                      da.sm_count(torch.device("cuda")), cfg.num_attention_heads // kh)
    return int(n > 1)


def main_path(torch, np, kernels: dict, card: str) -> tuple:
    """Drive the main path; returns (result line, the kernel Generator,
    its prompts) — the last two for the profile phase."""
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 128))
    ragged = [rng.integers(0, cfg.vocab_size, size=n) for n in (37, 128, 80, 101)]

    gen = Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                    decode_attn_impl="flash_decode")
    # flash refuses ragged input (as in the JAX package): ragged prefill
    # takes the plain attention path, decode still uses the kernels
    gen_ragged = Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="xla",
                           decode_attn_impl="flash_decode")
    if gen.epilogue_impl != "fused" or gen_ragged.epilogue_impl != "fused":
        raise AssertionError("greedy Generator did not select the fused epilogue")
    gen.generate(prompts, 4)  # warm-up: cuBLAS handles, allocator

    reset_counts(kernels)
    g0 = graph_totals()
    t0 = time.perf_counter()
    res = gen.generate(prompts, DECODE_STEPS)
    res_r = gen_ragged.generate_ragged(ragged, DECODE_STEPS)
    streamed = list(gen.stream(prompts[0], STREAM_TOKENS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    graphs_run = graph_delta(g0)

    steps = DECODE_STEPS - 1
    check_replayed("main path", graphs_run, 2 * steps + STREAM_TOKENS - 1)
    want = {name: 0 for name in kernels}
    want.update({
        "flash_attention": layers * 2,  # generate + stream prefill
        "decode_attention": layers * (2 * steps + STREAM_TOKENS - 1),
        # a combine follows every decode launch whose split plan has NSPLIT > 1
        "decode_attention_combine": layers * (
            steps * combines(torch, cfg, 4, 128 + DECODE_STEPS)
            + steps * combines(torch, cfg, 4, max(len(r) for r in ragged) + DECODE_STEPS)
            + (STREAM_TOKENS - 1) * combines(torch, cfg, 1, 128 + STREAM_TOKENS)),
        "sample_epilogue": 2 * steps + STREAM_TOKENS - 1,
    })
    if launches != want:
        raise AssertionError(f"launch counts {launches} != implied {want}")
    if res.tokens.shape != (4, DECODE_STEPS) or res_r.tokens.shape != (4, DECODE_STEPS):
        raise AssertionError(f"token shapes {res.tokens.shape} / {res_r.tokens.shape}")
    if len(streamed) != STREAM_TOKENS:
        raise AssertionError(f"stream yielded {len(streamed)} tokens, want {STREAM_TOKENS}")

    dev = torch.device("cuda")
    tf = teacher_forced(
        torch, forward, KVCache, params, cfg, torch.as_tensor(prompts, device=dev),
        torch.as_tensor(res.tokens, device=dev))
    ids, mask, pads = Generator.left_pad(ragged)
    tf_r = teacher_forced(
        torch, forward, KVCache, params, cfg, torch.as_tensor(ids, device=dev),
        torch.as_tensor(res_r.tokens, device=dev), torch.as_tensor(mask, device=dev),
        torch.as_tensor(pads, device=dev).long())
    tf_s = teacher_forced(
        torch, forward, KVCache, params, cfg, torch.as_tensor(prompts[:1], device=dev),
        torch.as_tensor([streamed], device=dev))

    # float32 twin of the kernel path (outside the counted window)
    params32 = float32_params(params)
    gen32 = Generator(params32, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                      decode_attn_impl="flash_decode", cache_dtype=torch.float32)
    res32 = gen32.generate(prompts, F32_STEPS)
    tf32 = teacher_forced(
        torch, forward, KVCache, params32, cfg, torch.as_tensor(prompts, device=dev),
        torch.as_tensor(res32.tokens, device=dev), tol=F32_TEACHER_TOL)
    del params32, gen32
    torch.cuda.empty_cache()
    long = long_prompt(torch, np, kernels, gen, params, cfg)
    result = dict(
        phase="main_path", model="meta-llama/Llama-3.2-1B", layers=layers,
        weights="seeded random bf16", card=card, launches=launches, implied=want,
        graphs=graphs_run,
        generate=dict(batch=4, prompt_len=128, new_tokens=DECODE_STEPS,
                      ttft_s=res.ttft_s, decode_tok_s_per_seq=res.decode_tokens_per_s,
                      decode_tok_s=res.decode_tokens_per_s * 4,
                      teacher_forced=tf),
        generate_ragged=dict(batch=4, prompt_lens=[37, 128, 80, 101], new_tokens=DECODE_STEPS,
                             ttft_s=res_r.ttft_s, decode_tok_s_per_seq=res_r.decode_tokens_per_s,
                             teacher_forced=tf_r),
        stream=dict(tokens=len(streamed), teacher_forced=tf_s),
        float32=dict(batch=4, prompt_len=128, new_tokens=F32_STEPS, teacher_forced=tf32,
                     teacher_tol=F32_TEACHER_TOL),
        long_prompt=long, wall_s=wall, teacher_tol=TEACHER_TOL,
    )
    return result, gen, prompts, res.tokens


def long_prompt(torch, np, kernels: dict, gen, params, cfg) -> dict:
    """One ``generate`` on a B=1 x LONG_PROMPT-token prompt, where prefill
    attention is bound by operations: flash launched once a layer, every
    token teacher-forced against the cache-less plain forward, and TTFT."""
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.models.transformer import forward

    layers = cfg.num_hidden_layers
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, LONG_PROMPT))
    gen.generate(prompt, 2)  # warm-up: the allocator's long-prompt buffers
    torch.cuda.synchronize()
    reset_counts(kernels)
    g0 = graph_totals()
    res = gen.generate(prompt, LONG_NEW_TOKENS)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    steps = LONG_NEW_TOKENS - 1
    check_replayed("long prompt", graph_delta(g0), steps)
    want = {name: 0 for name in kernels}
    want.update(flash_attention=layers, decode_attention=layers * steps,
                decode_attention_combine=layers * steps * combines(
                    torch, cfg, 1, LONG_PROMPT + LONG_NEW_TOKENS),
                sample_epilogue=steps)
    if launches != want:
        raise AssertionError(f"long prompt: launch counts {launches} != implied {want}")
    dev = torch.device("cuda")
    tf = teacher_forced(torch, forward, KVCache, params, cfg, torch.as_tensor(prompt, device=dev),
                        torch.as_tensor(res.tokens, device=dev))
    return dict(batch=1, prompt_len=LONG_PROMPT, new_tokens=LONG_NEW_TOKENS, launches=launches,
                implied=want, ttft_s=res.ttft_s, decode_tok_s_per_seq=res.decode_tokens_per_s,
                teacher_forced=tf)


def profile_run(torch, fn, markers: dict[str, str]) -> dict:
    """torch.profiler over ``fn()``: device time summed by kernel name,
    the port's kernels by ``markers`` (name → substring of the CUDA
    kernel's symbol), and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    events = prof.key_averages()
    # a record_function range's device-side span (``moe_mlp``'s, in an
    # eager prefill) repeats the kernels inside it
    ranges = {e.key for e in events if getattr(e, "is_user_annotation", False)}
    for e in events:
        # kernels only: an operator's own "self device time" repeats the
        # time of the kernels it launched
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type == DeviceType.CUDA and dev_us > 0 and e.key not in ranges:
            rows.append(dict(name=e.key[:90], device_ms=dev_us / 1e3, count=e.count))
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) / 1e3
    by_kernel = {name: sum(r["device_ms"] for r in rows if marker in r["name"])
                 for name, marker in markers.items()}
    return dict(wall_s=wall, device_busy_s=busy, port_kernels_device_ms=by_kernel,
                device_busy_share=busy / wall if rows else None, top=rows[:15])


def profile_generate(torch, gen, prompts, card: str, steps: int = 32) -> dict:
    """torch.profiler over one ``generate`` (prefill + ``steps`` decode
    steps)."""
    gen.generate(prompts, 2)
    prof = profile_run(torch, lambda: gen.generate(prompts, steps), {
        "flash_attention": "flash_kernel", **DECODE_MARKERS, "sample_epilogue": "epilogue_"})
    return dict(phase="profile", card=card, generate_new_tokens=steps, batch=len(prompts),
                **prof)


# ----------------------------------------------------------------------
# phase 4b: captured steps against their eager runs
# ----------------------------------------------------------------------

GRAPH_STEPS = 32


def step_stats(steps) -> list[dict]:
    return [dict(name=st.name, capture_s=st.capture_s, pool_bytes=st.pool_bytes,
                 replays=st.replays) for st in steps if st.graph is not None]


def graph_phase(torch, np, card: str, gen, prompts, captured_tokens) -> dict:
    """Each kind of captured step against the same step function run
    eagerly (``graphs.eager_steps``) on the main path's model, identical
    tokens required: the main path's Generator (decode kernel, fused
    epilogue; its captured tokens against an eager ``generate``), the
    decode loop with the other three (attention, tail) pairs, a min-p
    Generator (the captured stream against the eager stream of its seed,
    twice, every step after the first call's first a replay), and on the
    serve trace's requests submitted at once, so that both runs tick
    alike: leg A (the unified tick, one graph per bucket) greedy and
    min-p, and leg B (the phase-split decode step, one graph an engine)
    with the paged, flash_decode and xla decode attention, and min-p.
    Records each graph's capture time, pool bytes and replays."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.cache import KVCache, align_capacity
    from llm_np_cp_tpu_torch.generate import Generator, make_decode_loop_fn
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    params, cfg = gen.params, gen.config
    ids = torch.as_tensor(prompts, device="cuda")
    checks = {}
    with graphs.eager_steps():
        eager = gen.generate(prompts, DECODE_STEPS).tokens
    checks["generator_flash_decode_fused"] = dict(
        identical=bool((eager == captured_tokens).all()), steps=DECODE_STEPS - 1,
        graphs=step_stats(gen.graph_steps()))

    def loop_tokens(attn: str, fused: bool):
        loop = make_decode_loop_fn(cfg, Sampler("greedy"), attn_impl=attn, fused_epilogue=fused)
        cache = KVCache.init(cfg, ids.shape[0], align_capacity(ids.shape[1] + GRAPH_STEPS))
        logits, cache = forward(params, ids, cfg, cache, logits_last_only=True)
        toks, cache, _ = loop(params, logits[:, -1].argmax(-1).int(), cache, None, GRAPH_STEPS)
        return toks.cpu().numpy(), cache

    for attn, fused in (("xla", True), ("xla", False), ("flash_decode", False)):
        with graphs.eager_steps():
            want, _ = loop_tokens(attn, fused)
        got, cache = loop_tokens(attn, fused)
        checks[f"loop_{attn}_{'fused' if fused else 'logits'}"] = dict(
            identical=bool((got == want).all()), steps=GRAPH_STEPS,
            graphs=step_stats(st.run for st in cache.steps.values()))
        del cache

    sampled = Generator(params, cfg, sampler=Sampler("min_p"), prefill_attn_impl="flash",
                        decode_attn_impl="flash_decode")
    with graphs.eager_steps():
        want = sampled.generate(prompts, GRAPH_STEPS, seed=11).tokens
    g0 = graph_totals()
    got = [sampled.generate(prompts, GRAPH_STEPS, seed=11).tokens for _ in range(2)]
    run = graph_delta(g0)
    checks["generator_min_p"] = dict(
        identical=all(bool((g == want).all()) for g in got)
        and run == dict(captures=1, eager=1, replays=2 * (GRAPH_STEPS - 1) - 1),
        steps=GRAPH_STEPS - 1, calls=2, graphs_run=run, graphs=step_stats(sampled.graph_steps()))
    del sampled

    trace = serve_trace(np, cfg, SERVE_REQUESTS, SERVE_NEW_TOKENS, seed=0)

    def serve_all(leg: str, sampler: str, **extra):
        eng = serve_engine(params, cfg, torch.bfloat16, leg, sampler=sampler, **extra)
        for j, item in enumerate(trace):
            eng.submit(item["prompt"], item["max_new_tokens"], seed=j)
        eng.run_until_complete()
        return {r.req_id: list(r.generated) for r in eng.scheduler.finished}, eng

    # leg A greedy and min-p (a bucket graph each, the sampled tick's
    # row keys and draw inside it); leg B (the phase-split decode step,
    # one graph per engine) with each decode attention, and min-p
    serves = {"serve_leg_A": ("A_mixed", "greedy", {}),
              "serve_leg_A_min_p": ("A_mixed", "min_p", {}),
              "serve_leg_B_paged": ("B_split_paged", "greedy", {}),
              "serve_leg_B_paged_min_p": ("B_split_paged", "min_p", {}),
              "serve_leg_B_flash_decode": ("B_split_paged", "greedy",
                                           dict(decode_attn_impl="flash_decode")),
              "serve_leg_B_xla": ("B_split_paged", "greedy", dict(decode_attn_impl="xla"))}
    for name, (leg, sampler, extra) in serves.items():
        with graphs.eager_steps():
            want, _ = serve_all(leg, sampler, **extra)
        g0 = graph_totals()
        got, eng = serve_all(leg, sampler, **extra)
        counts = eng.compile_counts()
        steps = eng.n_dispatches if eng.mixed else eng.n_decode_dispatches
        run = graph_delta(g0)
        graphs_ok = (0 < counts["mixed_step"] <= len(eng.mixed_buckets) if eng.mixed
                     else counts == {"decode_step": 1})
        checks[name] = dict(
            identical=got == want and len(got) == SERVE_REQUESTS and graphs_ok
            and run["replays"] + run["eager"] == steps,
            sampler=sampler, steps=steps, graphs_run=run, compile_counts=counts,
            buckets=list(eng.mixed_buckets), graphs=step_stats(eng.graph_steps()))
        del eng
        torch.cuda.empty_cache()
    every = [g for c in checks.values() for g in c["graphs"]]
    return dict(phase="graphs", card=card, model="meta-llama/Llama-3.2-1B",
                weights="seeded random bf16", checks=checks,
                capture_s_per_graph=dict(min=min(g["capture_s"] for g in every),
                                         max=max(g["capture_s"] for g in every),
                                         mean=sum(g["capture_s"] for g in every) / len(every)),
                pool_bytes_per_graph=dict(min=min(g["pool_bytes"] for g in every),
                                          max=max(g["pool_bytes"] for g in every)),
                totals=graph_totals(), ok=all(c["identical"] for c in checks.values()))


# ----------------------------------------------------------------------
# phase 5: the serve engine
# ----------------------------------------------------------------------

def serve_engine(params, cfg, dtype, leg: str, prompt: int = SERVE_PROMPTS[1],
                 new_tokens: int = SERVE_NEW_TOKENS, sampler: str = "greedy", **extra):
    """A ServeEngine in one of SERVE_LEGS (and ``extra`` keywords) with a
    ``sampler`` (SERVE_SAMPLERS), its pool sized by ``pool_geometry`` for
    the trace's worst request (``prompt`` tokens, ``new_tokens`` more)."""
    import torch

    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine, pool_geometry

    _, num_blocks, max_seq_len = pool_geometry(
        prompt, new_tokens, SERVE_SLOTS, SERVE_BLOCK, SERVE_CHUNK)
    return ServeEngine(params, cfg, sampler=Sampler(sampler, **SERVE_SAMPLERS[sampler]),
                       max_slots=SERVE_SLOTS,
                       num_blocks=num_blocks, block_size=SERVE_BLOCK, max_seq_len=max_seq_len,
                       prefill_chunk=SERVE_CHUNK, cache_dtype=dtype, device=torch.device("cuda"),
                       **{**SERVE_LEGS[leg], **extra})


def serve_trace(np, cfg, n: int, new_tokens: int, seed: int,
                prompts: tuple[int, int] = SERVE_PROMPTS) -> list[dict]:
    from llm_np_cp_tpu_torch.serve import poisson_trace

    return poisson_trace(np.random.default_rng(seed), n, rate_rps=40.0,
                         prompt_len_range=prompts, max_new_tokens=new_tokens,
                         vocab_size=cfg.vocab_size)


def ragged_combines(torch, da, eng, cfg, since: dict[int, int],
                    counts: dict[int, int] | None = None, heads: int | None = None) -> int:
    """Combine launches the unified tick's dispatches since ``since`` (the
    engine's ``bucket_dispatches`` then; ``counts``: runs per width in
    their place) imply: per packed width, the layers whose ragged split
    plan over that width is > 1 (the plan reads shapes alone, so a
    replayed graph launches the combine exactly where the eager step
    did).  ``heads``: a tensor-parallel rank's query heads (its pool holds
    its KV heads)."""
    from llm_np_cp_tpu_torch.serve.engine import GLOBAL_WINDOW

    pages = eng.pool.pages.k[0]
    tables = torch.empty((eng.scheduler.max_slots, eng.max_blocks_per_seq), dtype=torch.int32,
                         device="cuda")
    n = 0
    for t_w, count in (eng.bucket_dispatches if counts is None else counts).items():
        q = torch.empty((t_w, heads or cfg.num_attention_heads, cfg.head_dim),
                        dtype=torch.bfloat16, device="cuda")
        for i in range(cfg.num_hidden_layers):
            window = (cfg.sliding_window if cfg.sliding_window is not None
                      and cfg.layer_is_sliding(i) else GLOBAL_WINDOW)
            n += (count - since.get(t_w, 0)) * int(da.ragged_split_plan(q, pages, tables, window) > 1)
    return n


def check_replayed(where: str, graphs_run: dict, steps: int) -> None:
    """Every one of ``steps`` captured steps ran as a graph replay, or as
    the eager first call of a new shape; some replayed."""
    if graphs_run["replays"] + graphs_run["eager"] != steps or graphs_run["replays"] == 0:
        raise AssertionError(f"{where}: {steps} steps, graphs ran {graphs_run}")


def graph_totals() -> dict:
    from llm_np_cp_tpu_torch import graphs

    return dict(graphs.TOTALS)


def graph_delta(before: dict) -> dict:
    now = graph_totals()
    return {k: now[k] - before[k] for k in ("captures", "replays", "eager")}


def teacher_forced_requests(torch, forward, params, cfg, reqs, tol: float,
                            cache_dtype=None) -> dict:
    """Every request's tokens against one plain forward over its prompt +
    tokens: each chosen token's logit within ``tol`` of its row's max.
    The forward is cache-less, or with ``cache_dtype`` (the int8 pool's
    ``torch.int8``) writes every position into a fresh plain cache of that
    type and attends it: the plain twin of an int8-cache engine, its
    quantization included."""
    from llm_np_cp_tpu_torch.cache import KVCache

    gaps, exact, n, finite = [], 0, 0, True
    for r in reqs:
        gen = torch.tensor(r.generated, device="cuda").long()
        ids = torch.cat([torch.as_tensor(r.prompt, device="cuda").long(), gen[:-1]])[None]
        cache = (None if cache_dtype is None
                 else KVCache.init(cfg, 1, ids.shape[1], cache_dtype, device="cuda"))
        logits, _ = forward(params, ids, cfg, cache)
        rows = logits[0, r.prompt.size - 1:]  # the row behind each chosen token
        finite = finite and bool(torch.isfinite(rows).all())
        chosen = rows.gather(-1, gen[:, None])[:, 0]
        gaps.append((rows.amax(dim=-1) - chosen).max().item())
        exact += int((rows.argmax(dim=-1) == gen).sum().item())
        n += gen.numel()
    return dict(requests=len(reqs), tokens=n, exact_share_vs_cacheless=exact / n,
                max_gap_vs_cacheless=max(gaps), tol=tol, ok=finite and max(gaps) <= tol)


def sampled_support(torch, forward, params, cfg, sampler, reqs, tol: float = TEACHER_TOL) -> dict:
    """Every request's min-p tokens against one cache-less plain forward
    over its prompt + tokens: each chosen token inside the sampler's
    support there, its log-prob within ``tol`` of the keep threshold (the
    bf16 noise of the cached path against the cache-less one)."""
    import math

    if sampler.kind != "min_p":
        raise ValueError(f"sampled_support checks min-p draws, got {sampler.kind}")

    n, inside, finite = 0, 0, True
    worst = 0.0
    for r in reqs:
        gen = torch.tensor(r.generated, device="cuda").long()
        ids = torch.cat([torch.as_tensor(r.prompt, device="cuda").long(), gen[:-1]])[None]
        logits, _ = forward(params, ids, cfg, None)
        rows = logits[0, r.prompt.size - 1:].float()
        finite = finite and bool(torch.isfinite(rows).all())
        if sampler.temperature != 1.0:
            rows = rows / sampler.temperature
        logp = torch.log_softmax(rows, dim=-1)
        chosen = logp.gather(-1, gen[:, None])[:, 0]
        thresh = logp.amax(dim=-1) + math.log(sampler.p_base)
        short = (thresh - chosen).clamp_min(0.0)
        worst = max(worst, short.max().item())
        inside += int((short <= tol).sum().item())
        n += gen.numel()
    return dict(requests=len(reqs), tokens=n, inside_support=inside,
                max_logp_below_threshold=worst, tol=tol, ok=finite and inside == n)


def first_divergence(torch, forward, params, cfg, prompt, a: list, b: list) -> float | None:
    """None when the two token lists agree; else the plain logits' top-two
    gap at their first difference (a near-tie is a small gap)."""
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None and len(a) == len(b):
        return None
    ids = torch.cat([torch.as_tensor(prompt, device="cuda").long(),
                     torch.tensor(a[:j], device="cuda").long()])[None]
    logits, _ = forward(params, ids, cfg, None, logits_last_only=True)
    top2 = torch.topk(logits[0, -1], 2).values
    return (top2[0] - top2[1]).item()


def timed_serve_leg(torch, kernels: dict, params, cfg, where: str, leg: str, trace: list[dict],
                    *, sampler: str = "greedy", prompt: int = SERVE_PROMPTS[1],
                    new_tokens: int = SERVE_NEW_TOKENS, epilogue: str = "sample_epilogue",
                    **extra) -> tuple[dict, object]:
    """One timed ``replay_trace`` of ``trace`` on a fresh engine in
    ``SERVE_LEGS[leg]`` (``extra``: engine keywords), its pool sized for
    ``prompt`` + ``new_tokens`` tokens, after a warm-up that captures
    every graph: every request finished, launch counts against what the
    ticks imply (``epilogue``: the head's epilogue kernel; a sampled kind
    draws instead, one row-key derivation and one categorical a step, and
    the phase split also draws each prefill's first token), one host
    fetch per dispatching step, every step a replay and no graph beyond
    the unified tick's buckets or the phase split's one decode step.
    Returns (the record, the engine); the caller checks the tokens."""
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da

    layers, kh = cfg.num_hidden_layers, cfg.num_key_value_heads
    eng = serve_engine(params, cfg, torch.bfloat16, leg, prompt, new_tokens, sampler=sampler,
                       **extra)
    if (eng.epilogue_impl == "fused") != (sampler == "greedy"):
        raise AssertionError(f"{where}: epilogue {eng.epilogue_impl} for a {sampler} sampler")
    eng.warmup([SERVE_PROMPTS[0]], 2)
    torch.cuda.synchronize()
    reset_counts(kernels)
    d0, dd0, v0, f0 = (eng.n_dispatches, eng.n_decode_dispatches, eng.n_verify_dispatches,
                       eng.n_host_fetches)
    b0, g0 = dict(eng.bucket_dispatches), graph_totals()
    t0 = time.perf_counter()
    snap = eng.replay_trace(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    graphs_run = graph_delta(g0)
    dispatches, fetches = eng.n_dispatches - d0, eng.n_host_fetches - f0
    decode_dispatches = eng.n_decode_dispatches - dd0
    if snap["finished"] != len(trace):
        raise AssertionError(f"{where}: {snap['finished']} of {len(trace)} finished")
    steps = dispatches if eng.mixed else decode_dispatches  # the steps that fetch
    want = {name: 0 for name in kernels}
    if sampler == "greedy":
        want[epilogue] = steps
    else:
        draws = steps + (0 if eng.mixed else len(trace) + snap["preemptions"])
        want.update(threefry2x32=draws, categorical=draws)
    nsplit = None
    if eng.mixed:
        want["ragged_paged_attention"] = layers * steps
        want["ragged_paged_attention_combine"] = ragged_combines(torch, da, eng, cfg, b0)
    else:
        # the paged decode's split plan over the engine's [slots, blocks
        # per sequence] tables: a combine follows each launch when > 1
        nsplit = da.split_plan(eng.scheduler.max_slots, kh, eng.max_blocks_per_seq * SERVE_BLOCK,
                               cfg.head_dim, da.sm_count(torch.device("cuda")),
                               cfg.num_attention_heads // kh)
        want["paged_decode_attention"] = layers * steps
        want["paged_decode_attention_combine"] = layers * steps * int(nsplit > 1)
    if launches != want or fetches != steps:
        raise AssertionError(f"{where}: launch counts {launches} != implied {want}, "
                             f"{fetches} host fetches for {steps} dispatching steps")
    check_replayed(where, graphs_run, steps)
    counts = eng.compile_counts()
    if graphs_run["captures"] or (counts["mixed_step"] > len(eng.mixed_buckets) if eng.mixed
                                  else counts != {"decode_step": 1}):
        raise AssertionError(f"{where}: graphs beyond the warm-up's: {graphs_run}, {counts}")
    out = dict(leg=leg, sampler=sampler, launches=launches, implied=want, graphs=graphs_run,
               compile_counts=counts, mixed_buckets=list(eng.mixed_buckets),
               paged_nsplit=nsplit, requests=len(trace), new_tokens=new_tokens,
               table_slots=eng.max_blocks_per_seq * SERVE_BLOCK,
               tick_token_budget=eng.tick_token_budget, wall_s=wall,
               generated_tokens=snap["total_generated_tokens"],
               tok_s_per_card=snap["total_generated_tokens"] / wall, ticks=snap["ticks"],
               dispatches=dispatches, decode_dispatches=decode_dispatches,
               dispatching_steps=steps, verify_dispatches=eng.n_verify_dispatches - v0,
               host_fetches=fetches, preemptions=snap["preemptions"],
               ttft_s_p50=snap.get("ttft_s_p50"), ttft_s_p99=snap.get("ttft_s_p99"),
               tpot_s_p50=snap.get("tpot_s_p50"), tpot_s_p99=snap.get("tpot_s_p99"),
               **{k: v for k, v in snap.items()
                  if k.startswith(("spec_", "mixed_prefill_tokens", "mixed_decode_tokens"))})
    return out, eng


def served_tokens_check(torch, forward, params, cfg, eng) -> dict:
    """A served leg's tokens: greedy teacher-forced against a cache-less
    plain forward (``teacher_forced_requests``), a sampled kind each
    token inside its sampler's support (``sampled_support``)."""
    if eng.sampler.kind == "greedy":
        return teacher_forced_requests(torch, forward, params, cfg, eng.scheduler.finished,
                                       TEACHER_TOL)
    return sampled_support(torch, forward, params, cfg, eng.sampler, eng.scheduler.finished)


def leg_a_replay(torch, np, kernels: dict, params, cfg, where: str, trace: list[dict],
                 prompt: int, new_tokens: int, epilogue: str = "sample_epilogue",
                 sampler: str = "greedy", **extra) -> tuple[dict, dict]:
    """Serve leg A (the unified tick; ``extra``: engine keywords) on
    ``trace`` through ``timed_serve_leg``, its tokens checked by
    ``served_tokens_check``.  Returns the record and each request's
    tokens by seed."""
    from llm_np_cp_tpu_torch.models.transformer import forward

    out, eng = timed_serve_leg(torch, kernels, params, cfg, where, "A_mixed", trace,
                               sampler=sampler, prompt=prompt, new_tokens=new_tokens,
                               epilogue=epilogue, **extra)
    out["teacher_forced"] = served_tokens_check(torch, forward, params, cfg, eng)
    tokens = {r.seed: list(r.generated) for r in eng.scheduler.finished}
    del eng
    torch.cuda.empty_cache()
    return out, tokens


def serve_phase(torch, np, kernels: dict, card: str) -> dict:
    """Llama-3.2-1B behind the ServeEngine, both legs on one trace."""
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    trace = serve_trace(np, cfg, SERVE_REQUESTS, SERVE_NEW_TOKENS, seed=0)
    legs = {}
    # each leg greedy (the fused epilogue), then each with min-p (the
    # logits tail and the keyed draw, captured like greedy)
    runs = {"A_mixed": ("A_mixed", "greedy"), "B_split_paged": ("B_split_paged", "greedy"),
            "A_min_p": ("A_mixed", "min_p"), "B_min_p": ("B_split_paged", "min_p")}
    for name, (leg, sampler) in runs.items():
        rec, eng = timed_serve_leg(torch, kernels, params, cfg, f"serve leg {name}", leg, trace,
                                   sampler=sampler)
        legs[name] = dict(rec, teacher_forced=served_tokens_check(torch, forward, params, cfg,
                                                                  eng),
                          tokens={r.seed: list(r.generated) for r in eng.scheduler.finished})
        if name == "A_mixed":
            prof_engine = eng
        else:
            del eng
    # leg A at long context: the ragged kernel's bands are long enough for
    # its plan to split them and launch the combine
    long_trace = serve_trace(np, cfg, LONG_SERVE_REQUESTS, LONG_SERVE_TOKENS, seed=3,
                             prompts=LONG_SERVE_PROMPTS)
    legs["A_long_context"] = dict(leg_a_replay(
        torch, np, kernels, params, cfg, "long-context leg", long_trace, LONG_SERVE_PROMPTS[1],
        LONG_SERVE_TOKENS)[0], prompt_len=LONG_SERVE_PROMPTS)

    # torch.profiler over a short leg-A replay (outside the counted runs)
    short = serve_trace(np, cfg, F32_SERVE_REQUESTS, F32_SERVE_TOKENS, seed=2)
    prof = profile_run(torch, lambda: prof_engine.replay_trace(short), {
        "ragged_paged_attention": "ragged_kernel", "sample_epilogue": "epilogue_"})
    del prof_engine

    # float32 run of both legs against the offline Generator
    params32 = float32_params(params)
    del params
    trace32 = serve_trace(np, cfg, F32_SERVE_REQUESTS, F32_SERVE_TOKENS, seed=1)
    got32 = {}
    for leg in SERVE_LEGS:
        eng = serve_engine(params32, cfg, torch.float32, leg)
        eng.replay_trace(trace32)
        got32[leg] = {r.seed: list(r.generated) for r in eng.scheduler.finished}
        del eng
    gen32 = Generator(params32, cfg, sampler=Sampler("greedy"), prefill_attn_impl="xla",
                      decode_attn_impl="flash_decode", cache_dtype=torch.float32)
    identical, gaps = 0, []
    for item in trace32:
        want = [int(t) for t in gen32.generate_ragged([item["prompt"]], F32_SERVE_TOKENS).tokens[0]]
        seqs = [got32[leg].get(item["seed"]) for leg in SERVE_LEGS]
        if any(s is None for s in seqs):
            raise AssertionError(f"float32 serve run lost request {item['seed']}")
        divs = [first_divergence(torch, forward, params32, cfg, item["prompt"], s, want)
                for s in seqs]
        divs.append(first_divergence(torch, forward, params32, cfg, item["prompt"], seqs[0],
                                     seqs[1]))
        divs = [d for d in divs if d is not None]
        identical += not divs
        gaps += divs
    f32 = dict(requests=F32_SERVE_REQUESTS, new_tokens=F32_SERVE_TOKENS,
               identical_across_legs_and_offline=identical, divergence_top2_gaps=gaps,
               tol=F32_TEACHER_TOL, ok=all(g <= F32_TEACHER_TOL for g in gaps))
    for leg in legs.values():
        leg.pop("tokens", None)
    return dict(phase="serve", model="meta-llama/Llama-3.2-1B", layers=layers,
                weights="seeded random bf16", card=card,
                trace=dict(requests=SERVE_REQUESTS, rate_rps=40.0, prompt_len=SERVE_PROMPTS,
                           new_tokens=SERVE_NEW_TOKENS),
                engine=dict(max_slots=SERVE_SLOTS, block_size=SERVE_BLOCK,
                            prefill_chunk=SERVE_CHUNK),
                legs=legs, float32=f32,
                profile=dict(leg="A_mixed", requests=F32_SERVE_REQUESTS,
                             new_tokens=F32_SERVE_TOKENS, **prof))


# ----------------------------------------------------------------------
# phase 6: quantized weights
# ----------------------------------------------------------------------

def quant_phase(torch, np, kernels: dict, card: str, main: dict, serve: dict) -> dict:
    """Llama-3.2-1B with its weights quantized on the card, in each weight
    mode, through ``Generator`` (and once, int8, through the unified-tick
    ``ServeEngine``); ``main`` / ``serve`` are the bf16 phases' results of
    this run, for comparison."""
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.quant import param_bytes, quantize_params
    from llm_np_cp_tpu_torch.utils.quality import quant_quality

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 128))
    dev = torch.device("cuda")
    steps = DECODE_STEPS - 1
    kernel_kw = dict(prefill_attn_impl="flash", decode_attn_impl="flash_decode")
    modes = {}
    for mode, qkw in QUANT_MODES.items():
        qp = quantize_params(params, **qkw)
        gen = Generator(qp, cfg, sampler=Sampler("greedy"), **kernel_kw)
        if gen.epilogue_impl != "fused":
            raise AssertionError(f"quant {mode}: the int8-head epilogue was not selected")
        gen.generate(prompts, 4)  # warm-up
        torch.cuda.synchronize()
        reset_counts(kernels)
        g0 = graph_totals()
        res = gen.generate(prompts, DECODE_STEPS)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        check_replayed(f"quant {mode}", graph_delta(g0), steps)
        want = {name: 0 for name in kernels}
        want.update(flash_attention=layers, decode_attention=layers * steps,
                    decode_attention_combine=layers * steps * combines(
                        torch, cfg, 4, 128 + DECODE_STEPS),
                    sample_epilogue_int8=steps)
        if launches != want:
            raise AssertionError(f"quant {mode}: launch counts {launches} != implied {want}")
        if res.tokens.shape != (4, DECODE_STEPS):
            raise AssertionError(f"quant {mode}: token shape {res.tokens.shape}")
        tf = teacher_forced(torch, forward, KVCache, qp, cfg, torch.as_tensor(prompts, device=dev),
                            torch.as_tensor(res.tokens, device=dev),
                            tol=A8_TEACHER_TOL if qkw["act_quant"] else TEACHER_TOL)
        nbytes = param_bytes(qp)
        if mode == "int8":
            prof = profile_run(torch, lambda: gen.generate(prompts, 16), {
                "flash_attention": "flash_kernel", **DECODE_MARKERS,
                "sample_epilogue_int8": "epilogue_"})
        del gen, qp
        quality = quant_quality(cfg, params, mode, steps=QUALITY_STEPS, base_dtype=torch.bfloat16,
                                device="cuda", **kernel_kw)
        modes[mode] = dict(
            launches=launches, implied=want, param_bytes=nbytes,
            ttft_s=res.ttft_s, decode_tok_s_per_seq=res.decode_tokens_per_s,
            decode_tok_s=res.decode_tokens_per_s * 4, teacher_forced=tf, quality=quality)
        torch.cuda.empty_cache()

    # float32 twins: kernels and plain references then differ only in
    # summation order
    f32 = {}
    for mode, tol in (("int8", F32_TEACHER_TOL), ("int8_a8", A8_TEACHER_TOL)):
        qp32 = quantize_params(float32_params(params), **QUANT_MODES[mode])
        gen32 = Generator(qp32, cfg, sampler=Sampler("greedy"), cache_dtype=torch.float32,
                          **kernel_kw)
        res32 = gen32.generate(prompts, F32_STEPS)
        f32[mode] = dict(new_tokens=F32_STEPS, teacher_tol=tol, teacher_forced=teacher_forced(
            torch, forward, KVCache, qp32, cfg, torch.as_tensor(prompts, device=dev),
            torch.as_tensor(res32.tokens, device=dev), tol=tol))
        del gen32, qp32
        torch.cuda.empty_cache()

    # the serve trace behind the unified tick, int8 weights
    qp = quantize_params(params)
    run, _ = leg_a_replay(torch, np, kernels, qp, cfg, "int8 serve",
                          serve_trace(np, cfg, SERVE_REQUESTS, SERVE_NEW_TOKENS, seed=0),
                          SERVE_PROMPTS[1], SERVE_NEW_TOKENS, epilogue="sample_epilogue_int8")
    served = dict(
        weights="int8", **run,
        bf16_leg_A=dict(tok_s_per_card=serve["legs"]["A_mixed"]["tok_s_per_card"],
                        ttft_s_p50=serve["legs"]["A_mixed"]["ttft_s_p50"],
                        tpot_s_p50=serve["legs"]["A_mixed"]["tpot_s_p50"]))
    del qp
    torch.cuda.empty_cache()
    gen_bf16 = main["generate"]
    return dict(phase="quant", model="meta-llama/Llama-3.2-1B", layers=layers,
                weights="seeded random bf16, quantized on the card", card=card,
                generate=dict(batch=4, prompt_len=128, new_tokens=DECODE_STEPS),
                bf16=dict(param_bytes=param_bytes(params), ttft_s=gen_bf16["ttft_s"],
                          decode_tok_s_per_seq=gen_bf16["decode_tok_s_per_seq"],
                          decode_tok_s=gen_bf16["decode_tok_s"]),
                modes=modes, quality_steps=QUALITY_STEPS, float32=f32, serve=served,
                teacher_tol=TEACHER_TOL, a8_teacher_tol=A8_TEACHER_TOL,
                profile_int8=dict(mode="int8", generate_new_tokens=16, batch=len(prompts), **prof))


# ----------------------------------------------------------------------
# phase 7: speculative decoding
# ----------------------------------------------------------------------

def tiled_trace(np, cfg, n: int, new_tokens: int, seed: int) -> list[dict]:
    """The serve trace's arrivals with every prompt a random SPEC_SEGMENT-
    token segment tiled to SPEC_PROMPT tokens, submitted speculative."""
    trace = serve_trace(np, cfg, n, new_tokens, seed)
    rng = np.random.default_rng(100 + seed)
    for item in trace:
        seg = rng.integers(1, cfg.vocab_size, size=SPEC_SEGMENT).astype(np.int32)
        item["prompt"] = np.resize(seg, SPEC_PROMPT)
        item["speculative"] = True
    return trace


def spec_offline(torch, np, kernels: dict, params, cfg, prompts, plain, name: str,
                 **draft) -> dict:
    """One SpeculativeGenerator (``draft``: its draft keywords, none for
    the int8 self-draft) on the main path's prompts: a warm-up call
    captures the round, the timed call must replay it every round and
    launch no attention or epilogue kernel, only a round's keyed draws
    (four threefry launches: the round's key, its three subkeys, the
    draft keys, the accept uniforms, and one a generation for its first
    split; gamma + 2 categorical draws, even
    greedy, whose filtered logits are one-hot, as in the JAX package);
    teacher-forced tokens, equal to the plain
    Generator's (``plain``, its result) or first apart at a near-tie, and the
    captured rounds' tokens against an eager run's."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.speculative import SpeculativeGenerator

    spec = SpeculativeGenerator(params, cfg, gamma=SPEC_GAMMA, sampler=Sampler("greedy"), **draft)
    first = spec.generate(prompts, DECODE_STEPS)  # captures the round
    torch.cuda.synchronize()
    reset_counts(kernels)
    g0 = graph_totals()
    calls0 = sum(s.calls for s in spec.graph_steps())
    res = spec.generate(prompts, DECODE_STEPS)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    graphs_run = graph_delta(g0)
    rounds_run = sum(s.calls for s in spec.graph_steps()) - calls0
    # and the generation's own key, kp = split(PRNGKey(seed))
    draws = dict(threefry2x32=4 * rounds_run + 1, categorical=(SPEC_GAMMA + 2) * rounds_run)
    if launches != {**{k: 0 for k in launches}, **draws}:
        raise AssertionError(f"offline spec {name} launched kernels {launches}, the rounds' "
                             f"draws imply {draws}")
    if graphs_run != dict(captures=0, replays=rounds_run, eager=0) or rounds_run == 0:
        raise AssertionError(f"offline spec {name}: {rounds_run} rounds, graphs ran {graphs_run}")
    if res.tokens.shape != (4, DECODE_STEPS) or not (res.tokens == first.tokens).all():
        raise AssertionError(f"offline spec {name}: tokens {res.tokens.shape} differ between calls")
    with graphs.eager_steps():
        eager = spec.generate(prompts, DECODE_STEPS).tokens
    dev = torch.device("cuda")
    tf = teacher_forced(torch, forward, KVCache, params, cfg, torch.as_tensor(prompts, device=dev),
                        torch.as_tensor(res.tokens, device=dev))
    divs = [first_divergence(torch, forward, params, cfg, prompts[r], list(res.tokens[r]),
                             list(plain.tokens[r])) for r in range(len(prompts))]
    gaps = [d for d in divs if d is not None]
    out = dict(draft=name, gamma=SPEC_GAMMA, ttft_s=res.ttft_s,
               decode_tok_s=res.decode_tokens_per_s,
               decode_tok_s_per_seq=res.decode_tokens_per_s / len(prompts),
               plain_decode_tok_s_per_seq=plain.decode_tokens_per_s, plain_ttft_s=plain.ttft_s,
               acceptance_rate=res.acceptance_rate, tokens_per_round=res.tokens_per_round,
               rounds=res.rounds, rounds_run=rounds_run, graphs=graphs_run,
               compile_counts=spec.compile_counts(), graph_steps=step_stats(spec.graph_steps()),
               launches=launches, captured_equals_eager=bool((eager == res.tokens).all()),
               rows_identical_to_plain=len(divs) - len(gaps), divergence_top2_gaps=gaps,
               teacher_forced=tf)
    out["ok"] = tf["ok"] and out["captured_equals_eager"] and all(g <= TEACHER_TOL for g in gaps)
    del spec
    torch.cuda.empty_cache()
    return out


def spec_phase(torch, np, kernels: dict, card: str, main: dict) -> dict:
    """Speculative decoding on Llama-3.2-1B, offline and served (module
    docstring, phase 7); ``main`` is the main path's result of this run."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.speculative import truncated_draft

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(4, 128))
    gen = Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                    decode_attn_impl="flash_decode")
    gen.generate(prompts, 4)
    plain = gen.generate(prompts, DECODE_STEPS)
    del gen
    dp, dc = truncated_draft(params, cfg, SPEC_DRAFT_LAYERS)
    offline = {
        "int8_self_draft": spec_offline(torch, np, kernels, params, cfg, prompts, plain,
                                        "int8 self-draft (quantize_params)"),
        "truncated_draft": spec_offline(torch, np, kernels, params, cfg, prompts, plain,
                                        f"truncated_draft({SPEC_DRAFT_LAYERS} layers)",
                                        draft_params=dp, draft_config=dc),
    }
    del dp

    # both served legs take the spec engine's default tick budget, so ticks,
    # tok/s and TPOT differ by the verify slices alone
    budget = SERVE_SLOTS * (1 + SPEC_K) + 2 * SERVE_CHUNK

    def leg(where: str, trace: list[dict], **extra) -> tuple[dict, dict]:
        return leg_a_replay(torch, np, kernels, params, cfg, where, trace, SPEC_PROMPT,
                            SPEC_NEW_TOKENS, tick_token_budget=budget, **extra)

    trace = tiled_trace(np, cfg, SERVE_REQUESTS, SPEC_NEW_TOKENS, seed=0)
    spec, _ = leg(f"spec serve (spec_k={SPEC_K})", trace, spec_k=SPEC_K)
    plain_a, _ = leg("plain leg A", trace)
    if not spec.get("spec_drafted_tokens") or not spec.get("spec_accepted_tokens"):
        raise AssertionError(f"spec serve: speculation did not engage: {spec}")
    # the ragged launches of the ticks that carried a verify slice
    spec["verify_ragged_launches"] = cfg.num_hidden_layers * spec["verify_dispatches"]

    # the captured spec ticks against the eager ticks, requests submitted
    # at once so both runs tick alike; and plain leg A on the same
    # submissions, whose ticks differ from the spec run's by the accepted
    # drafts alone (a replay's virtual clock follows the wall, so a
    # slower tick batches more arrivals)
    def serve_all(spec_k: int) -> tuple[dict, int]:
        eng = serve_engine(params, cfg, torch.bfloat16, "A_mixed", SPEC_PROMPT, SPEC_NEW_TOKENS,
                           spec_k=spec_k, tick_token_budget=budget)
        for j, item in enumerate(trace):
            eng.submit(item["prompt"], item["max_new_tokens"], seed=j, speculative=True)
        eng.run_until_complete()
        got = {r.req_id: list(r.generated) for r in eng.scheduler.finished}
        return got, eng.n_dispatches

    with graphs.eager_steps():
        want, _ = serve_all(SPEC_K)
    got, dispatches = serve_all(SPEC_K)
    captured = dict(identical=got == want and len(got) == SERVE_REQUESTS, dispatches=dispatches,
                    plain_dispatches=serve_all(0)[1])

    # float32: spec and plain leg A on the whole served trace, token for
    # token or apart only at a near-tie
    params32 = float32_params(params)
    del params
    torch.cuda.empty_cache()
    got32 = {}
    for k in (SPEC_K, 0):
        eng = serve_engine(params32, cfg, torch.float32, "A_mixed", SPEC_PROMPT, SPEC_NEW_TOKENS,
                           spec_k=k, tick_token_budget=budget)
        snap = eng.replay_trace(trace)
        got32[k] = {r.seed: list(r.generated) for r in eng.scheduler.finished}
        if k:
            drafted32 = snap.get("spec_drafted_tokens", 0)
        del eng
    identical, gaps = 0, []
    for item in trace:
        a, b = got32[SPEC_K].get(item["seed"]), got32[0].get(item["seed"])
        if a is None or b is None:
            raise AssertionError(f"float32 spec serve lost request {item['seed']}")
        d = first_divergence(torch, forward, params32, cfg, item["prompt"], a, b)
        identical += d is None
        gaps += [d] if d is not None else []
    f32 = dict(requests=SERVE_REQUESTS, new_tokens=SPEC_NEW_TOKENS, spec_k=SPEC_K,
               spec_drafted_tokens=drafted32, identical=identical, divergence_top2_gaps=gaps,
               tol=F32_TEACHER_TOL, ok=all(g <= F32_TEACHER_TOL for g in gaps))
    del params32
    torch.cuda.empty_cache()
    served = dict(spec=spec, plain_leg_A=plain_a, captured_equals_eager=captured, float32=f32,
                  ticks_spec_over_plain=spec["ticks"] / plain_a["ticks"],
                  tok_s_spec_over_plain=spec["tok_s_per_card"] / plain_a["tok_s_per_card"],
                  tpot_p50_spec_over_plain=spec["tpot_s_p50"] / plain_a["tpot_s_p50"])
    ok = (all(v["ok"] for v in offline.values()) and spec["teacher_forced"]["ok"]
          and plain_a["teacher_forced"]["ok"] and captured["identical"] and f32["ok"])
    return dict(phase="spec", model="meta-llama/Llama-3.2-1B", layers=cfg.num_hidden_layers,
                weights="seeded random bf16", card=card,
                offline=dict(batch=4, prompt_len=128, new_tokens=DECODE_STEPS, gamma=SPEC_GAMMA,
                             main_path_decode_tok_s_per_seq=main["generate"]["decode_tok_s_per_seq"],
                             **offline),
                served=dict(trace=dict(requests=SERVE_REQUESTS, rate_rps=40.0,
                                       prompt=f"{SPEC_SEGMENT}-token segment tiled to {SPEC_PROMPT}",
                                       new_tokens=SPEC_NEW_TOKENS, spec_k=SPEC_K,
                                       tick_token_budget=budget),
                            **served),
                teacher_tol=TEACHER_TOL, ok=ok)


# ----------------------------------------------------------------------

# ----------------------------------------------------------------------
# phase 8: the host-RAM KV tier
# ----------------------------------------------------------------------

def tier_engine(params, cfg, tier, int8: bool = False, **legs):
    """A ServeEngine of the tier phase's geometry (prefix cache on)."""
    import torch

    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine

    max_seq_len = -(-(TIER_PROMPT + TIER_NEW + TIER_CHUNK) // TIER_BLOCK) * TIER_BLOCK
    return ServeEngine(params, cfg, sampler=Sampler("greedy"), max_slots=TIER_SLOTS,
                       num_blocks=TIER_BLOCKS, block_size=TIER_BLOCK, max_seq_len=max_seq_len,
                       prefill_chunk=TIER_CHUNK,
                       cache_dtype=torch.int8 if int8 else torch.bfloat16,
                       enable_prefix_cache=True, host_tier=tier, device=torch.device("cuda"),
                       **legs)


def tier_roundtrip(torch, eng) -> dict:
    """One registered pool block spilled through a fresh tier (pinned
    memory, the writer's stream) and restored into a different free block
    id the way the engine lands a restore: bit-exact, page by page."""
    from llm_np_cp_tpu_torch.serve import HostTier

    key, src = eng.pool.prefix_cache.items()[-1]
    (dst,) = eng.pool.alloc(1)
    tier = HostTier(1 << 30)
    try:
        tier.enqueue_spill(b"roundtrip", *eng._block_clone(src))
        tier.drain()
        host = tier._wentries[b"roundtrip"]
        pinned = all(a.is_pinned() for a in host if a is not None)
        (res,) = tier.take_restored([tier.enqueue_restore(b"roundtrip", dst, eng.device)])
        _, staged, dt, ready = res
        stream = torch.cuda.current_stream()
        stream.wait_event(ready)
        for page, a in zip(eng.pool.pages, staged):
            if page is not None:
                page[:, dst].copy_(a)
                a.record_stream(stream)
        torch.cuda.synchronize()
        exact = all(torch.equal(page[:, dst], page[:, src])
                    for page in eng.pool.pages if page is not None)
    finally:
        tier.close()
        eng.pool.free([dst])
    return dict(src_block=src, dst_block=dst, bytes=host.nbytes, pinned=pinned,
                stage_s=dt, bit_exact=exact)


def tier_phase(torch, np, kernels: dict, card: str) -> dict:
    """Llama-3.2-1B behind the engine on the serve_prefix_tiered trace, on
    identical arrivals: (a) the unified tick without a tier, (b) with a 4
    GiB host tier, (c) as (b) with the int8 pool, (d) the phase split with
    the paged decode and the tier.  Then a block's round trip through the
    tier, and ``spill_prefix_blocks`` shipping a prefix into a second
    engine that shares the tier."""
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.serve import HostTier, poisson_trace

    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    layers, kh = cfg.num_hidden_layers, cfg.num_key_value_heads
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    trace = poisson_trace(np.random.default_rng(29), TIER_REQUESTS, rate_rps=TIER_RATE,
                          prompt_len_range=(TIER_PROMPT, TIER_PROMPT), max_new_tokens=TIER_NEW,
                          vocab_size=cfg.vocab_size, seed_base=29,
                          distinct_prompts=TIER_DISTINCT)
    legs, tokens, checks = {}, {}, []
    roundtrip = None
    for name, (extra, tiered, int8) in TIER_LEGS.items():
        tier = HostTier(TIER_BYTES) if tiered else None
        eng = tier_engine(params, cfg, tier, int8, **extra)
        eng.warmup([TIER_PROMPT], 2)
        torch.cuda.synchronize()
        reset_counts(kernels)
        dd0, f0 = eng.n_decode_dispatches, eng.n_host_fetches
        b0, g0 = dict(eng.bucket_dispatches), graph_totals()
        t0 = time.perf_counter()
        snap = eng.replay_trace(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        graphs_run = graph_delta(g0)
        if tier is not None:
            tier.drain()
            snap = eng.metrics.snapshot()
        fetches = eng.n_host_fetches - f0
        if eng.mixed:
            steps = sum(eng.bucket_dispatches.values()) - sum(b0.values())
        else:
            steps = eng.n_decode_dispatches - dd0
        want = {k: 0 for k in kernels}
        want["sample_epilogue"] = steps
        if eng.mixed:
            want["ragged_paged_attention"] = layers * steps
            want["ragged_paged_attention_combine"] = ragged_combines(torch, da, eng, cfg, b0)
        else:
            nsplit = da.split_plan(eng.scheduler.max_slots, kh,
                                   eng.max_blocks_per_seq * TIER_BLOCK, cfg.head_dim,
                                   da.sm_count(torch.device("cuda")),
                                   cfg.num_attention_heads // kh)
            want["paged_decode_attention"] = layers * steps
            want["paged_decode_attention_combine"] = layers * steps * int(nsplit > 1)
        if snap["finished"] != TIER_REQUESTS:
            checks.append(f"{name}: {snap['finished']} of {TIER_REQUESTS} finished")
        if launches != want:
            checks.append(f"{name}: launch counts {launches} != implied {want}")
        if fetches != steps:
            checks.append(f"{name}: {fetches} host fetches for {steps} steps")
        check_replayed(f"tier leg {name}", graphs_run, steps)
        if graphs_run["captures"]:
            checks.append(f"{name}: captures in the timed replay {graphs_run}")
        # an int8 pool is held against the plain forward over an int8
        # cache (its own quantization); the bf16 cache-less gap is kept
        tf = teacher_forced_requests(torch, forward, params, cfg, eng.scheduler.finished,
                                     TEACHER_TOL, torch.int8 if int8 else None)
        if not tf["ok"]:
            checks.append(f"{name}: teacher-forced check failed {tf}")
        tf_cacheless = (teacher_forced_requests(torch, forward, params, cfg,
                                                eng.scheduler.finished, TEACHER_TOL)
                        if int8 else None)
        leg = dict(
            engine=extra, tier=tiered, pool="int8" if int8 else "bf16", launches=launches,
            implied=want, graphs=graphs_run, compile_counts=eng.compile_counts(),
            wall_s=wall, generated_tokens=snap["total_generated_tokens"],
            tok_s_per_card=snap["total_generated_tokens"] / wall, ticks=snap["ticks"],
            steps=steps, host_fetches=fetches, preemptions=snap["preemptions"],
            ttft_s_p50=snap.get("ttft_s_p50"), ttft_s_p99=snap.get("ttft_s_p99"),
            tpot_s_p50=snap.get("tpot_s_p50"), tpot_s_p99=snap.get("tpot_s_p99"),
            mixed_prefill_tokens=snap["mixed_prefill_tokens"],
            prefix_blocks_hit=snap["prefix_blocks_hit"],
            prefix_hit_rate=snap.get("prefix_hit_rate", 0.0),
            prefix_evicted_blocks=snap["prefix_evicted_blocks"], teacher_forced=tf,
            teacher_forced_vs_bf16_cacheless=tf_cacheless)
        if tier is not None:
            st = tier.stats()
            leg.update(
                tier_spilled_blocks=snap["tier_spilled_blocks"],
                tier_restored_blocks=snap["tier_restored_blocks"],
                tier_restore_s_p50=snap.get("tier_restore_s_p50"),
                tier_restore_s_p99=snap.get("tier_restore_s_p99"),
                tier_breakeven_ratio=snap["tier_breakeven_ratio"],
                probe_restore_s_per_block=tier.restore_s_per_block,
                probe_gbps=st["restore_gbps"], block_bytes=eng._block_nbytes, tier_stats=st)
            if st["restore_misses"]:
                checks.append(f"{name}: {st['restore_misses']} restore misses")
            if (snap["tier_restored_blocks"] != st["restored_blocks"]
                    or snap["tier_spilled_blocks"] != st["spilled_blocks"]):
                checks.append(f"{name}: tier ledgers {snap['tier_spilled_blocks']} / "
                              f"{snap['tier_restored_blocks']} != the tier's stats {st}")
            if not st["restored_blocks"]:
                checks.append(f"{name}: nothing restored")
            if roundtrip is None and not int8:
                roundtrip = tier_roundtrip(torch, eng)
                if not (roundtrip["bit_exact"] and roundtrip["pinned"]):
                    checks.append(f"{name}: block round trip {roundtrip}")
            tier.close()
        legs[name] = leg
        tokens[name] = {r.seed: (r.prompt, list(r.generated)) for r in eng.scheduler.finished}
        del eng
        torch.cuda.empty_cache()
    a, b = legs["a_mixed_off"], legs["b_mixed_tier"]
    if not (b["mixed_prefill_tokens"] < a["mixed_prefill_tokens"]
            and b["prefix_hit_rate"] > a["prefix_hit_rate"]):
        checks.append(f"tier leg b does not beat leg a: prefill tokens "
                      f"{b['mixed_prefill_tokens']} vs {a['mixed_prefill_tokens']}, hit rate "
                      f"{b['prefix_hit_rate']} vs {a['prefix_hit_rate']}")
    # tokens of the tier-on legs against leg (a): equal, or apart first at
    # a near-tie of the plain logits (the cuBLAS products of a token's K/V
    # may round apart between ticks of different packed widths)
    parity = {}
    for name in ("b_mixed_tier", "c_mixed_tier_int8", "d_split_paged_tier"):
        gaps = []
        for seed, (prompt, want_toks) in tokens["a_mixed_off"].items():
            got = tokens[name][seed][1]
            gap = first_divergence(torch, forward, params, cfg, prompt, got, want_toks)
            if gap is not None:
                gaps.append(gap)
        parity[name] = dict(identical=TIER_REQUESTS - len(gaps), divergence_top2_gaps=gaps,
                            tol=TEACHER_TOL, ok=all(g <= TEACHER_TOL for g in gaps))
        if name == "b_mixed_tier" and not parity[name]["ok"]:
            checks.append(f"tier leg b parts from leg a away from a near-tie: {parity[name]}")

    # ship: one engine spills its registered prefix into a tier a second
    # engine shares; that engine's first request of the prompt restores
    # the whole shareable prefix and prefills only the last chunk
    tier = HostTier(TIER_BYTES)
    src, dst = (tier_engine(params, cfg, tier, mixed_step="on") for _ in range(2))
    prompt = trace[0]["prompt"]
    first = src.submit(prompt, TIER_NEW)
    src.run_until_complete()
    shipped = src.spill_prefix_blocks()
    tier.drain()
    again = dst.submit(prompt, TIER_NEW)
    dst.run_until_complete()
    snap = dst.metrics.snapshot()
    ship = dict(shipped_blocks=shipped, shared_blocks=again.n_shared_blocks,
                restored_blocks=snap.get("tier_restored_blocks", 0),
                prefill_tokens=snap["mixed_prefill_tokens"],
                last_chunk=TIER_PROMPT - again.n_shared_blocks * TIER_BLOCK,
                divergence_top2_gap=first_divergence(torch, forward, params, cfg, prompt,
                                                     again.generated, first.generated))
    ship["ok"] = (shipped > 0 and ship["restored_blocks"] == again.n_shared_blocks > 0
                  and ship["prefill_tokens"] == ship["last_chunk"] <= TIER_CHUNK
                  and (ship["divergence_top2_gap"] is None
                       or ship["divergence_top2_gap"] <= TEACHER_TOL))
    if not ship["ok"]:
        checks.append(f"spill_prefix_blocks into a second engine: {ship}")
    tier.close()
    del src, dst
    torch.cuda.empty_cache()
    return dict(phase="tier", model="meta-llama/Llama-3.2-1B", layers=layers,
                weights="seeded random bf16", card=card,
                trace=dict(requests=TIER_REQUESTS, rate_rps=TIER_RATE, prompt_len=TIER_PROMPT,
                           distinct_prompts=TIER_DISTINCT, new_tokens=TIER_NEW),
                engine=dict(max_slots=TIER_SLOTS, block_size=TIER_BLOCK,
                            prefill_chunk=TIER_CHUNK, num_blocks=TIER_BLOCKS,
                            tier_bytes=TIER_BYTES),
                legs=legs, parity_vs_a=parity, roundtrip=roundtrip, ship=ship,
                checks=checks, ok=not checks)


# ----------------------------------------------------------------------
# phase 9: the HTTP front end
# ----------------------------------------------------------------------

def _pct(np, vals: list, q: float) -> float | None:
    """The JAX bench's client percentile (np.percentile, linear)."""
    return float(np.percentile(vals, q)) if vals else None


def http_leg(torch, np, eng, trace: list[dict], model_id: str, *, server_kwargs=None,
             retries: int = 0, cut_stream: bool = True, body=None,
             probes: tuple[str, ...] = ()) -> dict:
    """The trace's arrivals through the port's server over ``eng``, started
    through ``run_server`` (the coroutine ``serve_forever`` runs) on this
    event loop, its runner thread ticking the engine: one
    ``astream_completion`` client a request (``retries`` transient
    failures each), sleeping until its arrival; then a ``/metrics``
    scrape, and (``cut_stream``) one more stream cut after HTTP_CUT_AFTER tokens,
    whose blocks must come back; then the drain that ends ``run_server``.
    ``server_kwargs`` go to ``run_server`` (supervision); ``body(item)``
    adds fields to a request's body (its tenant); each path of ``probes``
    is read with a GET after the scrape (``/debug/...``).  The runner's
    engine is read at the end: a supervised restart replaces ``eng``."""
    import asyncio

    from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
    from llm_np_cp_tpu_torch.serve.http.server import run_server

    async def leg() -> dict:
        loop = asyncio.get_running_loop()
        started = loop.create_future()
        serving = asyncio.ensure_future(run_server(
            eng, model_id=model_id, host="127.0.0.1", port=0, drain_timeout=60.0,
            on_started=started.set_result, **(server_kwargs or {})))
        await asyncio.wait([started, serving], return_when=asyncio.FIRST_COMPLETED)
        if not started.done():
            serving.result()  # raises what ended the server before it started
        server = started.result()

        async def one(item):
            await asyncio.sleep(item["arrival_s"])
            return await astream_completion(
                server.host, server.port,
                {"model": model_id, "prompt": [int(t) for t in item["prompt"]],
                 "max_tokens": item["max_new_tokens"], "seed": item["seed"],
                 **(body(item) if body is not None else {})},
                timeout=300.0, retries=retries, backoff_s=0.1)

        t0 = time.perf_counter()
        results = await asyncio.gather(*(one(item) for item in trace))
        wall = time.perf_counter() - t0
        status, raw = await loop.run_in_executor(None, http_get, server.host, server.port,
                                                 "/metrics")
        probed = {}
        for path in probes:
            probed[path] = await loop.run_in_executor(None, http_get, server.host, server.port,
                                                      path)
        runner = server.runner
        snap = runner.engine.metrics.snapshot()
        sup = dict(restarts=runner.restarts, recovery_latency_s=list(runner.recovery_latency_s),
                   rebuilds=list(runner.rebuilds), state=runner.state, engine=runner.engine)
        if not cut_stream:
            server.begin_drain()
            await serving
            return dict(results=results, wall=wall, status=status, prom=raw.decode(),
                        snap=snap, sup=sup, probed=probed)
        cut = await astream_completion(
            server.host, server.port,
            {"model": model_id, "prompt": [int(t) for t in trace[0]["prompt"]],
             "max_tokens": HTTP_NEW}, disconnect_after=HTTP_CUT_AFTER, timeout=300.0)
        t_end = time.perf_counter() + 30.0
        while time.perf_counter() < t_end and not (
                eng.metrics.snapshot()["aborted"] == 1
                and eng.pool.stats()["request_held"] == 0):
            await asyncio.sleep(0.01)
        held = eng.pool.stats()["request_held"]
        aborted = eng.metrics.snapshot()["aborted"]
        server.begin_drain()
        await serving
        return dict(results=results, wall=wall, status=status, prom=raw.decode(), snap=snap,
                    sup=sup, cut=cut, held=held, aborted=aborted, probed=probed)

    return asyncio.run(leg())


def tick_timer(np, eng):
    """Time every dispatching tick on the thread that runs it (the HTTP
    leg's runner thread): its wall time and that thread's CPU time, whose
    difference is the time the thread spent off the CPU inside the tick
    (held against the direct leg's, which has no event loop beside it:
    in the HTTP leg the excess is waiting for the GIL), and the
    kv_bytes_tick gauge's host time.  Only means over a leg are
    reported: the thread clock advances in coarse steps on the card's
    host (a single tick can read more CPU than wall time), so per-tick
    percentiles of the difference mean nothing.  Wraps the engine's
    ``step`` and the byte model's ``mixed_tick_kv_read`` (its gauge
    calls, ``per_request=False``, are timed); ``runner`` holds the
    thread ident that ran the last tick.  Returns (summary, restore,
    runner)."""
    import threading

    from llm_np_cp_tpu_torch.serve import telemetry as tel

    rec = dict(wall=[], cpu=[], gauge=[])
    runner = [None]
    real_step, real_kv = eng.step, tel.mixed_tick_kv_read

    def step():
        runner[0] = threading.get_ident()
        d0, w0, c0 = eng.n_dispatches, time.perf_counter(), time.thread_time()
        try:
            return real_step()
        finally:
            if eng.n_dispatches != d0:
                rec["cpu"].append(time.thread_time() - c0)
                rec["wall"].append(time.perf_counter() - w0)

    def kv_read(*args, per_request=True):
        t0 = time.perf_counter()
        out = real_kv(*args, per_request=per_request)
        if not per_request:
            rec["gauge"].append(time.perf_counter() - t0)
        return out

    def summary() -> dict:
        wall, cpu = np.asarray(rec["wall"]), np.asarray(rec["cpu"])
        off = wall - cpu
        return dict(ticks=int(wall.size), wall_ms_mean=float(wall.mean() * 1e3),
                    wall_ms_p50=float(np.percentile(wall, 50) * 1e3),
                    cpu_ms_mean=float(cpu.mean() * 1e3),
                    off_cpu_ms_mean=float(off.mean() * 1e3),
                    off_cpu_share=float(off.sum() / wall.sum()),
                    gauge_us_mean=float(np.mean(rec["gauge"]) * 1e6),
                    gauge_us_max=float(np.max(rec["gauge"]) * 1e6))

    def restore() -> None:
        del eng.step
        tel.mixed_tick_kv_read = real_kv

    eng.step, tel.mixed_tick_kv_read = step, kv_read
    return summary, restore, runner


# the observability plane's per-tick hooks, grouped as the observe phase
# reports them: (group, owner key, method names); owner keys name an
# entry of hook_timer's ``owners``
OBSERVE_HOOKS = (
    ("bill", "telemetry", ("mixed_tick_cost", "split_tick_cost")),
    ("grade and attribute", "telemetry", ("finish", "attribute")),
    ("grade and attribute", "metrics", ("on_telemetry",)),
    ("trace appends", "tracer", ("tick", "request_phase", "request_instant", "request_end",
                                 "instant", "complete")),
    ("trace clock reads", "tracer", ("now_us",)),
    ("request args", "engine", ("_targs",)),
    ("sentinel", "engine", ("_sentinel_observe",)),
    ("tenant ledger", "tenants", ("on_terminal", "on_throttle", "cost_shares")),
    ("SLO verdicts", "slo", ("observe",)),
    ("request log", "engine", ("_log_request",)),
)


def hook_timer(eng, runner: list):
    """Time each of the plane's hooks (OBSERVE_HOOKS) by wrapping it on its
    instance: calls and seconds per group, on the thread that runs the
    ticks (``runner``, from tick_timer) and off it.  Each wrapper adds two
    clock reads a call.  Returns (summary, restore)."""
    import threading

    owners = dict(telemetry=eng.telemetry, metrics=eng.metrics, tracer=eng.tracer,
                  engine=eng, tenants=eng.tenants, slo=eng.metrics.slo)
    rec: dict[tuple[str, bool], list] = {}
    wrapped = []

    def wrap(group, obj, name):
        real = getattr(obj, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                slot = rec.setdefault((group, threading.get_ident() == runner[0]), [0, 0.0])
                slot[0] += 1
                slot[1] += dt

        setattr(obj, name, timed)
        wrapped.append((obj, name))

    for group, owner, names in OBSERVE_HOOKS:
        for name in names:
            wrap(group, owners[owner], name)

    def summary(ticks: int) -> dict:
        out = {}
        for (group, on_runner), (calls, secs) in sorted(rec.items()):
            where = "runner" if on_runner else "off_runner"
            out.setdefault(group, {})[where] = dict(
                calls=calls, ms=secs * 1e3, us_per_tick=secs * 1e6 / max(ticks, 1))
        out["total_runner_us_per_tick"] = sum(
            v["runner"]["us_per_tick"] for v in out.values() if "runner" in v)
        return out

    def restore() -> None:
        for obj, name in wrapped:
            delattr(obj, name)

    return summary, restore


def scrape_counters(prom: str) -> tuple[list[str], dict[str, float]]:
    """(lines that are not Prometheus text, unlabelled samples by name)."""
    import re

    bad, samples = [], {}
    for line in prom.splitlines():
        if line.startswith("# "):
            continue
        if not re.fullmatch(PROM_LINE, line):
            bad.append(line)
        elif "{" not in line:
            name, value = line.split()
            samples[name] = float(value)
    return bad, samples


def http_phase(torch, np, kernels: dict, card: str) -> dict:
    """The HTTP front end on the JAX bench's serve_http_poisson shape:
    the direct realtime replay and the same arrivals over HTTP on one
    warmed engine."""
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine, ServeMetrics, poisson_trace, pool_geometry

    model_id = "meta-llama/Llama-3.2-1B"
    cfg = PRESETS[model_id]
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    trace = poisson_trace(np.random.default_rng(HTTP_SEED), HTTP_REQUESTS, rate_rps=HTTP_RATE,
                          prompt_len_range=HTTP_PROMPTS, max_new_tokens=HTTP_NEW,
                          vocab_size=cfg.vocab_size, seed_base=HTTP_SEED)
    _, num_blocks, max_seq_len = pool_geometry(HTTP_PROMPTS[1], HTTP_NEW, HTTP_SLOTS,
                                               HTTP_BLOCK, HTTP_CHUNK)
    eng = ServeEngine(params, cfg, sampler=Sampler("greedy"), max_slots=HTTP_SLOTS,
                      num_blocks=num_blocks, block_size=HTTP_BLOCK, max_seq_len=max_seq_len,
                      prefill_chunk=HTTP_CHUNK, cache_dtype=torch.bfloat16, mixed_step="on",
                      device=torch.device("cuda"))
    if eng.epilogue_impl != "fused":
        raise AssertionError(f"http: epilogue {eng.epilogue_impl} for a greedy sampler")
    eng.warmup([int(t["prompt"].size) for t in trace], HTTP_NEW)
    torch.cuda.synchronize()
    checks: list[str] = []

    def counted(where: str, run) -> tuple[dict, object]:
        """Run one leg with the launch counters at 0; check its launches,
        host fetches and graph replays against its dispatches."""
        reset_counts(kernels)
        d0, f0, b0, g0 = (eng.n_dispatches, eng.n_host_fetches, dict(eng.bucket_dispatches),
                          graph_totals())
        out = run()
        torch.cuda.synchronize()
        launches, graphs_run = read_counts(kernels), graph_delta(g0)
        dispatches, fetches = eng.n_dispatches - d0, eng.n_host_fetches - f0
        want = {name: 0 for name in kernels}
        want.update(ragged_paged_attention=layers * dispatches, sample_epilogue=dispatches,
                    ragged_paged_attention_combine=ragged_combines(torch, da, eng, cfg, b0))
        if launches != want or fetches != dispatches:
            checks.append(f"{where}: launch counts {launches} != implied {want}, "
                          f"{fetches} host fetches for {dispatches} dispatches")
        if graphs_run != dict(captures=0, replays=dispatches, eager=0):
            checks.append(f"{where}: {dispatches} ticks, graphs ran {graphs_run}")
        return dict(launches=launches, implied=want, graphs=graphs_run, dispatches=dispatches,
                    host_fetches=fetches), out

    def direct_leg(where: str) -> dict:
        """The direct realtime replay, the no-HTTP baseline."""
        eng.metrics = ServeMetrics(clock=eng.clock)
        eng.scheduler.finished.clear()
        summary, restore, _ = tick_timer(np, eng)
        t0 = time.perf_counter()
        try:
            counts, snap = counted(where, lambda: eng.replay_trace(trace, realtime=True))
        finally:
            restore()
        wall = time.perf_counter() - t0
        if snap["finished"] != HTTP_REQUESTS:
            checks.append(f"{where}: {snap['finished']} of {HTTP_REQUESTS} finished")
        return dict(leg=where, **counts, wall_s=wall,
                    generated_tokens=snap["total_generated_tokens"],
                    tok_s=snap["total_generated_tokens"] / wall, ticks=snap["ticks"],
                    tokens_per_tick=(snap["mixed_prefill_tokens"] + snap["mixed_decode_tokens"])
                    / max(snap["ticks"], 1),
                    ttft_s_p50=snap.get("ttft_s_p50"), ttft_s_p99=snap.get("ttft_s_p99"),
                    tpot_s_p50=snap.get("tpot_s_p50"), tpot_s_p99=snap.get("tpot_s_p99"),
                    tick_host=summary(),
                    tokens={r.seed: list(r.generated) for r in eng.scheduler.finished})

    def served_leg(where: str, direct_tokens: dict) -> dict:
        """The same arrivals over HTTP, the engine ticked by the runner's
        thread."""
        eng.metrics = ServeMetrics(clock=eng.clock)
        eng.scheduler.finished.clear()
        summary, restore, _ = tick_timer(np, eng)
        try:
            counts, res = counted(where, lambda: http_leg(torch, np, eng, trace, model_id))
        finally:
            restore()
        results = res["results"]
        ok200 = [r for r in results if r["status"] == 200 and r["finish_reason"] == "length"
                 and len(r["token_ids"]) == HTTP_NEW]
        if len(ok200) != HTTP_REQUESTS:
            checks.append(f"{where}: {len(ok200)} of {HTTP_REQUESTS} answered 200 with "
                          f"{HTTP_NEW} tokens: {[r['status'] for r in results]}")
        gaps = []
        for item, r in zip(trace, results):
            gap = first_divergence(torch, forward, params, cfg, item["prompt"], r["token_ids"],
                                   direct_tokens.get(item["seed"], []))
            if gap is not None:
                gaps.append(gap)
        parity = dict(identical=HTTP_REQUESTS - len(gaps), divergence_top2_gaps=gaps,
                      tol=TEACHER_TOL, ok=all(g <= TEACHER_TOL for g in gaps))
        if not parity["ok"]:
            checks.append(f"{where} parts from the direct leg away from a near-tie: {parity}")
        tf = teacher_forced_requests(
            torch, forward, params, cfg,
            [SimpleNamespace(prompt=item["prompt"], generated=r["token_ids"])
             for item, r in zip(trace, results) if r["token_ids"]], TEACHER_TOL)
        if not tf["ok"] or tf["requests"] != HTTP_REQUESTS:
            checks.append(f"{where} teacher-forced: {tf}")
        bad_lines, samples = scrape_counters(res["prom"])
        hsnap = res["snap"]
        scrape = dict(status=res["status"], bad_lines=bad_lines[:5],
                      finished=samples.get("llm_serve_requests_finished_total"),
                      submitted=samples.get("llm_serve_requests_submitted_total"),
                      snapshot_finished=hsnap["finished"], snapshot_submitted=hsnap["submitted"])
        if (res["status"] != 200 or bad_lines or scrape["finished"] != hsnap["finished"]
                or scrape["submitted"] != hsnap["submitted"]
                or hsnap["finished"] != HTTP_REQUESTS):
            checks.append(f"{where} scrape: {scrape}")
        cut = dict(finish_reason=res["cut"]["finish_reason"],
                   tokens=len(res["cut"]["token_ids"]), request_held_after=res["held"],
                   aborted=res["aborted"])
        if cut != dict(finish_reason="disconnected", tokens=HTTP_CUT_AFTER,
                       request_held_after=0, aborted=1):
            checks.append(f"{where} disconnect: {cut}")
        ttft = [r["ttft_s"] for r in ok200 if r["ttft_s"] is not None]
        # client TPOT: the time after the first token over the tokens after it
        tpot = [(r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1) for r in ok200
                if r["ttft_s"] is not None and len(r["token_ids"]) > 1]
        generated = sum(len(r["token_ids"]) for r in results)
        return dict(leg=where, **counts, wall_s=res["wall"], generated_tokens=generated,
                    tok_s=generated / res["wall"], ticks=hsnap["ticks"],
                    tokens_per_tick=(hsnap["mixed_prefill_tokens"]
                                     + hsnap["mixed_decode_tokens"]) / max(hsnap["ticks"], 1),
                    ttft_s_p50=_pct(np, ttft, 50), ttft_s_p99=_pct(np, ttft, 99),
                    tpot_s_p50=_pct(np, tpot, 50), tpot_s_p99=_pct(np, tpot, 99),
                    engine_ttft_s_p50=hsnap.get("ttft_s_p50"),
                    engine_tpot_s_p50=hsnap.get("tpot_s_p50"), tick_host=summary(),
                    parity_vs_direct=parity, teacher_forced=tf, scrape=scrape, disconnect=cut)

    # the legs alternate, direct, HTTP, HTTP, direct, so that what one
    # leg leaves behind (allocator state, a warmer host) falls on both
    # kinds; the HTTP legs are held to the first direct leg's tokens
    d1 = direct_leg("http direct 1")
    h1 = served_leg("http leg 1", d1["tokens"])
    h2 = served_leg("http leg 2", d1["tokens"])
    d2 = direct_leg("http direct 2")
    d2["identical_to_direct_1"] = sum(d2["tokens"].get(k) == v for k, v in d1["tokens"].items())
    legs = [d1, h1, h2, d2]
    for leg in (d1, d2):
        del leg["tokens"]
    keys = ("ttft_s_p50", "ttft_s_p99", "tpot_s_p50", "tok_s")

    def mean(pair, key):
        vals = [leg[key] for leg in pair]
        return None if None in vals else sum(vals) / len(vals)

    direct = {k: mean((d1, d2), k) for k in keys}
    http = {k: mean((h1, h2), k) for k in keys}
    delta = {k: (http[k] - direct[k]) if http[k] is not None and direct[k] is not None else None
             for k in keys}
    off_cpu = {kind: sum(leg["tick_host"]["off_cpu_ms_mean"] for leg in pair) / 2
               for kind, pair in (("direct", (d1, d2)), ("http", (h1, h2)))}
    del eng, params
    torch.cuda.empty_cache()
    return dict(phase="http", model=model_id, layers=layers, weights="seeded random bf16",
                card=card,
                trace=dict(requests=HTTP_REQUESTS, rate_rps=HTTP_RATE, prompt_len=HTTP_PROMPTS,
                           new_tokens=HTTP_NEW, seed=HTTP_SEED),
                engine=dict(max_slots=HTTP_SLOTS, block_size=HTTP_BLOCK,
                            prefill_chunk=HTTP_CHUNK, num_blocks=num_blocks,
                            max_seq_len=max_seq_len, mixed_step="on", sampler="greedy"),
                legs=legs, direct=direct, http=http, http_minus_direct=delta,
                tick_off_cpu_ms_mean=off_cpu, checks=checks, ok=not checks)


# ----------------------------------------------------------------------
# phase 9b: the observability plane over the captured unified tick
# ----------------------------------------------------------------------

# the traced legs' layers: an SLO policy (the JAX bench's serve targets
# are not fixed; these are a chat service's), the trace ring, the
# tenants of the traced trace, the tenant leg's in-flight cap and burst
OBSERVE_SLO = dict(ttft_s=0.5, tpot_s=0.05)
OBSERVE_RING = 1 << 20
OBSERVE_TENANTS = ("team-a", "team-b", "team-c")
OBSERVE_CAP, OBSERVE_BURST = 2, 12
# the split, min-p, OTLP-down, float32 and profiled legs: the trace's
# first requests, all submitted at once (one composition a run)
OBSERVE_SHORT_REQUESTS, OBSERVE_SHORT_TOKENS = 8, 16
# profiled legs taken at most this many times when the profiler lost
# kernel records (device_per_tick's launches_without_records)
PROFILE_ATTEMPTS = 3


def otlp_collector():
    """A stdlib OTLP/HTTP JSON collector on 127.0.0.1 (loopback only):
    counts the spans and scopes it was sent.  Returns (server, got);
    ``server.shutdown(); server.server_close()`` stops it."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    got = dict(posts=0, spans=0, scopes=set(), names={})
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", "0"))))
            with lock:
                got["posts"] += 1
                for rs in body["resourceSpans"]:
                    for ss in rs["scopeSpans"]:
                        got["scopes"].add(ss["scope"]["name"])
                        got["spans"] += len(ss["spans"])
                        for sp in ss["spans"]:
                            got["names"][sp["name"]] = got["names"].get(sp["name"], 0) + 1
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, name="otlp-collector", daemon=True).start()
    return server, got


def closed_port() -> int:
    """A loopback port nothing listens on (bound, then closed)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def tick_checks(events: list[dict], phases: tuple[str, ...], hbm_gbps: float,
                peak_tflops: float) -> dict:
    """A trace's tick spans: each followed by its phase slices, named
    ``phases`` in order, contiguous inside the tick and covering it whole
    (the engine ends the tick where its last phase ends, so the phases sum
    to t6 - t0), and each roofline-graded tick at 0 < util < 1 and mfu < 1
    against the given constants."""
    ticks, bad, shortfall, utils, mfus, walls, graded_hbm = 0, [], [], [], [], [], set()
    i = 0
    while i < len(events):
        ev = events[i]
        i += 1
        if ev.get("cat") != "tick" or ev.get("ph") != "X" or ev.get("name") != "tick":
            continue
        ph = events[i:i + len(phases)]
        i += len(phases)
        ticks += 1
        if [p["name"] for p in ph] != list(phases):
            bad.append(("names", [p.get("name") for p in ph]))
            continue
        t_end = ev["ts"] + ev["dur"]
        prev = ev["ts"]
        for p in ph:
            if abs(p["ts"] - prev) > 1e-3 or p["ts"] + p["dur"] > t_end + 1e-3:
                bad.append(("not contiguous", ev["ts"], p["name"]))
            prev = p["ts"] + p["dur"]
        covered = sum(p["dur"] for p in ph)
        shortfall.append(ev["dur"] - covered)
        if abs(ev["dur"] - covered) > 1e-3:
            bad.append(("coverage", ev["ts"], covered, ev["dur"]))
        args = ev.get("args", {})
        if "roofline_util" in args:
            utils.append(args["roofline_util"])
            mfus.append(args["mfu"])
            walls.append(args["device_time_s"])
            if not (0.0 < args["roofline_util"] < 1.0 and args["mfu"] < 1.0):
                bad.append(("roofline", ev["ts"], args["roofline_util"], args["mfu"]))
    arr = lambda v: sorted(v) or [0.0]  # noqa: E731
    return dict(ticks=ticks, graded=len(utils), problems=bad[:5], n_problems=len(bad),
                shortfall_us_max=max(shortfall, default=0.0),
                roofline_util_min=min(utils, default=None),
                roofline_util_median=arr(utils)[len(utils) // 2] if utils else None,
                roofline_util_max=max(utils, default=None), mfu_max=max(mfus, default=None),
                device_time_s_median=arr(walls)[len(walls) // 2] if walls else None,
                hbm_gbps=hbm_gbps, peak_tflops=peak_tflops)


def device_per_tick(np, prof, events: list[dict], checks: list[str]) -> dict:
    """Each graded tick's device work under the profiler: its graph
    replay's kernels, and the copies made by the torch ops that start
    between its serve.mixed_dispatch range and the next one (the tick's
    fetch waits for them), as their first-start-to-last-end span and as
    their summed durations, against the tick's dispatch → fetch wall.

    Records join ticks by id and order, not by their own times: the
    profiler places some ticks' device records whole milliseconds away
    from the host's timeline (``displaced_ticks``, by up to
    ``displaced_ms_max``).  A tick makes one ``cudaGraphLaunch`` (the
    CUDA tracer numbers its calls in order, and its kernels carry the
    call's number); a copy carries the number of the torch op that made
    it, and the op its start on the host's clock.  A launch none of whose
    kernels reached the profile (``launches_without_records``: the
    profiler lost them) leaves its tick without device work.  The range's
    own annotation on the device timeline is not device work."""
    import bisect

    from torch.autograd import DeviceType

    walls = [1e3 * e["args"]["device_time_s"] for e in events
             if e.get("name") == "tick" and "device_time_s" in e.get("args", {})]
    raw = prof.profiler.kineto_results.events()
    base = min((r.start_ns() for r in raw), default=0)
    recs = [(r.name(), r.device_type(), (r.start_ns() - base) / 1e3,
             ((r.end_ns() if hasattr(r, "end_ns") else r.start_ns() + r.duration_ns()) - base)
             / 1e3, r.correlation_id(), r.linked_correlation_id())
            for r in raw]
    starts = sorted(t0 for name, dt, t0, _, _, _ in recs
                    if name == "serve.mixed_dispatch" and dt == DeviceType.CPU)
    launches = sorted(corr for name, dt, _, _, corr, _ in recs
                      if name == "cudaGraphLaunch" and dt == DeviceType.CPU)
    tick_of_launch = ({corr: k for k, corr in enumerate(launches)}
                      if len(launches) == len(starts) else {})
    # torch's ops and ranges (the CUDA tracer's own host records number
    # from another series); an id that two of them share links nowhere
    op_start: dict[int, float] = {}
    shared: set[int] = set()
    for name, dt, t0, _, corr, link in recs:
        if dt == DeviceType.CPU and link == 0 and ("::" in name or name.startswith("serve.")):
            if corr in op_start:
                shared.add(corr)
            op_start[corr] = t0
    for corr in shared:
        del op_start[corr]
    by_tick: list[list[tuple[float, float]]] = [[] for _ in starts]
    n_records = unlinked = 0
    seen: set[int] = set()
    for name, dt, t0, t1, corr, link in recs:
        if dt != DeviceType.CUDA or name.startswith("serve."):
            continue
        n_records += 1
        seen.add(corr)
        k = tick_of_launch.get(corr)
        if k is None:
            t_op = op_start.get(link)
            k = None if t_op is None else bisect.bisect_right(starts, t_op) - 1
        if k is None or k < 0:
            unlinked += 1
            continue
        by_tick[k].append((t0, t1))
    spans, busy, displaced = [], [], []
    for k, mine in enumerate(by_tick):
        if not mine:
            continue
        first, last = min(a for a, _ in mine), max(b for _, b in mine)
        spans.append((last - first) / 1e3)
        busy.append(sum(b - a for a, b in mine) / 1e3)
        # the device starts a tick's work inside the tick's window
        t1 = starts[k + 1] if k + 1 < len(starts) else float("inf")
        if first < starts[k] or first >= t1:
            displaced.append(max(starts[k] - first, first - t1) / 1e3)
    gap_share = [(sp - b) / sp for sp, b in zip(spans, busy) if sp > 0]
    out = dict(ticks=len(walls), mixed_dispatch_ranges=len(starts),
               ticks_with_device_work=len(spans), device_records=n_records,
               graph_launches=len(launches),
               launches_without_records=sum(1 for c in launches if c not in seen),
               device_records_unlinked=unlinked,
               displaced_ticks=len(displaced), displaced_ms_max=max(displaced, default=0.0),
               dispatch_to_fetch_ms_mean=float(np.mean(walls)) if walls else None,
               dispatch_to_fetch_ms_p50=_pct(np, walls, 50),
               device_span_ms_mean=float(np.mean(spans)) if spans else None,
               device_span_ms_p50=_pct(np, spans, 50),
               device_busy_ms_mean=float(np.mean(busy)) if busy else None,
               device_busy_ms_p50=_pct(np, busy, 50),
               gap_share_of_span_mean=float(np.mean(gap_share)) if gap_share else None,
               gap_share_of_span_p50=_pct(np, gap_share, 50))
    if spans and walls and len(spans) == len(walls):
        over = [w - sp for w, sp in zip(walls, spans)]
        out.update(wall_over_span_ms_mean=float(np.mean(over)),
                   wall_over_span_ms_p50=_pct(np, over, 50))
    if (not walls or len(starts) < len(walls) or len(spans) != len(walls)
            or len(launches) != len(starts)):
        checks.append(f"observe profile: {out}")
    return out


def observe_phase(torch, np, kernels: dict, card: str) -> dict:
    """The observability plane on the http phase's engine and trace
    (serve_http_poisson): HTTP legs untraced, traced, traced, untraced —
    the traced ones with a tracer, a sentinel, an SLO tracker, telemetry
    with the card's constants, a tenant ledger over three tenants and an
    OTLP exporter feeding a loopback collector — then a traced phase-split
    leg, a traced min-p leg, a tenant leg whose in-flight cap throttles
    one tenant, an OTLP leg against a closed port, a float32 pair of
    legs (untraced, traced) and a torch.profiler capture of traced ticks."""
    import os
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import ServeEngine, ServeMetrics, poisson_trace, pool_geometry
    from llm_np_cp_tpu_torch.serve.otel import OtlpExporter
    from llm_np_cp_tpu_torch.serve.request_log import RequestLog, read_request_log
    from llm_np_cp_tpu_torch.serve.slo import SLOPolicy, SLOTracker, TickSentinel
    from llm_np_cp_tpu_torch.serve.telemetry import (
        HBM_GBPS_DEFAULT,
        PEAK_TFLOPS_DEFAULT,
        TelemetryModel,
    )
    from llm_np_cp_tpu_torch.serve.tenants import TenantLedger
    from llm_np_cp_tpu_torch.serve.tracing import MIXED_TICK_PHASES, TICK_PHASES, TraceRecorder

    model_id = "meta-llama/Llama-3.2-1B"
    cfg = PRESETS[model_id]
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    trace = poisson_trace(np.random.default_rng(HTTP_SEED), HTTP_REQUESTS, rate_rps=HTTP_RATE,
                          prompt_len_range=HTTP_PROMPTS, max_new_tokens=HTTP_NEW,
                          vocab_size=cfg.vocab_size, seed_base=HTTP_SEED)
    short = [dict(item, arrival_s=0.0, max_new_tokens=OBSERVE_SHORT_TOKENS)
             for item in trace[:OBSERVE_SHORT_REQUESTS]]
    _, num_blocks, max_seq_len = pool_geometry(HTTP_PROMPTS[1], HTTP_NEW, HTTP_SLOTS,
                                               HTTP_BLOCK, HTTP_CHUNK)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "smoke_out", "observe")
    os.makedirs(out_dir, exist_ok=True)
    policy = SLOPolicy(**OBSERVE_SLO)
    checks: list[str] = []
    collector, got = otlp_collector()

    def engine(leg_params, dtype=torch.bfloat16, sampler=None, **kw) -> ServeEngine:
        kw.setdefault("mixed_step", "on")
        eng = ServeEngine(leg_params, cfg, sampler=sampler or Sampler("greedy"),
                          max_slots=HTTP_SLOTS, num_blocks=num_blocks, block_size=HTTP_BLOCK,
                          max_seq_len=max_seq_len, prefill_chunk=HTTP_CHUNK, cache_dtype=dtype,
                          device=torch.device("cuda"), **kw)
        eng.warmup([int(t["prompt"].size) for t in trace], HTTP_NEW)
        torch.cuda.synchronize()
        return eng

    def attach(eng, leg_params, *, endpoint: str | None, ledger=None, log=None) -> dict:
        """Every layer of the plane on ``eng`` (fresh metrics with the SLO
        tracker); returns them."""
        tracer = TraceRecorder(ring=OBSERVE_RING)
        exporter = None
        if endpoint is not None:
            exporter = OtlpExporter(endpoint, batch_max=256, flush_interval_s=0.2,
                                    timeout_s=2.0).attach(tracer)
        layers_ = dict(tracer=tracer, sentinel=TickSentinel(),
                       telemetry=TelemetryModel(cfg, leg_params),
                       tenants=ledger or TenantLedger(policy=policy), otel=exporter)
        eng.tracer, eng.sentinel = layers_["tracer"], layers_["sentinel"]
        eng.telemetry, eng.tenants = layers_["telemetry"], layers_["tenants"]
        eng.request_log = log
        eng.metrics = ServeMetrics(clock=eng.clock, slo=SLOTracker(policy, clock=eng.clock))
        return layers_

    def detach(eng) -> None:
        eng.tracer = eng.sentinel = eng.telemetry = eng.tenants = eng.request_log = None
        eng.metrics = ServeMetrics(clock=eng.clock)

    def counted(where: str, eng, run, *, sampled: bool = False) -> tuple[dict, object]:
        """One leg with the launch counters at 0: its launches against its
        dispatches, one host fetch and one graph replay a dispatch, no
        capture."""
        reset_counts(kernels)
        d0, f0, b0, g0 = (eng.n_dispatches, eng.n_host_fetches, dict(eng.bucket_dispatches),
                          graph_totals())
        out = run()
        torch.cuda.synchronize()
        launches, graphs_run = read_counts(kernels), graph_delta(g0)
        dispatches, fetches = eng.n_dispatches - d0, eng.n_host_fetches - f0
        if eng.mixed:
            want = {name: 0 for name in kernels}
            want.update(ragged_paged_attention=layers * dispatches,
                        ragged_paged_attention_combine=ragged_combines(torch, da, eng, cfg, b0))
            if sampled:
                want.update(threefry2x32=dispatches, categorical=dispatches)
            else:
                want.update(sample_epilogue=dispatches)
            if launches != want or fetches != dispatches:
                checks.append(f"{where}: launch counts {launches} != implied {want}, "
                              f"{fetches} host fetches for {dispatches} dispatches")
            if graphs_run != dict(captures=0, replays=dispatches, eager=0):
                checks.append(f"{where}: {dispatches} ticks, graphs ran {graphs_run}")
        return dict(launches=launches, graphs=graphs_run, dispatches=dispatches,
                    host_fetches=fetches), out

    def ledgers_conserve(where: str, snap: dict, tenants: dict, log_records=None) -> dict:
        """Per-tenant sums (and the request log's per-request cost blocks)
        against the global ledgers."""
        keys = (("kv_bytes_read", "kv_read_bytes_total"),
                ("kv_bytes_written", "kv_write_bytes_total"),
                ("weight_bytes_amortized", "weight_bytes_total"),
                ("device_time_s", "device_time_s_total"))
        rel = {}
        for tk, mk in keys:
            total = snap.get(mk, 0.0)
            rel[tk] = abs(sum(e[tk] for e in tenants.values()) - total) / max(total, 1e-30)
            if log_records is not None:
                lsum = sum(r.get("cost", {}).get(tk, 0.0) for r in log_records)
                rel[f"log_{tk}"] = abs(lsum - total) / max(total, 1e-30)
        n_req = sum(e["requests"] for e in tenants.values())
        n_tok = sum(e["tokens"] for e in tenants.values())
        out = dict(rel_err=rel, requests=n_req,
                   terminals=snap["finished"] + snap["aborted"], tokens=n_tok,
                   generated=snap["total_generated_tokens"],
                   ok=max(rel.values()) <= 1e-6 and n_req == snap["finished"] + snap["aborted"]
                   and n_tok == snap["total_generated_tokens"])
        if not out["ok"]:
            checks.append(f"{where}: ledgers do not conserve: {out}")
        return out

    def trace_ticks_to_ledger(where: str, events: list[dict], snap: dict) -> dict:
        """The tick args' bytes (rounded to ints) summed against the
        metrics' ledgers of the graded ticks."""
        graded = [e["args"] for e in events if e.get("name") == "tick" and e.get("ph") == "X"
                  and "kv_read_bytes" in e.get("args", {})]
        kv = sum(a["kv_read_bytes"] for a in graded)
        total = snap.get("kv_read_bytes_total", 0.0)
        ok = abs(kv - total) <= len(graded) and len(graded) == snap.get("roofline_ticks", 0)
        if not ok:
            checks.append(f"{where}: the ticks' kv_read_bytes {kv} over {len(graded)} ticks, "
                          f"ledger {total} over {snap.get('roofline_ticks')}")
        return dict(graded_ticks=len(graded), ticks_kv_read_bytes=kv,
                    ledger_kv_read_bytes=total, ok=ok)

    def exported(where: str, layers_: dict) -> dict:
        """Flush and close the leg's exporter; the collector's spans
        against its stats."""
        exp = layers_["otel"]
        flushed = exp.flush(timeout=30.0)
        exp.close()
        return dict(flushed=flushed, **exp.stats())

    eng = engine(params)
    if eng.epilogue_impl != "fused":
        raise AssertionError(f"observe: epilogue {eng.epilogue_impl} for a greedy sampler")
    endpoint = f"http://127.0.0.1:{collector.server_address[1]}/v1/traces"
    tenant_of = {item["seed"]: OBSERVE_TENANTS[j % len(OBSERVE_TENANTS)]
                 for j, item in enumerate(trace)}

    from torch.profiler import ProfilerActivity, profile

    def http_observed(where: str, traced: bool, direct_tokens: dict | None,
                      export: bool = True, hooks: bool = False) -> dict:
        """One HTTP leg, untraced or with every layer (``export``: the
        OTLP exporter too); each tick's host wall and thread CPU time
        (``hooks``: and each hook's time)."""
        detach(eng)
        eng.scheduler.finished.clear()
        layers_ = None
        log_path = os.path.join(out_dir, f"{where.replace(' ', '_')}.jsonl")
        if traced:
            if os.path.exists(log_path):
                os.remove(log_path)
            layers_ = attach(eng, params, endpoint=endpoint if export else None,
                             log=RequestLog(log_path))
            spans0 = got["spans"]
        probes = ("/debug/trace", "/debug/tenants", "/debug/slo") if traced else ()
        summary, restore, runner = tick_timer(np, eng)
        hook_summary = hook_restore = None
        if hooks:
            hook_summary, hook_restore = hook_timer(eng, runner)
        try:
            counts, res = counted(where, eng, lambda: http_leg(
                torch, np, eng, trace, model_id, cut_stream=False, probes=probes,
                body=lambda item: {"tenant": tenant_of[item["seed"]]}))
        finally:
            restore()
            if hook_restore is not None:
                hook_restore()
        results = res["results"]
        ok200 = [r for r in results if r["status"] == 200 and r["finish_reason"] == "length"
                 and len(r["token_ids"]) == HTTP_NEW]
        if len(ok200) != HTTP_REQUESTS:
            checks.append(f"{where}: {len(ok200)} of {HTTP_REQUESTS} answered 200 with "
                          f"{HTTP_NEW} tokens: {[r['status'] for r in results]}")
        tokens = {item["seed"]: r["token_ids"] for item, r in zip(trace, results)}
        ttft = [r["ttft_s"] for r in ok200 if r["ttft_s"] is not None]
        tpot = [(r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1) for r in ok200
                if r["ttft_s"] is not None and len(r["token_ids"]) > 1]
        generated = sum(len(r["token_ids"]) for r in results)
        snap = res["snap"]
        out = dict(leg=where, traced=traced, export=traced and export, **counts,
                   wall_s=res["wall"], generated_tokens=generated,
                   tok_s=generated / res["wall"], ticks=snap["ticks"],
                   ttft_s_p50=_pct(np, ttft, 50), ttft_s_p99=_pct(np, ttft, 99),
                   tpot_s_p50=_pct(np, tpot, 50), tick_host=summary())
        if hook_summary is not None:
            out["hooks"] = hook_summary(counts["dispatches"])
        if direct_tokens is not None:
            gaps = []
            for item in trace:
                gap = first_divergence(torch, forward, params, cfg, item["prompt"],
                                       tokens[item["seed"]], direct_tokens[item["seed"]])
                if gap is not None:
                    gaps.append(gap)
            out["parity_vs_untraced"] = dict(identical=HTTP_REQUESTS - len(gaps),
                                             divergence_top2_gaps=gaps, tol=TEACHER_TOL,
                                             ok=all(g <= TEACHER_TOL for g in gaps))
            if not out["parity_vs_untraced"]["ok"]:
                checks.append(f"{where} parts from the untraced leg away from a near-tie: "
                              f"{out['parity_vs_untraced']}")
            tf = teacher_forced_requests(
                torch, forward, params, cfg,
                [SimpleNamespace(prompt=item["prompt"], generated=tokens[item["seed"]])
                 for item in trace if tokens[item["seed"]]], TEACHER_TOL)
            out["teacher_forced"] = tf
            if not tf["ok"] or tf["requests"] != HTTP_REQUESTS:
                checks.append(f"{where} teacher-forced: {tf}")
        if traced:
            eng.request_log.close()
            records = read_request_log(log_path)
            events = layers_["tracer"].events()
            tk = tick_checks(events, MIXED_TICK_PHASES, layers_["telemetry"].hbm_gbps,
                             layers_["telemetry"].peak_tflops)
            if tk["n_problems"] or tk["graded"] != counts["dispatches"]:
                checks.append(f"{where} ticks: {tk}, {counts['dispatches']} dispatches")
            st_trace, raw_trace = res["probed"]["/debug/trace"]
            dump = os.path.join(out_dir, f"{where.replace(' ', '_')}_trace.json")
            with open(dump, "wb") as f:
                f.write(raw_trace)
            summ = subprocess.run(
                [sys.executable, os.path.join(root, "tools", "summarize_trace.py"), dump,
                 "--top", "3"],
                capture_output=True, text=True, timeout=120)
            st_ten, raw_ten = res["probed"]["/debug/tenants"]
            st_slo, raw_slo = res["probed"]["/debug/slo"]
            tenants_view = json.loads(raw_ten)["tenants"] if st_ten == 200 else {}
            walls = [1e3 * e["args"]["device_time_s"] for e in events
                     if e.get("name") == "tick" and "device_time_s" in e.get("args", {})]
            out["dispatch_to_fetch_ms_p50"] = _pct(np, walls, 50)
            by_phase: dict[str, list[float]] = {}
            for t, ph in ((e, events[k + 1:k + 1 + len(MIXED_TICK_PHASES)])
                          for k, e in enumerate(events)
                          if e.get("name") == "tick" and e.get("ph") == "X"):
                by_phase.setdefault("tick", []).append(t["dur"])
                for p in ph:
                    by_phase.setdefault(p["name"], []).append(p["dur"])
            out.update(
                phase_us_mean={k: sum(v) / len(v) for k, v in by_phase.items()},
                tick_checks=tk,
                ticks_vs_ledger=trace_ticks_to_ledger(where, events, snap),
                conservation=ledgers_conserve(where, snap, tenants_view, records),
                debug=dict(trace=st_trace, tenants=st_ten, slo=st_slo,
                           slo_body=json.loads(raw_slo) if st_slo == 200 else None),
                summarize_trace=dict(rc=summ.returncode, head=summ.stdout[:600],
                                     stderr=summ.stderr[-400:]),
                sentinel=dict(ticks=layers_["sentinel"].ticks,
                              anomalies=dict(layers_["sentinel"].anomalies)),
                request_log_records=len(records),
                roofline=dict(util_mean=snap.get("roofline_util_mean"),
                              gbps_mean=snap.get("roofline_gbps_mean"),
                              mfu_mean=snap.get("mfu_mean"), hbm_gbps=snap.get("hbm_gbps")),
                slo=dict(attainment=snap.get("slo_attainment"),
                         goodput_tok_s=snap.get("goodput_tok_s")),
                trace_events=len(events), trace_dropped=layers_["tracer"].dropped)
            if export:
                exp = exported(where, layers_)
                exp["collector_spans_during_leg"] = got["spans"] - spans0
                out["otlp"] = exp
                if (not exp["flushed"] or exp["dropped"] or exp["export_errors"]
                        or exp["spans"] != exp["collector_spans_during_leg"]
                        or exp["spans"] == 0):
                    checks.append(f"{where} OTLP: {exp}")
            if summ.returncode != 0 or "host_sync" not in summ.stdout:
                checks.append(f"{where}: summarize_trace.py failed: {out['summarize_trace']}")
            if (st_trace, st_ten, st_slo) != (200, 200, 200):
                checks.append(f"{where} debug routes: {out['debug']}")
            if layers_["sentinel"].ticks != tk["ticks"]:
                checks.append(f"{where}: the sentinel saw {layers_['sentinel'].ticks} ticks, "
                              f"the trace has {tk['ticks']}")
            if len(records) != HTTP_REQUESTS:
                checks.append(f"{where}: {len(records)} request-log records")
        detach(eng)
        return out, tokens

    # the legs alternate, untraced, traced, traced without the exporter
    # (twice), traced, untraced: what one leg leaves behind falls on every
    # kind
    u1, u1_tokens = http_observed("observe untraced 1", False, None)
    t1, _ = http_observed("observe traced 1", True, u1_tokens)
    x1, _ = http_observed("observe traced no-export 1", True, u1_tokens, export=False)
    x2, _ = http_observed("observe traced no-export 2", True, u1_tokens, export=False)
    t2, _ = http_observed("observe traced 2", True, u1_tokens)
    u2, _ = http_observed("observe untraced 2", False, None)
    # after the alternated legs: a traced leg with every hook timed
    hk, _ = http_observed("observe traced hooks timed", True, None, hooks=True)
    http_legs = [u1, t1, x1, x2, t2, u2, hk]

    def mean(pair, get):
        vals = [get(leg) for leg in pair]
        return None if None in vals else sum(vals) / len(vals)

    cost = {}
    for key, get in (("tok_s", lambda leg: leg["tok_s"]),
                     ("ttft_s_p50", lambda leg: leg["ttft_s_p50"]),
                     ("tpot_s_p50", lambda leg: leg["tpot_s_p50"]),
                     ("tick_wall_ms_mean", lambda leg: leg["tick_host"]["wall_ms_mean"]),
                     ("tick_cpu_ms_mean", lambda leg: leg["tick_host"]["cpu_ms_mean"])):
        v = dict(untraced=mean((u1, u2), get), traced=mean((t1, t2), get),
                 traced_no_export=mean((x1, x2), get))
        for kind in ("traced", "traced_no_export"):
            v[f"{kind}_over_untraced"] = (v[kind] / v["untraced"]
                                          if v[kind] and v["untraced"] else None)
        cost[key] = v

    def direct_observed(where: str, profiled: bool, profile_checks: list[str] | None = None
                        ) -> dict:
        """The served trace's arrivals in real time straight into the
        traced engine on this thread (the profiler records the ranges of
        the thread that starts it only, and the HTTP leg's ticks run on the
        runner's): its ticks, and under torch.profiler each tick's device
        span and kernel time (its shortfalls into ``profile_checks``)."""
        detach(eng)
        eng.scheduler.finished.clear()
        lay = attach(eng, params, endpoint=None)
        prof = None
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                counts, snap = counted(where, eng, lambda: eng.replay_trace(trace, realtime=True))
        else:
            counts, snap = counted(where, eng, lambda: eng.replay_trace(trace, realtime=True))
        events = lay["tracer"].events()
        tk = tick_checks(events, MIXED_TICK_PHASES, HBM_GBPS_DEFAULT, PEAK_TFLOPS_DEFAULT)
        if tk["n_problems"] or tk["graded"] != counts["dispatches"]:
            checks.append(f"{where} ticks: {tk}, {counts['dispatches']} dispatches")
        walls = [1e3 * e["args"]["device_time_s"] for e in events
                 if e.get("name") == "tick" and "device_time_s" in e.get("args", {})]
        out = dict(leg=where, **counts, generated_tokens=snap["total_generated_tokens"],
                   tok_s=snap["throughput_tok_s"], dispatch_to_fetch_ms_p50=_pct(np, walls, 50),
                   roofline_util_median=tk["roofline_util_median"])
        if prof is not None:
            out["profile"] = device_per_tick(np, prof, events, profile_checks)
        detach(eng)
        eng.scheduler.finished.clear()
        return out

    # -- the profiler over the served composition: serve.mixed_dispatch
    # ranges, and the dispatch → fetch wall against the graph's device
    # time, beside the same arrivals without the profiler and the HTTP
    # traced legs' wall
    direct = direct_observed("observe direct traced", False)
    # the profiler now and then loses a whole launch's kernel records: a
    # leg that lost some, and nothing else, is taken again, up to
    # PROFILE_ATTEMPTS times; a tick that really has no device work has
    # none every time
    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        lost: list[str] = []
        direct_prof = direct_observed("observe direct traced profiled", True, lost)
        pr = direct_prof["profile"]
        attempts.append({k: pr[k] for k in ("ticks", "ticks_with_device_work", "graph_launches",
                                             "launches_without_records", "device_records",
                                             "displaced_ticks", "displaced_ms_max")})
        only_lost = (pr["graph_launches"] == pr["mixed_dispatch_ranges"] == pr["ticks"]
                     and pr["ticks_with_device_work"] + pr["launches_without_records"]
                     == pr["ticks"])
        if not lost or not only_lost:
            break
    checks.extend(lost)
    direct_prof["profile"]["attempts"] = attempts
    profiled = dict(direct_prof["profile"], unprofiled_direct=direct,
                    profiled_direct={k: v for k, v in direct_prof.items() if k != "profile"},
                    http_traced_dispatch_to_fetch_ms_p50=[
                        t1["dispatch_to_fetch_ms_p50"], t2["dispatch_to_fetch_ms_p50"]])

    # -- the tenant leg: one tenant bursts past its in-flight cap
    burst = [dict(item, arrival_s=0.0, max_new_tokens=OBSERVE_SHORT_TOKENS)
             for item in trace[:OBSERVE_BURST]]
    ten_ledger = TenantLedger(max_inflight=OBSERVE_CAP, policy=policy)
    ten_layers = attach(eng, params, endpoint=None, ledger=ten_ledger)
    ten_of = {item["seed"]: ("burst" if j < OBSERVE_BURST - 2 else OBSERVE_TENANTS[j % 3])
              for j, item in enumerate(burst)}
    counts, res = counted("observe tenant leg", eng, lambda: http_leg(
        torch, np, eng, burst, model_id, cut_stream=False, probes=("/debug/tenants",),
        body=lambda item: {"tenant": ten_of[item["seed"]]}))
    statuses = [r["status"] for r in res["results"]]
    st_ten, raw_ten = res["probed"]["/debug/tenants"]
    view = json.loads(raw_ten)["tenants"] if st_ten == 200 else {}
    _, samples = scrape_counters(res["prom"])
    tenant_leg = dict(
        cap=OBSERVE_CAP, requests=len(burst), status_429=statuses.count(429),
        status_200=statuses.count(200), throttled=view.get("burst", {}).get("throttled"),
        rejected=res["snap"]["rejected"], debug_tenants=st_ten,
        tenant_series="llm_serve_tenant_throttled_total" in res["prom"],
        conservation=ledgers_conserve("observe tenant leg", res["snap"], view), **counts)
    if (tenant_leg["status_429"] == 0 or tenant_leg["throttled"] != tenant_leg["status_429"]
            or tenant_leg["rejected"] != tenant_leg["status_429"]
            or not tenant_leg["tenant_series"]
            or tenant_leg["status_200"] + tenant_leg["status_429"] != len(burst)):
        checks.append(f"observe tenant leg: {tenant_leg}")
    detach(eng)
    eng.scheduler.finished.clear()

    # -- OTLP against a closed loopback port: errors and drops counted,
    # no tick stalls
    down = attach(eng, params, endpoint=f"http://127.0.0.1:{closed_port()}/v1/traces")
    counts, _ = counted("observe otlp down", eng, lambda: eng.replay_trace(short))
    down_ticks = [e["dur"] for e in down["tracer"].events() if e.get("name") == "tick"
                  and e.get("ph") == "X"]
    exp = down["otel"]
    exp.flush(timeout=30.0)
    exp.close()
    otlp_down = dict(**exp.stats(), offered=len(down["tracer"]),
                     tick_us_max=max(down_ticks, default=None), ticks=len(down_ticks), **counts)
    if (otlp_down["export_errors"] == 0 or otlp_down["spans"] != 0
            or otlp_down["dropped"] == 0 or otlp_down["tick_us_max"] is None
            or otlp_down["tick_us_max"] > 100_000):
        checks.append(f"observe otlp down: {otlp_down}")
    detach(eng)
    eng.scheduler.finished.clear()
    del eng
    torch.cuda.empty_cache()

    def direct_pair(where: str, eng, leg_params, *, phases, sampled: bool = False) -> dict:
        """``short`` submitted at once, untraced then traced (one
        composition, so the tokens must be identical), with the traced
        run's per-request attribution against the ledgers."""
        runs = {}
        for traced in (False, True):
            detach(eng)
            eng.scheduler.finished.clear()
            lay = attach(eng, leg_params, endpoint=None) if traced else None
            counts, _ = counted(f"{where} {'traced' if traced else 'untraced'}", eng,
                                lambda: eng.replay_trace(short), sampled=sampled)
            reqs = sorted(eng.scheduler.finished, key=lambda r: r.seed)
            runs[traced] = dict(counts=counts, tokens=[list(r.generated) for r in reqs],
                                reqs=reqs, layers=lay, snap=eng.metrics.snapshot())
        tr = runs[True]
        events = tr["layers"]["tracer"].events()
        tk = tick_checks(events, phases, HBM_GBPS_DEFAULT, PEAK_TFLOPS_DEFAULT)
        snap = tr["snap"]
        rel = {}
        for rk, mk in (("kv_bytes_read", "kv_read_bytes_total"),
                       ("kv_bytes_written", "kv_write_bytes_total"),
                       ("weight_bytes_amortized", "weight_bytes_total"),
                       ("device_time_s", "device_time_s_total")):
            total = snap.get(mk, 0.0)
            rel[rk] = abs(sum(getattr(r, rk) for r in tr["reqs"]) - total) / max(total, 1e-30)
        identical = sum(a == b for a, b in zip(runs[False]["tokens"], tr["tokens"]))
        out = dict(leg=where, identical=identical, requests=len(short),
                   untraced=runs[False]["counts"], traced=tr["counts"], tick_checks=tk,
                   attribution_rel_err=rel,
                   prefill_chunk_spans=sum(1 for e in events if e.get("name") == "prefill_chunk"),
                   roofline_ticks=snap.get("roofline_ticks"),
                   tenants=ledgers_conserve(where, snap, tr["layers"]["tenants"].snapshot()[
                       "tenants"]))
        if (identical != len(short) or tk["n_problems"] or max(rel.values()) > 1e-6
                or runs[False]["counts"]["graphs"]["captures"]
                or tr["counts"]["graphs"]["captures"]):
            checks.append(f"{where}: {out}")
        detach(eng)
        eng.scheduler.finished.clear()
        return out

    # -- the phase-split leg (paged decode): TICK_PHASES and the eager
    # prefill chunks' prefill_cost records
    split_eng = engine(params, mixed_step="off", decode_attn_impl="paged")
    split = direct_pair("observe split paged", split_eng, params, phases=TICK_PHASES)
    if split["prefill_chunk_spans"] < len(short):
        checks.append(f"observe split paged: {split['prefill_chunk_spans']} prefill_chunk spans")
    del split_eng
    # -- the min-p leg: the threefry kernels under the tracer
    minp_eng = engine(params, sampler=Sampler("min_p", **SERVE_SAMPLERS["min_p"]))
    minp = direct_pair("observe min_p", minp_eng, params, phases=MIXED_TICK_PHASES,
                       sampled=True)
    del minp_eng
    torch.cuda.empty_cache()
    # -- the float32 pair: tokens identical stream for stream
    f32 = float32_params(params)
    del params
    f32_eng = engine(f32, dtype=torch.float32)
    float32 = direct_pair("observe float32", f32_eng, f32, phases=MIXED_TICK_PHASES)
    del f32_eng, f32
    collector.shutdown()
    collector.server_close()
    torch.cuda.empty_cache()
    return dict(phase="observe", model=model_id, layers=layers, weights="seeded random bf16",
                card=card, hbm_gbps=HBM_GBPS_DEFAULT, peak_tflops=PEAK_TFLOPS_DEFAULT,
                slo_policy=OBSERVE_SLO, trace=dict(requests=HTTP_REQUESTS, rate_rps=HTTP_RATE,
                                                   prompt_len=HTTP_PROMPTS, new_tokens=HTTP_NEW,
                                                   seed=HTTP_SEED),
                http_legs=http_legs, tracer_cost=cost, profile=profiled, tenant_leg=tenant_leg,
                otlp_down=otlp_down, split=split, min_p=minp, float32=float32,
                collector=dict(posts=got["posts"], spans=got["spans"],
                               scopes=sorted(got["scopes"])),
                checks=checks, ok=not checks)


# ----------------------------------------------------------------------
# phase 10: faults and recovery — the chaos injector and the supervised
# restart
# ----------------------------------------------------------------------

def chaos_phase(torch, np, kernels: dict, card: str) -> dict:
    """The JAX bench's serve_chaos_poisson: the http phase's trace over
    HTTP, a clean leg and a leg under CHAOS_SPEC with supervised
    restarts; then float32 legs (greedy, min-p) under a crash and a hang,
    whose recovered streams must equal the clean ones."""
    import gc
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import FaultInjector, ServeEngine, poisson_trace, pool_geometry
    from llm_np_cp_tpu_torch.serve.slo import TickSentinel
    from llm_np_cp_tpu_torch.serve.tracing import TraceRecorder

    model_id = "meta-llama/Llama-3.2-1B"
    cfg = PRESETS[model_id]
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    trace = poisson_trace(np.random.default_rng(HTTP_SEED), HTTP_REQUESTS, rate_rps=HTTP_RATE,
                          prompt_len_range=HTTP_PROMPTS, max_new_tokens=HTTP_NEW,
                          vocab_size=cfg.vocab_size, seed_base=HTTP_SEED)
    _, num_blocks, max_seq_len = pool_geometry(HTTP_PROMPTS[1], HTTP_NEW, HTTP_SLOTS,
                                               HTTP_BLOCK, HTTP_CHUNK)
    checks: list[str] = []
    # every engine a restart builds, and each retired engine's captured
    # steps with their replay counts at retirement
    built, retired = [], []
    real_clone, real_retire = ServeEngine.clone_fresh, ServeEngine.retire

    def clone_fresh(self):
        eng = real_clone(self)
        built.append(eng)
        return eng

    def retire(self, reason="superseded by a restart"):
        if self.retired is None:
            retired.append([(st, st.replays) for st in self.graph_steps()])
        real_retire(self, reason)

    def leg(where: str, leg_params, dtype, leg_trace, sampler, new_tokens: int,
            spec: str | None, server_kwargs: dict) -> dict:
        # what earlier engines left in reference cycles goes first, so
        # that both legs' peaks start from the same reserved memory
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        injector = FaultInjector(spec, seed=HTTP_SEED) if spec else None
        eng = ServeEngine(leg_params, cfg, sampler=sampler, max_slots=HTTP_SLOTS,
                          num_blocks=num_blocks, block_size=HTTP_BLOCK, max_seq_len=max_seq_len,
                          prefill_chunk=HTTP_CHUNK, cache_dtype=dtype, mixed_step="on",
                          fault_injector=injector, device=torch.device("cuda"))
        eng.warmup([int(t["prompt"].size) for t in leg_trace], new_tokens)
        torch.cuda.synchronize()
        # both legs run traced, with a sentinel, so that the faults are
        # all that differs between them: the restarts' marks on the trace,
        # no tick span inside a recovery, and the rebuilds' captures no
        # sentinel samples
        eng.tracer, eng.sentinel = TraceRecorder(ring=OBSERVE_RING), TickSentinel()
        tracer, sentinel = eng.tracer, eng.sentinel
        graph_pool = sum(st.pool_bytes or 0 for st in eng.graph_steps())
        pool_bytes = eng.pool.stats()["kv_bytes_total"]
        built.clear()
        retired.clear()
        reset_counts(kernels)
        d0, g0 = eng.n_dispatches, graph_totals()
        res = http_leg(torch, np, eng, leg_trace, model_id, server_kwargs=server_kwargs,
                       retries=4, cut_stream=False)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_reserved()
        launches, graphs_run = read_counts(kernels), graph_delta(g0)
        sup = res["sup"]
        dispatches = eng.n_dispatches - d0 + sum(e.n_dispatches for e in built)
        rebuild_captures = sum(r["captures"] for r in sup["rebuilds"])
        if graphs_run != dict(captures=rebuild_captures, replays=dispatches,
                              eager=rebuild_captures):
            checks.append(f"{where}: {dispatches} ticks and {rebuild_captures} rebuild captures, "
                          f"graphs ran {graphs_run}")
        want_ragged = layers * (dispatches + rebuild_captures)
        if launches["ragged_paged_attention"] != want_ragged:
            checks.append(f"{where}: {launches['ragged_paged_attention']} ragged launches, "
                          f"{want_ragged} implied")
        late = [(st.name, n, st.replays) for steps in retired for st, n in steps
                if st.replays != n or not st.retired]
        if late or len(retired) != sup["restarts"]:
            checks.append(f"{where}: {len(retired)} engines retired for {sup['restarts']} "
                          f"restarts; steps replayed after retirement: {late}")
        results = res["results"]
        ok = [r for r in results if r["status"] == 200 and r["finish_reason"] == "length"
              and len(r["token_ids"]) == new_tokens]
        if len(ok) != len(leg_trace):
            checks.append(f"{where}: {len(ok)} of {len(leg_trace)} answered with {new_tokens} "
                          f"tokens: {[(r['status'], r['finish_reason']) for r in results]}")
        bad_lines, samples = scrape_counters(res["prom"])
        scrape = {k: samples.get(f"llm_serve_{k}") for k in (
            "restarts_total", "faults_injected_total", "requests_recovered_total",
            "recovery_latency_s_last", "requests_submitted_total", "requests_finished_total")}
        if bad_lines or scrape["restarts_total"] != sup["restarts"]:
            checks.append(f"{where} scrape: {scrape}, bad lines {bad_lines[:3]}")
        ttft = [r["ttft_s"] for r in ok if r["ttft_s"] is not None]
        tpot = [(r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1) for r in ok
                if r["ttft_s"] is not None and len(r["token_ids"]) > 1]
        generated = sum(len(r["token_ids"]) for r in results)
        traced = None
        if tracer is not None:
            events = tracer.events()
            deaths = [e for e in events if e.get("name") == "engine-death"]
            restarts = [e for e in events if e.get("name") == "restart" and e.get("ph") == "X"]
            ticks = [e for e in events if e.get("name") == "tick" and e.get("ph") == "X"]
            # no tick span starts between a death and the end of its
            # rebuild and replay (the captures, a zombie)
            inside = [t["ts"] for d, r in zip(deaths, restarts) for t in ticks
                      if d["ts"] <= t["ts"] <= r["ts"] + r["dur"]]
            traced = dict(engine_deaths=len(deaths), restart_spans=len(restarts),
                          tick_spans=len(ticks), sentinel_ticks=sentinel.ticks,
                          ticks_inside_recovery=len(inside), dropped=tracer.dropped,
                          anomalies=dict(sentinel.anomalies))
            if (len(deaths) != sup["restarts"] or len(restarts) != sup["restarts"] or inside
                    or sentinel.ticks != len(ticks) or tracer.dropped):
                checks.append(f"{where} trace: {traced}")
        out = dict(leg=where, spec=spec, traced=traced, dtype=str(dtype).replace("torch.", ""),
                   sampler=sampler.kind, answered=len(ok), restarts=sup["restarts"],
                   recovery_latency_s=sup["recovery_latency_s"], rebuilds=sup["rebuilds"],
                   injected=injector.snapshot() if injector else None, dispatches=dispatches,
                   graphs=graphs_run, launches=launches, scrape=scrape,
                   client_retries=sum(r.get("retries", 0) for r in results),
                   peak_reserved_bytes=peak, pool_bytes=pool_bytes, graph_pool_bytes=graph_pool,
                   wall_s=res["wall"], tok_s=generated / res["wall"],
                   ttft_s_p50=_pct(np, ttft, 50), ttft_s_p99=_pct(np, ttft, 99),
                   tpot_s_p50=_pct(np, tpot, 50),
                   tokens={item["seed"]: r["token_ids"] for item, r in zip(leg_trace, results)})
        del eng, res
        built.clear()
        retired.clear()
        return out

    def pair(where: str, leg_params, dtype, leg_trace, sampler, new_tokens: int, spec: str,
             server_kwargs: dict) -> tuple[dict, dict]:
        clean = leg(f"{where} clean", leg_params, dtype, leg_trace, sampler, new_tokens, None,
                    server_kwargs)
        chaos = leg(f"{where} chaos", leg_params, dtype, leg_trace, sampler, new_tokens, spec,
                    server_kwargs)
        if clean["restarts"]:
            checks.append(f"{where}: the clean leg restarted {clean['restarts']} times")
        return clean, chaos

    ServeEngine.clone_fresh, ServeEngine.retire = clone_fresh, retire
    try:
        sup_kw = dict(tick_deadline=CHAOS_DEADLINE, max_restarts=CHAOS_RESTARTS,
                      restart_backoff_s=CHAOS_BACKOFF)
        clean, chaos = pair("chaos bf16", params, torch.bfloat16, trace, Sampler("greedy"),
                            HTTP_NEW, CHAOS_SPEC, sup_kw)
        if chaos["restarts"] < 2:
            checks.append(f"chaos bf16: {chaos['restarts']} restarts, 2 expected")
        growth = chaos["peak_reserved_bytes"] - clean["peak_reserved_bytes"]
        allowed = clean["pool_bytes"] + clean["graph_pool_bytes"]
        memory = dict(clean_peak=clean["peak_reserved_bytes"],
                      chaos_peak=chaos["peak_reserved_bytes"], growth=growth,
                      pool_plus_graph_pools=allowed, ok=growth <= allowed)
        if not memory["ok"]:
            checks.append(f"chaos bf16 peak reserved memory: {memory}")
        gaps = []
        for item in trace:
            gap = first_divergence(torch, forward, params, cfg, item["prompt"],
                                   chaos["tokens"][item["seed"]], clean["tokens"][item["seed"]])
            if gap is not None:
                gaps.append(gap)
        parity = dict(identical=HTTP_REQUESTS - len(gaps), divergence_top2_gaps=gaps,
                      tol=TEACHER_TOL, ok=all(g <= TEACHER_TOL for g in gaps))
        if not parity["ok"]:
            checks.append(f"chaos bf16 parts from the clean leg away from a near-tie: {parity}")
        tf = teacher_forced_requests(
            torch, forward, params, cfg,
            [SimpleNamespace(prompt=item["prompt"], generated=chaos["tokens"][item["seed"]])
             for item in trace if chaos["tokens"][item["seed"]]], TEACHER_TOL)
        if not tf["ok"] or tf["requests"] != HTTP_REQUESTS:
            checks.append(f"chaos bf16 teacher-forced: {tf}")

        f32 = float32_params(params)
        del params
        f32_trace = [dict(item, max_new_tokens=F32_CHAOS_TOKENS)
                     for item in trace[:F32_CHAOS_REQUESTS]]
        f32_kw = dict(tick_deadline=F32_CHAOS_DEADLINE, max_restarts=CHAOS_RESTARTS,
                      restart_backoff_s=CHAOS_BACKOFF)
        float32 = {}
        for name, sampler in SERVE_SAMPLERS.items():
            fc, fx = pair(f"chaos float32 {name}", f32, torch.float32, f32_trace,
                          Sampler(name, **sampler), F32_CHAOS_TOKENS, F32_CHAOS_SPEC, f32_kw)
            same = sum(fx["tokens"][k] == v for k, v in fc["tokens"].items())
            float32[name] = dict(identical=same, requests=F32_CHAOS_REQUESTS,
                                 restarts=fx["restarts"], injected=fx["injected"],
                                 traced=fx["traced"],
                                 recovery_latency_s=fx["recovery_latency_s"],
                                 rebuilds=fx["rebuilds"],
                                 ok=same == F32_CHAOS_REQUESTS and fx["restarts"] == 2)
            if not float32[name]["ok"]:
                checks.append(f"chaos float32 {name}: {float32[name]}")
        del f32
    finally:
        ServeEngine.clone_fresh, ServeEngine.retire = real_clone, real_retire
    torch.cuda.empty_cache()
    for one in (clean, chaos):
        del one["tokens"]
    return dict(phase="chaos", model=model_id, layers=layers, weights="seeded random bf16",
                card=card,
                trace=dict(requests=HTTP_REQUESTS, rate_rps=HTTP_RATE, prompt_len=HTTP_PROMPTS,
                           new_tokens=HTTP_NEW, seed=HTTP_SEED),
                engine=dict(max_slots=HTTP_SLOTS, block_size=HTTP_BLOCK,
                            prefill_chunk=HTTP_CHUNK, num_blocks=num_blocks,
                            max_seq_len=max_seq_len, mixed_step="on", sampler="greedy"),
                supervision=dict(spec=CHAOS_SPEC, tick_deadline=CHAOS_DEADLINE,
                                 restart_backoff_s=CHAOS_BACKOFF, max_restarts=CHAOS_RESTARTS),
                legs=[clean, chaos], memory=memory, parity_vs_clean=parity, teacher_forced=tf,
                float32=dict(spec=F32_CHAOS_SPEC, tick_deadline=F32_CHAOS_DEADLINE,
                             new_tokens=F32_CHAOS_TOKENS, **float32),
                checks=checks, ok=not checks)


# ----------------------------------------------------------------------
# phase 10b: the command line (llm_np_cp_tpu_torch.cli) over a checkpoint
# directory
# ----------------------------------------------------------------------

# the cli phase: Llama-3.2-1B written as an HF checkpoint directory
# (seeded random bf16 weights, init_params(0)) under smoke_out/cli/ and
# loaded back through ``--model``; the restart phase's child servers
# serve the same directory
CLI_MODEL = "meta-llama/Llama-3.2-1B"
CLI_DIR = os.path.join(ROOT, "smoke_out", "cli")
CLI_SHARDS = 2
# the device every CLI leg and child asks for (--backend)
CLI_BACKEND = "cuda"
CLI_NEW, CLI_SEED, CLI_SPEC_NEW = 32, 7, 16
CLI_PROMPT = ("The quick brown fox jumps over the lazy dog while the five boxing wizards "
              "jump quickly; a journey of a thousand miles begins with a single step, "
              "and the early bird catches the worm before the sun rises over the hills.")
# leg d's prompts file: four uneven prompts, run in ragged batches of two
CLI_FILE_PROMPTS = (CLI_PROMPT[:40], CLI_PROMPT[:95], CLI_PROMPT, CLI_PROMPT[40:180])
CLI_BATCH = 2
# the serve child's four token-id completions (the http trace's first
# prompts): two unary, two SSE
CLI_SERVE_REQUESTS, CLI_SERVE_NEW = 4, 32


class ByteTokenizer:
    """A byte-level stand-in for the checkpoint's tokenizer (the port takes
    its tokenizer from the caller): a text's UTF-8 bytes, offset past the
    special ids, are its token ids, and ``decode`` maps each id to one
    character, so printed text gives back the ids (``ids``)."""

    eos_token_id = 128001  # Llama 3's <|end_of_text|>
    OFFSET, BASE = 3, 0x10000

    def __call__(self, text, return_tensors=None):
        import numpy as np

        return {"input_ids": np.asarray([[b + self.OFFSET for b in text.encode()]], np.int32)}

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(self.BASE + int(i)) for i in ids)

    @classmethod
    def ids(cls, text: str) -> list[int]:
        return [ord(c) - cls.BASE for c in text]


def hf_config(cfg) -> dict:
    """``cfg`` as the ``config.json`` of its HF checkpoint (Llama family:
    the keys ``ModelConfig.from_hf_dict`` reads, with llama3 RoPE scaling)."""
    d = dict(architectures=["LlamaForCausalLM"], model_type=cfg.model_type,
             vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
             intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
             num_attention_heads=cfg.num_attention_heads,
             num_key_value_heads=cfg.num_key_value_heads, head_dim=cfg.head_dim,
             max_position_embeddings=cfg.max_position_embeddings, rope_theta=cfg.rope_theta,
             rms_norm_eps=cfg.rms_norm_eps, hidden_act=cfg.hidden_act,
             tie_word_embeddings=cfg.tie_word_embeddings, attention_bias=cfg.attention_bias,
             mlp_bias=cfg.mlp_bias, torch_dtype="bfloat16",
             bos_token_id=128000, eos_token_id=ByteTokenizer.eos_token_id)
    if cfg.rope_scaling_type == "llama3":
        d["rope_scaling"] = dict(
            rope_type="llama3", factor=cfg.rope_scaling_factor,
            low_freq_factor=cfg.rope_scaling_low_freq_factor,
            high_freq_factor=cfg.rope_scaling_high_freq_factor,
            original_max_position_embeddings=cfg.rope_scaling_original_max_position)
    return d


def write_checkpoint(torch, params, cfg, out_dir: str, shards: int = CLI_SHARDS) -> dict:
    """``params`` (the port's layout) as an HF checkpoint directory:
    ``config.json``, ``shards`` safetensors files with HF key names and
    [out, in] projections, and their index.  The format is written here
    (the card's machine has no ``safetensors`` package): an 8-byte
    little-endian header length, the JSON header, the raw bytes."""
    import struct

    from llm_np_cp_tpu_torch.config import ModelConfig
    from llm_np_cp_tpu_torch.utils.loading import _key_maps

    hf = hf_config(cfg)
    if ModelConfig.from_hf_dict(hf) != cfg:
        raise AssertionError(f"config.json does not read back as the config: {hf}")
    layer_map, top_map = _key_maps(cfg)
    tensors = [(key, params[name], t) for key, (name, t) in top_map.items() if name in params]
    tensors += [(f"model.layers.{i}.{suffix}", params["layers"][name][i], t)
                for i in range(cfg.num_hidden_layers)
                for suffix, (name, t) in layer_map.items() if name in params["layers"]]
    dtypes = {torch.bfloat16: "BF16", torch.float32: "F32"}
    total = sum(x.numel() * x.element_size() for _, x, _ in tensors)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    weight_map, groups, size = {}, [[]], 0
    for item in tensors:
        if size >= total * len(groups) / shards and len(groups) < shards:
            groups.append([])
        groups[-1].append(item)
        size += item[1].numel() * item[1].element_size()
    for s, group in enumerate(groups):
        fn = f"model-{s + 1:05d}-of-{len(groups):05d}.safetensors"
        header, off = {}, 0
        for key, x, t in group:
            n = x.numel() * x.element_size()
            shape = list(x.shape[::-1] if t else x.shape)
            header[key] = dict(dtype=dtypes[x.dtype], shape=shape, data_offsets=[off, off + n])
            off += n
            weight_map[key] = fn
        raw = json.dumps(header).encode()
        raw += b" " * (-len(raw) % 8)
        with open(os.path.join(out_dir, fn), "wb") as f:
            f.write(struct.pack("<Q", len(raw)) + raw)
            for _, x, t in group:
                f.write((x.T if t else x).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(dict(metadata=dict(total_size=total), weight_map=weight_map), f)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    return dict(dir=os.path.relpath(out_dir, ROOT), shards=len(groups), tensors=len(tensors),
                bytes=total, write_s=time.perf_counter() - t0)


def cli_checkpoint(torch, cfg) -> dict:
    """The checkpoint directory of CLI_MODEL's seeded weights, written
    once a run (the cli phase writes it, the restart phase reuses it)."""
    import shutil

    from llm_np_cp_tpu_torch.models.transformer import init_params

    done = os.path.join(CLI_DIR, "written.json")
    if os.path.exists(done):
        with open(done) as f:
            return json.load(f)
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    info = write_checkpoint(torch, params, cfg, CLI_DIR)
    del params
    torch.cuda.empty_cache()
    with open(done, "w") as f:
        json.dump(info, f)
    return info


def serve_argv(model: str, port_file: str, *, port: int = 0, journal: str | None = None,
               chaos: str | None = None) -> list[str]:
    """``python -m llm_np_cp_tpu_torch.cli serve`` over ``model`` with the
    http phase's engine (8 slots, 128-slot blocks, 256-token chunks, pool
    sized for 512-token prompts and 64 new tokens, greedy)."""
    argv = [sys.executable, "-m", "llm_np_cp_tpu_torch.cli", "serve", "--model", model,
            f"--backend={CLI_BACKEND}", "--port", str(port), "--port-file", port_file,
            "--prompt-len", str(HTTP_PROMPTS[1]), "--max-tokens", str(HTTP_NEW),
            "--slots", str(HTTP_SLOTS), "--block-size", str(HTTP_BLOCK), "--sampler", "greedy",
            "--drain-timeout", "60"]
    if journal:
        argv += ["--journal", journal]
    if chaos:
        argv += ["--chaos-spec", chaos]
    return argv


def start_server(argv: list[str], port_file: str, log_path: str):
    """Start a CLI server process (its output to ``log_path``) and wait for
    its port file; → (process, port, seconds to the port file)."""
    log = open(log_path, "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
    log.close()
    while not (os.path.exists(port_file) and open(port_file).read().endswith("\n")):
        if proc.poll() is not None or time.perf_counter() - t0 > 300:
            proc.kill()
            proc.wait()
            with open(log_path) as f:
                raise RuntimeError(f"server {argv[4:]} did not start: {f.read()[-2000:]}")
        time.sleep(0.05)
    return proc, int(open(port_file).read().split()[1]), time.perf_counter() - t0


def cli_run(cli, argv: list[str], log: str) -> tuple[str, str, str, float]:
    """``cli.run(argv)`` with the byte tokenizer, its stdout and stderr
    captured (and kept in ``log``); → (returned text, stdout, stderr,
    seconds)."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        text = cli.run(argv, tokenizer=ByteTokenizer())
    wall = time.perf_counter() - t0
    with open(log, "w", encoding="utf-8") as f:
        f.write(" ".join(argv) + "\n--- stdout\n" + out.getvalue() + "--- stderr\n"
                + err.getvalue())
    return text, out.getvalue(), err.getvalue(), wall


def recorded_engines(cli) -> tuple[list, object]:
    """Wrap ``cli._build_serve_engine`` to keep every engine it builds;
    → (the list, the original to restore)."""
    built, orig = [], cli._build_serve_engine

    def build(*a, **k):
        out = orig(*a, **k)
        built.append(out[0])
        return out

    cli._build_serve_engine = build
    return built, orig


def mixed_step_runs(eng) -> dict[int, int]:
    """Per packed width, the times the unified tick's step ran (its eager
    first call and every replay: the warm-up's and the trace's)."""
    return {w: st.run.calls for w, st in eng._mixed_steps.items() if st.run.calls}


def cli_phase(torch, np, kernels: dict, card: str) -> dict:
    """The port's command line on the card, in process (``cli.run``) and as
    a ``serve`` child, over a checkpoint directory written here; every leg
    held to a direct library run on the same loaded params."""
    import gc
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch import cli
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.quant import quantize_params
    from llm_np_cp_tpu_torch.serve import ServeEngine, poisson_trace, pool_geometry
    from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get, post_completion
    from llm_np_cp_tpu_torch.speculative import SpeculativeGenerator, truncated_draft
    from llm_np_cp_tpu_torch.utils.loading import load_model
    from llm_np_cp_tpu_torch.utils.profiling import TRACE_FILE

    cfg = PRESETS[CLI_MODEL]
    layers = cfg.num_hidden_layers
    dev = torch.device("cuda")
    eos = ByteTokenizer.eos_token_id
    ckpt = cli_checkpoint(torch, cfg)
    logs = os.path.join(CLI_DIR, "logs")
    os.makedirs(logs, exist_ok=True)
    t0 = time.perf_counter()
    tok, params, loaded_cfg = load_model(CLI_DIR, device="cuda", tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    seeded = init_params(0, cfg, torch.bfloat16, device="cuda")
    same = loaded_cfg == cfg and all(
        torch.equal(params[k], seeded[k]) for k in ("embed_tokens", "final_norm")) and all(
        torch.equal(v, seeded["layers"][k]) for k, v in params["layers"].items())
    del seeded
    checks: list[str] = []
    if not same:
        checks.append("the checkpoint does not load back as the seeded weights")
    prompt = ByteTokenizer()(CLI_PROMPT)["input_ids"][0]
    base = [f"--model={CLI_DIR}", f"--backend={CLI_BACKEND}", f"--prompt={CLI_PROMPT}"]
    legs: dict[str, dict] = {}

    def rel(argv: list[str]) -> list[str]:  # the argv as recorded: paths from the checkout
        return [a.replace(CLI_DIR, os.path.relpath(CLI_DIR, ROOT)) for a in argv]

    def counted(name: str, argv: list[str]) -> tuple[str, str, str, dict, dict, float]:
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts(kernels)
        g0 = graph_totals()
        text, out, err, wall = cli_run(cli, argv, os.path.join(logs, f"{name}.log"))
        torch.cuda.synchronize()
        return text, out, err, read_counts(kernels), graph_delta(g0), wall

    def direct_counts(fn):
        reset_counts(kernels)
        out = fn()
        torch.cuda.synchronize()
        return out, read_counts(kernels)

    def leg(name: str, argv: list[str], launches: dict, want: dict, graphs_run: dict,
            wall: float, tokens_equal: bool, check: dict, must: tuple[str, ...], **extra) -> None:
        ok_launch = launches == want and all(launches[k] > 0 for k in must)
        legs[name] = dict(argv=argv, launches=launches, implied=want, graphs=graphs_run,
                          wall_s=wall, tokens_equal=tokens_equal, check=check, **extra)
        if not ok_launch:
            checks.append(f"cli leg {name}: launches {launches} != implied {want} "
                          f"(or one of {must} is 0)")
        if not tokens_equal:
            checks.append(f"cli leg {name}: tokens differ from the direct run")
        if not check["ok"]:
            checks.append(f"cli leg {name}: {check}")

    def metric(pattern: str, err: str) -> float | None:
        import re

        m = re.search(pattern, err)
        return float(m.group(1)) if m else None

    # -- a: greedy, captured decode loop, flash prefill, the decode kernel,
    # the epilogue, --metrics and the profiler trace
    prof_dir = os.path.join(CLI_DIR, "prof")
    argv = base + ["--sampler=greedy", "--no-stream", "--attn-impl=flash", "--decode-attn=pallas",
                   "--metrics", f"--jax-profile={prof_dir}", f"--max-tokens={CLI_NEW}"]
    text, _, err, launches, graphs_run, wall = counted("a", argv)
    got = ByteTokenizer.ids(text)
    gen = Generator(params, cfg, sampler=Sampler("greedy"), stop_tokens=(eos,),
                    prefill_attn_impl="flash", decode_attn_impl="flash_decode")
    want_toks = [int(t) for t in gen.generate(prompt, CLI_NEW).tokens[0]]
    del gen
    steps = CLI_NEW - 1
    want = {k: 0 for k in kernels}
    want.update(flash_attention=layers, decode_attention=layers * steps,
                decode_attention_combine=layers * steps * combines(
                    torch, cfg, 1, prompt.size + CLI_NEW),
                sample_epilogue=steps)
    with open(os.path.join(prof_dir, TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    markers = {"flash_attention": "flash_kernel", "decode_attention": "decode_kernel",
               "sample_epilogue": "epilogue_"}
    profiled = {k: sorted(n for n in names if m in n)[:3] for k, m in markers.items()}
    tf = teacher_forced(torch, forward, KVCache, params, cfg,
                        torch.as_tensor(prompt[None], device=dev),
                        torch.as_tensor([got], device=dev))
    leg("a_greedy_kernels", rel(argv[1:]), launches, want, graphs_run, wall, got == want_toks,
        tf, ("flash_attention", "decode_attention", "sample_epilogue"),
        tokens=len(got), ttft_s=metric(r"ttft ([0-9.]+)s", err),
        decode_tok_s=metric(r"([0-9.]+) tok/s decode", err),
        profile=dict(file=os.path.relpath(os.path.join(prof_dir, TRACE_FILE), ROOT),
                     kernels=profiled))
    if not all(profiled.values()):
        checks.append(f"cli leg a: the profile names no {[k for k, v in profiled.items() if not v]}")

    # -- b: the default streamed min-p run, seeded
    argv = base + [f"--seed={CLI_SEED}", f"--max-tokens={CLI_NEW}", "--metrics"]
    text, _, err, launches, graphs_run, wall = counted("b", argv)
    got = ByteTokenizer.ids(text)
    minp = Sampler("min_p")
    gen = Generator(params, cfg, sampler=minp, stop_tokens=(eos,))
    want_toks, want = direct_counts(lambda: list(gen.stream(prompt, CLI_NEW, seed=CLI_SEED)))
    del gen
    sup = sampled_support(torch, forward, params, cfg, minp,
                          [SimpleNamespace(prompt=prompt, generated=got)])
    stream_s = metric(r"tokens in ([0-9.]+)s", err)
    leg("b_min_p_stream", rel(argv[1:]), launches, want, graphs_run, wall, got == want_toks, sup,
        ("threefry2x32", "categorical"), tokens=len(got),
        ttft_s=metric(r"ttft ([0-9.]+)s", err), stream_s=stream_s,
        stream_tok_s=len(got) / stream_s if stream_s else None)

    # -- c: int8 weights, greedy, streamed: the int8-head epilogue
    argv = base + ["--quantize=int8", "--sampler=greedy", f"--max-tokens={CLI_NEW}", "--metrics"]
    text, _, err, launches, graphs_run, wall = counted("c", argv)
    got = ByteTokenizer.ids(text)
    q8 = quantize_params(params, bits=8)
    gen = Generator(q8, cfg, sampler=Sampler("greedy"), stop_tokens=(eos,))
    want_toks = list(gen.stream(prompt, CLI_NEW))
    del gen
    want = {k: 0 for k in kernels}
    want["sample_epilogue_int8"] = CLI_NEW - 1
    tf = teacher_forced(torch, forward, KVCache, q8, cfg, torch.as_tensor(prompt[None], device=dev),
                        torch.as_tensor([got], device=dev))
    del q8
    stream_s = metric(r"tokens in ([0-9.]+)s", err)
    leg("c_int8_stream", rel(argv[1:]), launches, want, graphs_run, wall, got == want_toks, tf,
        ("sample_epilogue_int8",), tokens=len(got), ttft_s=metric(r"ttft ([0-9.]+)s", err),
        stream_s=stream_s, stream_tok_s=len(got) / stream_s if stream_s else None)

    # -- d: a prompts file of four uneven prompts in ragged batches of two
    pf = os.path.join(CLI_DIR, "prompts.txt")
    with open(pf, "w") as f:
        f.write("\n".join(CLI_FILE_PROMPTS) + "\n")
    argv = [f"--model={CLI_DIR}", f"--backend={CLI_BACKEND}", f"--prompts-file={pf}",
            f"--batch-size={CLI_BATCH}", "--sampler=greedy", f"--max-tokens={CLI_NEW}", "--metrics"]
    text, _, err, launches, graphs_run, wall = counted("d", argv)
    rows = [ByteTokenizer.ids(line) for line in text.split("\n")]
    file_ids = [ByteTokenizer()(p)["input_ids"][0] for p in CLI_FILE_PROMPTS]
    gen = Generator(params, cfg, sampler=Sampler("greedy"), stop_tokens=(eos,))
    res, want = direct_counts(lambda: gen.generate_many(file_ids, CLI_NEW, batch_size=CLI_BATCH))
    del gen
    want_rows = [[int(t) for t in r.tokens[0]] for r in res]
    want_rows = [r[:r.index(eos)] if eos in r else r for r in want_rows]  # as the CLI trims
    tf = teacher_forced_requests(torch, forward, params, cfg, [
        SimpleNamespace(prompt=p, generated=r) for p, r in zip(file_ids, rows)], TEACHER_TOL)
    leg("d_prompts_file", rel(argv[1:]), launches, want, graphs_run, wall, rows == want_rows, tf,
        ("sample_epilogue",), prompt_lens=[int(p.size) for p in file_ids],
        ttft_s=metric(r"ttft ([0-9.]+)s", err),
        decode_tok_s_per_row=metric(r"([0-9.]+) tok/s/row decode", err))

    # -- e: speculative decoding, a 4-layer draft, min-p (the default)
    argv = base + ["--speculative=4", "--draft=trunc4", f"--max-tokens={CLI_SPEC_NEW}", "--metrics"]
    text, _, err, launches, graphs_run, wall = counted("e", argv)
    got = ByteTokenizer.ids(text)
    dp, dc = truncated_draft(params, cfg, 4)
    spec = SpeculativeGenerator(params, cfg, draft_params=dp, draft_config=dc, gamma=4,
                                sampler=minp)
    res, want = direct_counts(lambda: spec.generate(prompt, CLI_SPEC_NEW, stop_tokens=(eos,)))
    del spec, dp
    sup = sampled_support(torch, forward, params, cfg, minp,
                          [SimpleNamespace(prompt=prompt, generated=got)])
    leg("e_speculative_trunc4", rel(argv[1:]), launches, want, graphs_run, wall,
        got == [int(t) for t in res.tokens], sup, (), tokens=len(got),
        acceptance=metric(r"accept ([0-9.]+)", err),
        tokens_per_round=metric(r"([0-9.]+) tok/round", err),
        decode_tok_s=metric(r"([0-9.]+) tok/s, accept", err))

    # -- f, g: serve-bench, the unified tick and the phase split with the
    # paged decode; the engine the CLI built is read after its run
    sb = cli.build_serve_parser(CLI_MODEL).parse_args([])
    for name, extra in (("f_serve_bench", []),
                        ("g_serve_bench_split_paged", ["--mixed-step=off", "--attn-impl=paged"])):
        argv = ["serve-bench", f"--model={CLI_DIR}", f"--backend={CLI_BACKEND}", "--requests=32",
                "--rate=16", "--json", *extra]
        built, orig = recorded_engines(cli)
        try:
            _, out, _, launches, graphs_run, wall = counted(name[0], argv)
        finally:
            cli._build_serve_engine = orig
        eng = built[0]
        snap = json.loads(out.strip().rsplit("\n", 1)[-1])
        trace = poisson_trace(np.random.default_rng(sb.seed), 32, rate_rps=16.0,
                              prompt_len_range=(sb.prompt_len // 4, sb.prompt_len),
                              max_new_tokens=sb.max_tokens, vocab_size=cfg.vocab_size,
                              seed_base=sb.seed)
        want = {k: 0 for k in kernels}
        if eng.mixed:
            runs = mixed_step_runs(eng)
            want.update(ragged_paged_attention=layers * sum(runs.values()),
                        ragged_paged_attention_combine=ragged_combines(torch, da, eng, cfg, {},
                                                                       runs),
                        sample_epilogue=sum(runs.values()))
            must = ("ragged_paged_attention", "sample_epilogue")
        else:
            kh = cfg.num_key_value_heads
            nsplit = da.split_plan(eng.scheduler.max_slots, kh,
                                   eng.max_blocks_per_seq * eng.block_size, cfg.head_dim,
                                   da.sm_count(dev), cfg.num_attention_heads // kh)
            n = eng.n_decode_dispatches
            want.update(paged_decode_attention=layers * n,
                        paged_decode_attention_combine=layers * n * int(nsplit > 1),
                        sample_epilogue=n)
            must = ("paged_decode_attention",)
        got = {r.seed: list(r.generated) for r in eng.scheduler.finished}
        _, num_blocks, max_seq_len = pool_geometry(sb.prompt_len, sb.max_tokens, sb.slots,
                                                   sb.block_size, min(sb.block_size * 2, 256))
        direct = ServeEngine(params, cfg, sampler=Sampler("greedy"), max_slots=sb.slots,
                             num_blocks=num_blocks, block_size=sb.block_size,
                             max_seq_len=max_seq_len, prefill_chunk=min(sb.block_size * 2, 256),
                             decode_attn_impl=eng.decode_attn_impl,
                             mixed_step="on" if eng.mixed else "off")
        direct.replay_trace(trace)
        ref = {r.seed: list(r.generated) for r in direct.scheduler.finished}
        del direct
        gaps = [g for item in trace for g in [first_divergence(
            torch, forward, params, cfg, item["prompt"], got.get(item["seed"], []),
            ref[item["seed"]])] if g is not None]
        tf = teacher_forced_requests(torch, forward, params, cfg, eng.scheduler.finished,
                                     TEACHER_TOL)
        tf["ok"] = tf["ok"] and snap["finished"] == 32
        # greedy tokens equal, or first apart at a near-tie: the replay's
        # virtual clock follows the wall clock, so the two runs' schedules
        # (and with them which kernel tile computes a row) may differ
        leg(name, rel(argv[1:]), launches, want, graphs_run, wall,
            all(g <= TEACHER_TOL for g in gaps), tf, must,
            identical=32 - len(gaps), divergence_top2_gaps=gaps,
            finished=snap["finished"], tick=("mixed" if eng.mixed else "split"),
            attn=eng.decode_attn_impl, dispatches=eng.n_dispatches,
            decode_dispatches=eng.n_decode_dispatches,
            throughput_tok_s=snap["throughput_tok_s"], ttft_s_p50=snap.get("ttft_s_p50"),
            ttft_s_p99=snap.get("ttft_s_p99"), tpot_s_p50=snap.get("tpot_s_p50"))
        del eng, built
    gc.collect()
    torch.cuda.empty_cache()

    # -- the serve subcommand as a child process: token-id completions,
    # /healthz, SIGTERM drain
    import asyncio
    import signal

    http_trace = poisson_trace(np.random.default_rng(HTTP_SEED), HTTP_REQUESTS,
                               rate_rps=HTTP_RATE, prompt_len_range=HTTP_PROMPTS,
                               max_new_tokens=HTTP_NEW, vocab_size=cfg.vocab_size,
                               seed_base=HTTP_SEED)[:CLI_SERVE_REQUESTS]
    pfile = os.path.join(CLI_DIR, "serve.port")
    if os.path.exists(pfile):
        os.remove(pfile)
    journal = os.path.join(CLI_DIR, "serve.journal")
    if os.path.exists(journal):
        os.remove(journal)
    proc, port, startup = start_server(serve_argv(CLI_DIR, pfile, journal=journal), pfile,
                                       os.path.join(logs, "serve.log"))
    try:
        status, raw = http_get("127.0.0.1", port, "/healthz")
        health = json.loads(raw)
        served, client_s = [], []
        for i, item in enumerate(http_trace):
            body = {"model": CLI_DIR, "prompt": [int(t) for t in item["prompt"]],
                    "max_tokens": CLI_SERVE_NEW}
            t0 = time.perf_counter()
            if i % 2 == 0:
                st, obj = post_completion("127.0.0.1", port, body, timeout=300.0)
                served.append((st, obj["choices"][0]["token_ids"] if st == 200 else []))
            else:
                r = asyncio.run(astream_completion("127.0.0.1", port, body, timeout=300.0))
                served.append((r["status"], r["token_ids"]))
            client_s.append(time.perf_counter() - t0)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
    _, num_blocks, max_seq_len = pool_geometry(HTTP_PROMPTS[1], HTTP_NEW, HTTP_SLOTS, HTTP_BLOCK,
                                               HTTP_CHUNK)
    ref_eng = ServeEngine(params, cfg, sampler=Sampler("greedy"), max_slots=HTTP_SLOTS,
                          num_blocks=num_blocks, block_size=HTTP_BLOCK, max_seq_len=max_seq_len,
                          prefill_chunk=HTTP_CHUNK, mixed_step="on")
    ref = []
    for item in http_trace:
        req = ref_eng.submit(item["prompt"], CLI_SERVE_NEW)
        ref_eng.run_until_complete()
        ref.append(list(req.generated))
    del ref_eng
    with open(os.path.join(logs, "serve.log")) as f:
        serve_log = f.read()
    serve = dict(argv=serve_argv("DIR", "PORT_FILE", journal="JOURNAL")[3:],
                 startup_s=startup, healthz=dict(status=status, body=health),
                 statuses=[s for s, _ in served], tokens_equal=[t == r for (_, t), r in
                                                                zip(served, ref)],
                 client_s=client_s, exit_code=code,
                 drained="[serve] drained, bye" in serve_log,
                 unary=CLI_SERVE_REQUESTS // 2, sse=CLI_SERVE_REQUESTS - CLI_SERVE_REQUESTS // 2)
    tf = teacher_forced_requests(torch, forward, params, cfg, [
        SimpleNamespace(prompt=item["prompt"], generated=t)
        for item, (_, t) in zip(http_trace, served) if t], TEACHER_TOL)
    serve["teacher_forced"] = tf
    if (status != 200 or health.get("status") != "ok" or any(s != 200 for s, _ in served)
            or not all(serve["tokens_equal"]) or code != 0 or not serve["drained"]
            or not tf["ok"] or tf["requests"] != CLI_SERVE_REQUESTS):
        checks.append(f"cli serve child: {serve}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- a multi-rank --mesh on --backend cuda wants a card a rank (NCCL):
    # on one card it refuses with JAX's make_mesh message, spawning nothing
    want_refusal = f"plan needs 2 devices, have {torch.cuda.device_count()}"
    try:
        cli_run(cli, base + ["--mesh=1,1,2", "--sampler=greedy", "--max-tokens=2"],
                os.path.join(logs, "mesh.log"))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    mesh_refusal = dict(argv=rel(base + ["--mesh=1,1,2"]), raised=refusal, want=want_refusal)
    if torch.cuda.device_count() < 2 and refusal != want_refusal:
        checks.append(f"cli --mesh on one card: {mesh_refusal}")
    summary = {}
    for name in kernels:
        summary[name] = sum(v["launches"].get(name, 0) for v in legs.values())
    return dict(phase="cli", model=CLI_MODEL, layers=layers, weights="seeded random bf16",
                card=card, checkpoint=dict(ckpt, load_s=load_s, loads_as_seeded=same),
                legs=legs, serve=serve, mesh_refusal=mesh_refusal, launches=summary,
                checks=checks, ok=not checks)


def restart_phase(torch, np, card: str) -> dict:
    """The JAX bench's serve_restart_poisson: the http phase's trace
    against ``python -m llm_np_cp_tpu_torch.cli serve`` in a child process
    over the cli phase's checkpoint directory — a plain leg, a journaled
    leg, and a leg whose child SIGKILLs itself at its RESTART_KILL_TICK-th
    busy tick (``--chaos-spec proc_kill@N``), restarted on the same port
    and ``--journal`` while every client resumes its stream by
    Last-Event-ID."""
    import asyncio
    import shutil
    import signal
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.serve import poisson_trace
    from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
    from llm_np_cp_tpu_torch.utils.loading import load_model

    cfg = PRESETS[CLI_MODEL]
    cli_checkpoint(torch, cfg)
    # the server's model id is its --model: the checkpoint directory
    model_id = CLI_DIR
    _, params, _ = load_model(CLI_DIR, device="cuda")
    trace = poisson_trace(np.random.default_rng(HTTP_SEED), HTTP_REQUESTS, rate_rps=HTTP_RATE,
                          prompt_len_range=HTTP_PROMPTS, max_new_tokens=HTTP_NEW,
                          vocab_size=cfg.vocab_size, seed_base=HTTP_SEED)
    # the journals and the children's logs, under the checkout's
    # smoke_out/ (gitignored), made anew: a stale journal would replay
    tmp = os.path.join(ROOT, "smoke_out", "restart")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    checks: list[str] = []
    children: list = []
    exit_codes: dict[str, int] = {}

    def spawn(tag: str, port: int = 0, journal: str | None = None,
              chaos: str | None = None) -> tuple:
        """Start a child server; → (process, port, seconds to its port file)."""
        pf = os.path.join(tmp, f"port_{tag}")
        out = start_server(serve_argv(CLI_DIR, pf, port=port, journal=journal, chaos=chaos), pf,
                           os.path.join(tmp, f"log_{tag}"))
        children.append(out[0])
        return out

    def stop(tag: str, proc) -> None:
        proc.send_signal(signal.SIGTERM)
        exit_codes[tag] = proc.wait(timeout=120)

    def scrape(port: int) -> dict:
        _, raw = http_get("127.0.0.1", port, "/metrics")
        return scrape_counters(raw.decode())[1]

    async def clients(port: int, retries: int) -> tuple[list, float]:
        async def one(item):
            await asyncio.sleep(item["arrival_s"])
            return await astream_completion(
                "127.0.0.1", port,
                {"model": model_id, "prompt": [int(t) for t in item["prompt"]],
                 "max_tokens": item["max_new_tokens"], "seed": item["seed"]},
                timeout=300.0, retries=retries, backoff_s=0.25, max_backoff_s=1.0)

        t0 = time.perf_counter()
        results = await asyncio.gather(*(one(item) for item in trace))
        return results, time.perf_counter() - t0

    def served(tag: str, journal: str | None) -> dict:
        proc, port, startup = spawn(tag, journal=journal)
        results, wall = asyncio.run(clients(port, retries=0))
        samples = scrape(port)
        stop(tag, proc)
        generated = sum(len(r["token_ids"]) for r in results)
        return dict(leg=tag, startup_s=startup, wall_s=wall, tok_s=generated / wall,
                    answered=sum(r["status"] == 200 and len(r["token_ids"]) == HTTP_NEW
                                 for r in results),
                    journal_fsync_p99_s=samples.get("llm_serve_journal_fsync_p99_s"),
                    journal_records=samples.get("llm_serve_journal_records_total"),
                    tokens={item["seed"]: r["token_ids"] for item, r in zip(trace, results)})

    try:
        plain = served("plain", None)
        journaled = served("journaled", os.path.join(tmp, "journal_journaled"))
        jpath = os.path.join(tmp, "journal_kill")
        first, port, startup = spawn("kill", journal=jpath, chaos=f"proc_kill@{RESTART_KILL_TICK}")
        restarted = {}

        async def kill_leg():
            loop = asyncio.get_running_loop()
            streams = asyncio.ensure_future(clients(port, retries=200))
            code = await loop.run_in_executor(None, first.wait)
            restarted["killed_at"] = time.perf_counter()
            restarted["exit_code"] = code
            proc, _, secs = await loop.run_in_executor(
                None, lambda: spawn("restarted", port=port, journal=jpath))
            restarted.update(proc=proc, startup_s=secs)
            return await streams

        results, wall = asyncio.run(kill_leg())
        samples = scrape(port)
        stop("restarted", restarted["proc"])
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    resume = [r["resume_latency_s"] for r in results if r.get("resume_latency_s") is not None]
    complete = [r for r in results if r["status"] == 200 and r["finish_reason"] == "length"
                and len(r["token_ids"]) == HTTP_NEW]
    kill = dict(exit_code=restarted["exit_code"], startup_s=startup,
                restart_startup_s=restarted["startup_s"], wall_s=wall, complete=len(complete),
                resumed_streams=sum(r["resumed"] > 0 for r in results),
                resend_retries=sum(r["retries"] - r["resumed"] for r in results),
                restart_to_first_resumed_token_s=dict(
                    p50=_pct(np, resume, 50), max=max(resume) if resume else None,
                    min=min(resume) if resume else None),
                journal_replayed_total=samples.get("llm_serve_journal_replayed_total"),
                journal_resumed_total=samples.get("llm_serve_journal_resumed_total"),
                journal_epoch=samples.get("llm_serve_journal_epoch"))
    if kill["exit_code"] != -signal.SIGKILL or len(complete) != HTTP_REQUESTS:
        checks.append(f"restart: exit {kill['exit_code']}, {len(complete)} of {HTTP_REQUESTS} "
                      f"streams complete: {[(r['status'], r['finish_reason'], len(r['token_ids'])) for r in results]}")
    if not kill["resumed_streams"] or not kill["journal_replayed_total"]:
        checks.append(f"restart: nothing resumed through the journal: {kill}")
    for leg in (plain, journaled):
        if leg["answered"] != HTTP_REQUESTS:
            checks.append(f"restart {leg['leg']}: {leg['answered']} of {HTTP_REQUESTS} answered")
    gaps = []
    for item, r in zip(trace, results):
        gap = first_divergence(torch, forward, params, cfg, item["prompt"], r["token_ids"],
                               plain["tokens"][item["seed"]])
        if gap is not None:
            gaps.append(gap)
    parity = dict(identical=HTTP_REQUESTS - len(gaps), divergence_top2_gaps=gaps,
                  tol=TEACHER_TOL, ok=all(g <= TEACHER_TOL for g in gaps))
    if not parity["ok"]:
        checks.append(f"restart: streams part from the plain leg away from a near-tie: {parity}")
    tf = teacher_forced_requests(
        torch, forward, params, cfg,
        [SimpleNamespace(prompt=item["prompt"], generated=r["token_ids"])
         for item, r in zip(trace, results) if r["token_ids"]], TEACHER_TOL)
    if not tf["ok"] or tf["requests"] != HTTP_REQUESTS:
        checks.append(f"restart teacher-forced: {tf}")
    for leg in (plain, journaled):
        del leg["tokens"]
    del params
    torch.cuda.empty_cache()
    return dict(phase="restart", model=CLI_MODEL, weights="seeded random bf16", card=card,
                server=serve_argv("smoke_out/cli", "PORT_FILE", journal="JOURNAL",
                                  chaos=f"proc_kill@{RESTART_KILL_TICK}")[2:],
                sigterm_exit_codes=exit_codes,
                trace=dict(requests=HTTP_REQUESTS, rate_rps=HTTP_RATE, prompt_len=HTTP_PROMPTS,
                           new_tokens=HTTP_NEW, seed=HTTP_SEED),
                kill_tick=RESTART_KILL_TICK, legs=dict(plain=plain, journaled=journaled),
                journaled_over_plain_tok_s=journaled["tok_s"] / plain["tok_s"], kill=kill,
                parity_vs_plain=parity, teacher_forced=tf, checks=checks, ok=not checks)


# ----------------------------------------------------------------------
# phase 12: the fleet — replicas, rolling upgrades, elastic scale and
# auto-actions over the captured unified tick
# ----------------------------------------------------------------------

# the JAX bench's serve_rolling_upgrade (bench.py:305-308, run at
# bench.py:2584-2735): llama1b, 3 replicas, 32 requests at 16 req/s,
# prompts 128-512 tokens (poisson_trace seeded 29), 64 new tokens, 8
# slots, 128-slot blocks, 256-token chunks, a full roll onto the same
# weights as version 1 after tick 8; its float32 pair on the first 8
# requests with 16 new tokens, rolled after tick 3
ROLL_REPLICAS, ROLL_REQUESTS, ROLL_RATE, ROLL_PROMPT, ROLL_NEW, ROLL_SEED, ROLL_AFTER = (
    3, 32, 16.0, 512, 64, 29, 8)
F32_ROLL_REQUESTS, F32_ROLL_NEW, F32_ROLL_AFTER = 8, 16, 3
# the HTTP fleet on the http phase's trace: 2 replicas; POST /admin/upgrade
# this long after the first arrival (onto a second seeded weight set made
# with numpy), POST /admin/scale to 3 and back to 1 at these offsets
FLEET_REPLICAS, FLEET_UPGRADE_AT_S, FLEET_SCALE_AT_S = 2, 0.6, (0.4, 1.2)
# the fleet phase's depth: Llama-3.2-1B's widths at 8 of its 16 layers,
# cut to make room for the train phase (at 16 layers it was the script's
# costliest phase, 138 s on an H100); the fleet's checks are about ticks,
# captures and routing, which depth does not change
FLEET_LAYERS = 8
# the crash legs: float32, the trace's first 12 requests with 16 new
# tokens, replica 0 crashing at its 6th busy tick and restarted once
FLEET_CRASH_SPEC, F32_FLEET_REQUESTS, F32_FLEET_NEW = "tick_crash@6", 12, 16
# shed load: an SLO no request meets (every terminal a miss, burn 100),
# so the policy engages after the first wave; the burn window's aging
# is the tracker clock moved on by FLEET_BURN_AGE_S
FLEET_SHED_SLO, FLEET_BURN_AGE_S, FLEET_WAVE = dict(ttft_s=1e-4, tpot_s=1e-4), 400.0, 4
# shed prefill: a 50 ms host_sync stall on dispatching ticks 8-14 (the
# JAX test's window) under the default sentinel, well above the ~4-15 ms
# a prefill-heavy tick waits on the card
FLEET_SHED_PREFILL_SPEC = "host_sync@8:14=0.05"
# scaling on one card: the http phase's prompts, arriving at this rate
FLEET_SCALE_RATE = 256.0
# a fleet leg that has not ended by then is reported stuck (its state)
FLEET_LEG_TIMEOUT_S = 120.0
# the waves sent after a roll and after a scale-up: their new tokens
FLEET_POST_NEW = 16


def numpy_params(np, torch, cfg, seed: int, dtype) -> dict:
    """A second seeded weight set made with numpy (the upgrade's new
    checkpoint: nothing is downloaded) and converted leaf by leaf: norm
    gammas ones (zeros under unit offset), every other leaf one of 256
    levels drawn from N(0, 0.02^2), picked by a numpy byte per element
    (1.2 G normal draws would take the host ~25 s; bytes take ~1 s)."""
    from llm_np_cp_tpu_torch.convert import tensor_from_numpy
    from llm_np_cp_tpu_torch.models.transformer import param_shapes

    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name.startswith("ln_") or name == "final_norm":
            a = np.full(shape, 0.0 if cfg.rms_norm_unit_offset else 1.0, np.float32)
            return tensor_from_numpy(a, "cuda").to(dtype)
        levels = tensor_from_numpy(0.02 * rng.standard_normal(256).astype(np.float32), "cuda")
        codes = np.frombuffer(rng.bytes(int(np.prod(shape))), np.uint8).reshape(shape)
        return levels[tensor_from_numpy(codes, "cuda").long()].to(dtype)

    return {k: {n: leaf(n, s) for n, s in v.items()} if k == "layers" else leaf(k, v)
            for k, v in param_shapes(cfg).items()}


async def fleet_wave(server, model_id: str, items: list[dict], max_tokens: int) -> list[dict]:
    """One request a trace item at once (seeds as given), no retry."""
    import asyncio

    from llm_np_cp_tpu_torch.serve.http.client import astream_completion

    return await asyncio.gather(*(astream_completion(
        server.host, server.port,
        {"model": model_id, "prompt": [int(t) for t in it["prompt"]],
         "max_tokens": max_tokens, "seed": it["seed"]}, timeout=FLEET_LEG_TIMEOUT_S)
        for it in items))


class CaptureWatch:
    """Every CUDA-graph capture of the process while installed: the
    packed width of each (a ``mixed_step[T=...]`` step) and those made on
    a thread that was inside ``ServeEngine.step`` (a capture inside a
    serving tick).  Wraps ``CapturedStep._capture`` and ``ServeEngine.step``
    at class level (restored by ``close``)."""

    def __init__(self):
        import threading

        from llm_np_cp_tpu_torch import graphs
        from llm_np_cp_tpu_torch.serve import ServeEngine

        self._graphs, self._engine = graphs, ServeEngine
        self._real = graphs.CapturedStep._capture, ServeEngine.step
        self._local = threading.local()
        self._lock = threading.Lock()
        self.widths: list[int] = []
        self.inside: list[str] = []
        watch = self

        def capture(st, side):
            with watch._lock:
                if "T=" in st.name:
                    watch.widths.append(int(st.name.split("T=")[1].rstrip("]")))
                if getattr(watch._local, "in_step", False):
                    watch.inside.append(st.name)
            return watch._real[0](st, side)

        def step(eng):
            watch._local.in_step = True
            try:
                return watch._real[1](eng)
            finally:
                watch._local.in_step = False

        graphs.CapturedStep._capture, ServeEngine.step = capture, step

    def mark(self) -> tuple[int, int]:
        return len(self.widths), len(self.inside)

    def since(self, mark: tuple[int, int]) -> tuple[list[int], list[str]]:
        return self.widths[mark[0]:], self.inside[mark[1]:]

    def close(self) -> None:
        self._graphs.CapturedStep._capture, self._engine.step = self._real


def fleet_launches(torch, da, cfg, kernels: dict, engines: list, before: dict,
                   eager_widths: list[int], live) -> tuple[dict, dict, int]:
    """What a fleet leg's ticks imply: per packed width, the dispatches of
    every engine that ticked (``before`` maps id(engine) to its
    ``bucket_dispatches`` at the leg's start) plus the eager first call of
    each capture; ``layers`` ragged launches and one epilogue launch each,
    and the combine where the width's ragged split plan is > 1 (read on
    ``live``, geometry-identical).  Returns (implied counts, dispatches,
    eager calls)."""
    from collections import Counter

    from llm_np_cp_tpu_torch.serve.engine import GLOBAL_WINDOW

    per_w: Counter = Counter()
    dispatches = 0
    for e in engines:
        b0 = before.get(id(e), {})
        for w, c in e.bucket_dispatches.items():
            per_w[w] += c - b0.get(w, 0)
            dispatches += c - b0.get(w, 0)
    per_w.update(eager_widths)
    pages = live.pool.pages.k[0]
    tables = torch.empty((live.scheduler.max_slots, live.max_blocks_per_seq), dtype=torch.int32,
                         device="cuda")
    combine = 0
    for w, n in per_w.items():
        q = torch.empty((w, cfg.num_attention_heads, cfg.head_dim), dtype=torch.bfloat16,
                        device="cuda")
        for i in range(cfg.num_hidden_layers):
            window = (cfg.sliding_window if cfg.sliding_window is not None
                      and cfg.layer_is_sliding(i) else GLOBAL_WINDOW)
            combine += n * int(da.ragged_split_plan(q, pages, tables, window) > 1)
    total = sum(per_w.values())
    want = {name: 0 for name in kernels}
    want.update(ragged_paged_attention=cfg.num_hidden_layers * total, sample_epilogue=total,
                ragged_paged_attention_combine=combine)
    return want, dispatches, len(eager_widths)


def device_share(prof, wall: float) -> dict:
    """The device's work under a profiler capture: the union of its kernel
    and copy intervals over the wall time (busy share), and their summed
    durations over that union (above 1 where streams overlapped)."""
    from torch.autograd import DeviceType

    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA and not e.name.startswith("serve."))
    union, summed, cur = 0.0, 0.0, None
    for a, b in iv:
        summed += b - a
        if cur is None or a > cur[1]:
            if cur is not None:
                union += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        union += cur[1] - cur[0]
    return dict(device_intervals=len(iv), device_busy_s=union / 1e6,
                device_busy_share=union / 1e6 / wall if wall > 0 else None,
                kernel_overlap=summed / union if union > 0 else None)


def fleet_state(runner) -> list[dict]:
    """Each replica runner's supervision and queue state (a stuck leg's
    report)."""
    return [dict(replica=i, state=r.state, crashed=r.crashed, recovering=r.recovering,
                 gen=r._gen, thread_alive=r._thread is not None and r._thread.is_alive(),
                 live=sorted(r._live), inflight=sorted(r._inflight),
                 requests=sorted(r.engine._requests), queued_cmds=r._cmds.qsize(),
                 handback=len(r._handback), retired=r.engine.retired)
            for i, r in enumerate(runner.replicas)]


def fleet_http_leg(torch, np, runner, trace: list[dict], model_id: str, *,
                   upgrade_loader=None, during=None, profile: bool = False) -> dict:
    """The trace's arrivals through ``HttpServer(runner=...)`` started by
    ``run_server``, one ``astream_completion`` client a request (no
    retry: a dropped stream shows); ``during(server)`` runs beside the
    clients (the admin calls, a /healthz poll) and its result is kept;
    then a ``/metrics`` scrape and ``/healthz``, then the drain.  With
    ``profile`` the clients run under torch.profiler (the device's busy
    share and overlap, ``device_share``)."""
    import asyncio
    import contextlib

    from llm_np_cp_tpu_torch.serve.http.client import astream_completion, http_get
    from llm_np_cp_tpu_torch.serve.http.server import run_server

    async def leg() -> dict:
        loop = asyncio.get_running_loop()
        started = loop.create_future()
        serving = asyncio.ensure_future(run_server(
            runner.engine, model_id=model_id, host="127.0.0.1", port=0, drain_timeout=60.0,
            runner=runner, upgrade_loader=upgrade_loader, on_started=started.set_result))
        await asyncio.wait([started, serving], return_when=asyncio.FIRST_COMPLETED)
        if not started.done():
            serving.result()
        server = started.result()

        async def one(item):
            await asyncio.sleep(item["arrival_s"])
            return await astream_completion(
                server.host, server.port,
                {"model": model_id, "prompt": [int(t) for t in item["prompt"]],
                 "max_tokens": item["max_new_tokens"], "seed": item["seed"]},
                timeout=FLEET_LEG_TIMEOUT_S)

        prof_ctx = contextlib.nullcontext()
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile

            prof_ctx = tprofile(activities=[ProfilerActivity.CUDA])
        with prof_ctx as prof:
            side = asyncio.ensure_future(during(server)) if during is not None else None
            t0 = time.perf_counter()
            try:
                results = await asyncio.wait_for(asyncio.gather(*(one(item) for item in trace)),
                                                 FLEET_LEG_TIMEOUT_S)
                wall = time.perf_counter() - t0
                side_out = (await asyncio.wait_for(side, FLEET_LEG_TIMEOUT_S)
                            if side is not None else None)
            except asyncio.TimeoutError:
                raise AssertionError(f"fleet leg stuck after {FLEET_LEG_TIMEOUT_S:g} s: "
                                     + json.dumps(fleet_state(runner), default=str)) from None
        status, raw = await loop.run_in_executor(None, http_get, server.host, server.port,
                                                 "/metrics")
        hz_status, hz = await loop.run_in_executor(None, http_get, server.host, server.port,
                                                   "/healthz")
        server.begin_drain()
        await serving
        out = dict(results=results, wall=wall, status=status, prom=raw.decode(),
                   healthz=(hz_status, json.loads(hz)), side=side_out)
        if profile:
            out["device"] = device_share(prof, wall)
        return out

    return asyncio.run(leg())


def client_stats(np, results: list[dict], wall: float) -> dict:
    ok = [r for r in results if r["status"] == 200 and r["finish_reason"] == "length"]
    ttft = [r["ttft_s"] for r in ok if r["ttft_s"] is not None]
    tpot = [(r["latency_s"] - r["ttft_s"]) / (len(r["token_ids"]) - 1) for r in ok
            if r["ttft_s"] is not None and len(r["token_ids"]) > 1]
    generated = sum(len(r["token_ids"]) for r in results)
    return dict(answered=len(ok), wall_s=wall, tok_s=generated / wall,
                ttft_s_p50=_pct(np, ttft, 50), ttft_s_p99=_pct(np, ttft, 99),
                tpot_s_p50=_pct(np, tpot, 50))


def switch_forced(torch, forward, old, new, cfg, prompt, tokens: list, tol: float) -> list[int]:
    """Every index k such that the tokens before k are teacher-forced
    (within ``tol`` of their row's max) under ``old`` and those from k on
    under ``new`` — the one switch a stream drained onto new weights may
    make (k = 0: all new; k = len(tokens): all old); [] if none."""
    gen = torch.tensor(tokens, device="cuda").long()
    ids = torch.cat([torch.as_tensor(prompt, device="cuda").long(), gen[:-1]])[None]
    gaps = []
    for p in (old, new):
        logits, _ = forward(p, ids, cfg, None)
        rows = logits[0, prompt.size - 1:]
        if not bool(torch.isfinite(rows).all()):
            return []
        gaps.append((rows.amax(dim=-1) - rows.gather(-1, gen[:, None])[:, 0]).tolist())
    return [k for k in range(len(tokens) + 1)
            if max(gaps[0][:k], default=0.0) <= tol and max(gaps[1][k:], default=0.0) <= tol]


def fleet_phase(torch, np, kernels: dict, card: str) -> dict:
    """Engine replicas on one card: the JAX bench's serve_rolling_upgrade
    in direct mode (steady and rolling legs, bf16 and float32), the HTTP
    fleet on the http phase's trace (an upgrade onto a second weight set,
    a scale to 3 and back to 1, a replica crash beside a serving peer),
    the auto-actions (503-first load shedding, shed prefill under a
    host_sync stall) and the same trace at 1, 2 and 3 replicas."""
    import dataclasses
    import gc
    import os
    import tempfile
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.serve import (ActionPolicy, FaultInjector, LifecycleController,
                                           ReplicaRunner, ReplicaSet, RequestLog, ServeEngine,
                                           ServeMetrics, SLOPolicy, SLOTracker, TickSentinel,
                                           TraceRecorder, poisson_trace, pool_geometry,
                                           read_request_log)
    from llm_np_cp_tpu_torch.serve.trace import replay_arrivals

    model_id = "meta-llama/Llama-3.2-1B"
    cfg = dataclasses.replace(PRESETS[model_id], num_hidden_layers=FLEET_LAYERS)
    layers = cfg.num_hidden_layers
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    checks: list[str] = []
    watch = CaptureWatch()
    out_dir = os.path.join("smoke_out", "fleet")
    os.makedirs(out_dir, exist_ok=True)

    def engine(leg_params, dtype, trace, new_tokens, **kw) -> ServeEngine:
        _, num_blocks, max_seq_len = pool_geometry(max(int(t["prompt"].size) for t in trace),
                                                   new_tokens, HTTP_SLOTS, HTTP_BLOCK,
                                                   HTTP_CHUNK)
        eng = ServeEngine(leg_params, cfg, sampler=Sampler("greedy"), max_slots=HTTP_SLOTS,
                          num_blocks=num_blocks, block_size=HTTP_BLOCK,
                          max_seq_len=max_seq_len, prefill_chunk=HTTP_CHUNK, cache_dtype=dtype,
                          mixed_step="on", device=torch.device("cuda"), **kw)
        eng.warmup([int(t["prompt"].size) for t in trace], new_tokens)
        return eng

    def counted(where: str, engines_fn, run, live_fn) -> tuple[dict, object]:
        """One leg with the launch counters at 0 and the capture watch
        marked: its launches against what every engine's ticks and every
        capture's eager first call imply, its graph runs, no capture
        inside a serving tick."""
        torch.cuda.synchronize()
        first = list(engines_fn())
        before = {id(e): dict(e.bucket_dispatches) for e in first}
        reset_counts(kernels)
        g0, m0 = graph_totals(), watch.mark()
        t_leg = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        launches, graphs_run = read_counts(kernels), graph_delta(g0)
        widths, inside = watch.since(m0)
        seen = {id(e): e for e in first + list(engines_fn())}
        want, dispatches, eager = fleet_launches(torch, da, cfg, kernels, list(seen.values()),
                                                 before, widths, live_fn())
        if launches != want:
            checks.append(f"{where}: launch counts {launches} != implied {want}")
        if graphs_run != dict(captures=eager, replays=dispatches, eager=eager):
            checks.append(f"{where}: {dispatches} ticks, {eager} captures, graphs ran "
                          f"{graphs_run}")
        if inside:
            checks.append(f"{where}: captures inside a serving tick: {inside}")
        for k, v in launches.items():
            phase_launches[k] = phase_launches.get(k, 0) + v
        print(f"[fleet] {where}: {dispatches} ticks, {eager} captures, "
              f"{time.perf_counter() - t_leg:.1f} s", file=sys.stderr, flush=True)
        return dict(launches=launches, implied=want, dispatches=dispatches,
                    captures=eager, graphs=graphs_run, captures_in_ticks=len(inside)), out

    def teacher(leg_params, pairs) -> dict:
        return teacher_forced_requests(
            torch, forward, leg_params, cfg,
            [SimpleNamespace(prompt=p, generated=t) for p, t in pairs if t], TEACHER_TOL)

    def near_ties(leg_params, trace, a: dict, b: dict) -> dict:
        gaps = [g for g in (first_divergence(torch, forward, leg_params, cfg, item["prompt"],
                                             a[item["seed"]], b[item["seed"]])
                            for item in trace) if g is not None]
        return dict(identical=len(trace) - len(gaps), divergence_top2_gaps=gaps,
                    tol=TEACHER_TOL, ok=all(g <= TEACHER_TOL for g in gaps))

    results: dict = {}
    phase_launches: dict = {}
    try:
        # -- 1. serve_rolling_upgrade, direct mode ------------------------
        roll_trace = poisson_trace(np.random.default_rng(ROLL_SEED), ROLL_REQUESTS,
                                   rate_rps=ROLL_RATE,
                                   prompt_len_range=(ROLL_PROMPT // 4, ROLL_PROMPT),
                                   max_new_tokens=ROLL_NEW, vocab_size=cfg.vocab_size,
                                   seed_base=ROLL_SEED)

        def roll_leg(where, leg_params, dtype, trace, new_tokens, roll_after) -> dict:
            gc.collect()
            torch.cuda.empty_cache()
            fleet = ReplicaSet([engine(leg_params, dtype, trace, new_tokens)
                                for _ in range(ROLL_REPLICAS)])
            ctl = LifecycleController(fleet)
            rolled: dict = {}
            submitted_after: list = []

            def on_tick(i):
                if roll_after is not None and i == roll_after and not rolled:
                    t0 = time.perf_counter()
                    rolled.update(ctl.rolling_upgrade(lambda: leg_params, version=1,
                                                      steps_between=1))
                    rolled["roll_s"] = time.perf_counter() - t0
                    submitted_after.append(fleet._next_id)

            counts, snap = counted(where, lambda: fleet.engines,
                                   lambda: replay_arrivals(fleet, trace, fleet.snapshot,
                                                           on_tick=on_tick),
                                   lambda: fleet.engines[0])
            reqs = fleet.finished
            versions = sorted({r.extra["weights_version"] for r in reqs})
            late = [r.extra["weights_version"] for r in reqs
                    if submitted_after and r.req_id >= submitted_after[0]]
            leg = dict(leg=where, dtype=str(dtype).replace("torch.", ""), **counts,
                       finished=snap["finished"], dropped=len(trace) - snap["finished"],
                       rolled=rolled.get("rolled"), drained=rolled.get("drained"),
                       roll_s=rolled.get("roll_s"), weights_versions=snap["weights_versions"],
                       request_versions=versions, admitted_after_roll=len(late),
                       lifecycle_actions=_sum_actions(fleet.engines),
                       tok_s=snap["throughput_tok_s"], ttft_s_p50=snap.get("ttft_s_p50"),
                       ttft_s_p99=snap.get("ttft_s_p99"),
                       tokens={r.seed: list(r.generated) for r in reqs})
            if leg["dropped"]:
                checks.append(f"{where}: {leg['dropped']} dropped streams")
            if roll_after is not None and (
                    leg["rolled"] != list(range(ROLL_REPLICAS))
                    or leg["weights_versions"] != [1] * ROLL_REPLICAS
                    or any(v != 1 for v in late)):
                checks.append(f"{where}: roll {rolled}, versions {leg['weights_versions']}, "
                              f"admitted after it {late}")
            del fleet, ctl
            return leg

        steady = roll_leg("roll bf16 steady", params, torch.bfloat16, roll_trace, ROLL_NEW, None)
        rolling = roll_leg("roll bf16 rolling", params, torch.bfloat16, roll_trace, ROLL_NEW,
                           ROLL_AFTER)
        parity = near_ties(params, roll_trace, rolling["tokens"], steady["tokens"])
        if not parity["ok"]:
            checks.append(f"roll bf16 parts from the steady leg away from a near-tie: {parity}")
        tf = teacher(params, [(item["prompt"], rolling["tokens"][item["seed"]])
                              for item in roll_trace])
        if not tf["ok"] or tf["requests"] != ROLL_REQUESTS:
            checks.append(f"roll bf16 teacher-forced: {tf}")
        f32 = float32_params(params)
        f32_trace = [dict(item, max_new_tokens=F32_ROLL_NEW)
                     for item in roll_trace[:F32_ROLL_REQUESTS]]
        f_steady = roll_leg("roll float32 steady", f32, torch.float32, f32_trace, F32_ROLL_NEW,
                            None)
        f_rolling = roll_leg("roll float32 rolling", f32, torch.float32, f32_trace,
                             F32_ROLL_NEW, F32_ROLL_AFTER)
        f_same = sum(f_rolling["tokens"][k] == v for k, v in f_steady["tokens"].items())
        if f_same != F32_ROLL_REQUESTS or not f_rolling["drained"]:
            checks.append(f"roll float32: {f_same} of {F32_ROLL_REQUESTS} streams equal the "
                          f"steady leg's, {f_rolling['drained']} drained")
        deg = (rolling["ttft_s_p99"] / steady["ttft_s_p99"]
               if steady["ttft_s_p99"] else None)
        for leg in (steady, rolling, f_steady, f_rolling):
            del leg["tokens"]
        results["rolling_upgrade"] = dict(
            trace=dict(requests=ROLL_REQUESTS, rate_rps=ROLL_RATE,
                       prompt_len=(ROLL_PROMPT // 4, ROLL_PROMPT), new_tokens=ROLL_NEW,
                       seed=ROLL_SEED, replicas=ROLL_REPLICAS, roll_after_ticks=ROLL_AFTER),
            legs=[steady, rolling], parity_vs_steady=parity, teacher_forced=tf,
            ttft_p99_degradation=deg,
            float32=dict(requests=F32_ROLL_REQUESTS, new_tokens=F32_ROLL_NEW,
                         roll_after_ticks=F32_ROLL_AFTER, identical=f_same,
                         legs=[f_steady, f_rolling]))

        # -- 2. the HTTP fleet on the http phase's trace --------------------
        trace = poisson_trace(np.random.default_rng(HTTP_SEED), HTTP_REQUESTS,
                              rate_rps=HTTP_RATE, prompt_len_range=HTTP_PROMPTS,
                              max_new_tokens=HTTP_NEW, vocab_size=cfg.vocab_size,
                              seed_base=HTTP_SEED)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        new_params = numpy_params(np, torch, cfg, 1, torch.bfloat16)
        new_params_s = time.perf_counter() - t0
        log_path = os.path.join(out_dir, "upgrade_requests.jsonl")
        if os.path.exists(log_path):
            os.remove(log_path)
        log = RequestLog(log_path)
        post_items = [dict(item, seed=item["seed"] + 1000) for item in trace[:FLEET_WAVE]]
        fleet_engines = [engine(params, torch.bfloat16, trace, HTTP_NEW, request_log=log)
                         for _ in range(FLEET_REPLICAS)]
        runner = ReplicaRunner(fleet_engines)
        loads: list[int] = []

        def loader(body):
            loads.append(1)
            return new_params

        async def upgrade_during(server):
            import asyncio

            from llm_np_cp_tpu_torch.serve.http.client import http_post

            loop = asyncio.get_running_loop()
            await asyncio.sleep(FLEET_UPGRADE_AT_S)
            t_start = time.perf_counter()
            first = loop.run_in_executor(None, http_post, server.host, server.port,
                                         "/admin/upgrade", {"version": 1})
            await asyncio.sleep(0.05)
            second = await loop.run_in_executor(None, http_post, server.host, server.port,
                                                "/admin/upgrade", {})
            st, body = await first
            roll_s = time.perf_counter() - t_start
            # admitted after the roll: the new weights' streams
            post = await fleet_wave(server, model_id, post_items, FLEET_POST_NEW)
            return dict(status=st, body=body, second_status=second[0], roll_s=roll_s,
                        post=post)

        counts, res = counted(
            "fleet upgrade", lambda: [r.engine for r in runner.replicas],
            lambda: fleet_http_leg(torch, np, runner, trace, model_id, upgrade_loader=loader,
                                   during=upgrade_during),
            lambda: runner.replicas[0].engine)
        log.flush(10.0)
        log.close()
        lines = {ln["rid"]: ln for ln in read_request_log(log_path)}
        side = res["side"]
        served = (list(zip(trace, res["results"]))
                  + list(zip(post_items, side["post"])))
        rid_of = {item["seed"]: int((r.get("stream_id") or "cmpl--1").split("-")[-1])
                  for item, r in served}
        forced, unforced = {0: 0, 1: 0, "switched": 0}, []
        for item, r in served:
            ln = lines.get(rid_of[item["seed"]])
            if ln is None or not r["token_ids"]:
                unforced.append((item["seed"], "no log line"))
                continue
            ks = switch_forced(torch, forward, params, new_params, cfg, item["prompt"],
                               r["token_ids"], TEACHER_TOL)
            v, n = ln["weights_version"], len(r["token_ids"])
            if v == 1 and 0 in ks:
                forced[1] += 1
            elif v == 0 and ln["drains"] == 0 and n in ks:
                forced[0] += 1
            elif v == 0 and ln["drains"] > 0 and ks:
                forced["switched" if n not in ks else 0] += 1
            else:
                unforced.append((item["seed"], v, ln["drains"], ks[:3], n))
        versions = {ln["weights_version"] for ln in lines.values()}
        post_ok = sum(r["status"] == 200 and len(r["token_ids"]) == FLEET_POST_NEW
                      for r in side["post"])
        upgrade = dict(**counts, **client_stats(np, res["results"], res["wall"]),
                       new_weights_s=new_params_s, post_roll_answered=post_ok,
                       admin={k: v for k, v in side.items() if k != "post"},
                       checkpoint_loads=len(loads),
                       log_lines=len(lines), versions=sorted(versions),
                       teacher_forced=forced, unforced=unforced,
                       weights_versions=[r.engine.weights_version for r in runner.replicas],
                       scrape_has_version_label='version="1"' in res["prom"])
        if (upgrade["answered"] != HTTP_REQUESTS or side["status"] != 200
                or side["body"] != {"rolled": [0, 1], "version": 1}
                or side["second_status"] != 409 or len(loads) != 1 or post_ok != FLEET_WAVE
                or len(lines) != HTTP_REQUESTS + FLEET_WAVE or unforced
                or forced[1] < FLEET_WAVE
                or upgrade["weights_versions"] != [1, 1]):
            checks.append(f"fleet upgrade: {upgrade}")
        results["http_upgrade"] = upgrade

        # scale: the rolled fleet grows to 3 and shrinks to 1 under traffic
        runner = ReplicaRunner([r.engine for r in runner.replicas])
        # prompts the router has not seen (a seen prefix sticks to its replica)
        scale_items = poisson_trace(np.random.default_rng(HTTP_SEED + 1), FLEET_WAVE,
                                    rate_rps=HTTP_RATE, prompt_len_range=HTTP_PROMPTS,
                                    max_new_tokens=FLEET_POST_NEW, vocab_size=cfg.vocab_size,
                                    seed_base=HTTP_SEED + 2000)
        for e in runner.replicas[0].engine, runner.replicas[1].engine:
            e.request_log = None

        async def scale_during(server):
            import asyncio

            from llm_np_cp_tpu_torch.serve.http.client import http_post

            loop = asyncio.get_running_loop()
            await asyncio.sleep(FLEET_SCALE_AT_S[0])
            up = await loop.run_in_executor(None, http_post, server.host, server.port,
                                            "/admin/scale", {"replicas": 3})
            added = runner.replicas[-1].engine
            joined = dict(counts=added.compile_counts(),
                          source=runner.replicas[0].engine.compile_counts(),
                          reserved=torch.cuda.memory_reserved())
            # fresh prefixes after the scale-up: first sight routes one to
            # the newcomer
            wave = await fleet_wave(server, model_id, scale_items, FLEET_POST_NEW)
            await asyncio.sleep(FLEET_SCALE_AT_S[1] - FLEET_SCALE_AT_S[0])
            served_by_added = added.metrics.snapshot()["submitted"]
            down = await loop.run_in_executor(None, http_post, server.host, server.port,
                                              "/admin/scale", {"replicas": 1})
            return dict(up=up, down=down, joined=joined, served_by_added=served_by_added,
                        wave=wave)

        counts, res = counted(
            "fleet scale", lambda: [r.engine for r in runner.replicas],
            lambda: fleet_http_leg(torch, np, runner, trace, model_id, during=scale_during),
            lambda: runner.replicas[0].engine)
        side = res["side"]
        tf = teacher(new_params, [(item["prompt"], r["token_ids"]) for item, r in
                                  list(zip(trace, res["results"]))
                                  + list(zip(scale_items, side["wave"]))])
        scale = dict(**counts, **client_stats(np, res["results"], res["wall"]),
                     up=side["up"][1], down=side["down"][1], joined=side["joined"],
                     served_by_added=side["served_by_added"],
                     wave_answered=sum(r["status"] == 200 for r in side["wave"]),
                     teacher_forced=tf,
                     states=[s["state"] for s in runner.replica_states()])
        if (scale["answered"] != HTTP_REQUESTS or side["up"][0] != 200
                or side["down"][0] != 200 or side["up"][1].get("added") != [2]
                or side["down"][1].get("removed") != [2, 1]
                or side["joined"]["counts"] != side["joined"]["source"]
                or not tf["ok"] or tf["requests"] != HTTP_REQUESTS + FLEET_WAVE
                or scale["wave_answered"] != FLEET_WAVE or side["served_by_added"] < 1
                or scale["states"] != ["ok", "removed", "removed"]):
            checks.append(f"fleet scale: {scale}")
        results["http_scale"] = scale

        # shed load on the fleet's survivor: an SLO it never meets burns
        survivor = runner.replicas[0].engine
        skew = [0.0]
        survivor.metrics = ServeMetrics(clock=survivor.clock, slo=SLOTracker(
            SLOPolicy(**FLEET_SHED_SLO), clock=lambda: time.perf_counter() + skew[0]))
        survivor.actions = ActionPolicy(min_flip_interval_s=0.0)
        runner = ReplicaRunner([survivor])

        async def shed_during(server):
            import asyncio

            def wave(items):
                return fleet_wave(server, model_id, items, 8)

            async def until(cond, limit=30.0):
                end = time.perf_counter() + limit
                while not cond() and time.perf_counter() < end:
                    await asyncio.sleep(0.01)
                return cond()

            items = trace[:FLEET_WAVE]
            first = await wave(items)
            engaged = await until(lambda: survivor.actions.shedding)
            shed = await wave(items)
            skew[0] += FLEET_BURN_AGE_S  # the burn window ages out
            released = await until(lambda: not survivor.actions.shedding)
            again = await wave(items)
            return dict(first=[r["status"] for r in first], engaged=engaged,
                        shed=[(r["status"], r.get("retry_after_s")) for r in shed],
                        released=released, again=[r["status"] for r in again],
                        snapshot=survivor.actions.snapshot())

        counts, res = counted(
            "fleet shed load", lambda: [survivor],
            lambda: fleet_http_leg(torch, np, runner, [], model_id, during=shed_during),
            lambda: survivor)
        side = res["side"]
        shed_load = dict(**counts, **side, scrape_counts='action="shed_load_on"' in res["prom"])
        if (side["first"] != [200] * FLEET_WAVE or not side["engaged"]
                or any(st != 503 or not ra or ra < 1 for st, ra in side["shed"])
                or not side["released"] or side["again"] != [200] * FLEET_WAVE
                or not shed_load["scrape_counts"]):
            checks.append(f"fleet shed load: {shed_load}")
        results["shed_load"] = shed_load

        # shed prefill: a host_sync stall under the sentinel, direct
        survivor.metrics = ServeMetrics(clock=survivor.clock)
        survivor.tracer = TraceRecorder(ring=OBSERVE_RING)
        survivor.sentinel = TickSentinel(warmup_ticks=4)
        survivor.actions = ActionPolicy(engage_streak=3, release_clean=8,
                                        min_flip_interval_s=0.0)
        survivor.faults = FaultInjector(FLEET_SHED_PREFILL_SPEC)
        budgets: list[int] = []
        real_budget = survivor._tick_budget

        def tick_budget():
            budgets.append(real_budget())
            return budgets[-1]

        survivor._tick_budget = tick_budget
        counts, snap = counted("fleet shed prefill", lambda: [survivor],
                               lambda: survivor.replay_trace(trace), lambda: survivor)
        del survivor._tick_budget
        acts = snap.get("lifecycle_actions", {})
        shed_prefill = dict(**counts, spec=FLEET_SHED_PREFILL_SPEC,
                            finished=snap["finished"], lifecycle_actions=acts,
                            anomaly_ticks=snap.get("anomaly_ticks", {}),
                            full_budget=survivor.tick_token_budget,
                            min_budget=min(budgets), last_budget=budgets[-1],
                            shed_ticks=sum(b < survivor.tick_token_budget for b in budgets),
                            decode_floor=survivor.scheduler.max_slots)
        if (not acts.get("shed_prefill_on")
                or acts.get("shed_prefill_on") != acts.get("shed_prefill_off")
                or not (shed_prefill["decode_floor"] <= shed_prefill["min_budget"]
                        < shed_prefill["full_budget"] == shed_prefill["last_budget"])
                or snap["finished"] != HTTP_REQUESTS or counts["captures"]):
            checks.append(f"fleet shed prefill: {shed_prefill}")
        results["shed_prefill"] = shed_prefill
        survivor.tracer = survivor.sentinel = survivor.actions = survivor.faults = None
        del runner, survivor, fleet_engines, new_params

        # -- 3. a crash beside a serving peer, float32 ----------------------
        f32_trace = [dict(item, max_new_tokens=F32_FLEET_NEW)
                     for item in trace[:F32_FLEET_REQUESTS]]

        def crash_leg(where, spec) -> dict:
            gc.collect()
            torch.cuda.empty_cache()
            engines = [engine(f32, torch.float32, f32_trace, F32_FLEET_NEW,
                              fault_injector=FaultInjector(spec) if spec and i == 0 else None)
                       for i in range(FLEET_REPLICAS)]
            fl = ReplicaRunner(engines, max_restarts=1, restart_backoff_s=0.2,
                               tick_deadline=60.0)
            states: list = []

            async def poll(server):
                import asyncio

                from llm_np_cp_tpu_torch.serve.http.client import http_get

                loop = asyncio.get_running_loop()
                last = time.perf_counter() + max(t["arrival_s"] for t in f32_trace) + 0.5
                while fl.inflight or time.perf_counter() < last:
                    st, body = await loop.run_in_executor(None, http_get, server.host,
                                                          server.port, "/healthz")
                    states.append(json.loads(body)["status"])
                    await asyncio.sleep(0.01)
                return sorted(set(states))

            counts, res = counted(where, lambda: [r.engine for r in fl.replicas],
                                  lambda: fleet_http_leg(torch, np, fl, f32_trace, model_id,
                                                         during=poll),
                                  lambda: fl.replicas[1].engine)
            owners = dict(fl._owner)
            return dict(leg=where, **counts, **client_stats(np, res["results"], res["wall"]),
                        restarts=fl.restarts, healthz_states=res["side"],
                        rebuilds=fl.replicas[0].rebuilds,
                        peer_rids=sorted(r for r, i in owners.items() if i == 1),
                        tokens={item["seed"]: r["token_ids"]
                                for item, r in zip(f32_trace, res["results"])},
                        rid_of={item["seed"]: int((r.get("stream_id") or "cmpl--1").split("-")[-1])
                                for item, r in zip(f32_trace, res["results"])})

        clean = crash_leg("fleet float32 clean", None)
        crash = crash_leg("fleet float32 crash", FLEET_CRASH_SPEC)
        peer = [s for s, rid in crash["rid_of"].items() if rid in crash["peer_rids"]]
        same = sum(crash["tokens"][s] == clean["tokens"][s] for s in clean["tokens"])
        peer_same = sum(crash["tokens"][s] == clean["tokens"][s] for s in peer)
        for leg in (clean, crash):
            del leg["tokens"], leg["rid_of"], leg["peer_rids"]
        crash_out = dict(spec=FLEET_CRASH_SPEC, requests=F32_FLEET_REQUESTS,
                         new_tokens=F32_FLEET_NEW, legs=[clean, crash], identical=same,
                         peer_streams=len(peer), peer_identical=peer_same)
        if (same != F32_FLEET_REQUESTS or not peer or peer_same != len(peer)
                or crash["restarts"] != 1 or "degraded" not in crash["healthz_states"]
                or crash["answered"] != F32_FLEET_REQUESTS or clean["restarts"]):
            checks.append(f"fleet crash: {crash_out}")
        results["crash"] = crash_out
        del f32

        # -- 4. the same trace at 1, 2 and 3 replicas -----------------------
        gc.collect()
        torch.cuda.empty_cache()
        scale_trace = poisson_trace(np.random.default_rng(HTTP_SEED), HTTP_REQUESTS,
                                    rate_rps=FLEET_SCALE_RATE, prompt_len_range=HTTP_PROMPTS,
                                    max_new_tokens=HTTP_NEW, vocab_size=cfg.vocab_size,
                                    seed_base=HTTP_SEED)
        pool = []
        scaling = []
        for n in (1, 2, 3):
            # what building and warming one more replica adds to the
            # reserved bytes (the collector and the cache emptied on both
            # sides, so earlier phases' garbage does not count)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            pool.append(engine(params, torch.bfloat16, scale_trace, HTTP_NEW))
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            row = dict(replicas=n, reserved_bytes=reserved,
                       replica_reserved_bytes=reserved - reserved0,
                       pool_bytes=pool[-1].pool.stats()["kv_bytes_total"],
                       graph_pool_bytes=sum(st.pool_bytes or 0 for st in pool[-1].graph_steps()))
            for profiled in (False, True):
                for e in pool:
                    e.metrics = ServeMetrics(clock=e.clock)
                fl = ReplicaRunner(list(pool), spill_queue_depth=None)
                where = f"fleet scaling x{n}" + (" profiled" if profiled else "")
                # the profiled leg replays half the trace: the profiler's
                # post-processing grows with the kernels it saw
                leg_trace = scale_trace[:HTTP_REQUESTS // 2] if profiled else scale_trace
                counts, res = counted(where, lambda: list(pool),
                                      lambda: fleet_http_leg(torch, np, fl, leg_trace,
                                                             model_id, profile=profiled),
                                      lambda: pool[0])
                stats = client_stats(np, res["results"], res["wall"])
                if stats["answered"] != len(leg_trace):
                    checks.append(f"{where}: {stats}")
                if profiled:
                    row["profiled"] = dict(**res["device"], requests=len(leg_trace),
                                           tok_s=stats["tok_s"])
                else:
                    row.update(**stats, dispatches=counts["dispatches"],
                               launches=counts["launches"])
            scaling.append(row)
        results["scaling"] = dict(rate_rps=FLEET_SCALE_RATE, legs=scaling)
        del pool
    finally:
        watch.close()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(phase="fleet", model=model_id, layers=layers,
                reduced=f"depth 16 -> {FLEET_LAYERS} layers", weights="seeded random bf16",
                card=card, engine=dict(max_slots=HTTP_SLOTS, block_size=HTTP_BLOCK,
                                       prefill_chunk=HTTP_CHUNK, mixed_step="on",
                                       sampler="greedy"),
                launches=phase_launches, **results, checks=checks, ok=not checks)


def _sum_actions(engines) -> dict:
    out: dict = {}
    for e in engines:
        for k, v in e.metrics.snapshot().get("lifecycle_actions", {}).items():
            out[k] = out.get(k, 0) + v
    return out


# ----------------------------------------------------------------------
# phase 13: Mixture-of-Experts at Mixtral-8x7B widths
# ----------------------------------------------------------------------

# mistralai/Mixtral-8x7B-v0.1's published config.json (the keys
# ModelConfig.from_hf_dict reads); the JAX defaults moe_capacity_factor
# 2.0 and moe_group_size 1024 stand.  Depth is cut from 32 to MOE_LAYERS:
# 32 bf16 layers are ~93 GB, above the card's 80 GB; 4 are ~6.2 B
# parameters (~12.3 GB), cut from 8 to leave the whole script's time to
# the mesh phase's serve legs.
MIXTRAL_HF = dict(
    model_type="mixtral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    max_position_embeddings=32768, rope_theta=1e6, rms_norm_eps=1e-5, hidden_act="silu",
    tie_word_embeddings=False, num_local_experts=8, num_experts_per_tok=2,
    router_aux_loss_coef=0.02)
MOE_MODEL = "mistralai/Mixtral-8x7B-v0.1"
MOE_LAYERS = 4
# E / k: every expert's capacity is its group's length, so no route drops
# and a token's output does not depend on the rest of its forward
MOE_NO_DROP = 4.0
# route-pinned teacher forcing (``pinned_forced``): the chosen tokens'
# logit gap, and the plain forward's router logits against the path's at
# every position and layer.  At these widths the plain path alone (its
# cached twin against the cache-less forward, both pinned to the same
# routes) measured gaps of 0.066-0.081 and router-logit differences of
# 0.11-0.13 in bf16 (weights bf16, int8 or int4), 0.28-0.43 and 0.30-0.45
# in the W8A8 modes, on an NVIDIA H100 80GB HBM3 (700 W); each limit is
# ~3x that floor, as A8_TEACHER_TOL is, and far below what one expert
# without its down projection gives (7.4 and 7.0).  The W8A8 paths read
# router differences up to ~1.0, so MOE_A8_ROUTER_TOL, about one router
# logit's spread at these widths, catches gross faults only (the zeroed
# expert, checked under W8A8 too): there the logit gap and the flip rule
# (``pinned_forced``) gate
MOE_TEACHER_TOL = 0.25
MOE_ROUTER_TOL = 0.4
MOE_A8_ROUTER_TOL = 1.35
# the float32 serve check's depth (2 float32 layers of experts: ~11 GB)
MOE_F32_LAYERS = 2


def moe_config():
    """Mixtral-8x7B's config at MOE_LAYERS layers (capacity 2.0, group
    1024: the JAX defaults)."""
    from llm_np_cp_tpu_torch.config import ModelConfig

    return ModelConfig.from_hf_dict(dict(MIXTRAL_HF, num_hidden_layers=MOE_LAYERS))


class RouteLog:
    """While entered, record every MoE layer call's router logits
    (float32), its top-k experts and which of those routes its capacity
    kept (``ops.moe.route`` and ``dispatch_mask`` wrapped; device
    tensors).  For eager steps only: a captured graph would not run the
    wrappers again.  The calls come ``layers`` to a forward, in order."""

    def __init__(self, torch, layers: int):
        self.torch, self.layers = torch, layers
        self.logits, self.idx, self.kept = [], [], []

    def __enter__(self):
        from llm_np_cp_tpu_torch.ops import moe

        self.moe, self.route, self.dispatch = moe, moe.route, moe.dispatch_mask

        def route(x, router_w, *, top_k):
            probs, gates = self.route(x, router_w, top_k=top_k)
            self.logits.append(x.float() @ router_w.float())
            self.idx.append(moe.top_k_stable(probs, top_k)[1])
            return probs, gates

        def dispatch(routed, gs, capacity, dtype):
            d = self.dispatch(routed, gs, capacity, dtype)
            kept = d.reshape(routed.shape[0], routed.shape[1], -1).sum(dim=-1) > 0  # [T, E]
            self.kept.append(kept.gather(1, self.idx[-1]))
            return d

        moe.route, moe.dispatch_mask = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch_mask = self.route, self.dispatch

    def forwards(self) -> list[list[tuple]]:
        """Per forward, per layer: (logits [T, E], top-k [T, k], kept [T, k])."""
        calls = list(zip(self.logits, self.idx, self.kept))
        return [calls[f:f + self.layers] for f in range(0, len(calls), self.layers)]

    def drops(self) -> dict:
        """The share of the routes each forward dropped."""
        torch = self.torch
        n = torch.stack([torch.stack([k.numel() - k.sum() for _, _, k in fw]).sum()
                         for fw in self.forwards()]).float().cpu()
        routes = torch.tensor([sum(k.numel() for _, _, k in fw) for fw in self.forwards()],
                              dtype=torch.float32)
        share = n / routes
        return dict(forwards=len(routes), routes=int(routes.sum()), dropped=int(n.sum()),
                    dropped_share=float(n.sum() / routes.sum()),
                    dropped_share_per_forward_mean=share.mean().item(),
                    dropped_share_per_forward_max=share.max().item(),
                    forwards_with_drops=int((share > 0).sum().item()))


def batch_routes(torch, log: RouteLog, b: int) -> list[tuple]:
    """A ``Generator`` run's routes as the cache-less forward over its
    [B, P] ids sees them: each forward covers the next columns of every
    row (prefill, then one a decode step).  Per layer: (logits [B, P, E],
    top-k [B, P, k], kept [B, P, k])."""
    per_layer = list(zip(*log.forwards()))
    return [tuple(torch.cat([t.reshape(b, -1, t.shape[-1]) for t in parts], dim=1)
                  for parts in zip(*calls)) for calls in per_layer]


def request_routes(torch, log: RouteLog, ticks: list[list[tuple]], req) -> list[tuple]:
    """One served request's routes, per layer, over its content positions
    0 .. P-1 (prompt + generated, less the last token), gathered from the
    unified ticks that computed them (``ticks``: each tick's
    ``ServeEngine.tick_segments``): per layer (logits [1, P, E], top-k
    [1, P, k], kept [1, P, k])."""
    p = req.prompt.size + len(req.generated) - 1
    fws = log.forwards()
    if len(fws) != len(ticks):
        raise AssertionError(f"{len(fws)} routed forwards for {len(ticks)} ticks")
    cols = [[] for _ in range(p)]
    for f, segments in enumerate(ticks):
        for rid, lane0, n, pos0 in segments:
            if rid == req.req_id:
                for k in range(min(n, p - pos0)):
                    cols[pos0 + k].append((f, lane0 + k))
    if not all(cols):
        raise AssertionError(f"request {req.req_id}: positions never computed")
    # a preempted request's re-prefill computes positions again: the last
    # computation is the one its later tokens attended
    return [tuple(torch.stack([fws[f][layer][j][lane] for f, lane in (c[-1] for c in cols)])[None]
                  for j in range(3)) for layer in range(log.layers)]


def pinned_forced(torch, forward, params, cfg, prompt_ids, tokens, routes: list[tuple],
                  tol: float, attn_mask=None, pad_offsets=None, *, router_tol: float,
                  twin: bool = False) -> dict:
    """Teacher forcing with the routes pinned: one cache-less plain
    forward over prompt + tokens (capacity E / k, so it drops nothing of
    its own) whose every MoE layer takes the experts the path under test
    chose and drops the routes it dropped, weighted by its own router
    probabilities.  Each chosen token's logit must lie within ``tol`` of
    its row's max, and the plain router logits within ``router_tol`` of
    the path's at every valid position.  A position whose plain top-k
    differs from the path's (``flips``, counted with their top-k
    margins) must have a plain margin of at most twice its own largest
    router-logit difference d: logits within d of each other can swap
    two experts only if they lie within 2d, so a flip beyond that is a
    choice the path's own logits do not explain (``unexplained_flips``).
    Without pinning, one flipped near-tie changes a token's output by a
    whole expert and every later token through attention.  ``twin``:
    also the plain cached twin (prefill, then one plain token a forward),
    pinned alike, against the cache-less forward — the bf16 floor of
    both checks."""
    import dataclasses

    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.ops import moe

    s, n = prompt_ids.shape[1], tokens.shape[1]
    tokens = tokens.long()
    ids = torch.cat([prompt_ids.long(), tokens[:, :-1]], dim=1)
    b, p = ids.shape
    mask = torch.ones((b, p), dtype=torch.bool, device=ids.device)
    if attn_mask is not None:
        mask[:, :s] = attn_mask
    plain_cfg = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_local_experts / cfg.num_experts_per_tok)
    route = moe.route

    def run(x_ids, c0: int, seen: list, **kw):
        """One plain forward over columns c0 .. c0 + width of the rows,
        its routes pinned; ``seen`` gets each layer's router logits."""
        w, layer = x_ids.shape[1], [0]

        def pinned(x, router_w, *, top_k):
            logits_r, idx_r, kept_r = (t[:, c0:c0 + w].reshape(b * w, -1)
                                       for t in routes[layer[0]])
            layer[0] += 1
            logits = x.float() @ router_w.float()
            probs = torch.softmax(logits, dim=-1)
            own = moe.top_k_stable(probs, top_k)[1]
            vals = probs.gather(1, idx_r)
            vals = vals / vals.sum(dim=-1, keepdim=True) * kept_r
            top = torch.topk(logits, top_k + 1, dim=-1).values
            seen.append((logits.reshape(b, w, -1), (logits - logits_r).abs().amax(dim=-1),
                         (own.sort(dim=-1).values != idx_r.sort(dim=-1).values).any(dim=-1),
                         top[:, top_k - 1] - top[:, top_k]))  # [T] each but the first
            return probs, torch.zeros_like(probs).scatter(1, idx_r, vals)

        moe.route = pinned
        try:
            return forward(params, x_ids, plain_cfg, kw.pop("cache", None), **kw)[0]
        finally:
            moe.route = route

    seen: list = []
    logits = run(ids, 0, seen, attn_mask=mask if attn_mask is not None else None,
                 pad_offsets=pad_offsets)
    rows = logits[:, s - 1:s - 1 + n].float()
    gap = rows.amax(dim=-1) - rows.gather(-1, tokens[..., None])[..., 0]
    valid = mask.reshape(-1)
    dlogit = torch.stack([d for _, d, _, _ in seen])[:, valid]
    flips = torch.stack([f for _, _, f, _ in seen])[:, valid]
    margins = torch.stack([m for _, _, _, m in seen])[:, valid]
    # 2d: the widest margin that logits within d of the path's can cross;
    # 1e-4: the float32 rounding of the margin itself
    unexplained = flips & (margins > 2 * dlogit + 1e-4)
    ratio = margins / (2 * dlogit).clamp_min(1e-12)
    out = dict(tokens=tokens.numel(),
               exact_share=(rows.argmax(dim=-1) == tokens).float().mean().item(),
               max_gap=gap.max().item(), tol=tol,
               max_router_logit_diff=dlogit.max().item(), router_tol=router_tol,
               routes=int(flips.numel()), flips=int(flips.sum().item()),
               max_flip_margin=margins[flips].max().item() if bool(flips.any()) else None,
               max_flip_margin_over_2d=ratio[flips].max().item() if bool(flips.any()) else None,
               unexplained_flips=int(unexplained.sum().item()),
               dropped=int(sum(int((~t[2][:, :p].bool()).sum()) for t in routes)))
    out["ok"] = (bool(torch.isfinite(rows).all()) and out["max_gap"] <= tol
                 and out["max_router_logit_diff"] <= router_tol
                 and out["unexplained_flips"] == 0)
    if twin:
        cache = KVCache.init(plain_cfg, b, p, params["final_norm"].dtype)
        tseen: list = []
        steps = [run(prompt_ids.long(), 0, tseen, cache=cache, attn_mask=attn_mask,
                     pad_offsets=pad_offsets, logits_last_only=True)[:, -1]]
        for j in range(n - 1):
            steps.append(run(tokens[:, j:j + 1], s + j, tseen, cache=cache,
                             pad_offsets=pad_offsets, logits_last_only=True)[:, -1])
        twin_rows = torch.stack(steps, dim=1).float()
        full = torch.stack([lg for lg, _, _, _ in seen])  # [L, B, P, E]
        per_layer = [torch.cat([lg for lg, _, _, _ in tseen[i::len(seen)]], dim=1)
                     for i in range(len(seen))]
        tw = torch.stack(per_layer)
        floor = rows.amax(dim=-1) - rows.gather(-1, twin_rows.argmax(dim=-1)[..., None])[..., 0]
        out["plain_twin"] = dict(
            max_gap_vs_cacheless=floor.max().item(),
            max_logit_diff_vs_cacheless=(twin_rows - rows).abs().max().item(),
            max_router_logit_diff_vs_cacheless=(tw - full).abs().amax(dim=-1).reshape(
                len(seen), -1)[:, valid].max().item())
    return out


def merge_forced(parts: list[dict]) -> dict:
    """``pinned_forced`` results of several requests → their totals."""
    n = sum(p["tokens"] for p in parts)
    margins = [p["max_flip_margin"] for p in parts if p["max_flip_margin"] is not None]
    return dict(requests=len(parts), tokens=n,
                exact_share=sum(p["exact_share"] * p["tokens"] for p in parts) / max(1, n),
                max_gap=max(p["max_gap"] for p in parts), tol=parts[0]["tol"],
                max_router_logit_diff=max(p["max_router_logit_diff"] for p in parts),
                router_tol=MOE_ROUTER_TOL, routes=sum(p["routes"] for p in parts),
                flips=sum(p["flips"] for p in parts),
                max_flip_margin=max(margins) if margins else None,
                max_flip_margin_over_2d=max((p["max_flip_margin_over_2d"] for p in parts
                                             if p["max_flip_margin_over_2d"] is not None),
                                            default=None),
                unexplained_flips=sum(p["unexplained_flips"] for p in parts),
                dropped=sum(p["dropped"] for p in parts), ok=all(p["ok"] for p in parts))


def zeroed_expert_fault(torch, forward, params, cfg, prompts, tol: float,
                        router_tol: float) -> dict:
    """The fault the route-pinned check must catch: ``params`` with
    expert 0's down projection zeroed (a quantized payload's integers)
    generates 16 tokens eagerly, its routes recorded; ``pinned_forced``
    over the sound ``params`` must fail them.  Also says whether the
    router-logit bound alone fails them."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.quant import is_quantized, payload_key

    down = params["layers"]["down_proj"]
    if is_quantized(down):
        key = payload_key(down)
        bad_down = dict(down, **{key: down[key].clone()})
        bad_down[key][:, 0] = 0
    else:
        bad_down = down.clone()
        bad_down[:, 0] = 0
    bad = dict(params, layers=dict(params["layers"], down_proj=bad_down))
    with graphs.eager_steps(), RouteLog(torch, cfg.num_hidden_layers) as log:
        faulty = Generator(bad, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                           decode_attn_impl="flash_decode").generate(prompts, 16).tokens
    del bad, bad_down
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    out = pinned_forced(torch, forward, params, cfg, torch.as_tensor(prompts, device=dev),
                        torch.as_tensor(faulty, device=dev),
                        batch_routes(torch, log, len(prompts)), tol, router_tol=router_tol)
    out.update(caught=not out["ok"],
               router_bound_failed=out["max_router_logit_diff"] > router_tol)
    return out


def moe_offline(torch, np, kernels: dict, params, cfg, prompts, ragged, gate: bool) -> tuple:
    """``generate`` (flash prefill, the decode kernel, the fused epilogue),
    ``generate_ragged`` (left pads route through the experts) and
    ``stream`` at ``cfg``'s capacity: launch counts against what the path
    implies, every decode step a replay after its first, TTFT and decode
    rate.  Then each again eagerly (``graphs.eager_steps``) with its
    routes recorded: its tokens must equal the captured run's, and
    ``pinned_forced`` holds them (a gate where ``gate``).  Returns (the
    record, the captured Generator)."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.ops.sampling import Sampler

    layers = cfg.num_hidden_layers

    def generators():
        return (Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                          decode_attn_impl="flash_decode"),
                Generator(params, cfg, sampler=Sampler("greedy"), prefill_attn_impl="xla",
                          decode_attn_impl="flash_decode"))

    gen, gen_r = generators()
    if gen.epilogue_impl != "fused" or gen_r.epilogue_impl != "fused":
        raise AssertionError("moe: greedy Generator did not select the fused epilogue")
    gen.generate(prompts, 4)  # warm-up
    torch.cuda.synchronize()
    reset_counts(kernels)
    g0 = graph_totals()
    res = gen.generate(prompts, DECODE_STEPS)
    res_r = gen_r.generate_ragged(ragged, DECODE_STEPS)
    streamed = list(gen.stream(prompts[0], STREAM_TOKENS))
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    steps = DECODE_STEPS - 1
    graphs_run = graph_delta(g0)
    check_replayed("moe offline", graphs_run, 2 * steps + STREAM_TOKENS - 1)
    want = {name: 0 for name in kernels}
    want.update({
        "flash_attention": layers * 2,
        "decode_attention": layers * (2 * steps + STREAM_TOKENS - 1),
        "decode_attention_combine": layers * (
            steps * combines(torch, cfg, 4, prompts.shape[1] + DECODE_STEPS)
            + steps * combines(torch, cfg, 4, max(len(r) for r in ragged) + DECODE_STEPS)
            + (STREAM_TOKENS - 1) * combines(torch, cfg, 1, prompts.shape[1] + STREAM_TOKENS)),
        "sample_epilogue": 2 * steps + STREAM_TOKENS - 1,
    })
    if launches != want:
        raise AssertionError(f"moe offline: launch counts {launches} != implied {want}")
    if res.tokens.shape != (4, DECODE_STEPS) or len(streamed) != STREAM_TOKENS:
        raise AssertionError(f"moe offline: shapes {res.tokens.shape}, {len(streamed)}")

    dev = torch.device("cuda")
    ids, mask, pads = Generator.left_pad(ragged)
    runs = {"generate": (lambda g, gr: g.generate(prompts, DECODE_STEPS).tokens, res.tokens,
                         prompts, {}),
            "generate_ragged": (lambda g, gr: gr.generate_ragged(ragged, DECODE_STEPS).tokens,
                                res_r.tokens, ids,
                                dict(attn_mask=torch.as_tensor(mask, device=dev),
                                     pad_offsets=torch.as_tensor(pads, device=dev).long())),
            "stream": (lambda g, gr: np.asarray([list(g.stream(prompts[0], STREAM_TOKENS))]),
                       np.asarray([streamed]), prompts[:1], {})}
    forced, identical, drops = {}, {}, {}
    with graphs.eager_steps():
        eager, eager_r = generators()
        for name, (run, captured, prompt, kw) in runs.items():
            with RouteLog(torch, layers) as log:
                toks = run(eager, eager_r)
            identical[name] = bool((np.asarray(toks) == np.asarray(captured)).all())
            drops[name] = log.drops()
            forced[name] = pinned_forced(
                torch, forward, params, cfg, torch.as_tensor(prompt, device=dev),
                torch.as_tensor(np.asarray(captured), device=dev),
                batch_routes(torch, log, len(prompt)), MOE_TEACHER_TOL, **kw,
                router_tol=MOE_ROUTER_TOL, twin=name == "generate")
            del log
    out = dict(capacity_factor=cfg.moe_capacity_factor, launches=launches, implied=want,
               graphs=graphs_run,
               generate=dict(batch=4, prompt_len=int(prompts.shape[1]), new_tokens=DECODE_STEPS,
                             ttft_s=res.ttft_s, decode_tok_s_per_seq=res.decode_tokens_per_s,
                             decode_tok_s=res.decode_tokens_per_s * 4),
               generate_ragged=dict(prompt_lens=[len(r) for r in ragged], ttft_s=res_r.ttft_s,
                                    decode_tok_s_per_seq=res_r.decode_tokens_per_s),
               stream_tokens=len(streamed), captured_equals_eager=identical, drops=drops,
               teacher_forced=forced, gated_on_teacher_forcing=gate,
               ok=all(identical.values()) and (not gate or all(v["ok"] for v in forced.values())))
    return out, gen


def moe_at_once(torch, params, cfg, leg: str, sampler: str, trace: list[dict],
                gate: bool) -> dict:
    """The trace's requests submitted at once (so both runs tick alike)
    through a captured engine and an eager one (``graphs.eager_steps``):
    identical tokens required.  The eager run records its routes and
    drops; a greedy unified tick's requests are then held by
    ``pinned_forced`` (a gate where ``gate``)."""
    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.models.transformer import forward

    def serve_all(eng, ticks: list | None = None):
        """Every request to its end; ``ticks`` gets each unified tick's
        packed segments."""
        for j, item in enumerate(trace):
            eng.submit(item["prompt"], item["max_new_tokens"], seed=j)
        while True:
            last = eng.tick_segments
            more = eng.step()
            if ticks is not None and eng.tick_segments is not last:  # a tick was packed
                ticks.append(eng.tick_segments)
            if not more:
                return {r.req_id: list(r.generated) for r in eng.scheduler.finished}

    ticks: list = []
    with graphs.eager_steps():
        eager = serve_engine(params, cfg, torch.bfloat16, leg, sampler=sampler)
        with RouteLog(torch, cfg.num_hidden_layers) as log:
            want = serve_all(eager, ticks)
    eng = serve_engine(params, cfg, torch.bfloat16, leg, sampler=sampler)
    g0 = graph_totals()
    got = serve_all(eng)
    run = graph_delta(g0)
    out = dict(leg=leg, sampler=sampler, capacity_factor=cfg.moe_capacity_factor,
               requests=len(trace), graphs_run=run, drops=log.drops(),
               identical=got == want and len(got) == len(trace) and run["replays"] > 0,
               gated_on_teacher_forcing=gate)
    if eager.mixed and sampler == "greedy":
        dev = torch.device("cuda")
        out["teacher_forced"] = merge_forced([pinned_forced(
            torch, forward, params, cfg, torch.as_tensor(r.prompt, device=dev)[None],
            torch.tensor(r.generated, device=dev)[None],
            request_routes(torch, log, ticks, r), MOE_TEACHER_TOL, router_tol=MOE_ROUTER_TOL)
            for r in eager.scheduler.finished])
    out["ok"] = out["identical"] and (not gate or out["teacher_forced"]["ok"])
    del eng, eager, log, ticks
    torch.cuda.empty_cache()
    return out


def moe_profile(torch, gen, params, cfg, prompts) -> dict:
    """torch.profiler over one 4 x 128-token prefill (flash) and one B=4
    decode step (the decode kernel and the fused epilogue), both eager so
    that the layer's own ``record_function`` ranges (``ops/moe.py``)
    split its device time: routing (router product, softmax, top-k,
    scatter), slot positions, dispatch, expert products, combine; then
    the attention kernels and the epilogue, and the busy share; then the
    captured ``generate``'s busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llm_np_cp_tpu_torch.cache import KVCache, align_capacity
    from llm_np_cp_tpu_torch.models import transformer

    markers = {"attention_kernels": ("flash_kernel", "decode_kernel", "combine_splits"),
               "epilogue": ("epilogue_",)}
    names = ["moe.routing", "moe.positions", "moe.dispatch", "moe.experts", "moe.combine"]

    def split(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        parts = {n: 0.0 for n in names}
        kernels_ms, by_marker = 0.0, {k: 0.0 for k in markers}
        for e in prof.key_averages():
            if e.key in parts and e.device_type == DeviceType.CPU:
                parts[e.key] += (getattr(e, "device_time_total", 0) or 0) / 1e3
            dev_us = getattr(e, "self_device_time_total", 0) or 0
            if e.device_type == DeviceType.CUDA and dev_us > 0 and e.key not in parts:
                kernels_ms += dev_us / 1e3
                for k, ms in markers.items():
                    if any(m in e.key for m in ms):
                        by_marker[k] += dev_us / 1e3
        parts.update(by_marker)
        parts["other"] = kernels_ms - sum(parts.values())
        return dict(wall_s=wall, device_busy_ms=kernels_ms,
                    device_busy_share=kernels_ms / 1e3 / wall, device_ms=parts)

    ids = torch.as_tensor(prompts, device="cuda")
    b, s = ids.shape
    cap = align_capacity(s + 8)

    def prefill():
        cache = KVCache.init(cfg, b, cap, torch.bfloat16, device="cuda")
        h, cache = transformer.forward(params, ids, cfg, cache, attn_impl="flash",
                                       skip_logits=True, logits_last_only=True)
        return transformer.sample_epilogue_tail(params, h[:, -1], cfg), cache

    prefill()  # warm-up
    pre = split(prefill)
    tok, cache = prefill()

    def decode():
        h, _ = transformer.forward(params, tok[:, None], cfg, cache, attn_impl="flash_decode",
                                   skip_logits=True, logits_last_only=True)
        return transformer.sample_epilogue_tail(params, h[:, -1], cfg)

    decode()  # warm-up (the cache advances one slot a call)
    dec = split(decode)
    gen.generate(prompts, 2)
    captured = profile_run(torch, lambda: gen.generate(prompts, 16), {
        "flash_attention": "flash_kernel", **DECODE_MARKERS, "sample_epilogue": "epilogue_"})
    return dict(prefill=dict(batch=b, prompt_len=s, **pre), decode_step=dict(batch=b, **dec),
                captured_generate=dict(new_tokens=16, **{k: captured[k] for k in (
                    "wall_s", "device_busy_s", "device_busy_share", "port_kernels_device_ms")}))


def moe_phase(torch, np, kernels: dict, card: str) -> dict:
    """Mixtral-8x7B's widths at MOE_LAYERS layers on seeded random bf16
    weights, through the Generator, the ServeEngine (unified and phase-split ticks,
    min-p) and the four weight modes; see the module docstring, 12."""
    import dataclasses

    from llm_np_cp_tpu_torch import graphs
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.quant import param_bytes, quantize_params

    t_phase = time.perf_counter()
    cfg = moe_config()
    nodrop = dataclasses.replace(cfg, moe_capacity_factor=MOE_NO_DROP)
    layers = cfg.num_hidden_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(0, cfg, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init = dict(s=time.perf_counter() - t0, param_bytes=param_bytes(params),
                peak_reserved_bytes=torch.cuda.max_memory_reserved())
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 128))
    ragged = [rng.integers(0, cfg.vocab_size, size=n) for n in (37, 128, 80, 101)]
    dev = torch.device("cuda")
    checks = {}

    # offline without drops: tokens held by route-pinned teacher forcing
    off_nodrop, gen = moe_offline(torch, np, kernels, params, nodrop, prompts, ragged, gate=True)
    del gen
    checks["offline_no_drop"] = off_nodrop["ok"]
    # the check must catch a model whose expert 0 has no down projection
    caught = zeroed_expert_fault(torch, forward, params, nodrop, prompts, MOE_TEACHER_TOL,
                                 MOE_ROUTER_TOL)
    checks["zeroed_expert_caught"] = caught["caught"]

    # offline at the published capacity 2.0: the timed run; captured
    # against eager steps gated, route-pinned teacher forcing recorded
    off, gen = moe_offline(torch, np, kernels, params, cfg, prompts, ragged, gate=False)
    checks["offline_captured_equals_eager"] = all(off["captured_equals_eager"].values())
    prof = moe_profile(torch, gen, params, cfg, prompts)
    del gen
    torch.cuda.empty_cache()

    # serve: the serve phase's trace through legs A, B and A with min-p at
    # 2.0 (timed replays); their tokens checked on the requests submitted
    # at once, and leg A's without drops too (captured == eager; leg A's
    # route-pinned teacher forcing, gated without drops)
    trace = serve_trace(np, cfg, SERVE_REQUESTS, SERVE_NEW_TOKENS, seed=0)
    runs = {"A_mixed": (cfg, "A_mixed", "greedy"), "B_split_paged": (cfg, "B_split_paged", "greedy"),
            "A_min_p": (cfg, "A_mixed", "min_p"), "A_mixed_no_drop": (nodrop, "A_mixed", "greedy")}
    legs = {}
    for name, (c, leg, sampler) in runs.items():
        if c is cfg:
            legs[name] = dict(timed_serve_leg(torch, kernels, params, c, f"moe {name}", leg,
                                              trace, sampler=sampler)[0],
                              capacity_factor=c.moe_capacity_factor)
            torch.cuda.empty_cache()
    at_once = {name: moe_at_once(torch, params, c, leg, sampler, trace, gate=c is nodrop)
               for name, (c, leg, sampler) in runs.items()}
    for name, v in at_once.items():
        checks[f"serve_at_once_{name}"] = v["ok"]

    # quant: the four weight modes at the same depth without drops (timed
    # captured run, then eager with routes recorded: identical tokens and
    # route-pinned teacher forcing over the quantized params); one int8
    # unified-tick replay at 2.0
    modes, steps = {}, DECODE_STEPS - 1
    for mode, qkw in QUANT_MODES.items():
        torch.cuda.reset_peak_memory_stats()
        qp = quantize_params(params, **qkw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_reserved()

        def make():
            return Generator(qp, nodrop, sampler=Sampler("greedy"), prefill_attn_impl="flash",
                             decode_attn_impl="flash_decode")

        gen = make()
        gen.generate(prompts, 4)
        torch.cuda.synchronize()
        reset_counts(kernels)
        g0 = graph_totals()
        res = gen.generate(prompts, DECODE_STEPS)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        check_replayed(f"moe quant {mode}", graph_delta(g0), steps)
        want = {name: 0 for name in kernels}
        want.update(flash_attention=layers, decode_attention=layers * steps,
                    decode_attention_combine=layers * steps * combines(
                        torch, cfg, 4, 128 + DECODE_STEPS),
                    sample_epilogue_int8=steps)
        if launches != want:
            raise AssertionError(f"moe quant {mode}: launch counts {launches} != implied {want}")
        with graphs.eager_steps(), RouteLog(torch, layers) as log:
            eager = make().generate(prompts, DECODE_STEPS).tokens
        a8 = qkw["act_quant"]
        tf = pinned_forced(torch, forward, qp, nodrop, torch.as_tensor(prompts, device=dev),
                           torch.as_tensor(res.tokens, device=dev), batch_routes(torch, log, 4),
                           A8_TEACHER_TOL if a8 else MOE_TEACHER_TOL,
                           router_tol=MOE_A8_ROUTER_TOL if a8 else MOE_ROUTER_TOL, twin=True)
        del log
        modes[mode] = dict(launches=launches, implied=want, param_bytes=param_bytes(qp),
                           peak_reserved_bytes_quantizing=peak, ttft_s=res.ttft_s,
                           decode_tok_s_per_seq=res.decode_tokens_per_s,
                           decode_tok_s=res.decode_tokens_per_s * 4,
                           captured_equals_eager=bool((eager == res.tokens).all()),
                           teacher_forced=tf)
        checks[f"quant_{mode}"] = tf["ok"] and modes[mode]["captured_equals_eager"]
        if mode == "int8_a8":  # the W8A8 limits must catch the fault too
            fault = zeroed_expert_fault(torch, forward, qp, nodrop, prompts, A8_TEACHER_TOL,
                                        MOE_A8_ROUTER_TOL)
            modes[mode]["zeroed_expert_fault"] = fault
            checks["zeroed_expert_caught_int8_a8"] = fault["caught"]
        if mode == "int8":  # the int8 head: the epilogue's int8 variant
            int8_serve = timed_serve_leg(torch, kernels, qp, cfg, "moe int8 A_mixed", "A_mixed",
                                         trace, epilogue="sample_epilogue_int8")[0]
            torch.cuda.empty_cache()
        del gen, qp
        torch.cuda.empty_cache()

    # float32 at MOE_F32_LAYERS layers without drops: legs A and B equal the
    # offline generate_ragged token for token, or part at a near-tie
    f32cfg = dataclasses.replace(nodrop, num_hidden_layers=MOE_F32_LAYERS)
    p32 = {k: ({n: t[:MOE_F32_LAYERS].float() for n, t in v.items()} if k == "layers"
               else v.float()) for k, v in params.items()}
    del params
    torch.cuda.empty_cache()
    trace32 = serve_trace(np, f32cfg, F32_SERVE_REQUESTS, F32_SERVE_TOKENS, seed=1)
    got32 = {}
    for leg in SERVE_LEGS:
        eng = serve_engine(p32, f32cfg, torch.float32, leg)
        eng.replay_trace(trace32)
        got32[leg] = {r.seed: list(r.generated) for r in eng.scheduler.finished}
        del eng
    gen32 = Generator(p32, f32cfg, sampler=Sampler("greedy"), prefill_attn_impl="xla",
                      decode_attn_impl="flash_decode", cache_dtype=torch.float32)
    identical, gaps = 0, []
    for item in trace32:
        want_t = [int(t) for t in gen32.generate_ragged([item["prompt"]], F32_SERVE_TOKENS).tokens[0]]
        seqs = [got32[leg].get(item["seed"]) for leg in SERVE_LEGS]
        if any(s is None for s in seqs):
            raise AssertionError(f"moe float32 serve run lost request {item['seed']}")
        divs = [first_divergence(torch, forward, p32, f32cfg, item["prompt"], s, want_t)
                for s in seqs]
        divs.append(first_divergence(torch, forward, p32, f32cfg, item["prompt"], *seqs))
        divs = [d for d in divs if d is not None]
        identical += not divs
        gaps += divs
    f32 = dict(layers=MOE_F32_LAYERS, capacity_factor=MOE_NO_DROP,
               requests=F32_SERVE_REQUESTS, new_tokens=F32_SERVE_TOKENS,
               identical_across_legs_and_offline=identical, divergence_top2_gaps=gaps,
               tol=F32_TEACHER_TOL, ok=all(g <= F32_TEACHER_TOL for g in gaps))
    checks["float32_legs_equal_offline"] = f32["ok"]
    del p32, gen32
    torch.cuda.empty_cache()
    counted = ([off_nodrop["launches"], off["launches"], int8_serve["launches"]]
               + [v["launches"] for v in legs.values()] + [v["launches"] for v in modes.values()])
    launches_total = {name: sum(c[name] for c in counted) for name in kernels}
    return dict(phase="moe", model=MOE_MODEL, layers=MOE_LAYERS,
                reduced=f"depth 32 -> {MOE_LAYERS} layers",
                weights="seeded random bf16 (init_params, std 0.02)", card=card,
                config=dict(hidden=cfg.hidden_size, intermediate=cfg.intermediate_size,
                            heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
                            head_dim=cfg.head_dim, vocab=cfg.vocab_size,
                            experts=cfg.num_local_experts, top_k=cfg.num_experts_per_tok,
                            capacity_factor=cfg.moe_capacity_factor,
                            group_size=cfg.moe_group_size, no_drop_capacity=MOE_NO_DROP),
                init=init, offline_no_drop=off_nodrop, zeroed_expert_fault=caught, offline=off,
                serve=dict(trace=dict(requests=SERVE_REQUESTS, rate_rps=40.0,
                                      prompt_len=SERVE_PROMPTS, new_tokens=SERVE_NEW_TOKENS),
                           legs=legs, at_once=at_once),
                quant=dict(modes=modes, serve_int8=int8_serve), float32=f32, profile=prof,
                teacher_tol=MOE_TEACHER_TOL, router_tol=MOE_ROUTER_TOL,
                a8_teacher_tol=A8_TEACHER_TOL, a8_router_tol=MOE_A8_ROUTER_TOL,
                launches_total=launches_total, checks=checks,
                phase_s=time.perf_counter() - t_phase, ok=all(checks.values()))

# the train phase: Llama-3.2-1B at full width and depth in float32 (the
# training CLI's default dtype) on seeded weights, 8 x 128 tokens of the
# fixed synthetic corpus, through the user's entry point
# (``train.run``), then the library's pieces for the device time split
# and the checkpoint round trip.  The mesh phase's training legs take
# the same weights, batches and learning rate.
TRAIN_PRESET = "llama1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, TRAIN_SEED = 8, 128, 6, 1e-4, 0
TRAIN_ARGV = [f"--model={TRAIN_PRESET}", f"--batch={TRAIN_BATCH}", f"--seq-len={TRAIN_SEQ}",
              f"--steps={TRAIN_STEPS}", f"--lr={TRAIN_LR}", f"--seed={TRAIN_SEED}",
              "--dtype=f32", "--device=cuda"]
# the checkpoint is written after this many steps of the split run, and
# the next step taken from the continued and the restored state
TRAIN_CKPT_AFTER = 4
# the resumed step's loss against the continued one's: the embedding's
# backward sums float32 with atomics on the card, so two runs of one
# step may differ in the last bits
TRAIN_RESUME_RTOL = 1e-6
TRAIN_DIR = os.path.join(ROOT, "smoke_out", "train")
# float32 outside the tensor cores: the plain float32 products' peak
F32_TFLOPS = F32_FLOPS_PER_S / 1e12


def train_batches(vocab: int) -> list:
    """The train phase's batches: ``train._batches``' synthetic corpus
    for these settings (what ``train.run`` draws)."""
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch import train

    args = SimpleNamespace(data=None, seed=TRAIN_SEED, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    gen = train._batches(args, None, vocab)
    return [next(gen) for _ in range(TRAIN_STEPS)]


def train_flops(cfg, n_params: int) -> float:
    """The operations of one training step: 6 · params · tokens (forward
    and backward products) plus attention's scores and weighted sums
    (4 · B · heads · S² · D a layer forward, three times that with the
    backward; the plain path computes the whole square)."""
    s = TRAIN_SEQ - 1
    tokens = TRAIN_BATCH * s
    attn = 12 * cfg.num_hidden_layers * TRAIN_BATCH * cfg.num_attention_heads * s * s \
        * cfg.head_dim
    return 6.0 * n_params * tokens + attn


def train_phase(torch, np, kernels: dict, card: str) -> dict:
    """Training on the card (phase 12b of the module docstring)."""
    import contextlib
    import gc
    import io
    import math
    import re
    import shutil

    from llm_np_cp_tpu_torch import train
    from llm_np_cp_tpu_torch.config import LLAMA_3_2_1B
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.utils.checkpoint import (
        STATE_FILE,
        restore_checkpoint,
        save_checkpoint,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = LLAMA_3_2_1B
    checks: list[str] = []
    # 1. the entry point
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        losses = train.run(TRAIN_ARGV)
    run_s = time.perf_counter() - t0
    peak_reserved = torch.cuda.max_memory_reserved()
    launches = read_counts(kernels)
    printed = err.getvalue()
    print(printed, end="", flush=True)
    tok_s = [float(m.replace(",", "")) for m in re.findall(r"([\d,]+) tok/s", printed)]
    ln_vocab = math.log(cfg.vocab_size)
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        checks.append(f"train.run losses {losses}")
    if not losses[-1] < losses[0]:
        checks.append(f"train.run loss did not fall: {losses}")
    if abs(losses[0] - ln_vocab) > 0.5:
        checks.append(f"first loss {losses[0]} far from ln(vocab) {ln_vocab}")
    if any(launches.values()):
        checks.append(f"kernels launched on the training path: {launches}")
    print(f"train: first loss {losses[0]:.4f} against ln({cfg.vocab_size}) = {ln_vocab:.4f}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the same weights and batches through the library's pieces
    params = init_params(TRAIN_SEED, cfg, torch.float32, device="cuda")
    n_params = sum(t.numel() for _, t in train.tree_leaves(params))
    opt = train.default_optimizer(TRAIN_LR)
    state = opt.init(params)
    batches = [torch.as_tensor(b, device="cuda") for b in train_batches(cfg.vocab_size)]
    step = train.make_train_step(cfg, opt, device="cuda")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def loss_fn(p, b):
        loss = train.causal_lm_loss(p, b, cfg, device="cuda")
        ev[1].record()
        return loss

    split, split_losses = [], []
    for i in range(TRAIN_CKPT_AFTER):
        ev[0].record()
        loss, grads = train.loss_and_grads(loss_fn, params, batches[i])
        ev[2].record()
        opt.update(grads, state, params)
        ev[3].record()
        del grads
        ev[3].synchronize()
        split_losses.append(float(loss))
        split.append(dict(forward_ms=ev[0].elapsed_time(ev[1]),
                          backward_ms=ev[1].elapsed_time(ev[2]),
                          optimizer_ms=ev[2].elapsed_time(ev[3]),
                          step_ms=ev[0].elapsed_time(ev[3])))
    if not np.allclose(split_losses, losses[:TRAIN_CKPT_AFTER], rtol=1e-5, atol=0):
        checks.append(f"library steps {split_losses} != train.run's {losses[:TRAIN_CKPT_AFTER]}")
    # the steps after the first (its cuBLAS and allocator warm-up)
    steady = split[1:]
    med = {k: float(np.median([s[k] for s in steady])) for k in steady[0]}
    flops = train_flops(cfg, n_params)
    tflops = flops / (med["step_ms"] / 1e3) / 1e12

    # 3. the checkpoint round trip of the whole state after step 4
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    state_bytes = sum(t.numel() * t.element_size() for tree in (params, state["mu"], state["nu"])
                      for _, t in train.tree_leaves(tree))
    os.makedirs(TRAIN_DIR, exist_ok=True)
    disk_free = shutil.disk_usage(TRAIN_DIR).free
    if disk_free < state_bytes * 1.1:
        raise RuntimeError(f"train phase: {disk_free} bytes free under {TRAIN_DIR}, the "
                           f"checkpoint needs {state_bytes}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint(TRAIN_DIR, {"params": params, "opt_state": state,
                                "step": TRAIN_CKPT_AFTER})
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(TRAIN_DIR, STATE_FILE))
    t0 = time.perf_counter()
    restored = restore_checkpoint(TRAIN_DIR, like={"params": params, "opt_state": state,
                                                   "step": 0})
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if restored["step"] != TRAIN_CKPT_AFTER or restored["opt_state"]["count"] != TRAIN_CKPT_AFTER:
        checks.append(f"restored step / count {restored['step']} / "
                      f"{restored['opt_state']['count']}")
    _, _, loss_c = step(params, state, batches[TRAIN_CKPT_AFTER])
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    _, _, loss_r = step(restored["params"], restored["opt_state"], batches[TRAIN_CKPT_AFTER])
    loss_c, loss_r = float(loss_c), float(loss_r)
    resume_rel = abs(loss_r - loss_c) / abs(loss_c)
    if not resume_rel <= TRAIN_RESUME_RTOL:
        checks.append(f"resumed step loss {loss_r} vs continued {loss_c}")
    del restored
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train: step split (median of steps 2-{TRAIN_CKPT_AFTER}) {med}; "
          f"{tflops:.2f} TFLOP/s of {F32_TFLOPS:.0f} (float32); checkpoint {nbytes} bytes, "
          f"write {write_s:.2f} s, read {read_s:.2f} s; {card}", flush=True)
    return dict(phase="train", model="meta-llama/Llama-3.2-1B", preset=TRAIN_PRESET,
                layers=cfg.num_hidden_layers, dtype="float32", weights="seeded random float32",
                card=card, argv=TRAIN_ARGV, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                tokens_per_step=TRAIN_BATCH * (TRAIN_SEQ - 1), losses=losses, tok_s=tok_s,
                first_loss=losses[0], ln_vocab=ln_vocab, run_s=run_s,
                peak_reserved_bytes=peak_reserved, launches=launches,
                split_losses=split_losses, split_ms=split, split_ms_median=med,
                n_params=n_params, flops_per_step=flops, tflops=tflops,
                tflops_peak_f32=F32_TFLOPS,
                checkpoint=dict(after_step=TRAIN_CKPT_AFTER, file_bytes=nbytes,
                                state_bytes=state_bytes, disk_free_bytes=disk_free,
                                write_s=write_s, read_s=read_s,
                                read_note="warm: the file was just written",
                                loss_continued=loss_c, loss_restored=loss_r,
                                rel_diff=resume_rel, rtol=TRAIN_RESUME_RTOL),
                checks=checks, phase_s=time.perf_counter() - t_phase, ok=not checks)


# the mesh phase: generation over a 4-rank mesh on this one card.  The
# ranks are processes on cuda:0 joined over gloo, whose collectives stage
# every CUDA tensor through host memory (NCCL will not put two ranks on
# one GPU), so its times are one card shared by 4 ranks, not a multi-GPU
# figure.  Llama-3.2-1B at full widths and depth on the main path's
# seeded bf16 weights.  Leg a: seq 2 x model 2, ring prefill of a
# 2047-token prompt (the seq axis pads it to 2048) and 32 greedy tokens;
# leg b: data 2 x model 2 at B=4 x 128-token prompts, greedy and min-p;
# leg c: leg b's greedy run on int8 weights.
MESH_RANKS = 4
MESH_LEGS = {
    "a_seq2_model2_ring": dict(plan=dict(seq=2, model=2), batch=1, prompt=2047, new=32,
                               sampler=dict(kind="greedy"), prefill="ring"),
    "b_data2_model2_greedy": dict(plan=dict(data=2, model=2), batch=4, prompt=128, new=32,
                                  sampler=dict(kind="greedy"), prefill="flash"),
    "b_data2_model2_min_p": dict(plan=dict(data=2, model=2), batch=4, prompt=128, new=32,
                                 sampler=dict(kind="min_p", p_base=0.1), prefill="flash",
                                 seed=5),
    "c_data2_model2_int8": dict(plan=dict(data=2, model=2), batch=4, prompt=128, new=32,
                                sampler=dict(kind="greedy"), prefill="flash", quantize=8),
}
MESH_WARMUP_TOKENS = 2
MESH_TIMEOUT_S = 900.0
# the mesh phase's serve legs, in the same group of ranks: the
# tensor-parallel ServeEngine at model=4 (8 of 32 query heads, 2 of 8 KV
# heads and a 32064-row vocab shard a rank: kv-sharded), the serve
# phase's pool geometry (8 slots, 16-slot blocks, 64-token chunks) and
# seeded prompts of 64-256 tokens, 32 new tokens each.  s1: the unified
# tick, greedy, 16 requests cycling 8 prompts with the prefix cache on;
# s2: the phase-split tick with the paged decode over an int8 pool, 8
# requests
MESH_SERVE_PLAN = dict(model=4)
MESH_SERVE_PROMPTS, MESH_SERVE_NEW, MESH_SERVE_RATE = (64, 256), 32, 40.0
MESH_SERVE_LEGS = {
    "s1_unified_prefix": dict(leg="A_mixed", cache="bfloat16", requests=16, distinct=8,
                              seed=61, extra=dict(enable_prefix_cache=True)),
    "s2_split_paged_int8": dict(leg="B_split_paged", cache="int8", requests=8, seed=62,
                                extra={}),
}
# the mesh phase's training legs, last in the same group: the train
# phase's float32 weights, batches and learning rate, 2 steps each.  t1:
# data 2 x model 2; t2: pipe 2 x model 2, GPipe with 2 microbatches of 4
# rows (8 of 16 layers a stage)
MESH_TRAIN_LEGS = {
    "t1_data2_model2": dict(plan=dict(data=2, model=2)),
    "t2_pipe2_model2": dict(plan=dict(pipe=2, model=2), microbatches=2),
}
MESH_TRAIN_STEPS = 2
MESH_TRAIN_RTOL = 2e-4  # tests/test_train_cli.py's mesh tolerance
# a sampled draw whose margin (``draw_margins``, over the plain forward's
# logits) is under this may go either way between the mesh and the
# one-rank path: their bf16 logits differ by summation order, within the
# teacher-forced tolerance of the plain forward
MESH_NEAR_TIE = TEACHER_TOL


def mesh_prompts(np, cfg, leg: dict):
    """A leg's prompts [B, S], seeded by its shape."""
    rng = np.random.default_rng(1000 + leg["prompt"] + leg["batch"])
    return rng.integers(0, cfg.vocab_size, size=(leg["batch"], leg["prompt"]))


def mesh_counters() -> dict:
    """The mesh path's launch counters: name → (wrapper, attribute)."""
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa
    from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se
    from llm_np_cp_tpu_torch.ops.cuda import threefry as tfk

    return {"flash_attention": (fa.flash_attention, "launches"),
            "decode_attention": (da.decode_attention, "launches"),
            "decode_attention_combine": (da.decode_attention, "combine_launches"),
            "sample_epilogue": (se.sample_epilogue, "launches"),
            "sample_epilogue_int8": (se.sample_epilogue, "launches_int8"),
            "threefry2x32": (tfk.threefry2x32, "launches"),
            "categorical": (tfk.categorical, "launches")}


def mesh_serve_counters() -> dict:
    """The serve legs' launch counters: name → (wrapper, attribute)."""
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se

    return {"ragged_paged_attention": (da.ragged_paged_attention, "launches"),
            "ragged_paged_attention_combine": (da.ragged_paged_attention, "combine_launches"),
            "paged_decode_attention": (da.paged_decode_attention, "launches"),
            "paged_decode_attention_combine": (da.paged_decode_attention, "combine_launches"),
            "sample_epilogue": (se.sample_epilogue, "launches"),
            "sample_epilogue_int8": (se.sample_epilogue, "launches_int8")}


def mesh_serve_trace(np, cfg, leg: dict) -> list[dict]:
    from llm_np_cp_tpu_torch.serve import poisson_trace

    return poisson_trace(np.random.default_rng(leg["seed"]), leg["requests"],
                         rate_rps=MESH_SERVE_RATE, prompt_len_range=MESH_SERVE_PROMPTS,
                         max_new_tokens=MESH_SERVE_NEW, vocab_size=cfg.vocab_size,
                         distinct_prompts=leg.get("distinct"))


def mesh_serve_engine(torch, params, cfg, leg: dict, **extra):
    """A serve leg's engine (``serve_engine``'s geometry); ``extra``:
    ``mesh_plan=`` in a rank."""
    return serve_engine(params, cfg, getattr(torch, leg["cache"]), leg["leg"],
                        MESH_SERVE_PROMPTS[1], MESH_SERVE_NEW, **leg["extra"], **extra)


def mesh_serve_rank(torch, np, full, cfg) -> dict:
    """The serve legs on this rank: ``ServeEngine(mesh_plan=model 4)`` over
    the full seeded weights (it cuts its own shards), a warm-up, then the
    counted replay of the leg's trace.  Returns each leg's tokens by
    request seed, this rank's launches, collective calls, graph counts,
    dispatching steps and the combines they imply, ``shard_stats``, TTFT
    / TPOT / tok/s (one card shared by the ranks) and the wall."""
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.parallel import collectives
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan

    counters = mesh_serve_counters()
    out = {}
    for name, leg in MESH_SERVE_LEGS.items():
        eng = mesh_serve_engine(torch, full, cfg, leg, mesh_plan=MeshPlan(**MESH_SERVE_PLAN))
        eng.warmup([MESH_SERVE_PROMPTS[0]], 2)
        torch.cuda.synchronize()
        reset_counts(counters)
        collectives.reset_counts()
        g0, b0 = graph_totals(), dict(eng.bucket_dispatches)
        d0, dd0, f0 = eng.n_dispatches, eng.n_decode_dispatches, eng.n_host_fetches
        t0 = time.perf_counter()
        snap = eng.replay_trace(mesh_serve_trace(np, cfg, leg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.n_dispatches - d0 if eng.mixed else eng.n_decode_dispatches - dd0
        heads = cfg.num_attention_heads // MESH_SERVE_PLAN["model"]
        kh = eng.pool.kv_heads
        if eng.mixed:
            combines = ragged_combines(torch, da, eng, cfg, b0, heads=heads)
        else:
            nsplit = da.split_plan(eng.scheduler.max_slots, kh,
                                   eng.max_blocks_per_seq * SERVE_BLOCK, cfg.head_dim,
                                   da.sm_count(torch.device("cuda")), heads // kh)
            combines = cfg.num_hidden_layers * steps * int(nsplit > 1)
        out[name] = dict(
            tokens={r.seed: list(r.generated) for r in eng.scheduler.finished},
            finished=snap["finished"], launches=read_counts(counters),
            collectives=collectives.counts(), graphs=graph_delta(g0),
            compile_counts=eng.compile_counts(), steps=steps, combines=combines,
            host_fetches=eng.n_host_fetches - f0, mixed=eng.mixed,
            epilogue=eng.epilogue_impl, mesh_desc=eng.mesh_desc,
            shard_stats=eng.pool.shard_stats(), wall_s=wall, ticks=snap["ticks"],
            tok_s=snap["total_generated_tokens"] / wall,
            prefix_blocks_hit=snap["prefix_blocks_hit"],
            **{k: snap.get(k) for k in ("ttft_s_p50", "ttft_s_p99", "tpot_s_p50",
                                        "tpot_s_p99")})
        del eng
        torch.cuda.empty_cache()
    return out


def mesh_train_rank(torch, np, dev) -> dict:
    """The training legs on this rank: its shards of the train phase's
    float32 weights, ``make_train_step(mesh=)`` or ``make_pp_train_step``
    over a gloo mesh on cuda:0, ``MESH_TRAIN_STEPS`` steps on the train
    phase's batches.  Returns each leg's losses, step walls, collective
    calls and peak allocated bytes."""
    import torch.distributed as dist

    from llm_np_cp_tpu_torch import train
    from llm_np_cp_tpu_torch.config import LLAMA_3_2_1B
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.parallel import collectives
    from llm_np_cp_tpu_torch.parallel.pipeline import make_pp_train_step
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan, make_mesh, shard_params

    cfg = LLAMA_3_2_1B
    batches = train_batches(cfg.vocab_size)[:MESH_TRAIN_STEPS]
    out = {}
    for name, leg in MESH_TRAIN_LEGS.items():
        mesh = make_mesh(MeshPlan(**leg["plan"]), device=dev, backend="gloo")
        full = init_params(TRAIN_SEED, cfg, torch.float32, device=dev)
        local = shard_params(full, cfg, mesh.plan, mesh)
        del full
        torch.cuda.empty_cache()
        dist.barrier()  # no rank trains while another still holds the whole model
        opt = train.default_optimizer(TRAIN_LR)
        state = opt.init(local)
        if mesh.plan.pipe > 1:
            step = make_pp_train_step(cfg, opt, mesh.plan, mesh,
                                      num_microbatches=leg["microbatches"])
        else:
            step = train.make_train_step(cfg, opt, mesh=mesh)
        collectives.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, walls = [], []
        for b in batches:
            t0 = time.perf_counter()
            local, state, loss = step(local, state, torch.as_tensor(b, device=dev))
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
        out[name] = dict(losses=losses, step_s=walls, collectives=collectives.counts(),
                         coords=mesh.coords,
                         peak_allocated_bytes=torch.cuda.max_memory_allocated(dev))
        del local, state, step
        torch.cuda.empty_cache()
    return out


def mesh_rank(rank: int, legs: dict) -> dict:
    """One rank of the mesh phase, a spawned process on cuda:0 over gloo:
    per leg its mesh, its shards of the seeded weights and a
    ``Generator(mesh=)``; a short warm-up run, then the counted run.
    Returns each leg's tokens (the whole batch's), TTFT, decode rate,
    wall, this rank's kernel launches and collective calls; then the
    serve legs (``mesh_serve_rank``) under ``"serve"``."""
    import numpy as np
    import torch

    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.parallel import collectives
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan, make_mesh, shard_params
    from llm_np_cp_tpu_torch.quant import quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    full = init_params(0, cfg, torch.bfloat16, device=dev)
    counters = mesh_counters()
    out = {}
    for name, leg in legs.items():
        params = quantize_params(full, bits=leg["quantize"]) if leg.get("quantize") else full
        mesh = make_mesh(MeshPlan(**leg["plan"]), device=dev, backend="gloo")
        local = shard_params(params, cfg, mesh.plan, mesh)
        del params
        gen = Generator(local, cfg, sampler=Sampler(**leg["sampler"]),
                        prefill_attn_impl=leg["prefill"], decode_attn_impl="flash_decode",
                        mesh=mesh)
        prompts = mesh_prompts(np, cfg, leg)
        seed = leg.get("seed", 0)
        gen.generate(prompts, MESH_WARMUP_TOKENS, seed=seed)
        reset_counts(counters)
        collectives.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = gen.generate(prompts, leg["new"], seed=seed)
        torch.cuda.synchronize()
        out[name] = dict(tokens=res.tokens.tolist(), ttft_s=res.ttft_s,
                         decode_tok_s_per_seq=res.decode_tokens_per_s,
                         wall_s=time.perf_counter() - t0, steps=res.steps,
                         launches=read_counts(counters), collectives=collectives.counts(),
                         compile_counts=gen.compile_counts(), epilogue=gen.epilogue_impl,
                         coords=mesh.coords, backend=mesh.backend,
                         peak_allocated_bytes=torch.cuda.max_memory_allocated(dev))
        del gen, local
        torch.cuda.empty_cache()
    out["serve"] = mesh_serve_rank(torch, np, full, cfg)
    del full
    torch.cuda.empty_cache()
    out["train"] = mesh_train_rank(torch, np, dev)
    return out


def mesh_implied(torch, cfg, leg: dict) -> dict:
    """The launches one rank's counted run implies: a flash prefill
    launches once a layer, every decode step the slab kernel once a layer
    (and its combine where the rank's split plan splits), the greedy tail
    the (float or int8) epilogue once a step, min-p the categorical once a
    token (the prefill's draw and each step's)."""
    from llm_np_cp_tpu_torch.cache import align_capacity
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da

    plan = leg["plan"]
    tp, dp = plan.get("model", 1), plan.get("data", 1)
    layers, steps = cfg.num_hidden_layers, leg["new"] - 1
    b = leg["batch"] // dp if leg["batch"] % dp == 0 else leg["batch"]
    kh = cfg.num_key_value_heads // tp
    nsplit = da.split_plan(b, kh, align_capacity(leg["prompt"] + leg["new"]), cfg.head_dim,
                           da.sm_count(torch.device("cuda")), cfg.num_query_groups)
    greedy = leg["sampler"]["kind"] == "greedy"
    epi = "sample_epilogue_int8" if leg.get("quantize") else "sample_epilogue"
    want = {name: 0 for name in mesh_counters()}
    want.update(flash_attention=layers if leg["prefill"] == "flash" else 0,
                decode_attention=layers * steps,
                decode_attention_combine=layers * steps * int(nsplit > 1))
    if greedy:
        want[epi] = steps
    else:
        want["categorical"] = leg["new"]
        want["threefry2x32"] = 2  # the prefill's and the loop's keys
    return want


def draw_margins(torch, sampler, g, logits):
    """How far the logits ``[N, V]`` of a Gumbel-max draw under noise ``g``
    may move before the draw can change, per row: the top-two gap of
    gumbel + filtered logits; for min-p also the distance to the keep
    threshold of the winner and of every masked token whose gumbel +
    logit beats it (either may fall on the other side of the threshold).
    Returns (margin, top-two gap)."""
    import math

    z = g + sampler.filtered_logits(logits)
    top2 = torch.topk(z, 2).values
    gap = top2[:, 0] - top2[:, 1]
    if sampler.kind != "min_p":
        return gap, gap
    lg = logits.float() / sampler.temperature
    d = (lg - (lg.amax(dim=-1, keepdim=True) + math.log(sampler.p_base))).abs()
    za = g + lg
    w = z.argmax(dim=-1, keepdim=True)
    beats = za > za.gather(-1, w)
    near = torch.where(beats, d, torch.inf).amin(dim=-1)
    return torch.minimum(gap, torch.minimum(near, d.gather(-1, w)[:, 0])), gap


def generator_margins(torch, forward, params, cfg, sampler, prompts, tokens, seed: int):
    """The margins ``[B, n]`` (``draw_margins``: the margin and the
    top-two gap) of each draw of ``Generator.generate`` that emitted
    ``tokens`` (one key over the whole batch: the prefill's ``k_pre``,
    step i's ``split(k_loop, n - 1)[i]``), over the plain cache-less
    forward's logits behind each token."""
    from llm_np_cp_tpu_torch import random as tr

    b, n = tokens.shape
    k_pre, k_loop = tr.split(tr.PRNGKey(seed, "cuda"))
    keys = [k_pre] + (list(tr.split(k_loop, n - 1)) if n > 1 else [])
    ids = torch.cat([torch.as_tensor(prompts, device="cuda"),
                     torch.as_tensor(tokens[:, :-1], device="cuda")], dim=1).long()
    logits, _ = forward(params, ids, cfg, None)
    rows = logits[:, prompts.shape[1] - 1:].float()
    del logits
    margins, gaps = [], []
    for t, key in enumerate(keys):
        m, gap = draw_margins(torch, sampler, tr.gumbel(key, (b, rows.shape[-1])), rows[:, t])
        margins.append(m.cpu())
        gaps.append(gap.cpu())
    return torch.stack(margins, dim=1).numpy(), torch.stack(gaps, dim=1).numpy()


def prefix_parity(want, got, margins, gaps, near_tie: float) -> dict:
    """Each row of ``got`` equal to that of ``want`` up to its first
    difference, which must fall on a draw whose margin along ``want`` is
    under ``near_tie``: the tokens compared, and per row where it parted,
    the margin and the top-two gap there."""
    rows, compared, ok = [], 0, True
    for w, g, m, gap in zip(want, got, margins, gaps):
        d = next((t for t, (x, y) in enumerate(zip(w, g)) if x != y), None)
        if d is None:
            rows.append(dict(parted_at=None, margin=None, top2_gap=None))
            compared += len(w)
            continue
        rows.append(dict(parted_at=d, margin=float(m[d]), top2_gap=float(gap[d])))
        compared += d
        ok = ok and bool(m[d] < near_tie)
    return dict(rows=rows, tokens_compared=compared, near_tie=near_tie, ok=ok)


def mesh_train_legs(torch, ranks: list, train_losses: list | None, checks: list) -> dict:
    """The training legs' record: the ranks' losses equal, within
    ``MESH_TRAIN_RTOL`` of the one-rank losses (the train phase's, or
    ``train.run``'s first steps here when the phase did not run)."""
    if train_losses is None:
        import contextlib
        import io

        from llm_np_cp_tpu_torch import train

        argv = [a for a in TRAIN_ARGV if not a.startswith("--steps=")]
        with contextlib.redirect_stderr(io.StringIO()):
            train_losses = train.run(argv + [f"--steps={MESH_TRAIN_STEPS}"])
        torch.cuda.empty_cache()
    want = train_losses[:MESH_TRAIN_STEPS]
    legs = {}
    for name, leg in MESH_TRAIN_LEGS.items():
        r0 = ranks[0]["train"][name]
        if any(r["train"][name]["losses"] != r0["losses"] for r in ranks[1:]):
            checks.append(f"mesh {name}: the ranks' losses differ: "
                          f"{[r['train'][name]['losses'] for r in ranks]}")
        rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], want)]
        if len(rel) != MESH_TRAIN_STEPS or max(rel) > MESH_TRAIN_RTOL:
            checks.append(f"mesh {name}: losses {r0['losses']} vs one rank's {want}")
        print(f"mesh {name}: losses {r0['losses']} against one rank's {want} "
              f"(relative {rel}); step walls {r0['step_s']} s", flush=True)
        legs[name] = dict(
            plan=leg["plan"], microbatches=leg.get("microbatches"), steps=MESH_TRAIN_STEPS,
            dtype="float32", losses=r0["losses"], one_rank_losses=want, rel_diff=rel,
            rtol=MESH_TRAIN_RTOL, step_s=r0["step_s"],
            timing_note=f"one card shared by {MESH_RANKS} ranks over gloo (host-staged "
                        "collectives): not a multi-GPU figure",
            ranks=[dict(coords=r["train"][name]["coords"],
                        collectives=r["train"][name]["collectives"],
                        peak_allocated_bytes=r["train"][name]["peak_allocated_bytes"])
                   for r in ranks])
    return legs


def mesh_phase(torch, np, card: str, train_losses: list | None = None) -> dict:
    """Generation over a mesh on the card: the four legs of ``MESH_LEGS``
    in one spawned group of ``MESH_RANKS`` ranks (``mesh_rank``), each
    leg's tokens held to the one-rank path (teacher forcing against the
    cache-less plain forward and its cached twin; min-p equal to the
    one-rank ``Generator``'s tokens up to a near-tie, and inside the
    sampler's support), its first divergence from the one-rank
    ``Generator`` printed, and every rank's launches equal to what the
    leg implies."""
    import gc
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.config import PRESETS
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.models.transformer import forward, init_params
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.parallel.launch import run_ranks
    from llm_np_cp_tpu_torch.quant import quantize_params

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = PRESETS["meta-llama/Llama-3.2-1B"]
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_RANKS, MESH_LEGS, backend="gloo",
                      timeout_s=MESH_TIMEOUT_S)
    group_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    full = init_params(0, cfg, torch.bfloat16, device="cuda")
    checks: list[str] = []
    legs = {}
    for name, leg in MESH_LEGS.items():
        params = quantize_params(full, bits=leg["quantize"]) if leg.get("quantize") else full
        r0 = ranks[0][name]
        tokens = np.asarray(r0["tokens"])
        prompts = mesh_prompts(np, cfg, leg)
        if any(r[name]["tokens"] != r0["tokens"] for r in ranks[1:]):
            checks.append(f"mesh {name}: the ranks returned different tokens")
        if tokens.shape != (leg["batch"], leg["new"]):
            checks.append(f"mesh {name}: tokens {tokens.shape}")
        sampler = Sampler(**leg["sampler"])
        one = Generator(params, cfg, sampler=sampler, decode_attn_impl="flash_decode",
                        prefill_attn_impl="flash")
        ref = one.generate(prompts, leg["new"], seed=leg.get("seed", 0)).tokens
        del one
        diverge = [first_divergence(torch, forward, params, cfg, prompts[i], list(ref[i]),
                                    list(tokens[i])) for i in range(leg["batch"])]
        agree = [int(j) for j in ((ref != tokens).argmax(axis=1))]
        first = [None if d is None else agree[i] for i, d in enumerate(diverge)]
        print(f"mesh {name}: first divergence from the one-rank Generator per row "
              f"(token index, plain top-2 gap there): {list(zip(first, diverge))}", flush=True)
        if leg["sampler"]["kind"] == "greedy":
            tol = TEACHER_TOL
            check = teacher_forced(torch, forward, KVCache, params, cfg,
                                   torch.as_tensor(prompts, device=dev),
                                   torch.as_tensor(tokens, device=dev), tol=tol)
        else:
            check = sampled_support(torch, forward, params, cfg, sampler, [
                SimpleNamespace(prompt=prompts[i], generated=list(tokens[i]))
                for i in range(leg["batch"])])
            # each data rank's rows drew the whole batch's bits: a rank
            # drawing another row's would part from the one-rank tokens at
            # a draw that is no near-tie
            margins, gaps = generator_margins(torch, forward, params, cfg, sampler, prompts,
                                              ref, leg.get("seed", 0))
            check["one_rank_prefix"] = prefix_parity(ref, tokens, margins, gaps, MESH_NEAR_TIE)
            print(f"mesh {name}: against the one-rank tokens up to a near-tie: "
                  f"{check['one_rank_prefix']}", flush=True)
            check["ok"] = check["ok"] and check["one_rank_prefix"]["ok"]
        if not check["ok"]:
            checks.append(f"mesh {name}: {check}")
        want = mesh_implied(torch, cfg, leg)
        per_rank = [r[name]["launches"] for r in ranks]
        if any(got != want for got in per_rank):
            checks.append(f"mesh {name}: per-rank launches {per_rank} != implied {want}")
        colls = [r[name]["collectives"] for r in ranks]
        if not all(c["all_reduce"]["calls"] > 0 and c["all_reduce"]["staged"] ==
                   c["all_reduce"]["calls"] for c in colls):
            checks.append(f"mesh {name}: collectives not all host-staged over gloo: {colls}")
        if any(r[name]["compile_counts"] != {"decode_step": 0, "decode_step_eager": 1}
               for r in ranks):
            checks.append(f"mesh {name}: decode steps {[r[name]['compile_counts'] for r in ranks]}")
        legs[name] = dict(
            plan=leg["plan"], batch=leg["batch"], prompt_len=leg["prompt"], new_tokens=leg["new"],
            sampler=leg["sampler"], prefill=leg["prefill"], weights=(
                f"int{leg['quantize']}" if leg.get("quantize") else "bf16"),
            timing_note=f"one card shared by {MESH_RANKS} ranks over gloo (host-staged "
                        "collectives, eager decode steps): not a multi-GPU figure",
            ttft_s=r0["ttft_s"], decode_tok_s_per_seq=r0["decode_tok_s_per_seq"],
            decode_tok_s=r0["decode_tok_s_per_seq"] * leg["batch"], wall_s=r0["wall_s"],
            ranks=[dict(coords=r[name]["coords"], launches=r[name]["launches"],
                        collectives=r[name]["collectives"],
                        peak_allocated_bytes=r[name]["peak_allocated_bytes"],
                        ttft_s=r[name]["ttft_s"]) for r in ranks],
            implied=want, backend=r0["backend"], epilogue=r0["epilogue"],
            compile_counts=r0["compile_counts"], first_divergence=dict(
                token=first, plain_top2_gap=diverge), check=check)
        del params
    serve = {name: mesh_serve_leg(torch, np, full, cfg, name, leg, ranks, checks)
             for name, leg in MESH_SERVE_LEGS.items()}
    del full
    gc.collect()
    torch.cuda.empty_cache()
    train_legs = mesh_train_legs(torch, ranks, train_losses, checks)
    launches_total = {}
    for name in mesh_counters():
        launches_total[name] = sum(r[leg]["launches"][name] for r in ranks for leg in MESH_LEGS)
    for name in mesh_serve_counters():
        launches_total[name] = launches_total.get(name, 0) + sum(
            r["serve"][leg]["launches"][name] for r in ranks for leg in MESH_SERVE_LEGS)
    return dict(phase="mesh", model="meta-llama/Llama-3.2-1B", layers=cfg.num_hidden_layers,
                weights="seeded random bf16", card=card, ranks=MESH_RANKS, device="cuda:0",
                backend="gloo", staging="every collective copies its CUDA tensor to the host "
                "and back (a gloo group)", group_s=group_s, legs=legs, serve=serve,
                train=train_legs,
                teacher_tol=TEACHER_TOL, launches_total=launches_total, checks=checks,
                phase_s=time.perf_counter() - t_phase, ok=not checks)


def mesh_serve_leg(torch, np, full, cfg, name: str, leg: dict, ranks: list, checks: list) -> dict:
    """A serve leg's record from the ranks' results: the ranks' tokens
    equal, every request finished; each rank's launches equal to what its
    dispatching steps imply (16 ragged or paged launches a step, their
    combines where the rank's split plan splits, one float epilogue a
    step) with 0 graphs captured and the steps eager; the pool in 4 KV
    shards; each request's tokens teacher-forced against the cache-less
    plain forward (the int8 pool's against the plain forward over an int8
    cache); and the first divergence from a one-rank engine on the same
    trace, with the plain top-2 gap there (under ``MESH_NEAR_TIE``: a
    near-tie, as PR 21's rule reads a parting)."""
    from types import SimpleNamespace

    from llm_np_cp_tpu_torch.models.transformer import forward

    r0 = ranks[0]["serve"][name]
    trace = mesh_serve_trace(np, cfg, leg)
    where = f"mesh serve {name}"
    if any(r["serve"][name]["tokens"] != r0["tokens"] for r in ranks[1:]):
        checks.append(f"{where}: the ranks served different tokens")
    if r0["finished"] != len(trace):
        checks.append(f"{where}: {r0['finished']} of {len(trace)} finished")
    layers = cfg.num_hidden_layers
    per_rank = []
    for r in ranks:
        got = r["serve"][name]
        want = {k: 0 for k in mesh_serve_counters()}
        kernel = "ragged_paged_attention" if got["mixed"] else "paged_decode_attention"
        want.update({kernel: layers * got["steps"], kernel + "_combine": got["combines"],
                     "sample_epilogue": got["steps"]})
        per_rank.append(dict(launches=got["launches"], implied=want,
                             collectives=got["collectives"], graphs=got["graphs"],
                             compile_counts=got["compile_counts"],
                             shard_stats=got["shard_stats"]))
        if got["launches"] != want or got["host_fetches"] != got["steps"]:
            checks.append(f"{where}: launches {got['launches']} != implied {want}, "
                          f"{got['host_fetches']} fetches for {got['steps']} steps")
        step = "mixed_step" if got["mixed"] else "decode_step"
        if got["graphs"]["captures"] or got["compile_counts"][step] or \
                not got["compile_counts"][step + "_eager"]:
            checks.append(f"{where}: not eager: {got['graphs']}, {got['compile_counts']}")
        st = got["shard_stats"]
        if st["kv_shards"] != MESH_SERVE_PLAN["model"] or \
                st["kv_bytes_shard"] * MESH_SERVE_PLAN["model"] != st["kv_bytes_total"]:
            checks.append(f"{where}: shard_stats {st}")
    prompts = {t["seed"]: t["prompt"] for t in trace}
    reqs = [SimpleNamespace(prompt=prompts[rid], generated=toks)
            for rid, toks in sorted(r0["tokens"].items())]
    int8 = leg["cache"] == "int8"
    check = teacher_forced_requests(torch, forward, full, cfg, reqs, TEACHER_TOL,
                                    cache_dtype=torch.int8 if int8 else None)
    if not check["ok"]:
        checks.append(f"{where}: {check}")
    one = mesh_serve_engine(torch, full, cfg, leg)
    one.warmup([MESH_SERVE_PROMPTS[0]], 2)
    one.replay_trace(trace)
    ref = {r.seed: list(r.generated) for r in one.scheduler.finished}
    del one
    torch.cuda.empty_cache()
    parted = {}
    for rid, toks in sorted(r0["tokens"].items()):
        gap = first_divergence(torch, forward, full, cfg, prompts[rid], ref[rid], toks)
        if gap is not None:
            at = next((j for j, (x, y) in enumerate(zip(ref[rid], toks)) if x != y), None)
            parted[rid] = dict(token=at, plain_top2_gap=gap, near_tie=gap < MESH_NEAR_TIE)
    print(f"{where}: first divergence from the one-rank engine (request: token, plain top-2 "
          f"gap): {parted}", flush=True)
    return dict(
        plan=MESH_SERVE_PLAN, tick=leg["leg"], cache=leg["cache"], requests=len(trace),
        prompts=MESH_SERVE_PROMPTS, new_tokens=MESH_SERVE_NEW, mesh_desc=r0["mesh_desc"],
        epilogue=r0["epilogue"], steps=r0["steps"], ticks=r0["ticks"],
        prefix_blocks_hit=r0["prefix_blocks_hit"], wall_s=r0["wall_s"], tok_s=r0["tok_s"],
        ttft_s_p50=r0["ttft_s_p50"], ttft_s_p99=r0["ttft_s_p99"], tpot_s_p50=r0["tpot_s_p50"],
        tpot_s_p99=r0["tpot_s_p99"],
        timing_note=f"one card shared by {MESH_RANKS} ranks over gloo (host-staged "
                    "collectives, eager ticks): not a multi-GPU figure",
        ranks=per_rank, teacher_forced=check,
        one_rank=dict(requests_parted=len(parted), parted=parted,
                      all_near_ties=all(p["near_tie"] for p in parted.values())))


KERNEL_META = {
    "flash_attention": ("llm_np_cp_tpu_torch/csrc/flash_attention.cu",
                        "llm_np_cp_tpu/ops/pallas/flash_attention.py:180"),
    "decode_attention": ("llm_np_cp_tpu_torch/csrc/decode_attention.cu",
                         "llm_np_cp_tpu/ops/pallas/decode_attention.py:930"),
    # the split-KV merge: the part of the same TPU kernel that its
    # _finalize step (:192) does at the end of the sequential kv axis
    "decode_attention_combine": ("llm_np_cp_tpu_torch/csrc/split_kv.cuh",
                                 "llm_np_cp_tpu/ops/pallas/decode_attention.py:930"),
    "sample_epilogue": ("llm_np_cp_tpu_torch/csrc/sample_epilogue.cu",
                        "llm_np_cp_tpu/ops/pallas/sample_epilogue.py:215"),
    "paged_decode_attention": ("llm_np_cp_tpu_torch/csrc/paged_decode_attention.cu",
                               "llm_np_cp_tpu/ops/pallas/decode_attention.py:453"),
    # the same split-KV merge after the paged split kernel: that kernel's
    # _finalize across splits
    "paged_decode_attention_combine": ("llm_np_cp_tpu_torch/csrc/split_kv.cuh",
                                       "llm_np_cp_tpu/ops/pallas/decode_attention.py:453"),
    "ragged_paged_attention": ("llm_np_cp_tpu_torch/csrc/ragged_paged_attention.cu",
                               "llm_np_cp_tpu/ops/pallas/decode_attention.py:740"),
    # the split-KV merge after the ragged kernel: its _finalize across splits
    "ragged_paged_attention_combine": ("llm_np_cp_tpu_torch/csrc/split_kv.cuh",
                                       "llm_np_cp_tpu/ops/pallas/decode_attention.py:740"),
    "sample_epilogue_int8": ("llm_np_cp_tpu_torch/csrc/sample_epilogue.cu",
                             "llm_np_cp_tpu/ops/pallas/sample_epilogue.py:215"),
    "softmax": ("llm_np_cp_tpu_torch/csrc/softmax.cu", "llm_np_cp_tpu/ops/pallas/softmax.py:52"),
    # no pl.pallas_call: the JAX package draws with jax.random, which XLA
    # lowers to a fused threefry2x32 loop; the row keys of its min-p tick
    # and its categorical draw
    "threefry2x32": ("llm_np_cp_tpu_torch/csrc/threefry.cu",
                     "no pl.pallas_call: XLA's fused threefry, jax.random.fold_in at "
                     "llm_np_cp_tpu/serve/engine.py:1774"),
    "categorical": ("llm_np_cp_tpu_torch/csrc/threefry.cu",
                    "no pl.pallas_call: XLA's fused threefry, jax.random.categorical at "
                    "llm_np_cp_tpu/ops/sampling.py:108"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every result line (and the ptxas report) to this JSON file")
    args = ap.parse_args()
    t_script = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    from llm_np_cp_tpu_torch import random as tr
    from llm_np_cp_tpu_torch.cache import quantize_kv
    from llm_np_cp_tpu_torch.ops import norms
    from llm_np_cp_tpu_torch.ops.cuda import build
    from llm_np_cp_tpu_torch.ops.cuda import decode_attention as da
    from llm_np_cp_tpu_torch.ops.cuda import flash_attention as fa
    from llm_np_cp_tpu_torch.ops.cuda import sample_epilogue as se
    from llm_np_cp_tpu_torch.ops.cuda import softmax as sm
    from llm_np_cp_tpu_torch.ops.cuda import threefry as tfk
    from llm_np_cp_tpu_torch.quant import quantize_array

    # plain versions and library calls in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: list[dict] = []

    def record(line: dict) -> None:
        """Print a result line and rewrite the --out file with every line
        so far, so that a run that fails later keeps what it measured."""
        emit(line)
        results.append(line)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(results=results, ptxas=build.BUILD_INFO.get("ptxas")), f, indent=1)

    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    dev_line = dict(phase="device", kind=card, count=torch.cuda.device_count(),
                    torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
                    build_s=build_s, build_cached=build.BUILD_INFO.get("cached"))
    record(dev_line)

    sdpa_gqa = tuple(int(p) for p in torch.__version__.split(".")[:2]) >= (2, 5)
    sm.softmax.launches = 0
    t_phase = time.perf_counter()
    cases = (flash_cases(torch, F, fa, sdpa_gqa)
             + decode_cases(torch, F, da, quantize_kv, sdpa_gqa)
             + combine_cases(torch, da)
             + epilogue_cases(torch, se, norms, quantize_array, int8=False)
             + paged_cases(torch, F, da, quantize_kv, sdpa_gqa)
             + paged_combine_cases(torch, da, quantize_kv)
             + ragged_cases(torch, F, da, quantize_kv, sdpa_gqa)
             + ragged_combine_cases(torch, da, quantize_kv)
             + epilogue_cases(torch, se, norms, quantize_array, int8=True)
             + softmax_cases(torch, sm)
             + threefry_cases(torch, tr, tfk))
    # no model path calls softmax (as in the JAX package): its launches
    # are the kernel phase's
    softmax_launches = sm.softmax.launches
    for c in cases:
        record(dict(phase="kernel_case", card=smi, **c))
    record(dict(phase="kernel_cases", cases=len(cases), phase_s=time.perf_counter() - t_phase))
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"kernels outside tolerance: {bad}")

    # the main paths' kernels: name → (wrapper, its launch count)
    kernels = {"flash_attention": (fa.flash_attention, "launches"),
               "decode_attention": (da.decode_attention, "launches"),
               "decode_attention_combine": (da.decode_attention, "combine_launches"),
               "sample_epilogue": (se.sample_epilogue, "launches"),
               "paged_decode_attention": (da.paged_decode_attention, "launches"),
               "paged_decode_attention_combine": (da.paged_decode_attention, "combine_launches"),
               "ragged_paged_attention": (da.ragged_paged_attention, "launches"),
               "ragged_paged_attention_combine": (da.ragged_paged_attention, "combine_launches"),
               "sample_epilogue_int8": (se.sample_epilogue, "launches_int8"),
               "threefry2x32": (tfk.threefry2x32, "launches"),
               "categorical": (tfk.categorical, "launches")}
    def timed(fn, *a, **kw) -> dict:
        """A phase's result line with its seconds (``phase_s``) where the
        phase does not time itself."""
        t0 = time.perf_counter()
        line = fn(*a, **kw)
        line.setdefault("phase_s", time.perf_counter() - t0)
        return line

    t0 = time.perf_counter()
    mp, gen, prompts, main_tokens = main_path(torch, np, kernels, smi)
    mp.setdefault("phase_s", time.perf_counter() - t0)
    record(mp)
    prof = timed(profile_generate, torch, gen, prompts, smi)
    record(prof)
    failed = [k for k, v in mp.items() if isinstance(v, dict) and not v.get("teacher_forced", {}).get("ok", True)]
    if failed:
        raise AssertionError(f"teacher-forced check failed for {failed}")
    gp = timed(graph_phase, torch, np, smi, gen, prompts, main_tokens)
    record(gp)
    if not gp["ok"]:
        raise AssertionError("captured steps differ from their eager runs: " + json.dumps(
            {k: v["identical"] for k, v in gp["checks"].items()}))
    del gen
    torch.cuda.empty_cache()

    sv = timed(serve_phase, torch, np, kernels, smi)
    record(sv)
    failed = [leg for leg, v in sv["legs"].items() if not v["teacher_forced"]["ok"]]
    if failed or not sv["float32"]["ok"]:
        raise AssertionError(f"serve checks failed: teacher-forced {failed}, float32 {sv['float32']}")
    qt = timed(quant_phase, torch, np, kernels, smi, mp, sv)
    record(qt)
    failed = [m for m, v in qt["modes"].items() if not v["teacher_forced"]["ok"]]
    failed += [f"float32 {m}" for m, v in qt["float32"].items() if not v["teacher_forced"]["ok"]]
    if failed or not qt["serve"]["teacher_forced"]["ok"]:
        raise AssertionError(f"quant checks failed: teacher-forced {failed}, serve "
                             f"{qt['serve']['teacher_forced']}")
    sp = timed(spec_phase, torch, np, kernels, smi, mp)
    record(sp)
    if not sp["ok"]:
        raise AssertionError("spec checks failed: " + json.dumps(sp, default=str))
    tp = timed(tier_phase, torch, np, kernels, smi)
    record(tp)
    if not tp["ok"]:
        raise AssertionError("tier checks failed: " + json.dumps(tp["checks"], default=str))
    hp = timed(http_phase, torch, np, kernels, smi)
    record(hp)
    if not hp["ok"]:
        raise AssertionError("http checks failed: " + json.dumps(hp["checks"], default=str))
    op = timed(observe_phase, torch, np, kernels, smi)
    record(op)
    if not op["ok"]:
        raise AssertionError("observe checks failed: " + json.dumps(op["checks"], default=str))
    cp = timed(chaos_phase, torch, np, kernels, smi)
    record(cp)
    if not cp["ok"]:
        raise AssertionError("chaos checks failed: " + json.dumps(cp["checks"], default=str))
    clp = timed(cli_phase, torch, np, kernels, smi)
    record(clp)
    if not clp["ok"]:
        raise AssertionError("cli checks failed: " + json.dumps(clp["checks"], default=str))
    rp = timed(restart_phase, torch, np, smi)
    record(rp)
    if not rp["ok"]:
        raise AssertionError("restart checks failed: " + json.dumps(rp["checks"], default=str))
    fp = timed(fleet_phase, torch, np, kernels, smi)
    record(fp)
    if not fp["ok"]:
        raise AssertionError("fleet checks failed: " + json.dumps(fp["checks"], default=str))
    for name in ("ragged_paged_attention", "sample_epilogue"):
        if not fp["launches"][name]:
            raise AssertionError(f"fleet phase: {name} never launched")
    mo = moe_phase(torch, np, kernels, smi)
    record(mo)
    if not mo["ok"]:
        raise AssertionError("moe checks failed: " + json.dumps(mo["checks"], default=str))
    idle = [name for name, n in mo["launches_total"].items()
            if n == 0 and not name.endswith("_combine")]
    if idle:
        raise AssertionError(f"moe phase: kernels never launched on its path: {idle}")
    tr_line = train_phase(torch, np, kernels, smi)
    record(tr_line)
    if not tr_line["ok"]:
        raise AssertionError("train checks failed: " + json.dumps(tr_line["checks"], default=str))
    me = mesh_phase(torch, np, smi, tr_line["losses"])
    record(me)
    if not me["ok"]:
        raise AssertionError("mesh checks failed: " + json.dumps(me["checks"], default=str))
    idle = [name for name in ("flash_attention", "decode_attention", "sample_epilogue",
                              "sample_epilogue_int8", "categorical", "ragged_paged_attention",
                              "paged_decode_attention")
            if not me["launches_total"][name]]
    if idle:
        raise AssertionError(f"mesh phase: kernels never launched on its path: {idle}")

    path_launches = dict(mp["launches"])
    path_launches["ragged_paged_attention"] = sv["legs"]["A_mixed"]["launches"][
        "ragged_paged_attention"]
    path_launches["ragged_paged_attention_combine"] = sv["legs"]["A_long_context"]["launches"][
        "ragged_paged_attention_combine"]
    for name in ("paged_decode_attention", "paged_decode_attention_combine"):
        path_launches[name] = sv["legs"]["B_split_paged"]["launches"][name]
    path_launches["sample_epilogue_int8"] = sum(
        v["launches"]["sample_epilogue_int8"] for v in qt["modes"].values())
    for name in ("threefry2x32", "categorical"):
        path_launches[name] = sv["legs"]["A_min_p"]["launches"][name]
    idle = [name for name, n in path_launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    path_launches["softmax"] = softmax_launches
    launches_from = {name: "main path" for name in path_launches}
    launches_from.update(
        ragged_paged_attention="serve leg A",
        ragged_paged_attention_combine="serve leg A at long context (1024-1536-token prompts)",
        paged_decode_attention="serve leg B",
        paged_decode_attention_combine="serve leg B",
        sample_epilogue_int8="quant phase, the four modes' generate runs",
        threefry2x32="serve leg A with min-p (each tick's row keys)",
        categorical="serve leg A with min-p (each tick's draw)",
        softmax="kernel phase (no model path calls softmax, as in the JAX package)")

    summary = []
    for name, (source, replaces) in KERNEL_META.items():
        c = next(c for c in cases if c["kernel"] == name)  # the main-path shape
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_launches[name], launches_from=launches_from[name],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], case=c["case"], cli_launches=clp["launches"].get(name),
            moe_launches=mo["launches_total"].get(name),
            mesh_launches=me["launches_total"].get(name),
            **{k: c[k] for k in ("library", "gather_ms", "nsplit", "device_ms", "race_ms")
               if k in c},
        ))
    record(dict(phase="total", script_s=time.perf_counter() - t_script))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(results=results, kernels=summary,
                           ptxas=build.BUILD_INFO.get("ptxas")), f, indent=1)
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
