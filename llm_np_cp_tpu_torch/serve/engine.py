"""ServeEngine: continuous-batching serving over the paged block pool
(port of ``llm_np_cp_tpu/serve/engine.py``).

One engine owns the params, the block pool and the scheduler, and runs
the device steps from a host-side tick loop.  Two tick modes, as in the
JAX package:

- **Unified tick** (``mixed_step="on"``, and ``"auto"``, which means
  "on": the port has no kernel probe).  ONE step per tick runs a packed
  ragged batch of prefill-chunk slices and decode rows through the
  decoder: every token's K/V is written straight into its pool block and
  attention reads the pool through the block tables with
  ``ragged_paged_attention``; each row's sample comes out of the same
  step (the fused ``sample_epilogue`` for a greedy sampler over a float
  or int8 head).  The scheduler's token-budget planner (``plan_tick``) puts
  decode rows first and fills the rest of ``tick_token_budget`` with
  prefill.
- **Phase-split tick** (``mixed_step="off"``).  Each admitted request is
  prefilled in ``prefill_chunk`` chunks into a temporary contiguous cache
  (``make_ragged_prefill_step``, the plain masked path), scattered into
  its blocks, and its first token sampled, all eagerly; then one decode
  step serves every running row, over static ``[max_slots, ...]``
  operands (``[max_slots, blocks per sequence]`` tables), captured once.
  ``decode_attn_impl`` picks that step's attention: ``"xla"`` gathers
  each row's blocks into a [B, S_max, K, D] view and runs the plain
  masked attention, ``"flash_decode"`` gathers the same view for the
  ``decode_attention`` kernel, ``"paged"`` reads the pool through the
  block tables with ``paged_decode_attention`` (no gathered view exists).

Block 0 is the scratch block: inactive rows and dead packing lanes write
there and no live table reads it.  Every tick that dispatches fetches ONE
packed ``[R, W+3]`` int32 array to the host (``_pack_sync``; the
``n_host_fetches`` ledger counts it).  Prefix sharing
(``enable_prefix_cache``) claims a prompt's registered leading blocks at
admission and skips their prefill.  A non-greedy sampler draws row n
under the key ``fold_in(PRNGKey(seed), content position)``, computed on
the card from the step's seed and position operands (``random``, the
bits ``jax.random`` draws), as the JAX engine keys it: a preempted
request replays its stream, and sampled tokens equal the JAX engine's
wherever the logits agree.

The unified tick's step is the port's counterpart of the JAX engine's
one compile per packed-width bucket: each bucket owns static device
buffers for its packed operands (token ids, positions, pool slots, the
[T/8] tile metadata, the [R, MB] tables, pads, sample slots) and a
static ``[R, W+3]`` output, and ``graphs.CapturedStep`` runs the step
over them — on the card captured as a CUDA graph at ``warmup`` (every
bucket, on an all-dead batch, as the JAX engine compiles every bucket)
or at the bucket's first tick, and replayed at every later one; on the
CPU run eagerly.  A tick
writes its packed host metadata into the bucket's pinned host buffer
and copies it to the card in ONE copy before the step.
The phase-split decode step owns such buffers too, and is captured at
its first call (``warmup`` runs one).  ``compile_counts()`` reports
``{"mixed_step": graphs captured}`` — at most ``len(mixed_buckets)``,
greedy or sampled, and no more on a replay of the same trace — or, for
a phase-split engine, ``{"decode_step": n}``, where the JAX engine
reports five phase-split programs: its prefill chunks, first sample and
scatter stay eager here (``_prefill_request``; they need a static
prefill cache first).

Speculative serving (``spec_k=K``, unified tick only), as in the JAX
engine: requests that opt in (``submit(..., speculative=True)``) draft
up to K tokens a tick by host-side prompt lookup (``serve/spec.py``);
the tick packs each as a ragged verify slice of width <= K+1 (the input
token and its drafts, the ragged kernel's prefill tiles) in the same one
step, which samples every verify position by the plain decode rule and
walks the accepted prefix on the card (its drafts are its own packed
input tokens), so the tick still makes ONE host fetch and accepted
streams are token-identical to plain decode.  ``verify_len`` is a device
operand of the step; K fixes the ``[R, K+1]`` sample columns, so a
greedy spec tick replays one graph per bucket whatever the draft widths.
A request whose rolling acceptance falls below ``spec_min_accept`` over
``spec_window`` drafted tokens goes back to plain decode rows.

The host-RAM KV tier (``host_tier=HostTier(...)``, prefix cache on), as
in the JAX engine: a prefix block LRU reclaim drops is cloned on the
engine's stream and spilled to host memory by the tier's writer thread
(``_on_prefix_reclaim``); an admission whose prefix the device cache
misses but the tier holds plans ordinary pool blocks for it
(``_prefill_plan``), and the staged blocks are copied into the pool's
own pages before the covering step (``_apply_tier_restores``: the
unified tick after admission, the phase-split prefill before its shared
blocks are gathered).  The copies are eager operations between steps: a
restore writes the pool in place, so every captured step reads it at the
addresses it was captured with, and no tier copy is ever captured.  A
capture holds the tier's writer off the card (``HostTier.quiesce``).
A copy that fails raises; only a missing host block falls back to
re-prefill.

Faults and recovery, as in the JAX engine: a seeded ``fault_injector``
(``serve/faults.py``) fires the ``prefill``, ``decode`` and ``host_sync``
sites; ``recover`` resubmits an in-flight request into a rebuilt engine
with its delivered tokens teacher-forced, ``finish_recovered`` closes
one that needs no re-run, and ``clone_fresh`` rebuilds the engine with
an empty pool; the ``journal`` (``serve/journal.py``) records
admissions, one delivery watermark a tick and terminals, and the
``request_log`` (``serve/request_log.py``) one line per terminal.  Where
the card differs: a ``decode`` fault raises (the JAX engine degrades the
kernel to its XLA sibling first; here nothing falls back, so a dispatch
fault ends in a supervised restart), and a rebuild cannot share the
dead engine's compiled steps — ``retire`` drops its graphs and pages
(its ``step`` raises from then on, so no graph replays into memory the
clone now owns), and the clone captures its own before it serves.

The observability plane, as in the JAX engine: a ``tracer``
(``serve/tracing.TraceRecorder``: request tracks, one ``tick`` span a
tick with its phase slices, the ``prefix-evict`` / ``kv-restore`` /
``spec-fallback`` instants), a ``sentinel`` (``serve/slo.TickSentinel``
over the traced phases and the ``roofline_deficit`` pseudo-phase),
``telemetry`` (``serve/telemetry.TelemetryModel``: each tick's byte and
FLOP bill, made while the step runs and before the accept walk, graded
against the dispatch → fetch wall and attributed to its requests before
delivery; the ``kv_bytes_tick`` gauge reads the same byte model) and ``tenants``
(``serve/tenants.TenantLedger``: a bill at every terminal, the in-flight
cap that raises ``TenantThrottled``, the fair-share prefill order).
Every hook is one ``is None`` check and runs in the host tick code
around the step — Python inside a captured step runs only at capture —
so attaching them adds no device operation, no capture and no change to
any token.  On the card ``mixed_dispatch`` (or ``decode_dispatch``) is
the graph launch and ``host_sync`` the token fetch's wait on the device;
the dispatch runs under ``torch.profiler.record_function`` while a
tracer is attached, so a profiler capture lines up with the trace.

What the port leaves out, as the JAX package has it: donation (pages are
updated in place) and the runtime degradation to XLA fallbacks — on the
card a kernel launches or raises, and a step captures or raises; nothing
falls back.

Tensor parallelism (``mesh_plan=MeshPlan(model=N)``), as in the JAX
engine, which is TP-only (data parallelism is replicas behind a router,
``serve/replica.py``): the params are cut into this rank's shards
(``parallel.sharding.shard_params``), the pool's slabs hold this rank's
KV heads (``paged_kv_specs``; ``BlockPool.shard_stats``), and the tick
bodies issue the forward's collectives (``models.transformer``: the
vocab-parallel embedding, the row-parallel reduces, the greedy
epilogue's (row maximum, global index) merge or the sampled kinds'
gathered logits).  The paged kernels run unchanged on a rank's query
heads and slabs: GQA's kv-major head order makes the local group math
the global one.  Where the KV heads do not divide "model" (Gemma-2's 2
on 4 ranks) each rank's pool holds only the KV heads its query heads
read (``kv_head_select``), written there by the tick, so both kernels
still launch.  Where the JAX engine is one controller running every
shard, the port is one process a rank (``parallel/launch.run_ranks`` or
the CLI's spawn), each running its own engine on the same submissions:
every tick all-gathers a digest of its plan (the tick number, the step
and a checksum of the packed host operands) over "model" and raises
``RuntimeError`` naming the first rank whose plan differs, so ranks that
parted never pair the wrong collectives.  What would make a rank's host
decisions follow its own wall clock or an outside source raises
``NotImplementedError`` under a multi-rank mesh (``realtime`` replays,
deadlines, ``actions``, ``sentinel``, ``host_tier``, ``spec_k``,
``journal``, a fault injector: ROADMAP.md queue 1 item 8c), and
``replay_trace`` releases arrivals by the ranks' largest clock reading.
A gloo collective cannot be captured, so a multi-rank engine's steps
run eagerly (``compile_counts``: ``mixed_step_eager`` /
``decode_step_eager``), and where the JAX engine keeps the unfused tail
under ``model > 1`` the port keeps the fused epilogue (the same tokens).

The fleet's hooks (``serve/lifecycle.py``, ``serve/replica.py``), as in
the JAX engine: ``actions`` (an ``ActionPolicy``) is fed once a tick
(``_actions_tick``) and its shed-prefill verdict caps the planner's
budget (``_tick_budget``); ``weights_version`` tags every admission;
``clone_fresh(params=, weights_version=)`` is a rolling upgrade's
rebuild.  Where the card differs: ``share_compiled_steps`` adopts no
peer's graph (a graph replays its own engine's pool and buffer
addresses) but captures every bucket the peer has captured, so a
joining or rolled replica never captures inside a serving tick; and
``clone_fresh`` retires its source, so the fleet's ``add_replica`` clones
a live replica with ``clone_peer``.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
import weakref
import zlib
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from llm_np_cp_tpu_torch import graphs, random
from llm_np_cp_tpu_torch.cache import KVCache, dequantize_kv, quantize_kv
from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.device import resolve_device
from llm_np_cp_tpu_torch.generate import IncrementalDetok, make_ragged_prefill_step
from llm_np_cp_tpu_torch.graphs import CapturedStep
from llm_np_cp_tpu_torch.models import transformer
from llm_np_cp_tpu_torch.models.transformer import (
    embed_inputs,
    epilogue_gate_error,
    final_logits,
    kv_head_select,
    run_decoder_layer,
)
from llm_np_cp_tpu_torch.ops.activations import ACT2FN
from llm_np_cp_tpu_torch.ops.attention import gqa_attention
from llm_np_cp_tpu_torch.ops.cuda import decode_attention as _da
from llm_np_cp_tpu_torch.ops.rope import rope_cos_sin
from llm_np_cp_tpu_torch.ops.sampling import Sampler
from llm_np_cp_tpu_torch.parallel.collectives import all_gather, all_reduce
from llm_np_cp_tpu_torch.parallel.sharding import (
    MODEL_AXIS,
    MOE_TP_ITEM,
    Mesh,
    MeshPlan,
    kv_heads_shardable,
    local_kv_heads,
    make_mesh,
    shard_params,
)
from llm_np_cp_tpu_torch.serve import telemetry as _tel
from llm_np_cp_tpu_torch.serve.block_pool import BlockPool
from llm_np_cp_tpu_torch.serve.faults import FaultInjected, FaultInjector
from llm_np_cp_tpu_torch.serve.host_tier import HostTier
from llm_np_cp_tpu_torch.serve.journal import RequestJournal
from llm_np_cp_tpu_torch.serve.metrics import ServeMetrics
from llm_np_cp_tpu_torch.serve.prefix_cache import prefix_block_keys
from llm_np_cp_tpu_torch.serve.request_log import RequestLog, request_record
from llm_np_cp_tpu_torch.serve.scheduler import (
    QueueFull,
    Request,
    RequestState,
    Scheduler,
    TenantThrottled,
)
from llm_np_cp_tpu_torch.serve.spec import DraftState
from llm_np_cp_tpu_torch.serve.tracing import gen_trace_id

Params = dict[str, Any]

# the window a global layer passes to the ragged kernel
GLOBAL_WINDOW = 1 << 30

# what a multi-rank engine waits for
MESH_ITEM = "ROADMAP.md queue 1 item 8c"

# keyword → value that means "off", for the JAX engine's options the port
# does not have yet: a one-device placement mesh belongs to the fleet's
# data-parallel placement
_NOT_PORTED = {"mesh_devices": None}

# the plans a tick's digest names
_DIGEST_WHAT = {"mixed": 1, "decode": 2, "prefill": 3}

_NULL_CTX = contextlib.nullcontext()


def _roofline_targs(tel: dict) -> dict:
    """The roofline part of a tick's trace args (callers hold the tracer
    guard): what tools/summarize_trace.py's roofline section reads."""
    return {
        "roofline_gbps": round(tel["achieved_gbps"], 3),
        "roofline_util": round(tel["roofline_util"], 6),
        "mfu": round(tel["mfu"], 6),
        "device_time_s": round(tel["device_time_s"], 6),
        "kv_read_bytes": int(tel["kv_read_bytes"]),
        "kv_write_bytes": int(tel["kv_write_bytes"]),
        "weight_bytes": int(tel["weight_bytes"]),
    }


def _ceil_to(n: int, g: int) -> int:
    return -(-n // g) * g


def _stop_hits(samples: torch.Tensor, stops: torch.Tensor | None) -> torch.Tensor:
    """[.., W] bool — which sampled tokens are stop tokens (``stops``: the
    engine's stop ids on its device, or None)."""
    if stops is None:
        return torch.zeros(samples.shape, dtype=torch.bool, device=samples.device)
    return torch.isin(samples, stops)


def _pack_sync(samples: torch.Tensor, stop_hit: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """The one-fetch host-sync contract: the tick's whole outcome as ONE
    int32 array ``[R, W+3]`` — columns ``[0:W)`` the sampled tokens, ``W``
    a stop-hit bitmask over them, ``W+1`` the advance watermark (tokens
    the accept walk emits: up to the first stop inside the accepted
    prefix, else accept+1), ``W+2`` the accept length.  The split tick is
    the W=1 case.  The deliver walk reads the token column; finish rules
    stay host-side in ``_maybe_finish``, as in the JAX engine."""
    r, w = samples.shape
    # column ids and their bits made on the device: no host copy in a step
    kcol = torch.arange(w, dtype=torch.int32, device=samples.device)[None, :]
    stop_mask = torch.where(stop_hit, 1 << kcol, 0).sum(dim=1, dtype=torch.int32)
    cand = stop_hit & (kcol <= accept[:, None])
    first = torch.argmax(cand.to(torch.int32), dim=1).to(torch.int32) + 1
    advance = torch.where(cand.any(dim=1), first, accept + 1)
    return torch.cat(
        [samples.to(torch.int32), stop_mask[:, None], advance[:, None], accept[:, None]], dim=1
    )


def worst_case_slots(prompt_len: int, max_new_tokens: int, chunk: int) -> int:
    """Peak cache slots a request can occupy over its whole lifetime,
    including re-prefills after preemption.

    A re-prefill with ``g`` tokens already generated left-pads the
    content ``p+g`` to whole chunks and the remaining ``m-g`` decode
    steps extend from there, so the peak is
    ``max_g ceil_to(p+g, chunk) + (m-g)`` over ``0 <= g < m``: either the
    uninterrupted path (g=0) or just past a chunk boundary
    (``p+g ≡ 1 mod chunk``), where it equals ``p + m + chunk - 1``.
    """
    p, m = prompt_len, max_new_tokens
    worst = _ceil_to(p, chunk) + m
    g_cross = (1 - p) % chunk or chunk  # smallest g>0 with p+g ≡ 1 (mod chunk)
    if g_cross <= m - 1:
        worst = max(worst, p + m + chunk - 1)
    return worst


def pool_geometry(
    prompt_len: int,
    max_new_tokens: int,
    slots: int,
    block_size: int,
    prefill_chunk: int | None = None,
    spare_blocks: int = 2,
) -> tuple[int, int, int]:
    """Size a pool for a worst-case trace: ``(blocks_per_seq, num_blocks,
    max_seq_len)`` — every slot can hold a worst-case request (incl.
    preemption re-prefills, see ``worst_case_slots``) plus
    ``spare_blocks`` of headroom for the scratch block and the
    scheduler's decode reserve.  ``prefill_chunk=None`` means the engine
    default (``block_size``)."""
    chunk = prefill_chunk or block_size
    worst = worst_case_slots(prompt_len, max_new_tokens, chunk)
    blocks_per_seq = -(-worst // block_size)
    num_blocks = slots * blocks_per_seq + spare_blocks
    return blocks_per_seq, num_blocks, blocks_per_seq * block_size


def _seed_word(seed: int) -> int:
    """A request seed's low 32 bits as an int32 (the JAX engine's uint32
    seed operand; ``random.PRNGKey`` reads the same word)."""
    return ((int(seed) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


# the unified tick's packed int32 operands, in the order of their static
# device buffer
_MIXED_OPERANDS = ("tokens", "positions", "tok_blk", "tok_off", "tile_row", "tile_qpos0",
                   "tile_qlen", "tables", "pads", "last_idx", "verify_len", "seeds",
                   "sample_pos")
# the phase-split decode step's int32 operands, one row a slot
_DECODE_OPERANDS = ("toks", "content_pos", "blk", "off", "tables", "vis", "pads",
                    "pads_sliding", "seeds")


class _StaticStep:
    """A step over static buffers: its int32 operands' device buffer (one
    buffer, viewed per operand), the pinned host buffer a tick packs
    into, the ``[R, W+3]`` sync rows the step writes (``out``), and its
    runner, ``body(ops, out)`` run by ``graphs.CapturedStep``."""

    def __init__(self, eng: "ServeEngine", shapes: dict[str, tuple[int, ...]], out_cols: int,
                 body: Callable, name: str) -> None:
        dev = eng.device
        total = sum(math.prod(v) for v in shapes.values())
        self.dev = torch.zeros(total, dtype=torch.int32, device=dev)
        self.host = torch.zeros(total, dtype=torch.int32, pin_memory=dev.type == "cuda")
        self.host_np = self.host.numpy()
        self.spans: dict[str, tuple[int, int]] = {}
        self.ops: dict[str, torch.Tensor] = {}
        o = 0
        for k, shape in shapes.items():
            n = math.prod(shape)
            self.spans[k] = (o, n)
            self.ops[k] = self.dev[o:o + n].view(shape)
            o += n
        self.out = torch.zeros((eng.scheduler.max_slots, out_cols), dtype=torch.int32,
                               device=dev)
        # a multi-rank engine's collectives cannot be captured: eager
        self.run = CapturedStep(lambda: body(self.ops, self.out), dev, name,
                                guard=eng._capture_guard, side=eng._side_stream,
                                eager=eng._multi)

    def upload(self, host: dict[str, np.ndarray]) -> None:
        """The tick's host operands → the static device buffer, in ONE
        copy (pinned host memory, so the copy is asynchronous)."""
        for k, (o, n) in self.spans.items():
            self.host_np[o:o + n] = host[k].reshape(-1)
        self.dev.copy_(self.host, non_blocking=True)


def _mixed_step_state(eng: "ServeEngine", t_w: int) -> _StaticStep:
    """One packed-width bucket's static step (its operands ``_MIXED_OPERANDS``)."""
    r, w = eng.scheduler.max_slots, eng._spec_w
    nt = t_w // eng._q_tile
    shapes = dict(tokens=(t_w,), positions=(t_w,), tok_blk=(t_w,), tok_off=(t_w,),
                  tile_row=(nt,), tile_qpos0=(nt,), tile_qlen=(nt,),
                  tables=(r, eng.max_blocks_per_seq), pads=(r,), last_idx=(r, w),
                  verify_len=(r,), seeds=(r,), sample_pos=(r, w))
    return _StaticStep(eng, {k: shapes[k] for k in _MIXED_OPERANDS}, w + 3, eng._mixed_body,
                       f"mixed_step[T={t_w}]")


def _decode_step_state(eng: "ServeEngine") -> _StaticStep:
    """The phase-split decode step over every slot (its operands
    ``_DECODE_OPERANDS``, ``[max_slots]`` rows and ``[max_slots, blocks
    per sequence]`` tables)."""
    b = eng.scheduler.max_slots
    shapes = {k: (b,) for k in _DECODE_OPERANDS}
    shapes["tables"] = (b, eng.max_blocks_per_seq)
    return _StaticStep(eng, shapes, 4, eng._decode_body,
                       f"decode_step[{eng.decode_attn_impl}, B={b}]")


class ServeEngine:
    """Continuous-batching engine over a paged KV pool on ``device``
    (``"cuda"`` by default; raises without a card unless ``"cpu"``)."""

    def __init__(
        self,
        params: Params,
        config: ModelConfig,
        *,
        sampler: Sampler | None = None,
        stop_tokens: tuple[int, ...] = (),
        max_slots: int = 4,
        num_blocks: int = 64,
        block_size: int = 64,
        max_seq_len: int = 1024,
        prefill_chunk: int | None = None,
        cache_dtype: torch.dtype = torch.bfloat16,
        decode_attn_impl: str = "xla",
        enable_prefix_cache: bool = False,
        max_queue: int | None = None,
        tokenizer: Any = None,
        clock: Callable[[], float] = time.perf_counter,
        mixed_step: str = "off",
        sample_epilogue: str = "auto",
        tick_token_budget: int | None = None,
        spec_k: int = 0,
        spec_ngram: int = 3,
        spec_min_accept: float = 0.1,
        spec_window: int = 64,
        host_tier: HostTier | None = None,
        fault_injector: FaultInjector | None = None,
        journal: RequestJournal | None = None,
        request_log: RequestLog | None = None,
        tracer: Any = None,
        sentinel: Any = None,
        telemetry: Any = None,
        tenants: Any = None,
        actions: Any = None,
        weights_version: int = 0,
        device: str | torch.device = "cuda",
        mesh_plan: MeshPlan | None = None,
        mesh: Mesh | None = None,
        **not_ported: Any,
    ) -> None:
        """``mesh_plan``: a tensor-parallel plan (``MeshPlan(model=N)``);
        the engine is built inside a rank of a running process group of
        N ranks, makes its mesh over the group (``make_mesh``, the group's
        backend, this rank's tensors on ``device``) and cuts this rank's
        shards out of the full ``params``.  ``mesh``: that mesh, made by
        the caller (``params`` are then this rank's shards already, as
        ``Generator(mesh=)`` takes them; ``clone_fresh`` passes its
        own).  A plan of one device is no mesh."""
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"ServeEngine got an unexpected keyword argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported to PyTorch yet ({MESH_ITEM}: "
                    "the fleet's data-parallel placement)")
        if decode_attn_impl not in ("xla", "flash_decode", "paged"):
            raise ValueError(
                f"decode_attn_impl must be 'xla', 'flash_decode' or 'paged', "
                f"got {decode_attn_impl!r}"
            )
        if mixed_step not in ("auto", "on", "off"):
            raise ValueError(f"mixed_step must be 'auto', 'on' or 'off', got {mixed_step!r}")
        if sample_epilogue not in ("auto", "on", "off"):
            raise ValueError(
                f"sample_epilogue must be 'auto', 'on' or 'off', got {sample_epilogue!r}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k > 30:
            # the one-fetch sync carries a per-row stop-hit BITMASK over
            # the spec_k+1 sample columns in one int32
            raise ValueError(
                f"spec_k must be <= 30 (the packed host-sync stop mask is an int32 "
                f"bitmask over spec_k+1 columns), got {spec_k}")
        if spec_k and spec_ngram < 2:
            # at construction, not at the first draft tick (DraftState
            # needs ngram_min <= ngram_max, and its lookup floor is 2)
            raise ValueError(f"spec_ngram must be >= 2, got {spec_ngram}")
        if spec_k and mixed_step == "off":
            raise ValueError(
                "speculative serving (spec_k > 0) rides the unified tick's batched "
                "verifier; it cannot run with mixed_step='off'")
        if host_tier is not None and not enable_prefix_cache:
            raise ValueError(
                "host_tier requires enable_prefix_cache=True: the tier is keyed by the "
                "prefix cache's chained content hashes")
        if mesh is not None:
            if mesh_plan is not None and mesh_plan != mesh.plan:
                raise ValueError(f"mesh_plan {mesh_plan} is not the mesh's plan {mesh.plan}")
            mesh_plan = mesh.plan
        self.mesh_plan = mesh_plan
        self.mesh: Mesh | None = None
        if mesh_plan is not None and mesh_plan.num_devices > 1:
            self._check_mesh(mesh_plan, config, spec_k=spec_k, host_tier=host_tier,
                             fault_injector=fault_injector, journal=journal,
                             sentinel=sentinel, actions=actions)
            if mesh is None:
                mesh = make_mesh(mesh_plan, device=device,
                                 backend=dist.get_backend() if dist.is_initialized() else None)
                params = shard_params(params, config, mesh_plan, mesh)
            self.mesh = mesh
        # one process a rank: every rank runs this engine on the same
        # submissions, in lockstep (``_lockstep``)
        self._multi = self.mesh is not None
        # under TP with replicated KV heads: the heads this rank's pool
        # holds (those its query heads read); None = every head it computes
        self._kv_sel = kv_head_select(config, self.mesh)
        self.device = self.mesh.device if self._multi else resolve_device(device)
        if params["final_norm"].device != self.device:
            raise ValueError(
                f"params live on {params['final_norm'].device}, the engine asked for "
                f"device={str(self.device)!r}"
            )
        # the tick digest's collective moves host memory on a gloo group
        self._digest_device = (torch.device("cpu") if not self._multi
                               or self.mesh.backend == "gloo" else self.device)
        self._ticks = 0
        self.params = params
        self.config = config
        self.decode_attn_impl = decode_attn_impl
        self.mixed_step_mode = mixed_step
        self.sample_epilogue_mode = sample_epilogue
        self.mixed = mixed_step != "off"  # "auto" = "on": no probe to consult
        self.sampler = sampler or Sampler(kind="greedy")
        self.stop_tokens = tuple(stop_tokens)
        self.tokenizer = tokenizer
        self.clock = clock
        self.cache_dtype = cache_dtype
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk or block_size
        # per-request cache ceiling, in whole blocks (fixes the table
        # width and the gathered view's S_max = max_blocks_per_seq * bs)
        self.max_seq_len = _ceil_to(max_seq_len, block_size)
        self.max_blocks_per_seq = self.max_seq_len // block_size
        # prefix-share granularity in BLOCKS: shared prefixes cover whole
        # blocks AND whole prefill chunks (a partial chunk would
        # re-prefill and re-write a shared block)
        self._share_unit = math.lcm(self.block_size, self.prefill_chunk) // self.block_size

        self.pool = BlockPool(
            config, num_blocks, block_size, dtype=cache_dtype,
            enable_prefix_cache=enable_prefix_cache, device=self.device,
            kv_heads=self._pool_kv_heads(),
        )
        self.scheduler = Scheduler(
            self.pool,
            max_slots=max_slots,
            block_size=block_size,
            prefill_plan=self._prefill_plan,
            max_queue=max_queue,
        )
        self.metrics = ServeMetrics(clock=clock)
        # -- host-RAM KV block tier: spilled prefix blocks keyed by the
        # prefix cache's chained content hash, restored at admission as
        # ordinary claimed pool blocks.  None = every hook is an is-None
        # check.  A capture holds the tier's writer off the card.
        self.host_tier = host_tier
        self._capture_guard = host_tier.quiesce if host_tier is not None else None
        # the stream this engine's steps are captured on, its own (graphs
        # of two engines replaying at once must not share one stream's
        # cuBLAS workspace); it goes back for reuse at ``retire`` or when
        # the engine is collected
        self._side_stream = None
        self._release_side = None
        if self.device.type == "cuda":
            self._side_stream = graphs.take_side_stream(self.device)
            self._release_side = weakref.finalize(self, graphs.give_side_stream, self.device,
                                                  self._side_stream)
        # bytes one pool block holds across all layers (K+V + int8 scale
        # pages) — the unit every tier ledger counts in
        self._block_nbytes = int(sum(
            a.numel() * a.element_size() // a.shape[1]
            for a in self.pool.pages if a is not None))
        # the K/V byte model's geometry (the kv_bytes_tick gauge and
        # telemetry's bill): the ragged kernel's q tile and the layers
        # that read only their sliding window
        n_layers = config.num_hidden_layers
        self._kv_geom = dict(
            block_size=block_size, q_tile=_da.RAGGED_Q_TILE, window=config.sliding_window,
            n_layers=n_layers, n_sliding=0 if config.sliding_window is None else sum(
                config.layer_is_sliding(i) for i in range(n_layers)))
        # bytes spilled and restored this tick, and the restores' staging
        # time (the per-tick gauge refresh and the tick's trace args)
        self._tier_spill_bytes = 0
        self._tier_restore_bytes = 0
        self._tier_restore_us = 0.0
        if self.pool.prefix_cache is not None:
            # LRU reclaim is counted and, with a tier, spills the block
            self.pool.prefix_cache.on_reclaim = self._on_prefix_reclaim
        if host_tier is not None:
            # the restore side of the breakeven: a block-sized pinned
            # host→device copy timed at build; the recompute side comes
            # from measured prefill rates (HostTier.note_prefill_rate)
            shape = self.pool.pages.k.shape
            blk_shape = (shape[0],) + tuple(shape[2:])
            probes = [(blk_shape, cache_dtype)] * 2
            if self.pool.pages.quantized:
                probes += [(blk_shape[:-1], torch.float32)] * 2
            host_tier.ensure_probe(probes, device=self.device)
            if telemetry is not None:
                # the recompute side seeds from the byte model until a
                # measured prefill rate refines it
                w = telemetry.weight_bytes(self.prefill_chunk, 1)
                host_tier.note_prefill_rate(
                    self.prefill_chunk / (w / (telemetry.hbm_gbps * 1e9)))
            self.metrics.on_tier_gauge(
                resident_bytes=host_tier.resident_bytes,
                breakeven=host_tier.breakeven_ratio(self.block_size))
        # seeded chaos schedule (serve/faults.py), the durable request
        # journal (serve/journal.py) and the canonical request log
        # (serve/request_log.py): None = every hook is an is-None check
        self.faults = fault_injector
        self.journal = journal
        self.request_log = request_log
        # the observability plane: the trace recorder (serve/tracing.py),
        # the tick sentinel (serve/slo.py; fed only traced ticks), the
        # roofline model (serve/telemetry.py) and the tenant ledger
        # (serve/tenants.py).  None = every hook is an is-None check.  The
        # hooks re-read the attribute each time: the supervisor mutes a
        # dead engine by clearing them
        self.tracer = tracer
        self.sentinel = sentinel
        self.telemetry = telemetry
        self.tenants = tenants
        # lifecycle auto-actions (serve/lifecycle.ActionPolicy): the
        # sentinel's verdicts and the SLO burn rate feed it once a tick;
        # its shed-prefill verdict caps the planner's budget and its
        # shed-load verdict turns HTTP admission 503-first.  None = every
        # hook is an is-None check
        self.actions = actions
        # the weight version a rolling upgrade stamps on every admission
        # (journal records, request-log lines); clone_fresh(params=...)
        # sets the new one
        self.weights_version = int(weights_version)
        # the runtime degradation to an XLA fallback the JAX server reads:
        # none here (a kernel launches or raises, and a dispatch fault
        # ends in a supervised restart)
        self.decode_degraded: str | None = None
        # set by ``retire``: a superseded engine's step raises
        self.retired: str | None = None
        self._next_id = 0
        self._detok: dict[int, IncrementalDetok] = {}
        # live (queued or running) requests by id — the abort/deadline index
        self._requests: dict[int, Request] = {}
        # device steps issued (every prefill chunk, copy program, sample
        # and decode/mixed step, as the JAX engine counts them), the
        # split path's decode steps among them, the unified ticks that
        # carried a verify slice (some draft packed), and the host fetches
        self.n_dispatches = 0
        self.n_decode_dispatches = 0
        self.n_verify_dispatches = 0
        self.n_host_fetches = 0
        # the unified tick's steps by packed width, and its dispatches per
        # width; the phase-split tick's decode step
        self._mixed_steps: dict[int, _StaticStep] = {}
        self._split_step: _StaticStep | None = None
        self.bucket_dispatches: dict[int, int] = {}
        # the last unified tick's packed segments: (request id, first
        # lane, tokens, first content position) each, lanes consecutive
        self.tick_segments: list[tuple[int, int, int, int]] = []
        self._stops = (torch.tensor(self.stop_tokens, dtype=torch.int32, device=self.device)
                       if self.stop_tokens else None)
        # speculative serving: spec_k fixes the step's [R, spec_k+1]
        # sample columns; per-request draft streams (serve/spec.py) by
        # request id leave with their request
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_min_accept = spec_min_accept
        self.spec_window = spec_window
        self._draft_states: dict[int, DraftState] = {}

        # fused sampling epilogue: greedy sampler over a float or int8 head
        self.epilogue_impl = "xla"
        if sample_epilogue != "off":
            err = epilogue_gate_error(params, config, self.sampler.kind)
            if err is None:
                self.epilogue_impl = "fused"
            elif sample_epilogue == "on":
                logging.getLogger("llm_np_cp_tpu_torch").warning(
                    "sample_epilogue='on' but the fused epilogue cannot serve this "
                    "engine (%s); using the logits tail", err,
                )

        if self.mixed:
            self._q_tile = _da.RAGGED_Q_TILE
            # sample columns per row: a verify slice samples its input
            # token and every draft; plain rows use column 0
            self._spec_w = spec_k + 1
            # a spec engine's default budget leaves room for verify
            # lanes: drafts only spend what prefill leaves, so without
            # it a busy admission window would trim every draft away
            budget = tick_token_budget or (
                max_slots * (1 + spec_k) + 2 * self.prefill_chunk)
            if budget < max_slots:
                raise ValueError(
                    f"tick_token_budget ({budget}) must be >= max_slots ({max_slots}): "
                    "every decode row needs one token per tick before prefill fills "
                    "the remainder"
                )
            self.tick_token_budget = budget
            self.mixed_buckets = self._make_buckets(budget, max_slots)
        else:
            self.tick_token_budget = 0
            self.mixed_buckets: tuple[int, ...] = ()
            self._prefill_step = make_ragged_prefill_step(config, device=self.device,
                                                          mesh=self.mesh)

    @staticmethod
    def _check_mesh(plan: MeshPlan, config: ModelConfig, **options: Any) -> None:
        """The JAX engine's refusals of a multi-device plan (TP only, the
        config divisible), then the port's: MoE under TP and the options
        whose host decisions would differ between ranks."""
        for axis in ("data", "seq", "pipe", "expert"):
            if getattr(plan, axis) != 1:
                raise ValueError(
                    f"ServeEngine meshes are tensor-parallel only (model axis); got "
                    f"{axis}={getattr(plan, axis)} — use serve/replica.py ReplicaSet for "
                    "data parallelism")
        plan.validate(config)
        if config.is_moe:
            raise NotImplementedError(MOE_TP_ITEM)
        on = [name for name, value in options.items() if value]
        if on:
            raise NotImplementedError(
                f"ServeEngine({', '.join(f'{n}=...' for n in on)}) under a multi-rank mesh "
                f"is not ported yet ({MESH_ITEM}): its host decisions follow the wall "
                "clock or a source outside the trace, which the ranks do not share")

    def _pool_kv_heads(self) -> int:
        """The KV heads this rank's pool holds: its share over "model"
        when they shard, else those ``kv_head_select`` names."""
        sel = self._kv_sel
        if sel is None:
            return local_kv_heads(self.config, self.mesh)
        return sel.stop - sel.start if isinstance(sel, slice) else int(sel.numel())

    def _pool_heads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``t``'s KV heads (along ``dim``) that this rank's pool holds."""
        sel = self._kv_sel
        if sel is None:
            return t
        if isinstance(sel, slice):
            return t.narrow(dim, sel.start, sel.stop - sel.start)
        return t.index_select(dim, sel)

    @property
    def mesh_desc(self) -> str | None:
        """The topology for the serve banner and ``/healthz``: the TP
        degree, the ranks and this rank's device, the group backend, and
        whether the KV heads are sharded or replicated (None without a
        mesh)."""
        if self.mesh is None:
            return None
        kv = "kv-sharded" if kv_heads_shardable(self.config, self.mesh_plan) else "kv-replicated"
        return (f"tp={self.mesh_plan.model} over {self.mesh_plan.num_devices} "
                f"{self.mesh.backend} ranks on {self.device} ({kv})")

    def _lockstep(self, what: str, bucket: int, host: np.ndarray) -> None:
        """Under a multi-rank mesh: all-gather this tick's digest (tick
        number, which plan, its bucket, a checksum of its packed host
        operands) over "model" and raise ``RuntimeError`` naming the first
        rank whose digest differs from rank 0's, before any collective of
        the step could pair with another rank's different call."""
        if not self._multi:
            return
        crc = zlib.crc32(np.ascontiguousarray(host).view(np.uint8))
        mine = torch.tensor([[self._ticks, _DIGEST_WHAT[what], bucket, host.size, crc]],
                            dtype=torch.int64, device=self._digest_device)
        got = all_gather(mine, self.mesh, MODEL_AXIS, dim=0).cpu()
        bad = (got != got[0]).any(dim=1).nonzero()
        if bad.numel():
            r = int(bad[0, 0])
            ranks = dist.get_process_group_ranks(self.mesh.group(MODEL_AXIS))
            raise RuntimeError(
                f"tensor-parallel ranks out of lockstep at tick {self._ticks}: model rank {r} "
                f"(global rank {ranks[r]}) planned {got[r].tolist()}, model rank 0 planned "
                f"{got[0].tolist()} ([tick, plan, bucket, operands, crc32]); every rank must "
                "make the same submissions, aborts and calls in the same order")

    def _synced_clock(self) -> float:
        """The largest of the ranks' clock readings (one all-reduce): what
        a multi-rank replay releases arrivals by."""
        t = torch.tensor([self.clock()], dtype=torch.float64, device=self._digest_device)
        return float(all_reduce(t, self.mesh, MODEL_AXIS, op="max")[0])

    def _make_buckets(self, budget: int, max_slots: int) -> tuple[int, ...]:
        """Packed-width buckets for the mixed step: a doubling ladder of
        q-tile multiples capped by the worst aligned total (every planned
        token plus per-row tile padding) — the JAX engine's ladder, so
        the packed shapes (and the dead-lane work) are its too, with one
        captured graph per bucket used."""
        qb = self._q_tile
        a_max = _ceil_to(budget + max_slots * (qb - 1), qb)
        buckets = []
        t = qb
        while t < a_max:
            buckets.append(t)
            t *= 2
        buckets.append(a_max)
        return tuple(sorted(set(buckets)))

    def _pick_bucket(self, n: int) -> int:
        for t in self.mixed_buckets:
            if t >= n:
                return t
        raise AssertionError(
            f"planner produced {n} aligned tokens > largest bucket "
            f"{self.mixed_buckets[-1]} — budget accounting is broken"
        )

    # ------------------------------------------------------------------
    def _prefill_width(self, req: Request) -> int:
        """Left-padded prefill width: the request's content rounded up to
        a whole number of chunks."""
        return _ceil_to(req.total_len, self.prefill_chunk)

    def _prefill_plan(self, req: Request) -> tuple[list[int], int]:
        """Admission plan: ``(claimed shared block ids, fresh blocks
        needed)``.  With the prefix cache on, the prompt's fully-filled
        leading blocks are hashed and the longest registered chain is
        CLAIMED (one reference per block); the fresh need excludes them.
        The shareable span is capped at ``width - prefill_chunk``: the
        LAST chunk always re-prefills (the first token's logits come out
        of it), which also keeps decode writes strictly past every shared
        block.

        With the host tier attached, keys the device cache misses are
        looked up host-side as well: a hit at or above the measured
        restore-vs-recompute breakeven allocates ordinary pool blocks for
        the span now, and the restore is staged after admission (the plan
        only decides: a backed-off plan frees the blocks with nothing in
        flight to write into them).  Below breakeven the span re-prefills
        (counted)."""
        w = self._prefill_width(req)
        total = self.pool.blocks_for(w)
        cache = self.pool.prefix_cache
        # a backed-off admission freed its planned restore blocks; the
        # stale plan must not survive into this attempt
        req.extra.pop("tier_restore", None)
        if cache is None:
            return [], total
        unit = self._share_unit
        n_keys = ((w - self.prefill_chunk) // (unit * self.block_size)) * unit
        if n_keys <= 0:
            return [], total
        # a request stuck at the queue head is re-planned every tick:
        # reuse the hashes while its content (hence width) is unchanged
        keys = req.extra.get("prefix_keys")
        if keys is None or req.extra.get("prefix_keys_width") != w:
            content = req.effective_prompt()
            keys = prefix_block_keys(content, w - content.size, self.block_size, n_keys)
            req.extra["prefix_keys"] = keys
            req.extra["prefix_keys_width"] = w
        # only whole prefill chunks can be skipped
        n_shared = (len(cache.match(keys)) // unit) * unit
        shared = cache.claim(keys[:n_shared]) if n_shared else []
        restore_ids: list[int] = []
        if self.host_tier is not None and n_shared < len(keys):
            restore_ids = self._plan_tier_span(req, keys[n_shared:])
        return shared + restore_ids, total - len(shared) - len(restore_ids)

    def _plan_tier_span(self, req: Request, keys: list[bytes]) -> list[int]:
        """The combined device-and-host coverage walk past the device
        match, as in the JAX engine: LRU reclaim evicts a chain an entry
        at a time, so a prefix routinely ends up split between the pool
        and the tier.  Each covered key is a device hit (claimed in place)
        or a host hit (restored into a fresh block); the walk stops at the
        first key neither side holds, and the span truncates to whole
        share units.  Returns the span's block ids, in order (with the
        plan in ``req.extra["tier_restore"]``), or [] when the span is
        declined or an alloc fails (every claim and alloc rolled back)."""
        cache = self.pool.prefix_cache
        unit = self._share_unit
        span: list[tuple[bytes, int | None]] = []
        for key in keys:
            # device first: a key resident on both sides claims in place
            dev = cache.match([key])
            if dev:
                span.append((key, dev[0]))
            elif self.host_tier.contains(key):
                span.append((key, None))
            else:
                break
        span = span[: (len(span) // unit) * unit]
        n_host = sum(1 for _, b in span if b is None)
        if not n_host:
            return []
        if not self.host_tier.should_restore(n_host, self.block_size):
            # the measured breakeven says re-prefilling is cheaper
            self.host_tier.note_skip(n_host)
            return []
        # claim the span's device entries FIRST: their increfs pin them
        # against the LRU reclaim the restore-target allocs may trigger
        for key, dev_blk in span:
            if dev_blk is not None:
                cache.claim([key])
        plan: list[tuple[bytes, int, bool]] = []
        ordered: list[int] = []
        for key, dev_blk in span:
            if dev_blk is not None:
                ordered.append(dev_blk)
                plan.append((key, dev_blk, False))
                continue
            ids = self.pool.alloc(1)
            if ids is None:
                # roll the partial span back: decref the claimed device
                # entries, free the allocated targets (nothing enqueued)
                self.pool.free(ordered)
                for _, rest in span[len(ordered):]:
                    if rest is not None:
                        self.pool.free([rest])
                return []
            ordered.append(ids[0])
            plan.append((key, ids[0], True))
        req.extra["tier_restore"] = plan
        return ordered

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------
    def _upload(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Host metadata → the engine's device as int32 tensors, in ONE
        copy: the arrays are concatenated, moved, and split into
        contiguous views of their own shapes."""
        flat = np.concatenate([np.asarray(a, dtype=np.int32).ravel() for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, o = [], 0
        for a in arrays:
            out.append(dev[o:o + a.size].view(a.shape))
            o += a.size
        return out

    def _layer_pages(self, i: int) -> tuple:
        """Layer ``i``'s pool slabs ``(k, v, k_scale, v_scale)`` (scales
        None for a float pool), as contiguous views."""
        p = self.pool.pages
        if p.quantized:
            return p.k[i], p.v[i], p.k_scale[i], p.v_scale[i]
        return p.k[i], p.v[i], None, None

    def _write_kv(self, i: int, blk: torch.Tensor, off: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> None:
        """Write fresh K/V ``[N, K, D]`` of layer ``i`` at pool slots
        ``(blk, off)``, in place.  Dead lanes all write (scratch block 0,
        slot 0); which duplicate lands is unspecified on CUDA and
        harmless — no live table reads block 0.  Under TP with replicated
        KV heads only the heads this rank's pool holds are written."""
        kp, vp, ksp, vsp = self._layer_pages(i)
        k, v = self._pool_heads(k, 1), self._pool_heads(v, 1)
        if ksp is not None:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            kp[blk, off] = kq
            vp[blk, off] = vq
            ksp[blk, off] = ks
            vsp[blk, off] = vs
        else:
            kp[blk, off] = k.to(kp.dtype)
            vp[blk, off] = v.to(vp.dtype)

    def _run_layers(self, x: torch.Tensor, positions: torch.Tensor,
                    write: Callable, attend: Callable) -> torch.Tensor:
        """The decoder stack over ``x`` with the pool as its cache: layer
        i's fresh K/V go to ``write(i, k, v)`` and its attention is
        ``attend(i, q, sliding)``."""
        cfg = self.config
        cos, sin = rope_cos_sin(positions, cfg, dtype=torch.float32)
        act = ACT2FN[cfg.hidden_act]
        for i in range(cfg.num_hidden_layers):
            w = transformer.layer_weights(self.params["layers"], i)

            def kv_update(k, v, i=i):
                write(i, k, v)
                return None, None

            x, _, _, _ = run_decoder_layer(
                w, x, config=cfg, act=act, cos=cos, sin=sin,
                sliding=cfg.layer_is_sliding(i), kv_update=kv_update,
                attn_fn=lambda q, _k, _v, sliding, i=i: attend(i, q, sliding),
                mesh=self.mesh,
            )
        return x

    def _draw(self, logits: torch.Tensor, seeds: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
        """Sample ``logits [N, V]``, row n under the key ``fold_in(
        PRNGKey(seeds[n]), pos[n])`` (int32 ``[N]`` on the card: the
        request's seed word and the token's content position), as the JAX
        engine keys its rows, so a preempted request replays its stream.
        A greedy sampler needs no key."""
        if self.sampler.kind == "greedy":
            return self.sampler(None, logits)
        return self.sampler(random.fold_in(random.PRNGKey(seeds), pos), logits)

    def _sample_tail(self, x: torch.Tensor, seeds: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
        """Rows of pre-final-norm hidden states ``x [N, H]`` → ``[N]``
        int32 samples: the fused epilogue kernel (greedy, float or int8 head), or
        final_logits + the keyed sampler.  Under TP the epilogue runs on this
        rank's vocab shard and the ranks' (row maximum, index) pairs merge;
        the logits are gathered over "model" before a keyed draw, so every
        rank draws the same token."""
        if self.epilogue_impl == "fused":
            return transformer.sample_epilogue_tail(self.params, x, self.config, self.mesh)
        logits = final_logits(self.params, x[:, None], self.config, mesh=self.mesh)
        return self._draw(logits[:, 0], seeds, pos)

    def _mixed_step(self, host: dict[str, np.ndarray]) -> torch.Tensor:
        """The unified-tick step of the tick's bucket: the packed operands
        copied into the bucket's static buffers, then its captured step.
        Returns the bucket's static ``[R, W+3]`` sync rows (on the device;
        read them before the next tick)."""
        t_w = host["tokens"].shape[0]
        st = self._bucket_step(t_w)
        st.upload(host)
        self._lockstep("mixed", t_w, st.host_np)
        self.bucket_dispatches[t_w] = self.bucket_dispatches.get(t_w, 0) + 1
        st.run()
        return st.out

    def _bucket_step(self, t_w: int) -> _StaticStep:
        st = self._mixed_steps.get(t_w)
        if st is None:
            st = self._mixed_steps[t_w] = _mixed_step_state(self, t_w)
        return st

    def _mixed_body(self, ops: dict[str, torch.Tensor], out: torch.Tensor) -> None:
        """ONE pass of the packed ragged batch through the decoder — every
        token's K/V scattered into its pool block, ``ragged_paged_attention``
        over the block tables in every layer, and each row's sample slots
        through the tail (a sampled kind keyed by the rows' seeds and
        sample positions) — writing the packed sync rows to ``out``.  It
        reads nothing from the host."""
        cfg = self.config
        (tokens, positions, tok_blk, tok_off, tile_row, tile_qpos0, tile_qlen, tables,
         pads, last_idx, verify_len, seeds, sample_pos) = (ops[k] for k in _MIXED_OPERANDS)
        win = cfg.sliding_window

        def write(i, k, v):
            self._write_kv(i, tok_blk, tok_off, k[0], v[0])

        def attend(i, q, sliding):
            kp, vp, ksp, vsp = self._layer_pages(i)
            window = win if (win is not None and sliding) else GLOBAL_WINDOW
            return _da.ragged_paged_attention(
                q[0], kp, vp, tables, tile_row, tile_qpos0, tile_qlen, pads, window,
                k_scale=ksp, v_scale=vsp, scale=cfg.attn_scale,
                logit_softcap=cfg.attn_logit_softcapping,
            )[None]

        x = embed_inputs(self.params, tokens[None, :], cfg, self.mesh)  # [1, T, H]
        x = self._run_layers(x, positions[None, :], write, attend)
        r, w_cols = last_idx.shape
        xr = x[0][last_idx.reshape(-1)]  # [R*W, H]: only the sample slots
        nxt = self._sample_tail(xr, seeds.repeat_interleave(w_cols),
                                sample_pos.reshape(-1)).reshape(r, w_cols)
        # the accept walk on the card: a verify slice's drafts ARE its
        # packed input tokens at columns 1..k', so the longest prefix
        # matching the samples needs no host round trip
        drafts = tokens[last_idx[:, 1:]]  # [R, W-1]
        jpos = torch.arange(w_cols - 1, dtype=torch.int32, device=nxt.device)[None, :]
        hit = (drafts == nxt[:, :-1]) & (jpos < verify_len[:, None] - 1)
        accept = torch.cumprod(hit.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
        out.copy_(_pack_sync(nxt, _stop_hits(nxt, self._stops), accept))

    def _decode_step(self, host: dict[str, np.ndarray]) -> torch.Tensor:
        """The phase-split decode step: the operands copied into its static
        buffers, then its captured step (one graph, captured at the first
        call).  Returns the static packed ``[B, 4]`` sync rows (on the
        device; read them before the next tick)."""
        if self._split_step is None:
            self._split_step = _decode_step_state(self)
        st = self._split_step
        st.upload(host)
        self._lockstep("decode", 0, st.host_np)
        st.run()
        return st.out

    def _decode_body(self, ops: dict[str, torch.Tensor], out: torch.Tensor) -> None:
        """The phase-split decode step over every slot: the input token's
        K/V goes to slot ``lengths`` of its row, then row b attends slots
        ``[pads, lengths]`` (window-clipped on sliding layers) through
        ``decode_attn_impl``, and the sample (keyed by the row's seed and
        content position) lands in the packed ``[B, 4]`` sync rows
        ``out``.  It reads nothing from the host."""
        cfg = self.config
        impl = self.decode_attn_impl
        toks, content_pos, blk, off, tables, vis, pads, pads_sliding, seeds = (
            ops[k] for k in _DECODE_OPERANDS)
        s_max = self.max_seq_len
        pos = None if impl == "paged" else torch.arange(s_max, device=self.device)[None, :]

        def write(i, k, v):
            self._write_kv(i, blk, off, k[:, 0], v[:, 0])

        def attend(i, q, sliding):
            kp, vp, ksp, vsp = self._layer_pages(i)
            lower = pads_sliding if sliding else pads
            kw = dict(scale=cfg.attn_scale, logit_softcap=cfg.attn_logit_softcapping)
            if impl == "paged":
                return _da.paged_decode_attention(q, kp, vp, tables, vis, lower,
                                                  k_scale=ksp, v_scale=vsp, **kw)
            b = tables.shape[0]

            def view(pages):  # [NB, BS, *t] → the rows' [B, S_max, *t]
                return pages[tables.long()].reshape(b, s_max, *pages.shape[2:])

            mask = (pos >= lower[:, None]) & (pos < vis[:, None])
            if impl == "flash_decode":
                scales = {}
                if ksp is not None:
                    scales = dict(k_scale=view(ksp), v_scale=view(vsp))
                return _da.decode_attention(q, view(kp), view(vp), mask, **scales, **kw)
            k_att, v_att = view(kp), view(vp)
            if ksp is not None:
                k_att = dequantize_kv(k_att, view(ksp), q.dtype)
                v_att = dequantize_kv(v_att, view(vsp), q.dtype)
            return gqa_attention(q, k_att, v_att, mask[:, None, :], **kw)

        x = embed_inputs(self.params, toks[:, None], cfg, self.mesh)  # [B, 1, H]
        x = self._run_layers(x, content_pos[:, None], write, attend)
        nxt = self._sample_tail(x[:, -1], seeds, content_pos)[:, None]
        accept = torch.zeros(nxt.shape[0], dtype=torch.int32, device=nxt.device)
        out.copy_(_pack_sync(nxt, _stop_hits(nxt, self._stops), accept))

    def _gather_prefix(self, cache: KVCache, ids: list[int], pad: int) -> None:
        """Copy shared blocks ``ids`` into the temp cache's slots
        ``[0, H*bs)`` and set its validity/length — the state a full
        prefill of those chunks would have left."""
        h = len(ids)
        n = h * self.block_size
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        p = self.pool.pages
        l_axis = p.k.shape[0]
        sel = self._kv_sel
        for slab, page in ((cache.k, p.k), (cache.v, p.v),
                           (cache.k_scale, p.k_scale), (cache.v_scale, p.v_scale)):
            if page is not None:
                src = page[:, idx].reshape(l_axis, n, *page.shape[3:])
                # under TP with replicated KV heads the pool holds the
                # heads the query heads read; the others stay unread
                if sel is None:
                    slab[:, 0, :n] = src
                elif isinstance(sel, slice):
                    slab[:, 0, :n, sel] = src
                else:
                    slab[:, 0, :n].index_copy_(2, sel, src)
        pos = torch.arange(cache.max_seq_len, device=self.device)
        cache.valid[0] = (pos >= pad) & (pos < n)
        cache.set_length(n)

    def _scatter_prefill(self, cache: KVCache, ids: list[int], start: int) -> None:
        """Copy the temp cache's slots from block offset ``start`` into
        pool blocks ``ids`` (shared blocks before ``start`` are never
        written)."""
        nb, bs = len(ids), self.block_size
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        p = self.pool.pages
        l_axis = p.k.shape[0]
        for slab, page in ((cache.k, p.k), (cache.v, p.v),
                           (cache.k_scale, p.k_scale), (cache.v_scale, p.v_scale)):
            if page is not None:
                fresh = self._pool_heads(slab[:, 0, start * bs:(start + nb) * bs], 2)
                page[:, idx] = fresh.reshape(l_axis, nb, bs, *page.shape[3:])

    # ------------------------------------------------------------------
    # Host-RAM KV tier (serve/host_tier.py)
    # ------------------------------------------------------------------
    def _block_clone(self, blk: int) -> list[torch.Tensor]:
        """Pool block ``blk``'s K/V (+ scale pages) as contiguous clones,
        made on the engine's stream: a block ``[L, BS, K, D]`` strides
        over the layer axis, and a host copy of such a view would go
        through a hidden temporary."""
        return [a[:, blk].clone(memory_format=torch.contiguous_format)
                for a in self.pool.pages if a is not None]

    def _on_prefix_reclaim(self, key: bytes, blk: int) -> None:
        """One prefix-cache entry is about to be LRU-reclaimed (its block
        returns to the free list).  Always counted; with the host tier
        attached, the block is cloned BEFORE the id frees — the clone is
        ordered on the engine's stream ahead of any later write to the
        block — and handed to the tier's writer thread."""
        nbytes = self._block_nbytes
        spilled = False
        if self.host_tier is not None:
            spilled = True
            # the ledgers count only blocks the tier accepted (it dedupes
            # resident and queued keys)
            if self.host_tier.enqueue_spill(key, *self._block_clone(blk)):
                self._tier_spill_bytes += nbytes
                self.metrics.on_tier_spill(blocks=1, nbytes=nbytes)
        self.metrics.on_prefix_evicted(blocks=1, nbytes=nbytes)
        if self.tracer is not None:
            self.tracer.instant("prefix-evict", cat="kv_tier", args={
                "blocks": 1, "bytes": nbytes, "spilled": spilled})

    def _enqueue_tier_restores(self, req: Request) -> None:
        """Stage the admission plan's host-tier hits: one writer-thread
        job per block.  Runs only after the admission stuck — the planned
        blocks are owned by ``req``, so a job never targets a free id."""
        plan = req.extra.get("tier_restore")
        if not plan or self.host_tier is None:
            return
        req.extra["tier_tickets"] = [
            self.host_tier.enqueue_restore(key, blk, self.device)
            for key, blk, is_restore in plan if is_restore
        ]

    def _apply_tier_restores(self, reqs: list[Request]) -> None:
        """Land staged restores in the pool BEFORE the covering step: each
        staged block is copied into the pool's own pages at its planned id
        (in place — the captured steps read the pages by address), after
        the engine's stream waits on the staging copy's event.  A miss
        (the host entry raced a capacity eviction, or ``take_restored``
        timed out) un-covers the span's tail: those blocks stay allocated
        and ordinary prefill writes them.  Restored blocks register in the
        prefix cache at once.  A failed copy raises (``HostTierError``)."""
        if self.host_tier is None:
            return
        cuda = self.device.type == "cuda"
        for req in reqs:
            plan = req.extra.pop("tier_restore", None)
            tickets = req.extra.pop("tier_tickets", None)
            if not plan or tickets is None:
                continue
            results = iter(self.host_tier.take_restored(tickets))
            n_dev = req.n_shared_blocks - len(plan)
            ok = 0
            n_restored = 0
            lat = 0.0
            pages = self.pool.pages
            stream = torch.cuda.current_stream(self.device) if cuda else None
            for key, blk, is_restore in plan:
                if not is_restore:
                    ok += 1  # device-claimed in place: already valid
                    continue
                res = next(results)
                if res is None:
                    break  # coverage is prefix-contiguous: stop here
                _, staged, dt, ready = res
                if ready is not None:
                    stream.wait_event(ready)
                self.n_dispatches += 1
                for dst, src in zip(pages, staged):
                    if dst is not None:
                        dst[:, blk].copy_(src)
                        if stream is not None:
                            src.record_stream(stream)
                ok += 1
                n_restored += 1
                lat = max(lat, dt)
            unit = self._share_unit
            ok = (ok // unit) * unit  # coverage in whole share units
            if ok < len(plan):
                # re-prefill the un-covered tail: the tail blocks stay in
                # req.block_ids and the prefill writes them (a device-
                # claimed block rounded out of the span is rewritten with
                # the same content, so its sharers are unaffected)
                req.n_shared_blocks = n_dev + ok
                req.prefill_done = min(
                    req.prefill_done,
                    max(req.n_shared_blocks * self.block_size - req.pad, 0))
            pc = self.pool.prefix_cache
            for key, blk, is_restore in plan[:ok]:
                if is_restore and pc is not None:
                    pc.register([key], [blk])
            if n_restored:
                nbytes = n_restored * self._block_nbytes
                self._tier_restore_bytes += nbytes
                self._tier_restore_us += lat * 1e6
                self.metrics.on_tier_restore(blocks=n_restored, nbytes=nbytes, latency_s=lat)
                if self.tracer is not None:
                    self.tracer.request_instant(req.req_id, "kv-restore", args=self._targs(
                        req, blocks=n_restored, bytes=nbytes, restore_us=round(lat * 1e6, 1)))

    def spill_prefix_blocks(self, keys: list[bytes] | None = None) -> int:
        """Ship registered prefix blocks into the host tier WITHOUT
        dropping them — the fleet's block-shipping primitive: another
        engine that shares the tier then restores the prefix instead of
        re-prefilling it.  ``keys=None`` ships every registered entry;
        a key chain ships its matched prefix.  A registered full prefix
        block is never rewritten while registered, so the clones are
        stable; they are made while the tier is quiesced, so a call from
        another thread cannot overlap a capture.  Returns the number of
        blocks enqueued."""
        if self.host_tier is None or self.pool.prefix_cache is None:
            return 0
        if keys is None:
            pairs = self.pool.prefix_cache.items()
        else:
            ids = self.pool.prefix_cache.match(list(keys))
            pairs = list(zip(keys, ids))
        n = 0
        with self.host_tier.quiesce():
            for key, blk in pairs:
                if self.host_tier.contains(key):
                    continue  # fast path; the enqueue dedupe is authoritative
                if self.host_tier.enqueue_spill(key, *self._block_clone(blk)):
                    self.metrics.on_tier_spill(blocks=1, nbytes=self._block_nbytes)
                    n += 1
        return n

    def _tier_tick_start(self) -> None:
        """Per-tick tier bookkeeping: zero the tick's byte counters and
        raise a failure the writer kept since the last tick."""
        if self.host_tier is not None:
            self.host_tier.check()
            self._tier_spill_bytes = 0
            self._tier_restore_bytes = 0
            self._tier_restore_us = 0.0

    def _tier_tick_end(self) -> None:
        """Refresh the tier gauges on a tick that moved tier bytes."""
        if self.host_tier is not None and (self._tier_spill_bytes or self._tier_restore_bytes):
            self.metrics.on_tier_gauge(
                resident_bytes=self.host_tier.resident_bytes,
                breakeven=self.host_tier.breakeven_ratio(self.block_size))

    # ------------------------------------------------------------------
    # Request lifecycle
    # ------------------------------------------------------------------
    def submit(
        self,
        prompt_ids: np.ndarray | list[int],
        max_new_tokens: int,
        *,
        request_id: int | None = None,
        seed: int = 0,
        callback: Callable[[Request, int, str | None], None] | None = None,
        on_event: Callable[[Request, str], None] | None = None,
        deadline_s: float | None = None,
        arrival_time: float | None = None,
        trace_id: str | None = None,
        speculative: bool = False,
        tenant: str = "default",
        _recovered: bool = False,
    ) -> Request:
        """Queue a request.  ``speculative=True`` opts it into draft-then-
        verify (inert on an engine built without ``spec_k``, kept so that a
        replay onto a spec engine resumes drafting).  ``trace_id`` (the W3C
        trace id the HTTP server parsed or generated; minted here when a
        tracer or a request log will record it) is kept in
        ``req.extra["trace"]``; ``tenant`` is the request's bill, and with a
        ``TenantLedger`` whose ``max_inflight`` cap the tenant's live
        requests already fill, the submit raises ``TenantThrottled``.
        ``_recovered`` is ``recover``'s resubmit: exempt from both caps,
        counted as a recovery, and journaled by ``recover`` once its tokens
        are seeded."""
        prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        worst = worst_case_slots(prompt.size, max_new_tokens, self.prefill_chunk)
        if worst > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) needs up "
                f"to {worst} cache slots > max_seq_len {self.max_seq_len}"
            )
        # worst-case ADMISSION need (a re-prefill carries up to
        # max_new_tokens-1 generated tokens): a request that can never be
        # admitted would block the strict-FIFO queue head forever
        need_max = self.pool.blocks_for(
            _ceil_to(prompt.size + max_new_tokens - 1, self.prefill_chunk))
        headroom = need_max + self.scheduler.decode_reserve
        if headroom > self.pool.capacity:
            raise ValueError(
                f"request needs up to {need_max} blocks + "
                f"{self.scheduler.decode_reserve} reserve to admit > pool capacity "
                f"{self.pool.capacity}; grow num_blocks or shrink the request"
            )
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if deadline_s is not None and self._multi:
            raise NotImplementedError(
                f"deadlines under a multi-rank mesh are not ported yet ({MESH_ITEM}): each "
                "rank's sweep would read its own wall clock")
        if request_id is None:
            request_id = self._next_id
        self._next_id = max(self._next_id, request_id) + 1
        # the per-tenant in-flight cap over the live requests (queued and
        # running); recovered work is exempt, like the queue cap
        if self.tenants is not None and not _recovered:
            cap = self.tenants.max_inflight
            if cap is not None:
                n_live = sum(1 for r in self._requests.values() if r.tenant == tenant)
                if n_live >= cap:
                    self.tenants.on_throttle(tenant)
                    self.metrics.on_reject()
                    if self.tracer is not None:
                        self.tracer.instant("tenant-throttled", cat="request", args={
                            "tenant": tenant, "inflight": n_live, "cap": cap})
                    raise TenantThrottled(tenant, n_live, cap)
        req = Request(
            req_id=request_id,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            seed=seed,
            callback=callback,
            on_event=on_event,
            arrival_time=arrival_time if arrival_time is not None else 0.0,
            speculative=bool(speculative),
            tenant=tenant,
        )
        req.submit_time = self.clock()
        if deadline_s is not None:
            req.deadline = req.submit_time + deadline_s
        if trace_id is None and (self.tracer is not None or self.request_log is not None):
            trace_id = gen_trace_id()
        if trace_id is not None:
            req.extra["trace"] = trace_id
        req.extra["weights_version"] = self.weights_version
        try:
            self.scheduler.add(req, exempt_cap=_recovered)
        except QueueFull:
            self.metrics.on_reject()
            raise
        if _recovered:
            # counted at its original submit (the metrics survive the
            # restart): record the recovery itself instead
            self.metrics.on_recover()
        else:
            self.metrics.on_submit(req)
        if self.tracer is not None:
            self.tracer.request_phase(req.req_id, "queued", args=self._targs(
                req, prompt_len=req.prompt_len, max_new_tokens=max_new_tokens))
            if _recovered:
                # the link instant: a replay continues the same trace id
                self.tracer.request_instant(req.req_id, "recovery-replay",
                                            args=self._targs(req))
        self._requests[req.req_id] = req
        if self.journal is not None and not _recovered:
            self.journal.admit(req, now=self.clock())
        if self.tokenizer is not None:
            self._detok[req.req_id] = IncrementalDetok(self.tokenizer)
        return req

    def _emit(self, req: Request, token: int) -> None:
        req.generated.append(int(token))
        if req.first_token_time is None:
            req.first_token_time = self.clock()
        self.metrics.on_token(req)
        if req.callback is not None:
            delta = None
            detok = self._detok.get(req.req_id)
            if detok is not None:
                delta = detok.push(token)
            req.callback(req, int(token), delta)

    def _emit_event(self, req: Request, event: str) -> None:
        if req.on_event is not None:
            req.on_event(req, event)

    def _flush_detok(self, req: Request) -> None:
        """Pop the request's detokenizer and park any held-back tail text
        in ``req.extra['final_text_delta']``."""
        detok = self._detok.pop(req.req_id, None)
        if detok is not None:
            tail = detok.flush()
            if tail:
                req.extra["final_text_delta"] = tail

    def _maybe_finish(self, req: Request) -> bool:
        if req.state is not RequestState.RUNNING:
            # aborted out from under us (e.g. from a token callback)
            return True
        hit_stop = bool(
            self.stop_tokens and req.generated and req.generated[-1] in self.stop_tokens
        )
        if req.done or hit_stop:
            # a stop token on the last budgeted step still reports "stop"
            req.finish_reason = "stop" if hit_stop else "length"
            req.finish_time = self.clock()
            self.scheduler.finish(req)
            self._requests.pop(req.req_id, None)
            self._draft_states.pop(req.req_id, None)
            self._flush_detok(req)
            self.metrics.on_finish(req)
            if self.tenants is not None:
                self.tenants.on_terminal(req)
            if self.journal is not None:
                # the finishing tick's delta first (the request leaves the
                # live set before the tick's watermark), then the terminal
                self.journal.end_tick((req,))
                self.journal.terminal(req.req_id, req.finish_reason)
            self._log_request(req, req.finish_reason)
            if self.tracer is not None:
                self.tracer.request_end(req.req_id, req.finish_reason, args=self._targs(req))
            self._emit_event(req, req.finish_reason)
            return True
        return False

    def abort(self, request_id: int) -> bool:
        """Cancel a live request — queued, prefilled, or mid-decode: its
        slot frees, its block references drop (shared prefix blocks
        survive), and the terminal ``"aborted"`` event fires.  Returns
        False when the id is unknown or already terminal.  Not
        thread-safe, like every other engine entry point."""
        req = self._requests.pop(request_id, None)
        if req is None:
            return False
        self._draft_states.pop(request_id, None)
        self.scheduler.abort(req)
        req.finish_reason = "aborted"
        req.finish_time = self.clock()
        self._flush_detok(req)
        self.metrics.on_abort(req)
        if self.tenants is not None:
            # aborted work is billed work: the cost it accrued lands on
            # its tenant
            self.tenants.on_terminal(req)
        if self.journal is not None:
            self.journal.end_tick((req,))
            self.journal.terminal(req.req_id, "aborted")
        self._log_request(req, "aborted")
        if self.tracer is not None:
            self.tracer.request_end(req.req_id, "aborted", args=self._targs(req))
        self._emit_event(req, "aborted")
        return True

    def _sweep_deadlines(self) -> None:
        """Abort every live request past its deadline (checked once per
        tick)."""
        now = self.clock()
        expired = [r.req_id for r in self._requests.values()
                   if r.deadline is not None and now >= r.deadline]
        for rid in expired:
            self.abort(rid)

    def _register_prefix(self, req: Request) -> None:
        """After a prefill: register the request's fully-filled prompt
        blocks so the next matching prompt hits."""
        pc = self.pool.prefix_cache
        keys = req.extra.pop("prefix_keys", None)
        req.extra.pop("prefix_keys_width", None)
        if pc is not None and keys:
            pc.register(keys, req.block_ids[: len(keys)])
            self.metrics.on_prefix(requested=len(keys), hits=req.n_shared_blocks)

    # ------------------------------------------------------------------
    # Recovery: replay into a rebuilt engine (the supervised restart and
    # the journal's process restart)
    # ------------------------------------------------------------------
    def recover(
        self,
        prompt_ids: np.ndarray | list[int],
        max_new_tokens: int,
        *,
        request_id: int,
        seed: int = 0,
        generated: list[int] | tuple[int, ...] = (),
        callback: Callable[[Request, int, str | None], None] | None = None,
        on_event: Callable[[Request, str], None] | None = None,
        deadline_s: float | None = None,
        deadline_at: float | None = None,
        trace_id: str | None = None,
        lineage: dict | None = None,
        speculative: bool = False,
        tenant: str = "default",
        weights_version: int | None = None,
    ) -> Request:
        """Resubmit a request that was in flight when a previous engine (or
        process) died, with its delivered tokens teacher-forced: the
        evict-requeue discipline across a rebuild.  ``generated`` pre-seeds
        the request, so its prefill runs over prompt + generated and its
        later rows are keyed by (seed, content position) as before; the
        pre-seeded tokens are not re-emitted through the callback.  On the
        card the replay prefills, through prefill tiles, positions the first
        run decoded: in float32 the continuation equals the uninterrupted
        one, in bf16 it may part from it at a near-tie.

        ``trace_id`` continues the request's trace; ``lineage`` carries the
        ``replays`` / ``drains`` counts the request log reports; with
        ``speculative`` a spec engine's replay resumes drafting.  Deadlines
        resume the remaining budget: ``deadline_at`` is the original
        absolute deadline on the engine clock (``clone_fresh`` shares the
        clock), and one that expired while the engine was down is swept on
        the first tick; ``deadline_s`` is a fresh window instead.  A request
        already at its budget needs only its finish (``finish_recovered``)."""
        if deadline_s is not None and deadline_at is not None:
            raise ValueError("pass deadline_s or deadline_at, not both")
        if deadline_at is not None and self._multi:
            raise NotImplementedError(
                f"deadlines under a multi-rank mesh are not ported yet ({MESH_ITEM})")
        if len(generated) >= max_new_tokens:
            raise ValueError(
                f"request {request_id} already generated {len(generated)}/{max_new_tokens} "
                "tokens; deliver its finish event instead of recovering it")
        req = self.submit(
            prompt_ids, max_new_tokens, request_id=request_id, seed=seed,
            callback=callback, on_event=on_event, deadline_s=deadline_s,
            trace_id=trace_id, speculative=speculative, tenant=tenant, _recovered=True,
        )
        if deadline_at is not None:
            req.deadline = deadline_at
        req.generated = [int(t) for t in generated]
        if weights_version is not None:
            req.extra["weights_version"] = int(weights_version)
        if lineage:
            # before the journal's re-admission, so a second crash replays
            # the lineage with the token state
            req.extra.update({k: int(v) for k, v in lineage.items()
                              if k in ("replays", "drains")})
        if self.journal is not None:
            self.journal.admit(req, now=self.clock())
        detok = self._detok.get(req.req_id)
        if detok is not None:
            # the next delta continues the client's text exactly; the
            # replayed tokens' deltas were delivered before the crash
            for tok in req.generated:
                detok.push(tok)
        return req

    def finish_recovered(
        self,
        prompt_ids: np.ndarray | list[int],
        max_new_tokens: int,
        *,
        request_id: int,
        generated: list[int] | tuple[int, ...],
        reason: str,
        trace_id: str | None = None,
        lineage: dict | None = None,
        tenant: str = "default",
        weights_version: int | None = None,
    ) -> str | None:
        """Terminal bookkeeping for a recovered request that needs no re-run
        (every token generated before the crash, only its finish lost) or
        that recovery dropped: the finish or abort is counted in the
        metrics (which survive the rebuild), journaled and logged.  Returns
        the detokenizer's held-back tail text for the caller to deliver."""
        req = Request(
            req_id=request_id,
            prompt=np.asarray(prompt_ids, dtype=np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
        )
        req.generated = [int(t) for t in generated]
        req.finish_reason = reason
        req.tenant = tenant
        if trace_id is not None:
            req.extra["trace"] = trace_id
        req.extra["weights_version"] = int(
            weights_version if weights_version is not None else self.weights_version)
        if lineage:
            req.extra.update({k: int(v) for k, v in lineage.items()
                              if k in ("replays", "drains")})
        if self.journal is not None:
            self.journal.terminal(request_id, reason)
        if reason == "aborted":
            self.metrics.on_abort(req)
        else:
            self.metrics.on_finish(req)
        if self.tenants is not None:
            # the recovered terminal charges whatever cost the replay
            # carried (the dead engine's device time died with it)
            self.tenants.on_terminal(req)
        self._log_request(req, reason)
        if self.tracer is not None:
            # closes the span the dead engine left open: one finish
            # instant a terminal, across recoveries too
            self.tracer.request_end(request_id, reason, args=self._targs(
                req, recovered_terminal=True))
        if self.tokenizer is None or not req.generated:
            return None
        detok = IncrementalDetok(self.tokenizer)
        for tok in req.generated:
            detok.push(tok)
        return detok.flush() or None

    def retire(self, reason: str = "superseded by a restart") -> None:
        """Take this engine out of service before its replacement is built:
        every captured step drops its graph and raises if called again
        (the memory a graph replays into may belong to the replacement by
        then), the pool's pages are released (a late eager write fails on
        them, as a JAX engine's does on its deleted buffers), and ``step``
        raises.  The shapes it had captured are kept for ``clone_fresh``.
        Idempotent."""
        if self.retired is not None:
            return
        self._captured_shapes = self._captured_now()
        self.retired = reason
        for run in self.graph_steps():
            run.retire()
        self._mixed_steps = {}
        self._split_step = None
        self.pool.pages = None
        if self._release_side is not None:
            self._release_side()

    def _captured_now(self) -> tuple[list[int], bool]:
        """The packed widths whose step has its graph, and whether the
        phase-split decode step has one (a retired engine's, as it had
        them at ``retire``)."""
        if self.retired is not None:
            return self._captured_shapes
        return (sorted(t for t, st in self._mixed_steps.items() if self._built(st)),
                self._split_step is not None and self._built(self._split_step))

    def _built(self, st: _StaticStep) -> bool:
        """The step has its graph, or, under a multi-rank mesh (eager
        steps), has run."""
        return st.run.calls > 0 if self._multi else st.run.compiled

    def clone_fresh(self, *, params: Params | None = None,
                    weights_version: int | None = None) -> "ServeEngine":
        """A fresh engine with the same params, config, geometry and options
        and an empty pool: what a supervised restart rebuilds after a
        crash.  ``params`` / ``weights_version`` override the weights: the
        rolling upgrade's rebuild (``serve/replica.py``).  Carried across:
        the metrics (operator counters survive), the fault injector (its
        hit counts keep counting), the host tier (its entries survive the
        restart: the empty pool restores instead of re-prefilling), the
        journal, the request log and the request-id counter, and the
        observability plane and the action policy (the tracer, the
        sentinel, the telemetry model, the tenant ledger, ``actions``: a
        restart is the same replica, so its timeline and bills go on).

        Not carried: the captured steps.  The JAX clone shares its jitted
        steps; a CUDA graph replays its own engine's pool and buffer
        addresses, so the clone captures its own, and ``compile_counts()``
        on it counts them.  The order keeps the rebuild's peak at about one
        pool plus one set of graph pools: this engine is retired first
        (``retire``), the clone's pool is allocated into the memory that
        released, and the clone captures every bucket this engine had
        captured (and the phase-split decode step, if it had one) before
        it serves, so no capture lands inside a serving tick.  A live
        engine that must go on serving (the fleet's ``add_replica``)
        clones with ``clone_peer`` instead."""
        self.retire("superseded by clone_fresh")
        return self.clone_peer(params=params, weights_version=weights_version)

    def clone_peer(self, *, params: Params | None = None,
                   weights_version: int | None = None) -> "ServeEngine":
        """``clone_fresh`` without retiring this engine: the fleet's elastic
        ``add_replica`` clones a live replica, which goes on serving (the
        JAX clone never retires its source; the port's restart path does).
        The clone shares the params tensors (or takes ``params``), carries
        what ``clone_fresh`` carries, and captures every bucket this engine
        has captured, before anyone routes to it.  On the card call it on
        the thread and stream that will tick the clone."""
        if params is None:
            params = self.params
        elif self.mesh is not None:
            params = shard_params(params, self.config, self.mesh_plan, self.mesh)
        eng = ServeEngine(
            params, self.config,
            sampler=self.sampler,
            stop_tokens=self.stop_tokens,
            max_slots=self.scheduler.max_slots,
            num_blocks=self.pool.num_blocks,
            block_size=self.block_size,
            max_seq_len=self.max_seq_len,
            prefill_chunk=self.prefill_chunk,
            cache_dtype=self.cache_dtype,
            decode_attn_impl=self.decode_attn_impl,
            enable_prefix_cache=self.pool.prefix_cache is not None,
            max_queue=self.scheduler.max_queue,
            tokenizer=self.tokenizer,
            clock=self.clock,
            mixed_step=self.mixed_step_mode,
            sample_epilogue=self.sample_epilogue_mode,
            tick_token_budget=self.tick_token_budget or None,
            spec_k=self.spec_k,
            spec_ngram=self.spec_ngram,
            spec_min_accept=self.spec_min_accept,
            spec_window=self.spec_window,
            host_tier=self.host_tier,
            fault_injector=self.faults,
            journal=self.journal,
            request_log=self.request_log,
            tracer=self.tracer,
            sentinel=self.sentinel,
            telemetry=self.telemetry,
            tenants=self.tenants,
            actions=self.actions,
            weights_version=(weights_version if weights_version is not None
                             else self.weights_version),
            device=self.device,
            mesh=self.mesh,
        )
        eng.metrics = self.metrics
        eng._next_id = self._next_id
        eng.share_compiled_steps(self)
        return eng

    def share_compiled_steps(self, src: "ServeEngine") -> None:
        """The port's spelling of the JAX engine's adoption of a peer's
        jitted steps.  A CUDA graph replays its own engine's pool and
        buffer addresses, so nothing is adopted; the contract kept is that
        joining the fleet captures nothing while serving: this engine
        captures every bucket ``src`` has captured (and the phase-split
        decode step, if ``src`` has it) now, before it is routed to, and,
        with ``actions``, every bucket (a shed budget packs smaller ticks,
        whose buckets ``src`` may never have used).  ``compile_counts()``
        counts those captures."""
        if self.mixed != src.mixed:
            return
        buckets, split = src._captured_now()
        for t_w in self.mixed_buckets:
            if t_w in buckets or self.actions is not None:
                self._warm_mixed_bucket(t_w)
        if split:
            self._warm_split_step()

    def _log_request(self, req: Request, reason: str) -> None:
        """Emit the canonical wide-event line for a terminal request
        (enqueue only: the request log's writer thread does the IO)."""
        if self.request_log is None:
            return
        tracker = self.metrics.slo
        self.request_log.emit(request_record(
            req, reason=reason, policy=tracker.policy if tracker is not None else None,
            clock=self.clock))

    def _targs(self, req: Request, **kw: Any) -> dict:
        """Span args with the request's W3C trace id (and a non-default
        tenant) merged in.  Callers hold the tracer's is-None guard."""
        tid = req.extra.get("trace")
        if tid is not None:
            kw["trace"] = tid
        if req.tenant != "default":
            kw["tenant"] = req.tenant
        return kw

    def _sentinel_observe(self, phases: tuple[tuple[str, float, float], ...]) -> list[dict]:
        """Feed one traced tick's phase slices to the sentinel; an outlier
        bumps the per-phase anomaly counter and stamps a trace instant
        naming the guiltiest phase.  Returns the outliers."""
        sent = self.sentinel
        if sent is None:
            return []
        outliers = sent.observe(phases)
        if not outliers:
            return []
        for o in outliers:
            self.metrics.on_anomaly(str(o["phase"]))
        guilty = outliers[0]
        if self.tracer is not None:
            self.tracer.instant("anomaly", cat="sentinel", args={
                "phase": guilty["phase"], "dur_us": round(float(guilty["dur_us"]), 1),
                "baseline_us": round(float(guilty["baseline_us"]), 1), "tick": sent.ticks})
        return outliers

    def _tick_budget(self) -> int:
        """This tick's token budget: the configured budget, capped by the
        ActionPolicy's shed-prefill verdict (decode rows are never shed:
        the floor is max_slots).  Every budget it can give picks a bucket
        of ``mixed_buckets``, which ``warmup`` captures (and a clone with
        actions captures up front, ``share_compiled_steps``)."""
        if self.actions is None:
            return self.tick_token_budget
        return self.actions.plan_budget(self.tick_token_budget, self.scheduler.max_slots)

    def _actions_tick(self, outliers: list[dict]) -> None:
        """Feed one tick's sentinel verdicts and SLO burn to the
        ActionPolicy; count and trace every flip (the
        ``llm_serve_lifecycle_actions_total{action=}`` series and the
        ``lifecycle-action`` instants).  ``self.actions`` is re-read at
        each use: the supervisor mutes a dead engine by clearing it."""
        if self.actions is None:
            return
        for action in self.actions.on_tick(outliers, self.metrics.slo):
            self.metrics.on_lifecycle_action(action)
            if self.tracer is not None and self.actions is not None:
                self.tracer.instant("lifecycle-action", cat="lifecycle",
                                    args={"action": action, **self.actions.state_args()})

    def _fair_prefill_order(self, running: list[Request]) -> list[Request]:
        """The tenant-fairness prefill order: the running list sorted by
        each tenant's accumulated cost share (byte-based with telemetry
        attached, token-based otherwise), a stable sort, so a tenant's
        requests stay oldest first and one tenant's order is unchanged.
        Only the prefill fill reads it: decode rows are never reordered."""
        if self.tenants is None:
            return running
        share = self.tenants.cost_shares(running, use_bytes=self.telemetry is not None)
        return sorted(running, key=lambda r: share.get(r.tenant, 0.0))

    # ------------------------------------------------------------------
    # Phase-split tick
    # ------------------------------------------------------------------
    def _prefill_request(self, req: Request) -> None:
        """Chunked ragged prefill into a temp contiguous cache, scatter
        into the request's blocks, sample + emit the first token.
        Prefix-cache hits (``req.n_shared_blocks`` leading blocks) skip
        their chunks: the shared K/V is copied into the temp cache (a
        slot's K/V depends only on its token and position) and the
        remaining chunks run from that offset.  Host-tier hits land
        first: the claimed blocks must hold real K/V before they are
        gathered (a miss un-covers the tail, which then prefills)."""
        if self.faults is not None and self.faults.trip("prefill") is not None:
            raise FaultInjected("prefill")
        self._enqueue_tier_restores(req)
        self._apply_tier_restores([req])
        t_tel = self.clock() if self.telemetry is not None else 0.0
        content = req.effective_prompt()
        w = self._prefill_width(req)
        req.pad = w - content.size
        n_shared = req.n_shared_blocks
        shared_slots = n_shared * self.block_size
        dev = self.device
        ids = np.zeros((1, w), dtype=np.int64)
        mask = np.zeros((1, w), dtype=bool)
        ids[0, req.pad:] = content
        mask[0, req.pad:] = True
        ids_d = torch.from_numpy(ids).to(dev)
        mask_d = torch.from_numpy(mask).to(dev)
        pads = torch.tensor([req.pad], dtype=torch.long, device=dev)
        cache = KVCache.init(self.config, 1, self.max_seq_len, dtype=self.cache_dtype,
                             device=dev, kv_heads=local_kv_heads(self.config, self.mesh))
        if n_shared:
            self.n_dispatches += 1
            self._gather_prefix(cache, req.block_ids[:n_shared], req.pad)
        t_pf = self.clock() if self.host_tier is not None else 0.0
        last = None
        for off in range(shared_slots, w, self.prefill_chunk):
            end = off + self.prefill_chunk
            t_chunk = self.tracer.now_us() if self.tracer is not None else -1.0
            self.n_dispatches += 1
            with (torch.profiler.record_function("serve.prefill_chunk")
                  if self.tracer is not None else _NULL_CTX):
                last, cache = self._prefill_step(
                    self.params, ids_d[:, off:end], cache, mask_d[:, off:end], pads)
            if self.tracer is not None and t_chunk >= 0.0:
                # launch time, not device time: the chunk is eager and
                # asynchronous; its device side is in a profiler capture
                # under the record_function range above
                self.tracer.complete("prefill_chunk", t_chunk, cat="prefill", args={
                    "rid": req.req_id, "offset": off, "width": end - off})
        self.n_dispatches += 1
        self._scatter_prefill(cache, req.block_ids[n_shared:], n_shared)
        self._register_prefix(req)
        self.n_dispatches += 1
        seed, pos = self._upload(np.asarray([_seed_word(req.seed)]),
                                 np.asarray([content.size - 1]))
        tok = self._draw(last, seed, pos)
        # the phase-split design emits the first token inside the prefill
        # phase (its own sync); the unified tick retired this fetch
        tok_host = int(tok[0].item())
        if self.host_tier is not None and w > shared_slots:
            # measured prefill rate over the fresh chunks (the sync above
            # closed the window) — the breakeven's recompute side
            dt = self.clock() - t_pf
            if dt > 0:
                self.host_tier.note_prefill_rate((w - shared_slots) / dt)
        if self.telemetry is not None:
            # the chunks are this request's alone: their whole bill (the
            # weights streamed a chunk, the fresh K/V written, the wall the
            # sync above closed) lands on it, and the totals-only record
            # keeps the metrics' ledgers equal to the requests' sums.
            # Before _emit: a token callback may abort the request
            self.metrics.on_telemetry(self.telemetry.prefill_cost(
                self, req, self.clock() - t_tel))
        self._emit(req, tok_host)

    def step(self) -> bool:
        """One scheduler tick; returns True while work remains.  A retired
        engine (``retire``) raises: its pool and graphs are gone."""
        if self.retired is not None:
            raise RuntimeError(f"this engine was retired ({self.retired}); step the "
                               "engine that replaced it")
        self._ticks += 1
        if self.mixed:
            return self._step_mixed()
        return self._step_split()

    def _step_split(self) -> bool:
        """One phase-split tick: deadline sweep, admissions (+prefill),
        block growth, then one packed decode step.  With a tracer attached
        each tick records one ``tick`` span and its ``TICK_PHASES`` slices
        at consecutive timestamps; ``self.tracer`` is re-read at every hook
        (the supervisor mutes a dead engine by clearing it), and a tick
        that started untraced records nothing."""
        t0 = self.tracer.now_us() if self.tracer is not None else -1.0
        fetches0 = self.n_host_fetches
        outliers: list[dict] = []
        self._tier_tick_start()
        self._sweep_deadlines()
        admitted = self.scheduler.admit()
        if self._multi:
            # the admissions' prefills run the forward's collectives
            self._lockstep("prefill", len(admitted), np.asarray(
                [x for r in admitted for x in (r.req_id, r.total_len, r.n_shared_blocks,
                                               *r.block_ids)], np.int64))
        t1 = self.tracer.now_us() if self.tracer is not None else -1.0
        for req in admitted:
            t_req = self.clock()
            if req.admit_time is None:
                req.admit_time = t_req
            if self.tracer is not None:
                self.tracer.request_phase(req.req_id, "prefill", args=self._targs(
                    req, shared_blocks=req.n_shared_blocks, preemptions=req.n_preemptions))
            self._prefill_request(req)
            req.prefill_s += self.clock() - t_req
            if not self._maybe_finish(req) and self.tracer is not None:
                self.tracer.request_phase(req.req_id, "decode")
        t2 = self.tracer.now_us() if self.tracer is not None else -1.0

        # preempted requests are already requeued; slots rebuilt below
        for req in self.scheduler.ensure_decode_blocks():
            if self.tracer is not None:
                self.tracer.request_instant(req.req_id, "evicted-requeued")
                self.tracer.request_phase(req.req_id, "queued")
            self._emit_event(req, "evicted-requeued")
        t3 = self.tracer.now_us() if self.tracer is not None else -1.0

        running = [r for r in self.scheduler.running if r.generated]
        t4 = t5 = t3
        tel = None
        cost = None
        tdev0 = 0.0
        if running:
            b = self.scheduler.max_slots
            bs = self.block_size
            win = self.config.sliding_window
            tables = np.zeros((b, self.max_blocks_per_seq), dtype=np.int32)
            lengths = np.zeros(b, dtype=np.int32)
            pads = np.zeros(b, dtype=np.int32)
            toks = np.zeros(b, dtype=np.int32)
            seeds = np.zeros(b, dtype=np.int32)
            for r in running:
                tables[r.slot, : len(r.block_ids)] = r.block_ids
                # slots written so far: pads + content minus the latest
                # generated token (this tick's input, written by the step)
                lengths[r.slot] = r.cache_len - 1
                pads[r.slot] = r.pad
                toks[r.slot] = r.generated[-1]
                seeds[r.slot] = _seed_word(r.seed)
            vis = lengths + 1
            # a sliding layer's single query at slot lengths sees slots
            # > lengths - window: an effective left pad of vis - window
            pads_sliding = np.maximum(pads, vis - win) if win is not None else pads
            host = dict(
                toks=toks, content_pos=lengths - pads,
                blk=tables[np.arange(b), lengths // bs], off=lengths % bs,
                tables=tables, vis=vis, pads=pads, pads_sliding=pads_sliding, seeds=seeds,
            )
            if self.telemetry is not None:
                tdev0 = self.clock()
            self._dispatch_faults(has_prefill=False)
            self.n_dispatches += 1
            self.n_decode_dispatches += 1
            with (torch.profiler.record_function("serve.decode_dispatch")
                  if self.tracer is not None else _NULL_CTX):
                out = self._decode_step(host)
            t4 = self.tracer.now_us() if self.tracer is not None else -1.0
            if self.telemetry is not None:
                # the dispatch's byte bill while the graph runs; the
                # measured wall closes over it after the host sync below
                cost = self.telemetry.split_tick_cost(self, running)
            self._host_sync_fault()
            # THE tick's one device→host transfer: the packed [B, 4] rows
            out_host = out.cpu().numpy()
            self.n_host_fetches += 1
            t5 = self.tracer.now_us() if self.tracer is not None else -1.0
            if cost is not None and self.telemetry is not None:
                # attribution before delivery, so a finishing request's
                # log line carries its last tick's cost
                tel = self.telemetry.finish(cost, self.clock() - tdev0)
                self.telemetry.attribute(cost, tel["device_time_s"])
                self.metrics.on_telemetry(tel)
            for r in running:
                self._emit(r, int(out_host[r.slot, 0]))
                self._maybe_finish(r)

        self._journal_tick()
        self._tier_tick_end()
        self.metrics.on_tick(
            queue_depth=self.scheduler.queue_depth,
            occupancy=self.pool.occupancy,
            active_slots=len(running),
            preemptions_total=self.scheduler.n_preemptions,
            kv_bytes=_tel.split_tick_kv_read(self, running, per_request=False)[0]
            if running else 0,
        )
        if self.tracer is not None and t0 >= 0.0:
            # the tick ends with its last phase: building its args is the
            # tracer's work, outside the tick like the sentinel's below
            t6 = self.tracer.now_us()
            targs: dict[str, Any] = {
                "active_slots": len(running),
                "queue_depth": self.scheduler.queue_depth,
                "admitted": len(admitted),
                # the one-fetch contract covers the decode fetch; the
                # phase-split prefill's first-token sync counts in prefill
                "host_sync_us": round(max(t5 - t4, 0.0), 1),
                "host_fetches": self.n_host_fetches - fetches0,
            }
            if self.host_tier is not None:
                targs["tier_spill_bytes"] = self._tier_spill_bytes
                targs["tier_restore_bytes"] = self._tier_restore_bytes
                targs["tier_restore_us"] = round(self._tier_restore_us, 1)
            if tel is not None:
                targs.update(_roofline_targs(tel))
            self.tracer.tick(t0, (
                ("admission", t0, t1), ("prefill", t1, t2),
                ("grow", t2, t3), ("decode_dispatch", t3, t4),
                ("host_sync", t4, t5), ("deliver", t5, t6),
            ), args=targs, end_us=t6)
            if self.sentinel is not None:
                # the tick's phases, and the roofline deficit as a
                # pseudo-phase, so a utilization regression pages too
                outliers = self._sentinel_observe((
                    ("admission", t0, t1), ("prefill", t1, t2),
                    ("grow", t2, t3), ("decode_dispatch", t3, t4),
                    ("host_sync", t4, t5), ("deliver", t5, t6),
                ) + ((("roofline_deficit", 0.0, tel["deficit_us"]),) if tel is not None else ()))
        self._actions_tick(outliers)
        return self.scheduler.has_work

    def _dispatch_faults(self, has_prefill: bool) -> None:
        """A dispatch's chaos sites, before the step runs: ``prefill`` when
        the tick carries prefill tokens, ``decode`` at every dispatch.  The
        JAX engine answers a ``decode`` fault by degrading the kernel to
        its XLA sibling; the port has no plain fallback on the card, so the
        fault raises and the supervisor restarts the engine
        (``decode_degraded`` stays None)."""
        faults = self.faults
        if faults is None:
            return
        if has_prefill and faults.trip("prefill") is not None:
            raise FaultInjected("prefill")
        if faults.trip("decode") is not None:
            raise FaultInjected("decode")

    def _host_sync_fault(self) -> None:
        """The ``host_sync`` chaos site: a real stall inside the tick's
        host fetch window, between the dispatch and the fetch."""
        if self.faults is not None:
            hang = self.faults.trip("host_sync")
            if hang is not None:
                time.sleep(hang)

    def _journal_tick(self) -> None:
        """One delivery-watermark record for the whole tick: rows for every
        live request whose count advanced (rejected drafts never reach
        ``generated``, so they never reach the journal)."""
        if self.journal is not None:
            self.journal.end_tick(self._requests.values())

    # ------------------------------------------------------------------
    # Unified tick
    # ------------------------------------------------------------------
    def _init_mixed_prefill(self, req: Request) -> None:
        """Admission bookkeeping for the unified tick: fix the request's
        left-pad and prefill target, pre-mark prefix-cache-covered
        content as done (covered chunks consume no tick budget and are
        attended in place through the block table), and stash the
        teacher-forced content for the packer."""
        content = req.effective_prompt()
        w = self._prefill_width(req)
        req.pad = w - content.size
        shared_slots = req.n_shared_blocks * self.block_size
        req.prefill_target = int(content.size)
        req.prefill_done = max(shared_slots - req.pad, 0)
        req.prefilled = False
        req.extra["prefill_content"] = content

    def _pack_mixed(
        self,
        decode_rows: list[Request],
        prefill_segs: list[tuple[Request, int]],
    ) -> dict[str, np.ndarray]:
        """Build the mixed step's packed operands (host arrays) from the
        planner's verdict.  Each row's token segment lands at
        consecutive, q-tile-aligned packed positions (dead alignment
        lanes point at the scratch block and are masked); the packed
        width is the smallest bucket covering the aligned total."""
        qb = self._q_tile
        b = self.scheduler.max_slots
        mb = self.max_blocks_per_seq
        bs = self.block_size
        w_v = self._spec_w
        # segment = (request, tokens, first cache slot, n_verify): the
        # n_verify sample slots cover the segment's LAST n_verify tokens
        # — a plain decode row or completing prefill samples 1 (its last
        # token), a speculating row its whole verify slice (input +
        # drafts), a mid-prefill chunk 0
        segs: list[tuple[Request, np.ndarray, int, int]] = []
        for r in decode_rows:
            toks = [r.generated[-1]]
            if r.draft_len:
                toks.extend(int(t) for t in r.extra["spec_draft"][:r.draft_len])
            segs.append((r, np.asarray(toks, np.int32), r.cache_len - 1, len(toks)))
        for r, n in prefill_segs:
            content = r.extra["prefill_content"]
            toks = np.asarray(content[r.prefill_done:r.prefill_done + n], np.int32)
            segs.append((r, toks, r.pad + r.prefill_done,
                         1 if r.prefill_done + n >= r.prefill_target else 0))
        aligned = sum(_ceil_to(t.size, qb) for _, t, _, _ in segs)
        t_w = self._pick_bucket(max(aligned, qb))
        nt = t_w // qb
        h = dict(
            tokens=np.zeros(t_w, np.int32), positions=np.zeros(t_w, np.int32),
            tok_blk=np.zeros(t_w, np.int32), tok_off=np.zeros(t_w, np.int32),
            tile_row=np.zeros(nt, np.int32), tile_qpos0=np.zeros(nt, np.int32),
            tile_qlen=np.zeros(nt, np.int32), tables=np.zeros((b, mb), np.int32),
            pads=np.zeros(b, np.int32), last_idx=np.zeros((b, w_v), np.int32),
            sample_pos=np.zeros((b, w_v), np.int32), seeds=np.zeros(b, np.int32),
            verify_len=np.zeros(b, np.int32),
        )
        cur = 0
        self.tick_segments = []
        for r, toks, start_slot, n_verify in segs:
            n = toks.size
            slot = r.slot
            self.tick_segments.append((r.req_id, cur, n, start_slot - r.pad))
            h["tables"][slot, :len(r.block_ids)] = r.block_ids
            h["pads"][slot] = r.pad
            h["seeds"][slot] = _seed_word(r.seed)
            sl = start_slot + np.arange(n, dtype=np.int32)
            h["tokens"][cur:cur + n] = toks
            h["positions"][cur:cur + n] = sl - r.pad
            h["tok_blk"][cur:cur + n] = np.asarray(r.block_ids, np.int32)[sl // bs]
            h["tok_off"][cur:cur + n] = sl % bs
            n_tiles = -(-n // qb)
            ti0 = cur // qb
            for k in range(n_tiles):
                h["tile_row"][ti0 + k] = slot
                h["tile_qpos0"][ti0 + k] = start_slot + k * qb
                h["tile_qlen"][ti0 + k] = min(qb, n - k * qb)
            if n_verify:
                first = n - n_verify  # verify slots = the last n_verify
                h["verify_len"][slot] = n_verify
                for j in range(n_verify):
                    h["last_idx"][slot, j] = cur + first + j
                    h["sample_pos"][slot, j] = start_slot + first + j - r.pad
            cur += n_tiles * qb
        return h

    def _finish_mixed_prefill(self, req: Request, tok: int) -> None:
        """A row's prefill reached its target this tick: register its
        prompt blocks with the prefix cache (they are already IN the
        pool) and emit the first token sampled by the same step."""
        req.prefilled = True
        req.extra.pop("prefill_content", None)
        self._register_prefix(req)
        self._emit(req, tok)
        if not self._maybe_finish(req) and self.tracer is not None:
            self.tracer.request_phase(req.req_id, "decode")

    def _draft_tick(self) -> None:
        """Propose draft tokens for every speculating decode row by
        host-side prompt lookup (``DraftState``): no device work.  Sets
        ``Request.draft_len`` (the verify width the planner budgets and
        growth covers) and stashes the tokens in ``extra['spec_draft']``.
        The cap keeps every verify write inside the request's cache
        ceiling and every possible accept inside its token budget."""
        if not self.spec_k:
            return
        for r in self.scheduler.running:
            r.draft_len = 0
            if not (r.speculative and r.prefilled and r.generated) or r.extra.get("spec_off"):
                continue
            rem = r.max_new_tokens - len(r.generated)
            cap = min(self.spec_k, rem - 1, self.max_seq_len - r.cache_len)
            if cap <= 0:
                continue
            st = self._draft_states.get(r.req_id)
            if st is None:
                # built lazily (a preemption re-admission lands here too):
                # the stream is prompt + generated, what an uninterrupted
                # request would have indexed
                st = self._draft_states[r.req_id] = DraftState(self.spec_ngram)
                st.extend(int(t) for t in r.prompt)
            st.extend(r.generated[st.size - r.prompt_len:])
            draft = st.propose(cap)
            if draft:
                r.extra["spec_draft"] = draft
                r.draft_len = len(draft)

    def _spec_feedback(self, req: Request, drafted: int, accepted: int) -> None:
        """One verify round's accounting and the per-request fallback: a
        stream whose rolling acceptance falls below ``spec_min_accept``
        stops drafting (a plain decode row from then on), so a cold
        stream costs at most one window of wasted verify lanes."""
        self.metrics.on_spec(drafted=drafted, accepted=accepted)
        st = req.extra.setdefault("spec_acc", [0, 0])
        st[0] += drafted
        st[1] += accepted
        if st[0] < self.spec_window:
            return
        if st[1] < self.spec_min_accept * st[0]:
            req.extra["spec_off"] = True
            self._draft_states.pop(req.req_id, None)
            if self.tracer is not None:
                self.tracer.request_instant(req.req_id, "spec-fallback", args=self._targs(
                    req, drafted=st[0], accepted=st[1]))
        else:
            st[0] //= 2
            st[1] //= 2

    def _deliver_verify(self, r: Request, samples: np.ndarray, n_match: int) -> int:
        """The host deliver walk of one verify slice: the step sampled
        every position of the slice by the plain decode rule, so sample
        j IS the token the stream emits there — emit while the drafts
        matched (``n_match`` of them, from the packed fetch), then the
        first correction or the bonus sample, stopping early at a stop
        token, the budget or an abort.  Rejected drafts' K/V sit past
        the new ``cache_len`` and are overwritten before being read.
        Returns the accepted drafts."""
        r.extra.pop("spec_draft")
        acc = 0
        for j in range(1 + r.draft_len):
            self._emit(r, int(samples[j]))
            if j < n_match:
                # a drafted stop token still paid off: count it before
                # the finish check
                acc += 1
                if self._maybe_finish(r):
                    break
            else:
                self._maybe_finish(r)
                break
        drafted, r.draft_len = r.draft_len, 0
        self._spec_feedback(r, drafted, acc)
        return acc

    def _step_mixed(self) -> bool:
        """One unified tick: deadline sweep + admission, draft proposal,
        block growth, token-budget planning, then ONE mixed step covering
        every planned prefill slice, plain decode row and verify slice,
        and ONE host fetch.  With a tracer attached each tick records one
        ``tick`` span and its ``MIXED_TICK_PHASES`` slices at consecutive
        timestamps, with the prefill/decode token split (and the draft /
        accept split on a spec engine) in its args; ``self.tracer`` is
        re-read at every hook, as in the phase-split tick."""
        t0 = self.tracer.now_us() if self.tracer is not None else -1.0
        fetches0 = self.n_host_fetches
        outliers: list[dict] = []
        self._tier_tick_start()
        self._sweep_deadlines()
        admitted = self.scheduler.admit()
        for req in admitted:
            if req.admit_time is None:
                req.admit_time = self.clock()
            # stage this admission's host-tier hits first, so the writer's
            # copies overlap the rest of the admission loop; they land
            # below, before the step that attends them
            self._enqueue_tier_restores(req)
            self._init_mixed_prefill(req)
            if self.tracer is not None:
                self.tracer.request_phase(req.req_id, "prefill", args=self._targs(
                    req, shared_blocks=req.n_shared_blocks, preemptions=req.n_preemptions))
        self._apply_tier_restores(admitted)
        t1 = self.tracer.now_us() if self.tracer is not None else -1.0

        self._draft_tick()
        td = self.tracer.now_us() if self.tracer is not None else -1.0
        for req in self.scheduler.ensure_decode_blocks():
            if self.tracer is not None:
                self.tracer.request_instant(req.req_id, "evicted-requeued")
                self.tracer.request_phase(req.req_id, "queued")
            self._emit_event(req, "evicted-requeued")
        t2 = self.tracer.now_us() if self.tracer is not None else -1.0

        decode_rows, prefill_segs = self.scheduler.plan_tick(
            self._tick_budget(), self.prefill_chunk,
            prefill_order=(self._fair_prefill_order
                           if self.tenants is not None and self.tenants.fairness else None))
        t3 = self.tracer.now_us() if self.tracer is not None else -1.0
        t4 = t5 = t3
        n_prefill_tok = sum(n for _, n in prefill_segs)
        n_decode_tok = len(decode_rows)
        # drafts packed this tick (after the planner's trim), and accepted
        n_spec_tok = sum(r.draft_len for r in decode_rows)
        n_spec_acc = 0
        tel = None
        cost = None
        if decode_rows or prefill_segs:
            host = self._pack_mixed(decode_rows, prefill_segs)
            td0 = self.clock()
            self._dispatch_faults(has_prefill=bool(prefill_segs))
            self.n_dispatches += 1
            self.n_verify_dispatches += n_spec_tok > 0
            with (torch.profiler.record_function("serve.mixed_dispatch")
                  if self.tracer is not None else _NULL_CTX):
                out = self._mixed_step(host)
            t4 = self.tracer.now_us() if self.tracer is not None else -1.0
            if self.telemetry is not None:
                # the byte/FLOP bill while the graph runs, and before the
                # accept walk: verify lanes live in draft_len only until then
                cost = self.telemetry.mixed_tick_cost(self, decode_rows, prefill_segs)
            self._host_sync_fault()
            # THE tick's one device→host transfer: samples + stop mask +
            # watermark + accept length in one int32 array
            out_host = out.cpu().numpy()
            self.n_host_fetches += 1
            nxt_host = out_host[:, : self._spec_w]
            accept_host = out_host[:, self._spec_w + 2]
            t5 = self.tracer.now_us() if self.tracer is not None else -1.0
            if cost is not None and self.telemetry is not None:
                # graded against the dispatch → fetch wall, and attributed
                # before delivery, so a finishing request's log line
                # carries its last tick's cost
                tel = self.telemetry.finish(cost, self.clock() - td0)
                self.telemetry.attribute(cost, tel["device_time_s"])
                self.metrics.on_telemetry(tel)
            if n_prefill_tok:
                # per-request prefill time: the step's wall split by
                # token share (the mixed analogue of Request.prefill_s)
                per_tok = (self.clock() - td0) / (n_prefill_tok + n_decode_tok + n_spec_tok)
                for r, n in prefill_segs:
                    r.prefill_s += per_tok * n
                if self.host_tier is not None and per_tok > 0:
                    # the breakeven's recompute side: a measured rate
                    self.host_tier.note_prefill_rate(1.0 / per_tok)
            for r, n in prefill_segs:
                r.prefill_done += n
                if r.prefill_done >= r.prefill_target:
                    self._finish_mixed_prefill(r, int(nxt_host[r.slot, 0]))
            for r in decode_rows:
                if r.draft_len:
                    n_spec_acc += self._deliver_verify(r, nxt_host[r.slot],
                                                       int(accept_host[r.slot]))
                else:
                    self._emit(r, int(nxt_host[r.slot, 0]))
                    self._maybe_finish(r)

        self._journal_tick()
        self._tier_tick_end()
        active = n_decode_tok + len(prefill_segs)
        self.metrics.on_tick(
            queue_depth=self.scheduler.queue_depth,
            occupancy=self.pool.occupancy,
            active_slots=active,
            preemptions_total=self.scheduler.n_preemptions,
            # after the accept walk and prefill bookkeeping, as the JAX
            # engine calls it (draft_len is 0, prefill_done counts this
            # tick's slice), so the gauge equals that engine's
            kv_bytes=_tel.mixed_tick_kv_read(self, decode_rows, prefill_segs,
                                             per_request=False)[0] if active else 0,
            prefill_tokens=n_prefill_tok,
            decode_tokens=n_decode_tok,
        )
        if self.tracer is not None and t0 >= 0.0:
            # the tick ends with its last phase: building its args is the
            # tracer's work, outside the tick like the sentinel's below
            t6 = self.tracer.now_us()
            targs: dict[str, Any] = {
                "active_slots": active,
                "queue_depth": self.scheduler.queue_depth,
                "admitted": len(admitted),
                "prefill_tokens": n_prefill_tok,
                "decode_tokens": n_decode_tok,
                # the tick tail: host_sync wall (µs) and the device→host
                # transfers this tick (exactly 1 on a dispatching tick)
                "host_sync_us": round(max(t5 - t4, 0.0), 1),
                "host_fetches": self.n_host_fetches - fetches0,
            }
            if self.spec_k:
                targs["spec_draft_tokens"] = n_spec_tok
                targs["spec_accept_tokens"] = n_spec_acc
            if self.host_tier is not None:
                targs["tier_spill_bytes"] = self._tier_spill_bytes
                targs["tier_restore_bytes"] = self._tier_restore_bytes
                targs["tier_restore_us"] = round(self._tier_restore_us, 1)
            if tel is not None:
                targs.update(_roofline_targs(tel))
            self.tracer.tick(t0, (
                ("admission", t0, t1), ("draft", t1, td),
                ("grow", td, t2), ("plan", t2, t3),
                ("mixed_dispatch", t3, t4),
                ("host_sync", t4, t5), ("deliver", t5, t6),
            ), args=targs, end_us=t6)
            if self.sentinel is not None:
                # the tick's phases, and the roofline deficit as a
                # pseudo-phase, so a utilization regression pages too
                outliers = self._sentinel_observe((
                    ("admission", t0, t1), ("draft", t1, td),
                    ("grow", td, t2), ("plan", t2, t3),
                    ("mixed_dispatch", t3, t4),
                    ("host_sync", t4, t5), ("deliver", t5, t6),
                ) + ((("roofline_deficit", 0.0, tel["deficit_us"]),) if tel is not None else ()))
        self._actions_tick(outliers)
        return self.scheduler.has_work

    # ------------------------------------------------------------------
    def compile_counts(self) -> dict[str, int]:
        """The static-shape contract: a unified-tick engine reports
        ``{"mixed_step": n}``, the buckets whose step has its CUDA graph
        (on the CPU, whose static step has run) — at most
        ``len(mixed_buckets)``, greedy or sampled, and no more on a replay
        of the same trace; a phase-split engine ``{"decode_step": n}``, its
        one decode step's graph (n is 0 or 1).  The JAX engine reports
        five phase-split programs; here the phase-split prefill chunks,
        the first sample and the scatter run eagerly and are not
        reported.  Nor are the host tier's copies (the JAX engine's
        ``restore_block`` / ``slice_block`` programs): they are eager
        operations between steps, so a tier-on run adds no capture.
        Under a multi-rank mesh the steps run eagerly: ``mixed_step`` /
        ``decode_step`` are 0 and ``mixed_step_eager`` /
        ``decode_step_eager`` count the steps that have run."""
        name = "mixed_step" if self.mixed else "decode_step"
        steps = (list(self._mixed_steps.values()) if self.mixed
                 else [st for st in (self._split_step,) if st is not None])
        if self._multi:
            return {name: 0, name + "_eager": sum(st.run.calls > 0 for st in steps)}
        return {name: sum(st.run.compiled for st in steps)}

    def graph_steps(self) -> list[CapturedStep]:
        """The captured steps: the unified tick's bucket steps, or the
        phase-split decode step (capture time, pool bytes and replays are
        on each)."""
        steps = list(self._mixed_steps.values())
        if self._split_step is not None:
            steps.append(self._split_step)
        return [st.run for st in steps]

    def _warm_split_step(self) -> None:
        """Capture the phase-split decode step with a batch whose every row
        sees one slot, the scratch slot it writes (finite, so no row's
        attention is empty)."""
        if self._split_step is None:
            self._split_step = _decode_step_state(self)
        st = self._split_step
        if not self._built(st):
            host = {k: np.zeros(st.ops[k].shape, np.int32) for k in _DECODE_OPERANDS}
            host["vis"][:] = 1
            st.upload(host)
            st.run()
            st.out.cpu()

    def _warm_mixed_bucket(self, t_w: int) -> None:
        """Capture one packed-width bucket's step with an all-dead batch:
        every lane points at the scratch block and is fully masked, so
        the only effect is the capture (and a garbage write to scratch)."""
        st = self._bucket_step(t_w)
        if not self._built(st):
            st.upload({k: np.zeros(st.ops[k].shape, np.int32) for k in _MIXED_OPERANDS})
            st.run()
            st.out.cpu()

    def warmup(self, prompt_lens: list[int], max_new_tokens: int = 2) -> None:
        """Run one dummy request through the engine before measuring —
        it builds the kernel library and warms the card's allocator and
        cuBLAS handles, and a phase-split engine's decode step captures
        its graph — and, as the JAX engine compiles every bucket, capture
        every packed-width bucket's graph, greedy or sampled, so that no
        capture stalls a measured tick; then drop the dummy's traces:
        prefix-cache entries, the finished ledger and the metrics.  The
        host tier is detached meanwhile: the dummy's blocks neither spill
        nor restore, and its times do not feed the breakeven.  The fault
        injector, journal and request log are detached too: a scheduled
        fault must not fire (or a hit be counted) in a capture, and the
        dummy is neither journaled nor logged.  So is the observability
        plane: the dummy's ticks and the captures are not traced (so the
        sentinel never sees them), billed or counted as SLO verdicts, and
        the SLO tracker passes to the fresh metrics."""
        if not prompt_lens:
            return
        host_tier, self.host_tier = self.host_tier, None
        faults, self.faults = self.faults, None
        journal, self.journal = self.journal, None
        request_log, self.request_log = self.request_log, None
        tracer, self.tracer = self.tracer, None
        telemetry, self.telemetry = self.telemetry, None
        tenants, self.tenants = self.tenants, None
        slo_tracker, self.metrics.slo = self.metrics.slo, None
        try:
            self.submit(np.ones(min(prompt_lens), np.int32), min(2, max_new_tokens))
            self.run_until_complete()
            if self.mixed:
                for t_w in self.mixed_buckets:
                    self._warm_mixed_bucket(t_w)
        finally:
            self.host_tier = host_tier
            self.faults = faults
            self.journal = journal
            self.request_log = request_log
            self.tracer = tracer
            self.telemetry = telemetry
            self.tenants = tenants
            self.metrics.slo = slo_tracker
        if self.pool.prefix_cache is not None:
            self.pool.prefix_cache.clear()
        self.scheduler.finished.clear()
        self.metrics = ServeMetrics(clock=self.clock, slo=slo_tracker)

    def run_until_complete(self, max_ticks: int = 100_000) -> None:
        for _ in range(max_ticks):
            if not self.step():
                return
        raise RuntimeError(f"serve loop did not drain within {max_ticks} ticks")

    def replay_trace(
        self,
        trace: list[dict[str, Any]],
        *,
        realtime: bool = False,
        max_ticks: int = 100_000,
    ) -> dict[str, Any]:
        """Replay ``[{"arrival_s", "prompt", "max_new_tokens", "seed"?,
        "speculative"?}]``
        (see ``serve/trace.replay_arrivals``): a virtual clock releases
        arrivals whenever the engine is idle, or ``realtime=True`` sleeps
        until each one.  Returns ``metrics.snapshot()``.  Under a
        multi-rank mesh every rank replays the same trace and the virtual
        clock follows the ranks' largest clock reading, so every rank
        releases the same arrivals at the same tick (``realtime`` would
        follow each rank's own wall clock: not ported yet)."""
        from llm_np_cp_tpu_torch.serve.trace import replay_arrivals

        target: Any = self
        if self._multi:
            if realtime:
                raise NotImplementedError(
                    f"replay_trace(realtime=True) under a multi-rank mesh is not ported yet "
                    f"({MESH_ITEM}): each rank would release arrivals by its own wall clock")
            target = _LockstepReplay(self)
        return replay_arrivals(target, trace, self.metrics.snapshot,
                               realtime=realtime, max_ticks=max_ticks)


class _LockstepReplay:
    """A multi-rank engine as ``replay_arrivals`` drives it: its clock is
    the ranks' largest reading (``ServeEngine._synced_clock``)."""

    def __init__(self, eng: ServeEngine) -> None:
        self.clock = eng._synced_clock
        self.submit = eng.submit
        self.step = eng.step
