"""Rank bodies of the mesh tests (``test_torch_sharding.py``,
``test_torch_ring_attention.py``, and ``test_torch_cli.py``'s
``cli_in_rank``).

A spawned rank imports the module of the function it runs, so the rank
side lives here and imports torch, numpy and the port only — no JAX.
``run_cases(rank, cases)`` runs every case of one spawned group in
order and returns ``{name: result}`` (numpy arrays and Python values):
one spawn of ranks serves a whole test module at one world size.

A case is ``(name, kind, kwargs)``; each kind below builds its own mesh
(``make_mesh`` over the group, on the CPU) and returns what every rank
sees, whole-batch and whole-vocab: a data-parallel forward's rows and a
tensor-parallel cache's heads are all-gathered here, so the parent
compares one array with the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch


def _mesh(plan_kw: dict):
    from llm_np_cp_tpu_torch.parallel.sharding import MeshPlan, make_mesh

    return make_mesh(MeshPlan(**plan_kw), device="cpu")


def _rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's batch rows of ``t`` (its data block)."""
    from llm_np_cp_tpu_torch.parallel.sharding import DATA_AXIS

    dp = mesh.size(DATA_AXIS)
    n = t.shape[0] // dp
    return t[mesh.index(DATA_AXIS) * n:(mesh.index(DATA_AXIS) + 1) * n]


def _all_rows(mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data rank's rows of ``t`` (batch along ``dim``)."""
    from llm_np_cp_tpu_torch.parallel.collectives import all_gather
    from llm_np_cp_tpu_torch.parallel.sharding import DATA_AXIS

    return all_gather(t, mesh, DATA_AXIS, dim=dim)


def forward_case(mesh, params, cfg, ids, attn_impl="xla", quantize=None):
    """Cache-less forward logits over the whole batch (``quantize``:
    ``quantize_params`` keywords for the weights first)."""
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.parallel.sharding import shard_params
    from llm_np_cp_tpu_torch.quant import quantize_params

    if quantize is not None:
        params = quantize_params(params, **quantize)
    p = shard_params(params, cfg, mesh.plan, mesh)
    logits, _ = forward(p, _rows(mesh, torch.as_tensor(ids)), cfg, attn_impl=attn_impl,
                        mesh=mesh)
    return _all_rows(mesh, logits).numpy()


def cached_case(mesh, params, cfg, ids, steps, capacity, attn_impl="xla"):
    """Prefill ``ids`` into a fresh cache (``attn_impl``), then one
    forward a token of ``steps`` ``[B, n]``: every call's logits, and the
    cache's K/V after the prefill with the KV heads all-gathered over
    "model"."""
    from llm_np_cp_tpu_torch.cache import KVCache
    from llm_np_cp_tpu_torch.models.transformer import forward
    from llm_np_cp_tpu_torch.parallel.collectives import all_gather
    from llm_np_cp_tpu_torch.parallel.sharding import (
        MODEL_AXIS,
        kv_heads_shardable,
        local_kv_heads,
        shard_params,
    )

    p = shard_params(params, cfg, mesh.plan, mesh)
    ids = _rows(mesh, torch.as_tensor(ids))
    cache = KVCache.init(cfg, ids.shape[0], capacity, torch.float32, device="cpu",
                         kv_heads=local_kv_heads(cfg, mesh))
    logits, cache = forward(p, ids, cfg, cache, attn_impl=attn_impl, mesh=mesh)
    out = [logits]
    k, v = cache.k.clone(), cache.v.clone()
    if kv_heads_shardable(cfg, mesh.plan):
        k = all_gather(k, mesh, MODEL_AXIS, dim=3)
        v = all_gather(v, mesh, MODEL_AXIS, dim=3)
    for t in _rows(mesh, torch.as_tensor(steps)).T:
        logits, cache = forward(p, t[:, None], cfg, cache, mesh=mesh)
        out.append(logits)
    return dict(logits=[_all_rows(mesh, o).numpy() for o in out],
                k=_all_rows(mesh, k, dim=1).numpy(), v=_all_rows(mesh, v, dim=1).numpy(),
                length=cache.length)


def generate_case(mesh, params, cfg, prompts, new_tokens, sampler_kw, seed=0,
                  prefill_attn_impl="xla", decode_attn_impl="xla", quantize=None):
    """``Generator(mesh=)`` tokens for the whole batch (every rank's
    return value is the whole batch's), with the step counts."""
    from llm_np_cp_tpu_torch.generate import Generator
    from llm_np_cp_tpu_torch.ops.sampling import Sampler
    from llm_np_cp_tpu_torch.parallel.sharding import shard_params
    from llm_np_cp_tpu_torch.quant import quantize_params

    if quantize is not None:
        params = quantize_params(params, **quantize)
    gen = Generator(shard_params(params, cfg, mesh.plan, mesh), cfg,
                    sampler=Sampler(**sampler_kw), cache_dtype=torch.float32,
                    prefill_attn_impl=prefill_attn_impl, decode_attn_impl=decode_attn_impl,
                    device="cpu", mesh=mesh)
    res = gen.generate(np.asarray(prompts), new_tokens, seed=seed)
    return dict(tokens=res.tokens, counts=gen.compile_counts(),
                epilogue=gen.epilogue_impl)


def ring_case(mesh, q, k, v, **kw):
    """``ring_attention`` on global tensors."""
    from llm_np_cp_tpu_torch.parallel.ring_attention import ring_attention

    return ring_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          mesh=mesh, **kw).numpy()


# FakeTokenizer.decode: token id t is the character BASE + t
BASE = 0x4E00


class FakeTokenizer:
    """The CLI tests' tokenizer (the JAX CLI tests' encode and EOS, a
    lossless decode: one character a token id), importable by a rank."""

    eos_token_id = 199

    def __call__(self, text, return_tensors=None):
        ids = [(ord(c) % 250) + 1 for c in text][:8]
        return {"input_ids": np.asarray([ids], dtype=np.int32)}

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(BASE + int(i)) for i in ids)


def cli_in_rank(rank: int, argvs: list[list[str]], params, cfg) -> list[tuple[str, str]]:
    """``cli.run(argv)`` of each of ``argvs`` in turn inside a rank of a
    running process group (as under torchrun: ``WORLD_SIZE`` set), over
    these weights: each run's returned text and what it wrote to
    stderr."""
    import contextlib
    import io
    import os

    from llm_np_cp_tpu_torch import cli

    os.environ["WORLD_SIZE"] = "set by the test's rank"
    cli._load = lambda args: (FakeTokenizer(), params, cfg)
    out = []
    for argv in argvs:
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
            text = cli.run(argv)
        out.append((text, err.getvalue()))
    return out


KINDS = {"forward": forward_case, "cached": cached_case, "generate": generate_case,
         "ring": ring_case}


def run_cases(rank: int, cases: list[tuple[str, str, dict]]) -> dict:
    """Every case in order on this rank: ``{name: result}``, with the
    collective counts each case issued under ``name + "/collectives"``."""
    from llm_np_cp_tpu_torch.parallel import collectives

    out = {}
    for name, kind, kw in cases:
        kw = dict(kw)
        mesh = _mesh(kw.pop("plan"))
        collectives.reset_counts()
        out[name] = KINDS[kind](mesh, **kw)
        out[name + "/collectives"] = collectives.counts()
    return out
