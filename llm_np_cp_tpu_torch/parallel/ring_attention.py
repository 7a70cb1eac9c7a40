"""Ring attention: sequence-parallel causal self-attention over the mesh's
``seq`` axis (port of ``llm_np_cp_tpu/parallel/ring_attention.py``).

Each seq rank keeps its query block and the K/V blocks rotate one hop a
step (``collectives.ppermute``, one exchange of K and V together), with
an online softmax (running max / sum / accumulator) merging the partial
results: attention over a prompt no one rank holds, with O(S/n) score
memory.  The same surface as ``ops.attention.gqa_attention``: GQA
grouping, causal masking from global positions, sliding windows, logit
softcapping, float32 math.

The local step is plain torch einsums, as the JAX ring is XLA einsums:
it has no Pallas kernel, and so no CUDA one here.
"""

from __future__ import annotations

import torch

from llm_np_cp_tpu_torch.parallel.collectives import all_gather, ppermute
from llm_np_cp_tpu_torch.parallel.sharding import SEQ_AXIS, Mesh

NEG_INF = float(torch.finfo(torch.float32).min)


def _local_ring_attention(
    q: torch.Tensor,  # [B, S_loc, H, D]   (this rank's query block)
    k: torch.Tensor,  # [B, S_loc, K, D]   (rotating)
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str,
    scale: float,
    logit_softcap: float | None,
    window: int | None,
) -> torch.Tensor:
    b, s_loc, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    n = mesh.size(axis_name)
    me = mesh.index(axis_name)
    dev = q.device

    ar = torch.arange(s_loc, device=dev)
    q_pos = me * s_loc + ar
    qg = q.float().reshape(b, s_loc, kh, g, d)

    m = torch.full((b, kh, g, s_loc, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kh, g, s_loc, 1), device=dev)
    acc = torch.zeros((b, kh, g, s_loc, d), device=dev)

    kv_cur = torch.stack([k, v])  # one exchange a hop carries both
    for step in range(n):
        src = (me - step) % n  # owner of the block we now hold
        kv_pos = src * s_loc + ar
        k_cur, v_cur = kv_cur[0], kv_cur[1]

        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cur.float()) * scale
        if logit_softcap is not None:
            scores = torch.tanh(scores / logit_softcap) * logit_softcap

        mask = kv_pos[None, :] <= q_pos[:, None]  # [S_loc, S_kv]
        if window is not None:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        scores = torch.where(mask, scores, NEG_INF)

        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        p = torch.exp(scores - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgqs,bskd->bkgqd", p, v_cur.float())
        m = m_new

        if step < n - 1:
            kv_cur = ppermute(kv_cur, mesh, axis_name)

    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows (none in causal use)
    out = (acc / l).to(q.dtype)  # [B, K, G, S_loc, D]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s_loc, h, d)


def _pad_seq(q, k, v, num_shards):
    """Pad the sequence axis up to a multiple of the shard count.  The
    pad slots sit at the highest global positions, so causal masking
    hides them from every real query; callers slice the pad-query rows
    back off."""
    pad = -q.shape[1] % num_shards
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        q, k, v = (torch.nn.functional.pad(t, widths) for t in (q, k, v))
    return q, k, v, pad


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    scale: float,
    logit_softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Causal self-attention with the sequence axis sharded over
    ``axis_name``: q [B, S, H, D], k/v [B, S, K, D] global (the same on
    every rank of the axis; any S, padded up to the axis size) → the
    global [B, S, H, D] on every rank.  Each rank attends its block of
    the queries; the blocks are all-gathered back."""
    n = mesh.size(axis_name)
    s = q.shape[1]
    q, k, v, pad = _pad_seq(q, k, v, n)
    s_loc = q.shape[1] // n
    lo = mesh.index(axis_name) * s_loc
    out = _local_ring_attention(
        q[:, lo:lo + s_loc], k[:, lo:lo + s_loc], v[:, lo:lo + s_loc],
        mesh=mesh, axis_name=axis_name, scale=scale, logit_softcap=logit_softcap,
        window=window)
    out = all_gather(out, mesh, axis_name, dim=1)
    return out[:, :s] if pad else out


def check_ring_mesh(mesh: Mesh | None, what: str = "attn_impl='ring'") -> None:
    """Raise unless ``mesh`` has a ``seq`` axis of at least 2 (``what``
    names the option that asked for the ring)."""
    if mesh is None or mesh.size(SEQ_AXIS) < 2:
        shape = None if mesh is None else mesh.shape
        raise ValueError(
            f"{what} needs a mesh (mesh=) with a '{SEQ_AXIS}' axis of size >= 2; "
            f"got mesh shape {shape}"
        )


def ring_attention_ctx(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: Mesh,
    scale: float,
    logit_softcap: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Ring attention on this rank's block — the entry
    ``models.transformer.forward`` uses for ``attn_impl="ring"``.  The
    forward has already cut the (padded) prompt into ``seq`` blocks: q
    [B, S_loc, H_loc, D] and k/v [B, S_loc, K_loc, D] are this rank's
    positions ``index * S_loc ...``, with this rank's batch rows (data)
    and heads (model).  The JAX function reads the ambient mesh; here the
    caller passes it."""
    check_ring_mesh(mesh)
    return _local_ring_attention(q, k, v, mesh=mesh, axis_name=SEQ_AXIS, scale=scale,
                                 logit_softcap=logit_softcap, window=window)
