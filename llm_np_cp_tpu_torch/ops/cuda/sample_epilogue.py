"""Fused sampling epilogue: final RMSNorm → lm_head → greedy argmax.

Port of ``llm_np_cp_tpu/ops/pallas/sample_epilogue.py`` for float heads
and int8 heads (quant.py's ``"q"`` payload with per-vocab-column float32
scales).  The kernel is ``csrc/sample_epilogue.cu``;
``sample_epilogue_plain`` is the same function in plain PyTorch.

The logits are never written: the kernel keeps one (best value, first
index) per row and vocab tile and combines them with jnp.argmax's
first-occurrence rule, so the token matches ``final_logits`` +
``Sampler("greedy")`` up to float32 summation order.
"""

from __future__ import annotations

import torch

from llm_np_cp_tpu_torch.ops.activations import softcap as _softcap
from llm_np_cp_tpu_torch.ops.cuda import _common
from llm_np_cp_tpu_torch.ops.cuda.build import check, library
from llm_np_cp_tpu_torch.ops.norms import rms_norm


def sample_epilogue_plain(
    x: torch.Tensor, gamma: torch.Tensor, w: torch.Tensor, *,
    w_scale: torch.Tensor | None = None,
    tied: bool, eps: float, unit_offset: bool = False,
    logit_softcap: float | None = None, return_max: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: rms_norm (cast back to x's dtype), float32
    logits from a float32 product (an int8 head's payload as float32,
    the product times the per-column scale), softcap, first-occurrence
    argmax (and, with ``return_max``, each row's largest logit)."""
    xn = rms_norm(x, gamma, eps=eps, unit_offset=unit_offset).float()
    logits = xn @ (w.float().T if tied else w.float())
    if w_scale is not None:
        logits = logits * w_scale.float().reshape(1, -1)
    if logit_softcap is not None:
        logits = _softcap(logits, logit_softcap)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return (tok, logits.amax(dim=-1)) if return_max else tok


def sample_epilogue(
    x: torch.Tensor, gamma: torch.Tensor, w: torch.Tensor, *,
    w_scale: torch.Tensor | None = None,
    tied: bool, eps: float, unit_offset: bool = False,
    logit_softcap: float | None = None, return_max: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Greedy-sample the next token for each row of ``x`` without
    materializing the logits.

    x [N, H] pre-final-norm hidden states, gamma [H] the final norm
    weight, w the lm-head weight: ``[V, H]`` when ``tied``, ``[H, V]``
    otherwise → [N] int32 token ids.  An int8 ``w`` comes with
    ``w_scale`` [1, V] float32 per-vocab-column scales (and only then).
    ``return_max``: also return each row's largest (softcapped) logit
    ``[N]`` float32, the maximum over the tiles' bests the kernel already
    writes (``part_val``) — what a tensor-parallel head merges its vocab
    shards by.

    CPU tensors run ``sample_epilogue_plain``; CUDA tensors launch the
    kernel or raise.  ``launches`` counts float-head launches,
    ``launches_int8`` int8-head launches.
    """
    int8 = w.dtype == torch.int8
    if int8 != (w_scale is not None):
        raise ValueError(
            "int8 lm-head payloads require w_scale (and vice versa); "
            f"got w={w.dtype}, w_scale={'set' if w_scale is not None else None}"
        )
    n, h = x.shape
    v = w.shape[0] if tied else w.shape[1]
    if (w.shape[1] if tied else w.shape[0]) != h or gamma.shape != (h,):
        raise ValueError(
            f"lm-head weight {tuple(w.shape)} / gamma {tuple(gamma.shape)} do "
            f"not match hidden size {h} (tied={tied})"
        )
    if int8 and w_scale.numel() != v:
        raise ValueError(f"w_scale has {w_scale.numel()} entries for a vocab of {v}")
    extra = (w_scale,) if int8 else ()
    if _common.on_cpu(x, gamma, w, *extra):
        return sample_epilogue_plain(
            x, gamma, w, w_scale=w_scale, tied=tied, eps=eps, unit_offset=unit_offset,
            logit_softcap=logit_softcap, return_max=return_max,
        )
    if x.dtype != gamma.dtype or (not int8 and w.dtype != x.dtype):
        raise TypeError(f"sample_epilogue: dtypes differ: {x.dtype}, {gamma.dtype}, {w.dtype}")
    if int8 and w_scale.dtype != torch.float32:
        raise TypeError(f"sample_epilogue: w_scale must be float32, got {w_scale.dtype}")
    code = _common.dtype_code("sample_epilogue", x.dtype)
    # the tied loop reads 16-byte vectors of the weight row and the
    # matching elements of the normed row: both rows whole vectors
    if (h * x.element_size()) % 16 or (h * w.element_size()) % 16 or w.data_ptr() % 16:
        raise ValueError(
            f"sample_epilogue: the kernel reads 16-byte vectors: hidden size {h} rows "
            f"of {x.dtype} and of {w.dtype} must be multiples of 16 bytes and w "
            "16-byte aligned"
        )
    _common.check_contiguous("sample_epilogue", x=x, gamma=gamma, w=w, **(
        {"w_scale": w_scale} if int8 else {}))
    lib = library()
    nt = lib.sample_epilogue_num_tiles(v)
    part_val = torch.empty((n, nt), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((n, nt), dtype=torch.int32, device=x.device)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    err = lib.sample_epilogue_launch(
        x.data_ptr(), gamma.data_ptr(), w.data_ptr(), w_scale.data_ptr() if int8 else None,
        part_val.data_ptr(), part_idx.data_ptr(), out.data_ptr(), n, h, v, int(tied),
        float(eps), int(unit_offset), float(logit_softcap or 0.0), code,
        _common.stream_ptr(x),
    )
    check(err, "sample_epilogue")
    if int8:
        _common.count(sample_epilogue, "launches_int8")
    else:
        _common.count(sample_epilogue, "launches")
    return (out, part_val.amax(dim=1)) if return_max else out


sample_epilogue.launches = 0
sample_epilogue.launches_int8 = 0
