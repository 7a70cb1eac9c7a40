"""Fused sampling epilogue: final RMSNorm → lm_head → greedy argmax.

Port of ``llm_np_cp_tpu/ops/pallas/sample_epilogue.py`` for float heads
(the int8-head variant waits for the port of ``quant.py``).  The kernel
is ``csrc/sample_epilogue.cu``; ``sample_epilogue_plain`` is the same
function in plain PyTorch.

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
    tied: bool, eps: float, unit_offset: bool = False,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: rms_norm (cast back to x's dtype), float32
    logits from a float32 product, softcap, first-occurrence argmax."""
    xn = rms_norm(x, gamma, eps=eps, unit_offset=unit_offset).float()
    logits = xn @ (w.float().T if tied else w.float())
    if logit_softcap is not None:
        logits = _softcap(logits, logit_softcap)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_epilogue(
    x: torch.Tensor, gamma: torch.Tensor, w: torch.Tensor, *,
    w_scale: torch.Tensor | None = None,
    tied: bool, eps: float, unit_offset: bool = False,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Greedy-sample the next token for each row of ``x`` without
    materializing the logits.

    x [N, H] pre-final-norm hidden states, gamma [H] the final norm
    weight, w the lm-head weight: ``[V, H]`` when ``tied``, ``[H, V]``
    otherwise → [N] int32 token ids.  ``w_scale`` (int8 heads) is not
    ported yet and raises.

    CPU tensors run ``sample_epilogue_plain``; CUDA tensors launch the
    kernel or raise.
    """
    if w_scale is not None or w.dtype == torch.int8:
        raise NotImplementedError("int8 lm-head epilogue waits for the quant.py port")
    n, h = x.shape
    v = w.shape[0] if tied else w.shape[1]
    if (w.shape[1] if tied else w.shape[0]) != h or gamma.shape != (h,):
        raise ValueError(
            f"lm-head weight {tuple(w.shape)} / gamma {tuple(gamma.shape)} do "
            f"not match hidden size {h} (tied={tied})"
        )
    if _common.on_cpu(x, gamma, w):
        return sample_epilogue_plain(
            x, gamma, w, tied=tied, eps=eps, unit_offset=unit_offset,
            logit_softcap=logit_softcap,
        )
    if not (x.dtype == gamma.dtype == w.dtype):
        raise TypeError(f"sample_epilogue: dtypes differ: {x.dtype}, {gamma.dtype}, {w.dtype}")
    code = _common.dtype_code("sample_epilogue", x.dtype)
    if (h * x.element_size()) % 16 or w.data_ptr() % 16:
        raise ValueError(
            f"sample_epilogue: the kernel reads 16-byte vectors: hidden size {h} rows "
            "must be a multiple of 16 bytes and w 16-byte aligned"
        )
    _common.check_contiguous("sample_epilogue", x=x, gamma=gamma, w=w)
    lib = library()
    nt = lib.sample_epilogue_num_tiles(v)
    part_val = torch.empty((n, nt), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((n, nt), dtype=torch.int32, device=x.device)
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    err = lib.sample_epilogue_launch(
        x.data_ptr(), gamma.data_ptr(), w.data_ptr(), part_val.data_ptr(),
        part_idx.data_ptr(), out.data_ptr(), n, h, v, int(tied), float(eps),
        int(unit_offset), float(logit_softcap or 0.0), code, _common.stream_ptr(x),
    )
    check(err, "sample_epilogue")
    sample_epilogue.launches += 1
    return out


sample_epilogue.launches = 0
