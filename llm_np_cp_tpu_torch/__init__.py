"""llm_np_cp_tpu_torch — the PyTorch/CUDA port of ``llm_np_cp_tpu``.

Same module names and public functions as the JAX package, written for
one NVIDIA H100: plain tensor code is PyTorch, and each Pallas kernel on
the ported path is a hand-written CUDA C++ kernel for ``sm_90a``
(``csrc/``, built at first use by ``ops/cuda/build.py``).

Ported so far: the offline ``Generator`` path — config, ops, the static
KV cache, the dense decoder forward, samplers, generation and
safetensors loading — with the ``flash_attention``, ``decode_attention``
and ``sample_epilogue`` kernels (slice 1); the ``ServeEngine``'s paged
block pool and tick modes with the ``ragged_paged_attention`` and
``paged_decode_attention`` kernels (slice 2); quantized weights
(``quant.py``: int8 / int4, weight-only or W8A8) through both, with the
epilogue's int8-head variant, ``utils/quality.py``, and the ``softmax``
kernel, which no model path calls (slice 3); the captured step
(``graphs.py``: the decode step and the engine's unified tick replayed
as CUDA graphs, the KV cache's offset on the card), the counterpart of
``jax.jit``; and speculative decoding (``speculative.py``, the
offline ``SpeculativeGenerator`` over per-row cache offsets, its round
one captured graph; ``ServeEngine(spec_k=...)`` with ``serve/spec.py``'s
prompt-lookup drafts verified in the captured unified tick).  The
command line, ``python -m llm_np_cp_tpu_torch.cli`` (generation,
``serve-bench`` and ``serve``), drives every layer from a local
checkpoint directory (``utils/loading.load_model``); ``--backend numpy``
runs the fp32 NumPy oracle (``backends/numpy_ref.py``).  Generation
runs over a mesh (``parallel/``: tensor, data and sequence parallelism
over ``torch.distributed``, ring attention, ``Generator(mesh=)`` and the
CLI's ``--mesh``).  Training (``train.py``: the causal-LM loss, an AdamW
step equal to the JAX package's optax chain, ``python -m
llm_np_cp_tpu_torch.train``) runs on one card or over a data-, tensor-
and pipeline-parallel mesh (``parallel/pipeline.py``), and
``utils/checkpoint.py`` saves and restores its state.

Entry points take ``device=`` and default to ``"cuda"``; they raise when
no card is present unless the caller asks for ``"cpu"``.
"""

from llm_np_cp_tpu_torch.config import PRESETS, ModelConfig, tiny_config
from llm_np_cp_tpu_torch.device import resolve_device

__all__ = ["ModelConfig", "PRESETS", "resolve_device", "tiny_config"]
