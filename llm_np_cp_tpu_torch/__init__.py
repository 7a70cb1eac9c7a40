"""llm_np_cp_tpu_torch — the PyTorch/CUDA port of ``llm_np_cp_tpu``.

Same module names and public functions as the JAX package, written for
one NVIDIA H100: plain tensor code is PyTorch, and each Pallas kernel on
the ported path is a hand-written CUDA C++ kernel for ``sm_90a``
(``csrc/``, built at first use by ``ops/cuda/build.py``).

Ported so far (slice 1): the offline ``Generator`` path — config, ops,
the static KV cache, the dense decoder forward, samplers, generation and
safetensors loading — with the ``flash_attention``, ``decode_attention``
and ``sample_epilogue`` kernels.

Entry points take ``device=`` and default to ``"cuda"``; they raise when
no card is present unless the caller asks for ``"cpu"``.
"""

from llm_np_cp_tpu_torch.config import PRESETS, ModelConfig, tiny_config
from llm_np_cp_tpu_torch.device import resolve_device

__all__ = ["ModelConfig", "PRESETS", "resolve_device", "tiny_config"]
