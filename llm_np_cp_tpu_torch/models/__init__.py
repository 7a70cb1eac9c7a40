"""Model family assembly: one generic decoder (``transformer.py``);
``llama.py``, ``gemma2.py`` and ``qwen2.py`` bind family configs and
checkpoint key names; ``api.py`` is the reference-shaped facade."""

from llm_np_cp_tpu_torch.models.transformer import forward, init_params

__all__ = ["forward", "init_params"]
