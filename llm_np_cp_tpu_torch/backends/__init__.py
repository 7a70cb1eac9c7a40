"""Array backends beside the torch path.

``numpy_ref`` is the fp32 NumPy oracle (the reference's
llama3.2_model_numpy.py role): the runtime of the command line's
``--backend numpy``.
"""

from llm_np_cp_tpu_torch.backends.numpy_ref import NpKVCache, forward_np

__all__ = ["NpKVCache", "forward_np"]
