"""Reference-shaped model API (port of ``llm_np_cp_tpu/models/api.py``).

Called as a function returning the reference's 5-tuple
``(loss, logits, kv_cache, hidden_states, attentions)`` with HF-style
accessors, on top of ``models.transformer.forward``.
"""

from __future__ import annotations

from typing import Any

import torch

from llm_np_cp_tpu_torch.cache import KVCache
from llm_np_cp_tpu_torch.config import ModelConfig
from llm_np_cp_tpu_torch.models.transformer import forward


class CausalLM:
    """Callable model facade over (params, config) on ``device``."""

    def __init__(
        self, params: dict[str, Any], config: ModelConfig,
        *, device: str | torch.device = "cuda",
    ) -> None:
        self.params = params
        self.config = config
        self.device = device

    def __call__(
        self,
        input_ids: torch.Tensor,
        use_cache: bool = False,
        kv_cache: KVCache | None = None,
        labels: torch.Tensor | None = None,
        output_hidden_states: bool = False,
        output_attentions: bool = False,
    ):
        """Returns ``(loss, logits, kv_cache, hidden_states, attentions)``;
        loss is None unless ``labels`` is given (HF convention: labels
        align with input_ids, -100 is ignored)."""
        cache = kv_cache if use_cache else None
        out = forward(
            self.params, input_ids, self.config, cache,
            output_hidden_states=output_hidden_states,
            output_attentions=output_attentions,
            device=self.device,
        )
        logits, new_cache = out[0], out[1]
        aux = out[2] if len(out) > 2 else {}
        loss = None
        if labels is not None:
            labels = torch.as_tensor(labels, device=logits.device).long()
            logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
            tgt = labels[:, 1:]
            nll = -torch.gather(logp, -1, tgt.clamp_min(0)[..., None])[..., 0]
            mask = (tgt != -100).float()
            loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return loss, logits, new_cache, aux.get("hidden_states"), aux.get("attentions")

    def get_input_embeddings(self) -> torch.Tensor:
        return self.params["embed_tokens"]

    def set_input_embeddings(self, value: torch.Tensor) -> None:
        self.params["embed_tokens"] = value

    def get_output_embeddings(self) -> torch.Tensor:
        if self.config.tie_word_embeddings:
            return self.params["embed_tokens"]
        return self.params["lm_head"]

    def set_output_embeddings(self, value: torch.Tensor) -> None:
        """A tied model's head IS the embedding table: setting one sets both."""
        if self.config.tie_word_embeddings:
            self.params["embed_tokens"] = value
        else:
            self.params["lm_head"] = value

    def get_decoder(self) -> dict[str, Any]:
        """The backbone params (everything but the head)."""
        return {k: v for k, v in self.params.items() if k != "lm_head"}

    def set_decoder(self, decoder: dict[str, Any]) -> None:
        """Swap the backbone, keep the head."""
        head = self.params.get("lm_head")
        self.params = dict(decoder)
        if head is not None and "lm_head" not in self.params:
            self.params["lm_head"] = head
