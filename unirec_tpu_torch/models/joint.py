"""Joint multimodal Qwen3 embedding model (port of
``unirec_tpu/models/joint.py``).

The Item Q-Former runs on the history items' field embeddings; the first
``num_query_tokens_per_item`` of each item's query tokens overwrite the
embedding rows of the reserved special tokens (ids ``vocab_size + i``) in one
vectorised gather/where; the Qwen3 decoder with LoRA runs; the output is
pooled.  ``model.train()`` puts both submodules in training mode; a training
forward takes a ``DropoutStream`` (``dropout=``), which each submodule
extends with its own name, so the Q-Former's and the decoder's masks are
independent.  ``remat`` / ``remat_policy`` go to the decoder, and
``param_dtype`` to both (see ``models/qwen3.py``).
``history_token_strings`` and ``construct_input_text`` are
framework-free copies of the JAX module's functions (that module imports JAX,
and ``unirec_tpu`` is the reference the port is held against, so it is not
edited).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from unirec_tpu_torch.configs import (
    ItemQFormerConfig,
    JointModelConfig,
    LoRAConfig,
    Qwen3Config,
)
from unirec_tpu_torch.models.item_qformer import ItemQFormer
from unirec_tpu_torch.models.qwen3 import Qwen3Model, last_token_pool, mean_pool
from unirec_tpu_torch.ops.dropout import DropoutStream, at


def history_token_strings(num_items: int, tokens_per_item: int) -> List[str]:
    """The reserved special-token strings."""
    return [
        f"<|history_item_{i}_query_{j}|>"
        for i in range(num_items)
        for j in range(tokens_per_item)
    ]


class MultiModalQwenEmbedding(nn.Module):
    """Qwen3 + LoRA + Item Q-Former with query-token injection."""

    def __init__(self, qwen_config: Qwen3Config,
                 qformer_config: ItemQFormerConfig,
                 joint_config: JointModelConfig = JointModelConfig(),
                 lora: Optional[LoRAConfig] = None, *, device=None,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: bool = False, remat_policy: Optional[str] = None):
        super().__init__()
        if qformer_config.hidden_size != qwen_config.hidden_size:
            raise ValueError(
                "query-token injection requires Q-Former hidden_size "
                f"({qformer_config.hidden_size}) == LLM hidden_size "
                f"({qwen_config.hidden_size})")
        if joint_config.pool not in ("mean", "masked_mean", "last_token"):
            raise ValueError(f"unknown pool {joint_config.pool}")
        self.qwen_config = qwen_config
        self.qformer_config = qformer_config
        self.joint_config = joint_config
        self.lora = lora
        self.dtype = dtype
        self.param_dtype = param_dtype or dtype
        self.base_model = Qwen3Model(qwen_config, lora,
                                     n_extra_tokens=self.num_special_tokens,
                                     device=device, dtype=dtype,
                                     param_dtype=param_dtype, remat=remat,
                                     remat_policy=remat_policy)
        self.qformer = ItemQFormer(qformer_config, device=device, dtype=dtype,
                                   param_dtype=param_dtype)

    def clone(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
              **changes) -> "MultiModalQwenEmbedding":
        """A new module over ``state_dict`` (default: this model's own), with
        the constructor arguments in ``changes`` (``qwen_config``, ``lora``,
        ...) replaced: Flax's ``model.clone``.  The tensors are shared, not
        copied, and this model is left as it is."""
        kw = dict(qwen_config=self.qwen_config,
                  qformer_config=self.qformer_config,
                  joint_config=self.joint_config, lora=self.lora,
                  param_dtype=self.param_dtype,
                  remat=self.base_model.remat,
                  remat_policy=self.base_model.remat_policy)
        kw.update(changes)
        new = MultiModalQwenEmbedding(**kw, device="meta", dtype=self.dtype)
        new.load_state_dict(
            self.state_dict() if state_dict is None else state_dict,
            assign=True)
        return new.train(self.training)

    @property
    def num_special_tokens(self) -> int:
        jc = self.joint_config
        return jc.num_history_items * jc.num_query_tokens_per_item

    @property
    def first_special_id(self) -> int:
        return self.qwen_config.vocab_size

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                history_field_embeddings: Optional[torch.Tensor] = None,
                history_attention_mask: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutStream] = None) -> torch.Tensor:
        """ids/mask [B, L], history [B, H, F, FD] / [B, H, F] -> [B, D];
        ``dropout``: a training forward's stream."""
        jc = self.joint_config
        n_special = self.num_special_tokens
        text_embeds = self.base_model.embed(input_ids)
        b, l, d = text_embeds.shape

        if history_field_embeddings is not None:
            if history_attention_mask is None:
                raise ValueError("history_attention_mask required with history")
            bh, num_hist, num_fields, field_dim = history_field_embeddings.shape
            q_out = self.qformer.query_outputs(
                history_field_embeddings.reshape(bh * num_hist, num_fields,
                                                 field_dim),
                history_attention_mask.reshape(bh * num_hist, num_fields),
                dropout=at(dropout, "qformer"),
            )
            k_per_item = jc.num_query_tokens_per_item
            tokens = q_out[:, :k_per_item, :].reshape(
                bh, num_hist * k_per_item, -1)  # [B, n_special, D]
            offset = input_ids.long() - self.first_special_id
            valid = (offset >= 0) & (offset < n_special)
            safe = offset.clamp(0, n_special - 1)
            gathered = torch.gather(tokens.to(text_embeds.dtype), 1,
                                    safe[..., None].expand(b, l, d))
            text_embeds = torch.where(valid[..., None], gathered, text_embeds)

        hidden = self.base_model(
            inputs_embeds=text_embeds, attention_mask=attention_mask,
            dropout=at(dropout, "base_model"))
        if jc.pool == "mean":
            # mean over ALL positions, padding included (the reference)
            return mean_pool(hidden)
        if jc.pool == "masked_mean":
            return mean_pool(hidden, attention_mask, masked=True)
        return last_token_pool(hidden, attention_mask)


def construct_input_text(history_ids, item_dict: Dict[str, dict],
                         num_history_items: int = 10,
                         num_query_tokens_per_item: int = 2) -> str:
    """Prompt template: numbered titles (truncated to 80 characters), each
    followed by that item's query-token placeholders."""
    parts = []
    for i in range(num_history_items):
        token_part = "".join(
            f" <|history_item_{i}_query_{j}|>"
            for j in range(num_query_tokens_per_item)
        )
        if i < len(history_ids):
            item_id = history_ids[i]
            title = item_dict.get(item_id, {}).get("title", f"Item {item_id}")
            if len(title) > 80:
                title = title[:77] + "..."
            parts.append(f"{i + 1}. {title}{token_part}")
        else:
            parts.append(token_part.strip())
    return "I have bought these items in the past: " + ", ".join(parts)
