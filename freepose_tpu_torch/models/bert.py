"""BERT text encoder (GroundingDINO's language tower), as nn.Modules.

Counterpart of freepose_tpu.models.bert: a post-LN transformer encoder with
token, position and type embeddings. It takes a [B, L] padding mask or the
[B, L, L] pairwise mask GroundingDINO builds over sub-sentences, and explicit
position ids. Attention logits are formed and kept in fp32 whatever the
compute dtype, as the JAX einsum's preferred_element_type does. Module and
parameter names follow the JAX tree (models/convert.py:bert_from_jax).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from freepose_tpu_torch.models.layers import Dense, LayerNorm, gelu


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    dtype: torch.dtype = torch.float32


BERT_TEST = BertConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2, intermediate=64, max_position=32)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        c = self.cfg = cfg
        h, dt = c.hidden_size, c.dtype
        self.q, self.k, self.v = Dense(h, h, dt), Dense(h, h, dt), Dense(h, h, dt)
        self.attn_out = Dense(h, h, dt)
        self.attn_ln = LayerNorm(h, eps=1e-12, dtype=dt)
        self.fc1 = Dense(h, c.intermediate, dt)
        self.fc2 = Dense(c.intermediate, h, dt)
        self.out_ln = LayerNorm(h, eps=1e-12, dtype=dt)

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        c = self.cfg
        b, n, _ = x.shape
        head_dim = c.hidden_size // c.num_heads

        def heads(t):
            return t.reshape(b, n, c.num_heads, head_dim).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (head_dim**-0.5)
        if bias is not None:
            logits = logits + bias
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(w, v).transpose(1, 2).reshape(b, n, c.hidden_size)
        x = self.attn_ln(x + self.attn_out(attn))
        h = self.fc2(gelu(self.fc1(x)))
        return self.out_ln(x + h)


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        c = self.cfg = cfg
        self.word_embeddings = nn.Parameter(torch.zeros(c.vocab_size, c.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(c.max_position, c.hidden_size))
        self.token_type_embeddings = nn.Parameter(torch.zeros(c.type_vocab, c.hidden_size))
        self.embed_ln = LayerNorm(c.hidden_size, eps=1e-12, dtype=c.dtype)
        for i in range(c.num_layers):
            self.add_module(f"layer{i}", BertLayer(c))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor | None = None,
                token_type_ids: torch.Tensor | None = None,
                position_ids: torch.Tensor | None = None) -> torch.Tensor:
        """input_ids [B, L]; attention_mask [B, L] or [B, L, L] (> 0 = attend)."""
        c = self.cfg
        b, length = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(length, device=input_ids.device)[None].expand(b, -1)
        # Ids past a table clamp to its last row, as a JAX gather does (the
        # tiny test vocabulary is smaller than the prompt's BERT ids).
        x = (self.word_embeddings[input_ids.clamp(0, c.vocab_size - 1)]
             + self.position_embeddings[position_ids.clamp(0, c.max_position - 1)]
             + self.token_type_embeddings[token_type_ids.clamp(0, c.type_vocab - 1)])
        x = self.embed_ln(x.to(c.dtype))

        bias = None
        if attention_mask is not None:
            allowed = attention_mask[:, None, None, :] if attention_mask.ndim == 2 else attention_mask[:, None]
            bias = torch.where(allowed > 0, 0.0, -1e9).to(torch.float32)
        for i in range(c.num_layers):
            x = getattr(self, f"layer{i}")(x, bias)
        return x
