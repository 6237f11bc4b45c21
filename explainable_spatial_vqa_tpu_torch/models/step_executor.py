"""Step-executor seq2seq, ported from
``explainable_spatial_vqa_tpu/models/step_executor.py``: per program step,
(image, src tokens) -> output tokens.

Image features (B, 196, 1024) are projected to d_model and joined by the
embedded src text (the function token and the input-value tokens); a
post-LN encoder gives the memory, with a key mask ``[ones(P) | src valid]``
when a src padding mask is given; a transformer decoder emits the output
tokens, teacher-forced in training (:meth:`StepExecutorSeq2Seq.forward`) or
greedily over KV caches in inference (:meth:`~StepExecutorSeq2Seq.init_cache`,
:meth:`~StepExecutorSeq2Seq.decode_step`, driven by :mod:`..ops.decoding`
and :class:`~..infer.chain.Seq2SeqChainRunner`).  The encoder runs once per
step; decoding does not re-run it.

In eval mode on the card the encoder's blocks run on K2 at head dim 128, with
the key mask or none; at the preset's head dim 64 their self-attention runs
on K1.  The decoder's causal self-attention and its cross-attention never
reach K1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import StepSeq2SeqConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.layers import (
    Dense,
    Device,
    PositionalEncoding,
    TransformerDecoder,
    TransformerEncoder,
    embed_or_nan,
)

__all__ = ["StepExecutorSeq2Seq", "image_grid_to_tokens"]


def image_grid_to_tokens(features: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) feature grid -> (B, H*W, C) tokens, channel last."""
    b, c, h, w = features.shape
    return features.reshape(b, c, h * w).transpose(1, 2)


class StepExecutorSeq2Seq(nn.Module):
    def __init__(self, config: StepSeq2SeqConfig, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        self.config = cfg
        self.dtype = dtype
        d = cfg.d_model
        self.image_proj = Dense(cfg.image_feature_dim, d, dtype, device)
        self.embed = nn.Embedding(cfg.vocab_size, d, device=device)
        self.pos_encoder = PositionalEncoding(d, cfg.max_src_len + cfg.num_image_tokens,
                                              cfg.dropout, device)
        self.pos_decoder = PositionalEncoding(d, cfg.max_tgt_len, cfg.dropout, device)
        self.encoder = TransformerEncoder(cfg.encoder_layers, d, cfg.num_heads, cfg.ffn_dim,
                                          cfg.dropout, dtype=dtype, device=device)
        self.decoder = TransformerDecoder(cfg.decoder_layers, d, cfg.num_heads, cfg.ffn_dim,
                                          cfg.dropout, dtype, device)
        self.output = Dense(d, cfg.vocab_size, torch.float32, device)

    def encode(self, image_tokens: torch.Tensor, src_tokens: torch.Tensor,
               src_pad_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """image_tokens (B, P, C), src_tokens (B, S), src_pad_mask (B, S) bool
        or None -> (memory (B, P+S, d), key mask (B, 1, 1, P+S) or None)."""
        dt = self.dtype
        img = self.image_proj(image_tokens.to(dt))
        src = embed_or_nan(self.embed, src_tokens).to(dt)
        x = self.pos_encoder(torch.cat([img, src], dim=1))
        key_mask = None
        if src_pad_mask is not None:
            img_valid = torch.ones(img.shape[:2], dtype=torch.bool, device=img.device)
            key_mask = torch.cat([img_valid, src_pad_mask.bool()], dim=1)[:, None, None, :]
        return self.encoder(x, key_mask), key_mask

    def decode(self, tgt_tokens: torch.Tensor, memory: torch.Tensor,
               memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced decode: tgt_tokens (B, T) -> logits (B, T, V)."""
        x = self.pos_decoder(embed_or_nan(self.embed, tgt_tokens).to(self.dtype))
        return self.output(self.decoder(x, memory, memory_mask))

    def forward(self, image_tokens: torch.Tensor, src_tokens: torch.Tensor,
                tgt_tokens: torch.Tensor,
                src_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        memory, key_mask = self.encode(image_tokens, src_tokens, src_pad_mask)
        return self.decode(tgt_tokens, memory, key_mask)

    def init_cache(self, memory: torch.Tensor, max_len: int):
        return self.decoder.init_cache(memory.shape[0], max_len, memory)

    def decode_step(self, token: torch.Tensor, cache, index: int,
                    memory_mask: Optional[torch.Tensor] = None):
        """token (B,) -> (logits (B, V), the new cache); no dropout in any mode."""
        x = self.embed(token[:, None]).to(self.dtype)
        x = self.pos_decoder(x, offset=index, deterministic=True)
        x, cache = self.decoder.decode_step(x, cache, index, memory_mask)
        return self.output(x)[:, 0], cache
