"""Transformer IQAP baseline family, ported from
``explainable_spatial_vqa_tpu/models/iqap.py``: (image features, question)
-> answer, program and, optionally, a box set.

A post-LN encoder over [CLS | image tokens | question] with no key mask (the
reference applies none), an answer MLP on CLS, and a transformer decoder
that generates the program greedily over KV caches
(:func:`generate_programs`), also in training, where the loss flows through
each step's logits and, through the caches, into every earlier step's K/V
projections.  The bbox variant adds a box head on the mean-pooled image
memory.  ``answer_out``, ``prog_out`` and ``bbox_out`` compute in float32
whatever the model's type, as their Flax ``Dense(dtype=float32)`` do.

In eval mode on the card the encoder's blocks run on K2 when their head dim
is 128 (:class:`~.layers.EncoderBlock`); at the presets' head dim 64 they run
the plain path, as in the JAX package, with their self-attention on K1.  The
program decoder's causal self-attention and its cross-attention never reach
K1.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import IQAPConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.layers import (
    Dense,
    Device,
    PositionalEncoding,
    TransformerDecoder,
    TransformerEncoder,
    embed_or_nan,
)
from explainable_spatial_vqa_tpu_torch.ops.decoding import greedy_decode_logits

__all__ = ["TransformerIQAP", "generate_programs"]


class TransformerIQAP(nn.Module):
    def __init__(self, config: IQAPConfig, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        self.config = cfg
        self.dtype = dtype
        e = cfg.embed_dim
        self.image_proj = Dense(cfg.image_feature_dim, e, dtype, device)
        self.embed = nn.Embedding(cfg.vocab_size, e, device=device)
        self.cls = nn.Parameter(torch.zeros(1, 1, e, device=device))
        self.pos_encoder = PositionalEncoding(
            e, cfg.num_image_tokens + cfg.max_question_len + 1, cfg.dropout, device)
        self.encoder = TransformerEncoder(cfg.encoder_layers, e, cfg.num_heads, 4 * e,
                                          cfg.dropout, dtype=dtype, device=device)
        self.answer_hidden = Dense(e, cfg.hidden_dim, dtype, device)
        self.answer_out = Dense(cfg.hidden_dim, cfg.num_answer_classes, torch.float32, device)
        self.answer_dropout = nn.Dropout(0.1)
        self.prog_embed = nn.Embedding(cfg.program_vocab_size, e, device=device)
        self.pos_decoder = PositionalEncoding(e, cfg.program_len + 1, cfg.dropout, device)
        self.prog_decoder = TransformerDecoder(cfg.decoder_layers, e, cfg.num_heads, 4 * e,
                                               cfg.dropout, dtype, device)
        self.prog_out = Dense(e, cfg.program_vocab_size, torch.float32, device)
        if cfg.with_bbox_head:
            self.bbox_hidden = Dense(e, cfg.hidden_dim, dtype, device)
            self.bbox_out = Dense(cfg.hidden_dim, cfg.num_bbox_slots * 4, torch.float32, device)

    def encode(self, image_tokens: torch.Tensor, questions: torch.Tensor) -> torch.Tensor:
        """[CLS | image | question] -> encoder memory (B, 1+P+L, d)."""
        dt = self.dtype
        img = self.image_proj(image_tokens.to(dt))
        q = embed_or_nan(self.embed, questions).to(dt)
        cls = self.cls.expand(img.shape[0], 1, img.shape[-1]).to(dt)
        x = self.pos_encoder(torch.cat([cls, img, q], dim=1))
        return self.encoder(x, None)

    def answer_logits(self, memory: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.answer_hidden(memory[:, 0]))
        return self.answer_out(self.answer_dropout(h))

    def bbox_predictions(self, memory: torch.Tensor) -> torch.Tensor:
        """Mean-pooled image-token memory -> (B, num_bbox_slots, 4) in [0, 1]."""
        cfg = self.config
        pooled = memory[:, 1:1 + cfg.num_image_tokens].mean(dim=1)
        out = torch.sigmoid(self.bbox_out(torch.relu(self.bbox_hidden(pooled))))
        return out.reshape(out.shape[0], cfg.num_bbox_slots, 4)

    def decode_programs_tf(self, program_inputs: torch.Tensor, memory: torch.Tensor,
                           deterministic: bool = True) -> torch.Tensor:
        """Teacher-forced decode: (B, T) program inputs -> (B, T, V) logits,
        without dropout unless ``deterministic`` is False (then as the
        module's mode says), as in JAX."""
        x = self.pos_decoder(embed_or_nan(self.prog_embed, program_inputs).to(self.dtype),
                             deterministic=deterministic or None)
        return self.prog_out(self.prog_decoder(x, memory, None, deterministic))

    def init_cache(self, memory: torch.Tensor, max_len: int):
        return self.prog_decoder.init_cache(memory.shape[0], max_len, memory)

    def decode_step(self, token: torch.Tensor, cache, index: int,
                    memory_mask: Optional[torch.Tensor] = None):
        """token (B,) -> (logits (B, V), the new cache); no dropout in any mode."""
        x = self.prog_embed(token[:, None]).to(self.dtype)
        x = self.pos_decoder(x, offset=index, deterministic=True)
        x, cache = self.prog_decoder.decode_step(x, cache, index, memory_mask)
        return self.prog_out(x)[:, 0], cache

    def forward(self, image_tokens: torch.Tensor,
                questions: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{"memory", "answer_logits"} and, with the bbox head, "pred_boxes";
        programs come from :func:`generate_programs` on the memory."""
        memory = self.encode(image_tokens, questions)
        out = {"memory": memory, "answer_logits": self.answer_logits(memory)}
        if self.config.with_bbox_head:
            out["pred_boxes"] = self.bbox_predictions(memory)
        return out


def generate_programs(model: TransformerIQAP, memory: torch.Tensor,
                      start_token: Optional[int] = None,
                      max_len: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy program generation with each step's logits: (tokens (B, T),
    logits (B, T, V)).  The argmax feedback carries no gradient; a loss on
    the logits reaches the decoder, the caches and the memory."""
    cfg = model.config
    return greedy_decode_logits(model, memory, None,
                                cfg.sos_token if start_token is None else start_token,
                                cfg.program_len if max_len is None else max_len)
