"""LSTM IQAP/IQA baseline family, ported from
``explainable_spatial_vqa_tpu/models/lstm_iqap.py``.

A question LSTM (hidden 512) runs over the whole padded question, unmasked,
and gives its final ``h``; the image features (B, C, H, W) are flattened
C-major (1024·14·14 = 200,704 inputs, the order ``image_fc``'s kernel was
converted in) through ``image_fc`` and a ReLU; the two are joined for the
answer classifier.  With ``with_program_decoder`` (IQAP) an LSTM decodes the
program from ``tanh(dec_init_fc(fused))`` with scheduled teacher forcing:
one coin per time step, shared across the batch, drawn from a
``torch.Generator`` in training mode; in eval mode every coin is
``teacher_forcing >= 1``.  ``lstm_iqa`` is the same model without the
decoder.  The recurrences are Python loops over time; the cells are Flax's
``OptimizedLSTMCell`` arithmetic (:class:`~.generator.LSTMCell`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import LstmIQAPConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.generator import LSTMCell
from explainable_spatial_vqa_tpu_torch.models.layers import Dense, Device, embed_or_nan

__all__ = ["LstmIQAP"]


def _promoted_cat(parts) -> torch.Tensor:
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    return torch.cat([p.to(dtype) for p in parts], dim=-1)


class LstmIQAP(nn.Module):
    def __init__(self, config: LstmIQAPConfig, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        self.config = cfg
        self.dtype = dtype
        e, h = cfg.embed_dim, cfg.hidden_dim
        flat = cfg.image_feature_dim * cfg.image_spatial[0] * cfg.image_spatial[1]
        self.embed = nn.Embedding(cfg.vocab_size, e, device=device)
        self.q_lstm = LSTMCell(e, h, dtype, device)
        self.image_fc = Dense(flat, h, dtype, device)
        self.answer_fc = Dense(2 * h, cfg.num_answer_classes, torch.float32, device)
        if cfg.with_program_decoder:
            self.prog_embed = nn.Embedding(cfg.program_vocab_size, e, device=device)
            self.dec_init_fc = Dense(2 * h, h, dtype, device)
            self.dec_lstm = LSTMCell(e, h, dtype, device)
            self.prog_fc = Dense(h, cfg.program_vocab_size, torch.float32, device)

    def _encode(self, image_features: torch.Tensor, questions: torch.Tensor) -> torch.Tensor:
        emb = embed_or_nan(self.embed, questions).to(self.dtype)
        zeros = torch.zeros(questions.shape[0], self.config.hidden_dim, device=emb.device)
        carry = (zeros, zeros)
        for t in range(emb.shape[1]):
            carry, _ = self.q_lstm(carry, emb[:, t])
        img_flat = image_features.reshape(image_features.shape[0], -1).to(self.dtype)
        img_repr = torch.relu(self.image_fc(img_flat))
        fused = _promoted_cat([carry[1], img_repr])
        return F.dropout(fused, self.config.dropout, training=self.training)

    def forward(self, image_features: torch.Tensor, questions: torch.Tensor,
                program_targets: Optional[torch.Tensor] = None,
                teacher_forcing: Optional[float] = None, start_token: int = 1,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """image_features (B, C, H, W) or (B, F); questions (B, L).  Returns
        {"answer_logits"} and, with the program decoder, "program_logits"
        (B, T, V) and "program_tokens" (B, T), the argmaxes.  Step t+1 is
        fed gold token t where step t's coin says so, else step t's argmax;
        without ``program_targets`` the decoder feeds itself for
        ``program_len`` steps.  The coins come from ``generator``, a CPU
        generator (they steer the host's loop)."""
        cfg = self.config
        fused = self._encode(image_features, questions)
        out = {"answer_logits": self.answer_fc(fused)}
        if not cfg.with_program_decoder:
            return out
        batch = questions.shape[0]
        length = cfg.program_len if program_targets is None else program_targets.shape[1]
        tf_ratio = cfg.teacher_forcing if teacher_forcing is None else teacher_forcing
        if program_targets is None:
            tf_ratio = 0.0
        if self.training and tf_ratio > 0.0:
            coins = (torch.rand(length, generator=generator) < tf_ratio).tolist()
        else:
            coins = [tf_ratio >= 1.0] * length
        h0 = torch.tanh(self.dec_init_fc(fused))
        carry = (torch.zeros_like(h0), h0)
        # a target past the program table reads NaN, as Flax's Embed does;
        # the start token and the argmaxes always lie inside it
        fed = self.prog_embed(torch.full((batch,), start_token, dtype=torch.long,
                                         device=questions.device))
        logits_t, tokens = [], []
        for t in range(length):
            carry, h = self.dec_lstm(carry, fed.to(self.dtype))
            logits = self.prog_fc(h)
            pred = torch.argmax(logits, dim=-1)
            fed = (embed_or_nan(self.prog_embed, program_targets[:, t]) if coins[t]
                   else self.prog_embed(pred))
            logits_t.append(logits)
            tokens.append(pred)
        out["program_logits"] = torch.stack(logits_t, dim=1)
        out["program_tokens"] = torch.stack(tokens, dim=1)
        return out
