"""Program Generator: question tokens -> program tokens, ported from
``explainable_spatial_vqa_tpu/models/generator.py``.

The thesis-final generator (§3.4.1 p.16): an embedding, a 3-layer LSTM
encoder per direction, a 3-layer LSTM decoder with Luong dot attention over
the encoder states, greedy decoding.  The two encoder directions are two
separate unidirectional stacks (upper layers take ``h``, not ``2h``); their
top outputs are concatenated and projected by ``enc_proj``, and the decoder
starts from the per-layer sum of their final ``(c, h)`` carries.  This is
not ``nn.LSTM(bidirectional=True)``, which concatenates the directions
between layers.  The encoder scans run over padding unmasked, as in JAX.

``simple=True`` is the checked-in 1-layer variant without attention.  The
generator has no TPU kernel, so it is plain PyTorch; recurrences are Python
loops over time.  :meth:`ProgramGenerator.forward` is the training forward
(teacher forcing with scheduled sampling, dropout on the embeddings in
training mode); :meth:`ProgramGenerator.generate` the greedy decode and
:meth:`ProgramGenerator.beam_generate` the beam search, both on the device
with no host read inside the loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import GeneratorConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.layers import (
    Dense,
    Device,
    cached_on_params,
    embed_or_nan,
)

__all__ = ["ProgramGenerator", "LSTMCell"]

Carry = Tuple[torch.Tensor, torch.Tensor]  # (c, h), as in Flax


class LSTMCell(nn.Module):
    """Flax ``OptimizedLSTMCell`` arithmetic: gates i, f, g, o from an input
    product without bias plus a hidden product with bias, computed in
    ``dtype``; the carry keeps the type promotion of ``f * c + i * g``.
    Without autograd the cast weights are kept between calls."""

    def __init__(self, input_dim: int, hidden_dim: int, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden_dim, input_dim, device=device))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden_dim, hidden_dim, device=device))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_dim, device=device))

    def _cast(self):
        dt = self.dtype
        return self.weight_hh.to(dt), self.bias.to(dt), self.weight_ih.to(dt)

    def forward(self, carry: Carry, x: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        c, h = carry
        dt = self.dtype
        weight_hh, bias, weight_ih = (self._cast() if torch.is_grad_enabled()
                                      else cached_on_params(self, self._cast))
        y = F.linear(h.to(dt), weight_hh, bias) + F.linear(x.to(dt), weight_ih)
        i, f, g, o = y.chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        new_c = f * c + i * g
        new_h = o * torch.tanh(new_c)
        return (new_c, new_h), new_h


class _LSTMStack(nn.Module):
    """Multi-layer LSTM cell stack operating on one timestep."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cells = nn.ModuleList(
            LSTMCell(input_dim if i == 0 else hidden_dim, hidden_dim, dtype, device)
            for i in range(num_layers))

    def forward(self, carry: Tuple[Carry, ...], x: torch.Tensor):
        new_carry = []
        for cell, c in zip(self.cells, carry):
            c, x = cell(c, x)
            new_carry.append(c)
        return tuple(new_carry), x

    def initialize_carry(self, batch: int, device: torch.device) -> Tuple[Carry, ...]:
        zeros = lambda: torch.zeros(batch, self.hidden_dim, device=device)  # noqa: E731
        return tuple((zeros(), zeros()) for _ in self.cells)

    def scan(self, carry, xs: torch.Tensor):
        """Run over (B, T, E) inputs; returns (final carry, (B, T, H) outputs)."""
        outs: List[torch.Tensor] = []
        for t in range(xs.shape[1]):
            carry, h = self(carry, xs[:, t])
            outs.append(h)
        return carry, torch.stack(outs, dim=1)


class ProgramGenerator(nn.Module):
    def __init__(self, config: GeneratorConfig, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        self.config = cfg
        self.dtype = dtype
        self.bidirectional = cfg.bidirectional and not cfg.simple
        self.attention = cfg.attention and not cfg.simple
        enc_layers = 1 if cfg.simple else cfg.encoder_layers
        dec_layers = 1 if cfg.simple else cfg.decoder_layers
        e, h = cfg.embed_dim, cfg.hidden_dim
        self.embed = nn.Embedding(cfg.vocab_size, e, device=device)
        self.prog_embed = nn.Embedding(cfg.program_vocab_size, e, device=device)
        self.enc_fwd = _LSTMStack(e, h, enc_layers, dtype, device)
        if self.bidirectional:
            self.enc_bwd = _LSTMStack(e, h, enc_layers, dtype, device)
            self.enc_proj = Dense(2 * h, h, dtype, device)
        self.decoder = _LSTMStack(e, h, dec_layers, dtype, device)
        if self.attention:
            self.attn_combine = Dense(2 * h, h, dtype, device)
        self.out_proj = Dense(h, cfg.program_vocab_size, torch.float32, device)

    def _dropout(self, x: torch.Tensor, deterministic: bool) -> torch.Tensor:
        return F.dropout(x, self.config.dropout, training=not deterministic)

    def encode(self, questions: torch.Tensor,
               deterministic: bool = True) -> Tuple[torch.Tensor, Tuple[Carry, ...]]:
        """questions: (B, L) int (0 = <NULL> pad).  Returns (encoder outputs
        (B, L, H), the decoder's initial carry)."""
        emb = self._dropout(embed_or_nan(self.embed, questions).to(self.dtype), deterministic)
        batch = questions.shape[0]
        carry_f, outs_f = self.enc_fwd.scan(self.enc_fwd.initialize_carry(batch, emb.device), emb)
        if self.bidirectional:
            carry_b, outs_b = self.enc_bwd.scan(
                self.enc_bwd.initialize_carry(batch, emb.device), torch.flip(emb, dims=[1]))
            outs_b = torch.flip(outs_b, dims=[1])
            enc_outputs = self.enc_proj(torch.cat([outs_f, outs_b], dim=-1))
            # decoder init: combine directions per layer (sum of c and h)
            dec_init = tuple((cf[0] + cb[0], cf[1] + cb[1]) for cf, cb in zip(carry_f, carry_b))
        else:
            enc_outputs, dec_init = outs_f, carry_f
        dec_layers = len(self.decoder.cells)
        if len(dec_init) < dec_layers:  # decoder deeper than encoder: zero carries
            extra = self.decoder.initialize_carry(batch, emb.device)
            dec_init = tuple(dec_init) + tuple(extra[len(dec_init):])
        return enc_outputs, dec_init[:dec_layers]

    def _decode_step(self, carry, fed: torch.Tensor, enc_outputs: torch.Tensor,
                     enc_mask: Optional[torch.Tensor], deterministic: bool = True):
        """One decoder step on ``fed``, the (B, E) program embedding rows of
        the tokens fed at this step."""
        x = self._dropout(fed.to(self.dtype), deterministic)
        carry, h = self.decoder(carry, x)
        if self.attention:
            # Luong dot attention over the encoder outputs, softmax in float32
            common = torch.promote_types(h.dtype, enc_outputs.dtype)
            scores = torch.einsum("bh,blh->bl", h.to(common), enc_outputs.to(common)).float()
            if enc_mask is not None:
                scores = torch.where(enc_mask, scores, torch.full_like(scores, -1e30))
            weights = torch.softmax(scores, dim=-1).to(self.dtype)
            context = torch.einsum("bl,blh->bh", weights, enc_outputs.to(self.dtype))
            common = torch.promote_types(h.dtype, context.dtype)
            h = torch.tanh(self.attn_combine(torch.cat([h.to(common), context.to(common)], -1)))
        return carry, self.out_proj(h)

    def forward(self, questions: torch.Tensor, program_targets: Optional[torch.Tensor] = None,
                start_token: int = 1, teacher_forcing: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Teacher-forced / scheduled-sampling training forward (JAX
        ``ProgramGenerator.__call__``): questions (B, L); program_targets
        (B, T), or None for pure greedy self-feeding over ``program_len``.

        Step t+1 is fed gold token t where step t's coin says so, else step
        t's argmax.  In training mode the coins are one Bernoulli draw per
        step, shared across the batch, with probability ``teacher_forcing``
        (the config's by default), drawn from ``generator`` (a CPU
        generator: the coins steer the host's loop); in eval mode every coin
        is ``teacher_forcing >= 1``.  Returns {"logits": (B, T, V) float32,
        "tokens": (B, T) the argmaxes}."""
        cfg = self.config
        deterministic = not self.training
        enc_outputs, carry = self.encode(questions, deterministic)
        enc_mask = questions != 0
        length = cfg.program_len if program_targets is None else program_targets.shape[1]
        tf_ratio = cfg.teacher_forcing if teacher_forcing is None else teacher_forcing
        if program_targets is None:
            tf_ratio = 0.0
        if not deterministic and tf_ratio > 0.0:
            coins = (torch.rand(length, generator=generator) < tf_ratio).tolist()
        else:
            coins = [tf_ratio >= 1.0] * length
        # a target past the program table reads NaN, as Flax's Embed does;
        # the start token and the argmaxes always lie inside it
        gold = None if program_targets is None else embed_or_nan(self.prog_embed,
                                                                 program_targets)
        fed = self.prog_embed(torch.full((questions.shape[0],), start_token, dtype=torch.long,
                                         device=questions.device))
        logits_t, tokens = [], []
        for t in range(length):
            carry, logits = self._decode_step(carry, fed, enc_outputs, enc_mask, deterministic)
            pred = torch.argmax(logits, dim=-1)
            if t + 1 < length:
                fed = gold[:, t] if coins[t] else self.prog_embed(pred)
            logits_t.append(logits)
            tokens.append(pred)
        return {"logits": torch.stack(logits_t, dim=1), "tokens": torch.stack(tokens, dim=1)}

    @torch.no_grad()
    def generate(self, questions: torch.Tensor, max_len: Optional[int] = None,
                 start_token: int = 1) -> torch.Tensor:
        """Greedy decode: (B, L) questions -> (B, T) program tokens, each step
        fed the previous step's argmax."""
        length = max_len or self.config.program_len
        enc_outputs, carry = self.encode(questions)
        enc_mask = questions != 0
        token = torch.full((questions.shape[0],), start_token, dtype=torch.long,
                           device=questions.device)
        tokens = []
        for _ in range(length):
            carry, logits = self._decode_step(carry, self.prog_embed(token), enc_outputs,
                                              enc_mask)
            token = torch.argmax(logits, dim=-1)
            tokens.append(token)
        return torch.stack(tokens, dim=1)

    @torch.no_grad()
    def beam_generate(self, questions: torch.Tensor, beam_size: int = 4,
                      max_len: Optional[int] = None, start_token: int = 1, end_token: int = 2,
                      pad_token: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search decode (JAX ``ProgramGenerator.beam_generate``): returns
        (tokens (B, K, T), scores (B, K)), best first.

        The decoder carry is tiled to (B·K, ...) and regathered along the beam
        axis each step; log-probabilities are float32; a finished beam (one
        that emitted ``end_token``) can only add ``pad_token`` at no cost.
        Beams start as one live beam and K-1 at -1e30.  Top-k breaks ties by
        the lower flat (beam·V + token) index, as ``jax.lax.top_k`` does:
        a stable descending sort, then the first K."""
        length = max_len or self.config.program_len
        k = beam_size
        enc_outputs, carry = self.encode(questions)
        enc_mask = questions != 0
        batch, device = questions.shape[0], questions.device
        enc_k = enc_outputs.repeat_interleave(k, dim=0)
        mask_k = enc_mask.repeat_interleave(k, dim=0)
        carry = tuple((c.repeat_interleave(k, dim=0), h.repeat_interleave(k, dim=0))
                      for c, h in carry)

        neg_inf = -1e30
        scores = torch.full((batch, k), neg_inf, device=device)
        scores[:, 0] = 0.0
        tokens = torch.full((batch, k), start_token, dtype=torch.long, device=device)
        finished = torch.zeros(batch, k, dtype=torch.bool, device=device)
        offsets = torch.arange(batch, device=device)[:, None] * k
        step_tokens, step_beams = [], []
        for _ in range(length):
            carry, logits = self._decode_step(carry, self.prog_embed(tokens.reshape(-1)), enc_k,
                                              mask_k)
            logp = torch.log_softmax(logits.float(), dim=-1)
            vocab = logp.shape[-1]
            logp = logp.reshape(batch, k, vocab)
            pad_only = torch.full((vocab,), neg_inf, device=device)
            pad_only[pad_token] = 0.0
            logp = torch.where(finished[..., None], pad_only, logp)
            total = (scores[..., None] + logp).reshape(batch, k * vocab)
            ordered, index = torch.sort(total, dim=-1, descending=True, stable=True)
            scores, top_index = ordered[:, :k], index[:, :k]
            beam_index = torch.div(top_index, vocab, rounding_mode="floor")
            tokens = top_index % vocab
            flat = (beam_index + offsets).reshape(-1)
            carry = tuple((c[flat], h[flat]) for c, h in carry)
            finished = torch.gather(finished, 1, beam_index) | (tokens == end_token)
            step_tokens.append(tokens)
            step_beams.append(beam_index)

        beam = torch.arange(k, device=device).expand(batch, k)
        rev_tokens = []
        for step in range(length - 1, -1, -1):
            rev_tokens.append(torch.gather(step_tokens[step], 1, beam))
            beam = torch.gather(step_beams[step], 1, beam)
        out_tokens = torch.stack(rev_tokens[::-1], dim=-1)
        order = torch.argsort(-scores, dim=-1, stable=True)
        scores = torch.gather(scores, 1, order)
        out_tokens = torch.gather(out_tokens, 1, order[..., None].expand_as(out_tokens))
        return out_tokens, scores
