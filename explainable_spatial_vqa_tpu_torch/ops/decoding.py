"""Autoregressive decoding over KV caches, ported from
``explainable_spatial_vqa_tpu/ops/decoding.py``.

JAX runs each decode as one ``lax.scan`` of cached steps; here each is a
Python loop of the same steps, with no host read inside it (no ``.item()``,
no early exit when every row has finished: the tokens after a row's end
are padding either way, and a data-dependent exit would wait on the card).

``model`` exposes ``init_cache(memory, max_len)`` and ``decode_step(token,
cache, index, memory_mask)`` -> (logits (B, V), new cache), as
``TransformerIQAP`` and ``StepExecutorSeq2Seq`` do.  Tokens are int64.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

__all__ = ["greedy_decode", "greedy_decode_logits", "beam_search_decode"]


def greedy_decode(model: Any, memory: torch.Tensor, memory_mask: Optional[torch.Tensor],
                  start_token: int, max_len: int, end_token: Optional[int] = None,
                  pad_token: int = 0) -> torch.Tensor:
    """Greedy decode ``max_len`` tokens from encoder ``memory``: (B, max_len)
    tokens; once a row emits ``end_token``, the rest of it is ``pad_token``
    and the pad is what the next step is fed, as in JAX."""
    batch = memory.shape[0]
    cache = model.init_cache(memory, max_len)
    token = torch.full((batch,), start_token, dtype=torch.long, device=memory.device)
    finished = torch.zeros(batch, dtype=torch.bool, device=memory.device)
    tokens = []
    for index in range(max_len):
        logits, cache = model.decode_step(token, cache, index, memory_mask)
        nxt = torch.argmax(logits, dim=-1)
        token = torch.where(finished, torch.full_like(nxt, pad_token), nxt)
        if end_token is not None:
            finished = finished | (nxt == end_token)
        tokens.append(token)
    return torch.stack(tokens, dim=1)


def greedy_decode_logits(model: Any, memory: torch.Tensor, memory_mask: Optional[torch.Tensor],
                         start_token: int, max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode that also returns each step's logits: (tokens (B, T),
    logits (B, T, V)).  The argmax feedback carries no gradient; the logits
    do, through every step's cache (the IQAP family trains through it)."""
    batch = memory.shape[0]
    cache = model.init_cache(memory, max_len)
    token = torch.full((batch,), start_token, dtype=torch.long, device=memory.device)
    tokens, logits_t = [], []
    for index in range(max_len):
        logits, cache = model.decode_step(token, cache, index, memory_mask)
        token = torch.argmax(logits, dim=-1)
        tokens.append(token)
        logits_t.append(logits)
    return torch.stack(tokens, dim=1), torch.stack(logits_t, dim=1)


def _gather(tree: Any, flat: torch.Tensor) -> Any:
    """Every tensor leaf of a cache (tuples and dicts) reindexed by ``flat``
    along its batch axis."""
    if isinstance(tree, dict):
        return {k: _gather(v, flat) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_gather(v, flat) for v in tree)
    return tree[flat]


def beam_search_decode(model: Any, memory: torch.Tensor, memory_mask: Optional[torch.Tensor],
                       start_token: int, max_len: int, beam_size: int = 4,
                       end_token: Optional[int] = None, pad_token: int = 0,
                       length_penalty: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over the cached decoder: (tokens (B, K, max_len), scores
    (B, K)), best first.

    Memory and caches are tiled to (B·K, ...) and regathered along the beam
    axis each step; log-probabilities are float32; beam 0 starts live and the
    others at -1e30; a finished beam can only add ``pad_token`` at no cost.
    Top-k breaks ties by the lower flat (beam·V + token) index, as
    ``jax.lax.top_k`` does (a stable descending sort, then the first K), and
    the final order is a stable sort by score."""
    batch, k, device = memory.shape[0], beam_size, memory.device
    memory_k = memory.repeat_interleave(k, dim=0)
    mask_k = None if memory_mask is None else memory_mask.repeat_interleave(k, dim=0)
    cache = model.init_cache(memory_k, max_len)

    neg_inf = -1e30
    scores = torch.full((batch, k), neg_inf, device=device)
    scores[:, 0] = 0.0
    tokens = torch.full((batch, k), start_token, dtype=torch.long, device=device)
    finished = torch.zeros(batch, k, dtype=torch.bool, device=device)
    offsets = torch.arange(batch, device=device)[:, None] * k
    step_tokens, step_beams = [], []
    for index in range(max_len):
        logits, cache = model.decode_step(tokens.reshape(-1), cache, index, mask_k)
        logp = torch.log_softmax(logits.float(), dim=-1)
        vocab = logp.shape[-1]
        logp = logp.reshape(batch, k, vocab)
        pad_only = torch.full((vocab,), neg_inf, device=device)
        pad_only[pad_token] = 0.0
        logp = torch.where(finished[..., None], pad_only, logp)
        total = (scores[..., None] + logp).reshape(batch, k * vocab)
        ordered, index_sorted = torch.sort(total, dim=-1, descending=True, stable=True)
        scores, top_index = ordered[:, :k], index_sorted[:, :k]
        beam_index = torch.div(top_index, vocab, rounding_mode="floor")
        tokens = top_index % vocab
        cache = _gather(cache, (beam_index + offsets).reshape(-1))
        finished = torch.gather(finished, 1, beam_index)
        if end_token is not None:
            finished = finished | (tokens == end_token)
        step_tokens.append(tokens)
        step_beams.append(beam_index)

    beam = torch.arange(k, device=device).expand(batch, k)
    rev_tokens = []
    for step in range(max_len - 1, -1, -1):
        rev_tokens.append(torch.gather(step_tokens[step], 1, beam))
        beam = torch.gather(step_beams[step], 1, beam)
    out_tokens = torch.stack(rev_tokens[::-1], dim=-1)
    if length_penalty:
        lengths = (out_tokens != pad_token).sum(-1).float()
        scores = scores / torch.pow(torch.clamp(lengths, min=1.0), length_penalty)
    order = torch.argsort(-scores, dim=-1, stable=True)
    scores = torch.gather(scores, 1, order)
    out_tokens = torch.gather(out_tokens, 1, order[..., None].expand_as(out_tokens))
    return out_tokens, scores
