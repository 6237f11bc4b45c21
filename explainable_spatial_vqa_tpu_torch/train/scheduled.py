"""Chain-level scheduled sampling for the thesis executor, ported from
``explainable_spatial_vqa_tpu/train/scheduled.py``.

The flat ``executor`` pipeline trains every step teacher-forced: dependency
inputs are ground-truth upstream outputs.  At chained inference the executor
consumes its OWN upstream predictions instead.  Each training step here
closes that loop (DAgger-style):

1. the full chained pass with the current parameters, without autograd
   (:func:`~explainable_spatial_vqa_tpu_torch.infer.chain.chained_forward`,
   the loop that serves inference, which runs the executor in eval mode: on
   the card, K2 and K1), gives the model's own per-step box/token caches;
2. MIXED dependency caches: per (question, step), with probability ``p`` the
   model's predicted outputs replace the ground-truth ones;
3. the per-step set loss with inputs gathered from the mixed caches, masked
   to active and valid steps, in the caller's mode (train mode: the plain
   path with dropout and the grounding noise).

``p`` ramps linearly from 0 to ``ExecutorConfig.scheduled_p_max`` over
``scheduled_ramp_epochs`` (Bengio et al. 2015), fed per batch through
``batch["p_sample"]``.  Both loops stop at the batch's deepest chain (one
host read of ``num_steps``): positions past every question's depth write
nothing in the chained pass and carry zero weight in the loss, so the loss
equals JAX's loop over all ``max_steps`` positions.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.infer.chain import (
    ChainState,
    chained_forward,
    gather_step_inputs,
)
from explainable_spatial_vqa_tpu_torch.parallel.mesh import global_count
from explainable_spatial_vqa_tpu_torch.train.losses import executor_set_loss, perturb_input_boxes

__all__ = ["gt_chain_state", "make_scheduled_loss_fn", "mixed_chain_state", "schedule_p",
           "scheduled_step_loss"]


def schedule_p(epoch: int, cfg: ExecutorConfig) -> float:
    """Linear 0 -> p_max ramp over the first ``scheduled_ramp_epochs``.

    Epoch 0 is fully teacher-forced (p=0); p reaches p_max at
    ``epoch == scheduled_ramp_epochs`` and stays there.
    """
    if cfg.scheduled_p_max <= 0.0:
        return 0.0
    ramp = max(cfg.scheduled_ramp_epochs, 1)
    return float(cfg.scheduled_p_max) * min(1.0, epoch / ramp)


def gt_chain_state(batch: Dict[str, torch.Tensor], cfg: ExecutorConfig) -> ChainState:
    """Ground-truth caches in the inference runner's ChainState layout."""
    is_box = batch["is_box_branch"]
    valid = batch["step_valid"]
    box_mask = batch["target_box_mask"] & (is_box & valid)[..., None]
    return ChainState(
        box_cache=batch["target_boxes"].float(),
        box_mask=box_mask,
        conf_cache=box_mask.float(),
        token_cache=batch["token_target"].to(torch.int32),
        token_branch=~is_box & valid,
        routing=(~is_box).to(torch.int32),
    )


def mixed_chain_state(model, batch: Dict[str, torch.Tensor], image: torch.Tensor,
                      cfg: ExecutorConfig, generator: torch.Generator, depth: int) -> ChainState:
    """The ground-truth caches with each (question, step) replaced by the
    model's own chained prediction with probability ``batch["p_sample"]``.

    The chained pass runs on ``image.detach()`` (the precomputed image
    tokens) to ``depth``, deterministic and without autograd; the draws come
    from ``generator`` (on its own device) and move to the batch's."""
    functions = batch["functions"]
    n, s = functions.shape
    pred = chained_forward(model, image.detach(), functions, batch["deps"], batch["num_steps"],
                           cfg, s, image_precomputed=True, active_steps=depth)
    p = batch.get("p_sample", 0.0)
    draws = torch.rand((n, s), generator=generator, device=generator.device)
    use_pred = draws.to(functions.device) < p

    def mix(p_field: torch.Tensor, g_field: torch.Tensor) -> torch.Tensor:
        pick = use_pred.reshape(use_pred.shape + (1,) * (g_field.ndim - 2))
        return torch.where(pick, p_field, g_field)

    return ChainState(*map(mix, pred, gt_chain_state(batch, cfg)))


def scheduled_step_loss(model, batch: Dict[str, torch.Tensor], image: torch.Tensor,
                        state: ChainState, cfg: ExecutorConfig, generator: torch.Generator,
                        train: bool, depth: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The set loss summed over step positions 0..depth-1, inputs gathered
    from ``state``, each row weighted by whether the step is active and
    valid; returns (loss, JAX's metric sums)."""
    functions, deps, num_steps = batch["functions"], batch["deps"], batch["num_steps"]
    perturb = train and (cfg.input_box_noise > 0.0 or cfg.input_box_drop > 0.0)
    loss_sum = torch.zeros((), device=image.device)
    weight_sum = torch.zeros((), device=image.device)  # global active steps (data parallel)
    counts = torch.zeros(4, device=image.device)  # active steps, routing, token hits, tokens
    for k in range(depth):
        input_boxes, input_mask, text, text_mask = gather_step_inputs(
            state, functions[:, k], deps[:, k, 0], deps[:, k, 1], cfg.max_input_boxes)
        if perturb:
            # stateless grounding noise composes with the scheduled mixture
            input_boxes, input_mask = perturb_input_boxes(
                input_boxes, input_mask, generator, cfg.input_box_noise, cfg.input_box_drop)
        out = model(image, input_boxes, input_mask, text, text_mask, image_precomputed=True)
        is_box = batch["is_box_branch"][:, k]
        w = ((k < num_steps) & batch["step_valid"][:, k]).float()
        losses = executor_set_loss(out, batch["target_boxes"][:, k],
                                   batch["target_box_mask"][:, k], batch["token_target"][:, k],
                                   is_box, cfg, sample_weight=w)
        n_active = w.sum()
        # each position's loss weighs by its global count of active rows
        # (this rank's count outside data parallel)
        n_global = global_count(n_active)
        loss_sum = loss_sum + losses["loss"] * n_global
        weight_sum = weight_sum + n_global
        routing_pred = torch.argmax(out["routing_logits"], -1).detach()
        token_pred = torch.argmax(out["token_logits"], -1).detach()
        tok_w = w * ~is_box
        counts = counts + torch.stack([
            n_active,
            ((routing_pred == 1 - is_box.long()) * w).sum(),
            ((token_pred == batch["token_target"][:, k]) * tok_w).sum(),
            tok_w.sum(),
        ])
    loss = loss_sum / torch.clamp(weight_sum, min=1.0)
    metrics = {"routing_correct": counts[1], "routing_total": counts[0],
               "token_correct": counts[2], "token_total": counts[3]}
    return loss, metrics


def make_scheduled_loss_fn(cfg: ExecutorConfig) -> Callable:
    """The Trainer's ``loss_fn(model, batch, generator, train)`` for
    chain-structured batches (``executor_chain_step_arrays`` plus ``image``
    and a scalar ``p_sample``).  The image projection runs with autograd;
    with ``train`` the mixed caches come from :func:`mixed_chain_state`,
    else the ground-truth caches are used."""

    def loss_fn(model, batch: Dict[str, torch.Tensor], generator: torch.Generator, train: bool):
        depth = int(batch["num_steps"].max())
        image = model.precompute_image(batch["image"])
        state = (mixed_chain_state(model, batch, image, cfg, generator, depth) if train
                 else gt_chain_state(batch, cfg))
        return scheduled_step_loss(model, batch, image, state, cfg, generator, train, depth)

    return loss_fn
