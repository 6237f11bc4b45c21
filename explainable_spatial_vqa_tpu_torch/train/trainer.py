"""The trainer, ported from ``explainable_spatial_vqa_tpu/train/trainer.py``
for one device.

- Optimizer from ``OptimConfig``: Adam, or AdamW when ``weight_decay`` is
  set (β = (0.9, 0.999), eps 1e-8, optax's defaults), global-norm clipping
  when ``grad_clip_norm`` is set (optax's rule: scale by max/norm when the
  norm exceeds max), and a staircase decay by ``lr_gamma`` every
  ``lr_step_size · steps_per_epoch`` updates.  The update is PyTorch's fused
  Adam kernel, which writes the parameters without bumping their version
  counters; a step hook bumps them, because the modules key the cast and
  fused weights they keep for inference on those counters
  (``models.layers.cached_on_params``).
- Train step: ``model.train()``, forward, ``loss.backward()``, clip, step.
  Eval step: ``model.eval()`` under ``torch.no_grad()``, where the executor
  runs its fusion layers on K2 and its box decoder's self-attention on K1.
- ``fit``: early stopping on a (numerator, denominator) metric ratio,
  save-best and patience, resume with optimizer state, ``evaluate_best``.
  Randomness is keyed by epoch, as the JAX trainer's ``fold_in(rng, epoch)``
  is: each epoch seeds the dropout generator (PyTorch's global one, forked
  for the epoch) and the generator handed to the loss function from
  ``(seed, epoch)``, so a resumed run draws what an uninterrupted run draws.
- Metrics stay summed on the device and are read once per epoch.
"""

from __future__ import annotations

import copy
import logging
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import OptimConfig, TrainConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.train.checkpoints import CheckpointStore
from explainable_spatial_vqa_tpu_torch.train.metrics import MetricAccumulator
from explainable_spatial_vqa_tpu_torch.train.prefetch import prefetch

logger = logging.getLogger(__name__)

__all__ = ["Trainer", "build_optimizer", "clip_by_global_norm_", "epoch_seed"]

# loss_fn(model, batch, generator, train) -> (loss, count-style metrics)
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], torch.Generator, bool],
                  Tuple[torch.Tensor, Dict[str, Any]]]

_DROPOUT, _SAMPLE, _EVAL = range(3)  # the per-epoch random streams


def epoch_seed(seed: int, epoch: int, stream: int) -> int:
    """A 63-bit seed for one random stream of one epoch."""
    state = np.random.SeedSequence([seed, epoch, stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def build_optimizer(params: List[nn.Parameter], optim: OptimConfig,
                    steps_per_epoch: Optional[int] = None):
    """(optimizer, learning-rate schedule) for ``params``, as the JAX
    package's ``build_optimizer`` builds them with optax."""
    kwargs = dict(lr=optim.learning_rate, betas=(optim.beta1, optim.beta2), eps=1e-8, fused=True)
    if optim.weight_decay:
        optimizer = torch.optim.AdamW(params, weight_decay=optim.weight_decay, **kwargs)
    else:
        optimizer = torch.optim.Adam(params, **kwargs)
    period = optim.lr_step_size * steps_per_epoch if optim.lr_step_size and steps_per_epoch else 0
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda update: optim.lr_gamma ** (update // period) if period else 1.0)

    def bump_versions(opt, _args, _kwargs) -> None:
        for group in opt.param_groups:
            for p in group["params"]:
                torch.autograd.graph.increment_version(p)

    optimizer.register_step_post_hook(bump_versions)
    return optimizer, schedule


def clip_by_global_norm_(params: Iterable[nn.Parameter], max_norm: float) -> None:
    """Scale the gradients in place by max_norm / ‖g‖ when their global norm
    ‖g‖ is at least ``max_norm`` (optax's ``clip_by_global_norm``), without
    reading the norm to the host."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


class Trainer:
    """Generic loop around a loss function
    ``loss_fn(model, batch, generator, train) -> (loss, metrics)``, whose
    metrics are count-style (summable across batches): numbers, or tensors
    on the device.  ``checkpoint_dir=False`` keeps no checkpoints."""

    def __init__(
        self,
        loss_fn: LossFn,
        model: nn.Module,
        optim_config: OptimConfig,
        train_config: TrainConfig,
        steps_per_epoch: Optional[int] = None,
        eval_fn: Optional[LossFn] = None,
        checkpoint_dir: Any = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.eval_loss_fn = eval_fn or loss_fn
        self.optim_config = optim_config
        self.train_config = train_config
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer, self.schedule = build_optimizer(self.params, optim_config,
                                                        steps_per_epoch)
        self.step = 0
        self.epoch = 0
        self.store = (CheckpointStore(checkpoint_dir or train_config.checkpoint_dir)
                      if checkpoint_dir is not False else None)
        self.best_metric = -math.inf
        self.best_state: Optional[Dict[str, torch.Tensor]] = None
        self.stale_epochs = 0

    # -- steps --------------------------------------------------------------

    def apply_gradients(self) -> None:
        """Clip (if configured), take one optimizer step and one schedule step."""
        if self.optim_config.grad_clip_norm:
            clip_by_global_norm_(self.params, self.optim_config.grad_clip_norm)
        self.optimizer.step()
        self.schedule.step()
        self.step += 1

    def train_step(self, batch: Dict[str, Any], generator: torch.Generator) -> Dict[str, Any]:
        """One update on a batch already on the device; returns its metrics
        (tensors, not read) with ``loss_sum`` and ``batches``."""
        self.model.train()
        loss, metrics = self.loss_fn(self.model, batch, generator, True)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.apply_gradients()
        return {**metrics, "loss_sum": loss.detach(), "batches": 1}

    def eval_step(self, model: nn.Module, batch: Dict[str, Any],
                  generator: torch.Generator) -> Dict[str, Any]:
        model.eval()
        with torch.no_grad():
            loss, metrics = self.eval_loss_fn(model, batch, generator, False)
        return {**metrics, "loss_sum": loss, "batches": 1}

    # -- loops --------------------------------------------------------------

    def train_epoch(self, data: Iterable[Dict[str, np.ndarray]], seed: int, epoch: int
                    ) -> MetricAccumulator:
        acc = MetricAccumulator()
        devices = []
        if self.device.type == "cuda":
            devices = [torch.cuda.current_device() if self.device.index is None
                       else self.device.index]
        generator = torch.Generator().manual_seed(epoch_seed(seed, epoch, _SAMPLE))
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(epoch_seed(seed, epoch, _DROPOUT))
            for i, batch in enumerate(prefetch(data, self.device)):
                acc.update(self.train_step(batch, generator))
                if self.train_config.log_every and (i + 1) % self.train_config.log_every == 0:
                    logger.info("step %d loss %.4f", i + 1, acc.mean("loss_sum"))
        return acc

    def evaluate(self, data: Iterable[Dict[str, np.ndarray]], seed: int = 0,
                 model: Optional[nn.Module] = None) -> MetricAccumulator:
        model = self.model if model is None else model
        generator = torch.Generator().manual_seed(seed)
        acc = MetricAccumulator()
        for batch in prefetch(data, self.device):
            acc.update(self.eval_step(model, batch, generator))
        return acc

    def fit(
        self,
        train_batches: Callable[[int], Iterable[Dict[str, np.ndarray]]],
        val_batches: Optional[Callable[[], Iterable[Dict[str, np.ndarray]]]] = None,
        monitor: Tuple[str, str] = ("answer_correct", "answer_total"),
        num_epochs: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Run the training loop; returns {"train": [...], "val": [...]}, the
        metric totals of each epoch.  ``train_batches(epoch)`` and
        ``val_batches()`` return fresh iterators of numpy batches;
        ``monitor`` is the (numerator, denominator) ratio maximized for early
        stopping and the best snapshot."""
        cfg = self.train_config
        num_epochs = num_epochs or cfg.num_epochs
        seed = cfg.seed if seed is None else seed
        if self.store is not None and cfg.resume:
            self._resume()

        history: Dict[str, List[Dict[str, float]]] = {"train": [], "val": []}
        for epoch in range(self.epoch, num_epochs):
            t0 = time.time()
            train_acc = self.train_epoch(train_batches(epoch), seed, epoch)
            history["train"].append(train_acc.totals)
            logger.info("epoch %d train loss %.4f (%.1fs)", epoch, train_acc.mean("loss_sum"),
                        time.time() - t0)
            self.epoch = epoch + 1

            if val_batches is not None:
                val_acc = self.evaluate(val_batches(), epoch_seed(seed, epoch, _EVAL))
                if not val_acc.totals:
                    logger.warning("validation yielded ZERO batches (dataset smaller than the "
                                   "batch size?) — early stopping and the best snapshot are "
                                   "inactive")
                history["val"].append(val_acc.totals)
                metric = val_acc.ratio(*monitor)
                logger.info("epoch %d val loss %.4f monitor %.4f", epoch,
                            val_acc.mean("loss_sum"), metric)
                if metric > self.best_metric:
                    self.best_metric = metric
                    self.best_state = {k: v.detach().to("cpu", copy=True)
                                       for k, v in self.model.state_dict().items()}
                    self.stale_epochs = 0
                    if self.store is not None:
                        self.store.save_best({"model": self.best_state})
                else:
                    self.stale_epochs += 1

            if self.store is not None and (
                    (epoch + 1) % cfg.checkpoint_interval == 0 or epoch + 1 == num_epochs):
                self.store.save(epoch + 1, self._payload())
            if val_batches is not None and self.stale_epochs >= cfg.patience:
                logger.info("early stopping at epoch %d", epoch)
                break

        if self.store is not None:
            self.store.save(self.epoch, self._payload())
            self.store.wait()
        return history

    def evaluate_best(self, data: Iterable[Dict[str, np.ndarray]],
                      seed: int = 0) -> MetricAccumulator:
        """Evaluate with the best parameters seen by ``fit`` (the current
        ones, with a warning, if validation never ran or never improved)."""
        if self.best_state is None:
            logger.warning("evaluate_best: no best snapshot recorded (validation never improved "
                           "or never ran) — evaluating the CURRENT parameters instead")
            return self.evaluate(data, seed)
        model = copy.deepcopy(self.model)
        model.load_state_dict(self.best_state)
        return self.evaluate(data, seed, model)

    # -- checkpoints --------------------------------------------------------

    def _payload(self) -> Dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "schedule": self.schedule.state_dict(),
            "step": self.step,
            "epoch": self.epoch,
            "best_metric": self.best_metric,
            "stale_epochs": self.stale_epochs,
        }

    def _resume(self) -> None:
        restored = self.store.restore()
        if restored is None:
            return
        self.model.load_state_dict(restored["model"])
        self.optimizer.load_state_dict(restored["optimizer"])
        self.schedule.load_state_dict(restored["schedule"])
        self.step, self.epoch = int(restored["step"]), int(restored["epoch"])
        self.best_metric = float(restored["best_metric"])
        self.stale_epochs = int(restored["stale_epochs"])
        # the best snapshot too: a resumed run that never beats the restored
        # best_metric would otherwise have no best parameters to evaluate
        best = self.store.restore_best()
        if best is not None:
            self.best_state = best["model"]
        logger.info("resumed from epoch %d%s", self.epoch,
                    "" if best is None else " (best snapshot reloaded)")
