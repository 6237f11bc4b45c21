"""The trainer, ported from ``explainable_spatial_vqa_tpu/train/trainer.py``.

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
- Data parallel over the ``data`` axis of a mesh (``parallel.mesh``; by
  default ``TrainConfig.mesh_shape``/``mesh_axes`` over the process group
  when one is initialised), one process per card, as JAX's trainer shards
  its global batch over a mesh: the parameters and buffers are broadcast
  from the axis's first rank at construction; each rank takes its own rows
  of every global batch (the pipelines' ``batches`` do the slicing); the
  losses divide by the global batch's counts (``parallel.mesh.
  global_normaliser``) and the gradients are averaged by one all-reduce, so
  a step equals one process's step on the whole batch up to the order of
  sums; the count-style metrics are summed over the ranks before they are
  read; only the process group's rank 0 writes checkpoints.  Each rank
  draws its own dropout and sampling streams (rank 0 draws the
  single-process ones).  On a one-rank mesh every step is the
  single-process step.
"""

from __future__ import annotations

import copy
import logging
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import OptimConfig, TrainConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.parallel.mesh import (
    Mesh,
    collective_device,
    data_parallel,
    make_mesh,
    replicated,
)
from explainable_spatial_vqa_tpu_torch.train.checkpoints import CheckpointStore
from explainable_spatial_vqa_tpu_torch.train.metrics import MetricAccumulator
from explainable_spatial_vqa_tpu_torch.train.prefetch import prefetch

logger = logging.getLogger(__name__)

__all__ = ["Trainer", "build_optimizer", "clip_by_global_norm_", "epoch_seed"]

# loss_fn(model, batch, generator, train) -> (loss, count-style metrics)
LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], torch.Generator, bool],
                  Tuple[torch.Tensor, Dict[str, Any]]]

_DROPOUT, _SAMPLE, _EVAL = range(3)  # the per-epoch random streams


def epoch_seed(seed: int, epoch: int, stream: int, rank: int = 0) -> int:
    """A 63-bit seed for one random stream of one epoch (of one data-parallel
    rank; rank 0's are the single-process streams)."""
    entropy = [seed, epoch, stream] + ([rank] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
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
    on the device.  ``checkpoint_dir=False`` keeps no checkpoints.

    ``mesh``: data parallel over its ``data`` axis (module docstring); by
    default the training config's mesh over the process group when one is
    initialised, else none.  A mesh with another axis larger than 1 is
    refused: the trainer replicates the parameters and splits rows only."""

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
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(train_config.mesh_shape, train_config.mesh_axes)
        if mesh is not None and mesh.shape.get("data", 1) != mesh.size:
            raise ValueError(f"the trainer splits batches over a mesh's data axis only: {mesh}")
        self.mesh = mesh
        self.rank = 0 if mesh is None else mesh.rank("data")
        self._group = None if mesh is None else mesh.group("data")
        if mesh is not None:
            replicated(self.model, mesh)
        # only the process group's rank 0 writes checkpoints; every rank reads
        self._writes = not dist.is_initialized() or dist.get_rank() == 0
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

    @property
    def data_parallel(self) -> bool:
        """More than one rank on the mesh's data axis."""
        return self._group is not None and dist.get_world_size(self._group) > 1

    def train_step(self, batch: Dict[str, Any], generator: torch.Generator) -> Dict[str, Any]:
        """One update on a batch already on the device (this rank's rows
        under data parallel); returns its metrics (tensors, not read) with
        ``loss_sum`` and ``batches``."""
        self.model.train()
        with data_parallel(self.mesh):
            loss, metrics = self.loss_fn(self.model, batch, generator, True)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.data_parallel:
            self.average_gradients()
        self.apply_gradients()
        return {**metrics, "loss_sum": loss.detach(), "batches": 1}

    def average_gradients(self) -> None:
        """Replace every gradient by its mean over the data axis's ranks: one
        all-reduce of the gradients flattened into one buffer.  Each rank's
        loss is its share of the global batch's (``global_normaliser``), so
        the mean is the global batch's gradient."""
        grads = [p.grad for p in self.params if p.grad is not None]
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=self._group)
        flat /= dist.get_world_size(self._group)
        for g, mean in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(mean)

    def eval_step(self, model: nn.Module, batch: Dict[str, Any],
                  generator: torch.Generator) -> Dict[str, Any]:
        model.eval()
        with torch.no_grad(), data_parallel(self.mesh):
            loss, metrics = self.eval_loss_fn(model, batch, generator, False)
        return {**metrics, "loss_sum": loss, "batches": 1}

    def _reduced(self, acc: MetricAccumulator) -> MetricAccumulator:
        """Under data parallel, ``acc``'s totals summed over the ranks, the
        loss (each rank's share of the global loss) and batch count averaged,
        as one process on the global batches counts them."""
        if self.data_parallel:
            acc.sum_over(self._group, collective_device(self._group),
                         means=("loss_sum", "batches"))
        return acc

    # -- loops --------------------------------------------------------------

    def train_epoch(self, data: Iterable[Dict[str, np.ndarray]], seed: int, epoch: int
                    ) -> MetricAccumulator:
        acc = MetricAccumulator()
        devices = []
        if self.device.type == "cuda":
            devices = [torch.cuda.current_device() if self.device.index is None
                       else self.device.index]
        generator = torch.Generator().manual_seed(epoch_seed(seed, epoch, _SAMPLE, self.rank))
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(epoch_seed(seed, epoch, _DROPOUT, self.rank))
            for i, batch in enumerate(prefetch(data, self.device)):
                acc.update(self.train_step(batch, generator))
                if self.train_config.log_every and (i + 1) % self.train_config.log_every == 0:
                    logger.info("step %d loss %.4f", i + 1, acc.mean("loss_sum"))
        return self._reduced(acc)

    def evaluate(self, data: Iterable[Dict[str, np.ndarray]], seed: int = 0,
                 model: Optional[nn.Module] = None) -> MetricAccumulator:
        model = self.model if model is None else model
        generator = torch.Generator().manual_seed(seed)
        acc = MetricAccumulator()
        for batch in prefetch(data, self.device):
            acc.update(self.eval_step(model, batch, generator))
        return self._reduced(acc)

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
                    if self.store is not None and self._writes:
                        self.store.save_best({"model": self.best_state})
                else:
                    self.stale_epochs += 1

            if self.store is not None and self._writes and (
                    (epoch + 1) % cfg.checkpoint_interval == 0 or epoch + 1 == num_epochs):
                self.store.save(epoch + 1, self._payload())
            if val_batches is not None and self.stale_epochs >= cfg.patience:
                logger.info("early stopping at epoch %d", epoch)
                break

        if self.store is not None and self._writes:
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
