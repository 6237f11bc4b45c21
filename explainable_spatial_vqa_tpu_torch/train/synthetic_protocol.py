"""Train and evaluate the thesis pair on the synthetic corpora, ported from
``explainable_spatial_vqa_tpu/train/synthetic_protocol.py``.

The CoGenT four-cell protocol (thesis §4.2.2, Table 4.6) and the scheduled
sampling demos share these building blocks: the generator's teacher-forced
training, the executor's set-loss training (optionally warm-started for
fine-tuning), and the full generate -> parse -> chained-execute -> tally
evaluation.  They run the port's production components
(:class:`ProgramGenerator`, :class:`ProgramExecutor`, ``executor_set_loss``
with the device matcher (``matcher="auto"``), :class:`ExecutorChainRunner`,
:class:`InferencePipeline`); only the corpus is synthetic.

As in the JAX package: the models are float32; each trainer draws its
batches with ``np.random.RandomState(seed).choice(n, take, replace=False)``;
the optimizer is Adam (β = (0.9, 0.999), eps 1e-8) behind global-norm
clipping at 1.0, at a constant rate or optax's ``warmup_cosine_decay``
(:func:`warmup_cosine_lr`).  A trainer returns ``(model, config, loss)``:
the model holds its weights, and ``loss`` is the last step's.  Each takes
``device`` (the card by default); the features and step arrays move to it
once, and every batch is gathered there.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import logging
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.artifacts import encode_questions
from explainable_spatial_vqa_tpu_torch.core.config import (
    ExecutorConfig,
    GeneratorConfig,
    OptimConfig,
)
from explainable_spatial_vqa_tpu_torch.core.vocab import canonicalize, invert_vocab
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.evalsuite.accuracy import answer_accuracy_by_type
from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
from explainable_spatial_vqa_tpu_torch.infer.pipeline import InferencePipeline
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
from explainable_spatial_vqa_tpu_torch.train import datasets as ds
from explainable_spatial_vqa_tpu_torch.train.losses import (
    cross_entropy,
    executor_set_loss,
    perturb_input_boxes,
)
from explainable_spatial_vqa_tpu_torch.train.pipelines import _init_executor
from explainable_spatial_vqa_tpu_torch.train.trainer import (
    build_optimizer,
    clip_by_global_norm_,
    epoch_seed,
)

logger = logging.getLogger(__name__)

__all__ = [
    "default_executor_lr",
    "make_protocol_executor_config",
    "train_generator_synthetic",
    "train_executor_synthetic",
    "train_executor_scheduled_synthetic",
    "evaluate_pipeline_synthetic",
    "warmup_cosine_lr",
]

Device = Union[str, torch.device]
# a model to fine-tune, or its state_dict
InitVariables = Optional[Union[nn.Module, Dict[str, torch.Tensor]]]


def make_protocol_executor_config(
    vocabs: Dict,
    *,
    d_model: int = 96,
    encoder_layers: int = 2,
    noise: float = 0.0,
    drop: float = 0.0,
    sinkhorn_tau: float = 1.0,
    sinkhorn_iters: int = 20,
    box_roi: bool = False,
    roi_sim: bool = False,
    roi_sim_heads: int = 1,
    count_embed: bool = False,
) -> ExecutorConfig:
    """The synthetic protocol's ExecutorConfig: 4 heads, 1 box-decoder
    layer, 8 queries, 196 image tokens of 64 channels and 8 input-box slots
    are fixed; the vocabulary sizes come from the split vocab."""
    return ExecutorConfig(
        vocab_size=len(vocabs["function"]) + 1,
        d_model=d_model, num_heads=4, encoder_layers=encoder_layers,
        box_decoder_layers=1, num_queries=8, num_image_tokens=196,
        image_feature_dim=64, max_input_boxes=8,
        token_classes=len(vocabs["other"]) + 1, dropout=0.0,
        input_box_noise=noise, input_box_drop=drop,
        sinkhorn_tau=sinkhorn_tau, sinkhorn_iters=sinkhorn_iters,
        box_roi=box_roi, roi_sim=roi_sim, roi_sim_heads=roi_sim_heads,
        count_embed=count_embed,
    )


def default_executor_lr(d_model: int) -> float:
    """Width-scaled Adam peak lr for the post-LN executor:
    ``1e-3 * (96/d)^1.5``, at most 1e-3 (96 -> 1e-3, 192 -> 3.5e-4).  Used
    whenever the caller passes no lr."""
    return min(1e-3, 1e-3 * (96.0 / float(d_model)) ** 1.5)


@functools.lru_cache(maxsize=1)
def _cosf() -> Callable[[float], float]:
    """The C library's single-precision ``cosf``, the cosine XLA's CPU
    backend evaluates, so that :func:`warmup_cosine_lr` equals optax's
    schedule to the bit."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def warmup_cosine_lr(step: int, peak: float, steps: int) -> float:
    """optax's ``warmup_cosine_decay_schedule(init_value=0, peak_value=peak,
    warmup_steps=max(1, steps // 20), decay_steps=steps,
    end_value=0.05 * peak)`` at ``step``, in float32 with optax's operation
    order: a linear warmup from 0, then a cosine decay to 5% of the peak
    over ``steps - warmup`` steps, held after.  Like optax, it raises when
    the decay has no step (``steps == 1``)."""
    f32 = np.float32
    warmup = max(1, steps // 20)
    decay = steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs steps > warmup ({warmup}); got {steps}")
    if step < warmup:
        frac = f32(1.0) - f32(min(max(step, 0), warmup)) / f32(warmup)
        return float(f32(-peak) * frac + f32(peak))
    alpha = (0.05 * peak) / peak
    count = min(f32(step - warmup), f32(decay))
    cosine = f32(0.5) * (f32(1.0) + f32(_cosf()(float(f32(math.pi) * count / f32(decay)))))
    return float(f32(peak) * (f32(1.0 - alpha) * cosine + f32(alpha)))


def _make_optimizer(params: List[nn.Parameter], learning_rate: float, lr_schedule: str,
                    steps: int, grad_clip: float = 1.0) -> Callable[[int], None]:
    """``update(step)``: clip the gradients by their global norm at
    ``grad_clip`` (optax's rule, :func:`clip_by_global_norm_`), set the
    step's learning rate and take one Adam step (the trainer's fused Adam,
    which keeps the modules' cached inference weights current).

    ``"constant"`` keeps ``learning_rate``; ``"cosine"`` follows
    :func:`warmup_cosine_lr`.  ``steps <= 0`` (a resume with nothing to
    run) keeps the rate constant."""
    if lr_schedule == "constant" or steps <= 0:
        def schedule(step: int) -> float:
            return learning_rate
    elif lr_schedule == "cosine":
        warmup_cosine_lr(0, learning_rate, steps)  # raise now if the schedule is empty

        def schedule(step: int) -> float:
            return warmup_cosine_lr(step, learning_rate, steps)
    else:
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    optimizer, _ = build_optimizer(params, OptimConfig(learning_rate=learning_rate))

    def update(step: int) -> None:
        if grad_clip:
            clip_by_global_norm_(params, grad_clip)
        for group in optimizer.param_groups:
            group["lr"] = schedule(step)
        optimizer.step()

    return update


def _warm_start(model: nn.Module, init_variables: InitVariables) -> nn.Module:
    """Load ``init_variables`` (a model or a state_dict) into ``model``; the
    caller's model is left as it is."""
    state = (init_variables.state_dict() if isinstance(init_variables, nn.Module)
             else init_variables)
    model.load_state_dict(state)
    return model


def _on(device: torch.device, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in arrays.items()}


def train_generator_synthetic(
    questions: List[dict],
    vocab: Dict,
    steps: int = 400,
    batch_size: int = 64,
    learning_rate: float = 2e-3,
    seed: int = 0,
    config: Optional[GeneratorConfig] = None,
    init_variables: InitVariables = None,
    lr_schedule: str = "constant",
    device: Device = "cuda",
) -> Tuple[ProgramGenerator, GeneratorConfig, float]:
    """Teacher-forced generator training on encoded synthetic questions
    (deterministic, teacher forcing 1.0).  Pass ``config`` and
    ``init_variables`` to fine-tune an existing model (CoGenT phase 2)
    instead of training from scratch."""
    device = resolve_device(device)
    enc = encode_questions(questions, vocab)
    q, p = enc.questions, enc.programs
    cfg = config or GeneratorConfig(
        vocab_size=int(q.max()) + 1, program_vocab_size=int(p.max()) + 1,
        embed_dim=64, hidden_dim=128, encoder_layers=1, decoder_layers=1,
        dropout=0.0, program_len=p.shape[1],
    )
    model = ProgramGenerator(cfg, torch.float32, device)
    if init_variables is None:
        init_parameters(model, seed)
    else:
        _warm_start(model, init_variables)
    model.eval()  # deterministic: no dropout, every coin teacher-forced
    params = list(model.parameters())
    update = _make_optimizer(params, learning_rate, lr_schedule, steps)
    data = _on(device, {"questions": q, "programs": p})
    rng = np.random.RandomState(seed)
    loss = torch.zeros(())
    take = min(batch_size, len(q))
    for it in range(steps):
        idx = torch.as_tensor(rng.choice(len(q), take, replace=False), device=device)
        qb, pb = data["questions"][idx], data["programs"][idx]
        out = model(qb, pb, teacher_forcing=1.0)
        loss = cross_entropy(out["logits"], pb)
        for prm in params:
            prm.grad = None
        loss.backward()
        update(it)
    return model, cfg, float(loss.detach())


def train_executor_synthetic(
    annotated: List[dict],
    vocabs: Dict,
    features,
    steps: int = 500,
    batch_size: int = 64,
    learning_rate: Optional[float] = None,
    seed: int = 0,
    noise: Optional[float] = None,
    drop: Optional[float] = None,
    sinkhorn_tau: Optional[float] = None,
    sinkhorn_iters: Optional[int] = None,
    config: Optional[ExecutorConfig] = None,
    init_variables: InitVariables = None,
    log_every: int = 100,
    lr_schedule: str = "constant",
    box_roi: Optional[bool] = None,
    roi_sim: Optional[bool] = None,
    roi_sim_heads: Optional[int] = None,
    count_embed: Optional[bool] = None,
    device: Device = "cuda",
) -> Tuple[ProgramExecutor, ExecutorConfig, float]:
    """Thesis-executor set-loss training over flattened annotation steps;
    ``features`` is the (M, 196, 64) image cache indexed by image index,
    numpy or a tensor.

    Pass ``config`` and ``init_variables`` to fine-tune (CoGenT phase 2).
    ``noise``/``drop``/``sinkhorn_*``/``box_roi``/... left as ``None`` mean
    the config's value (or the protocol default when no config is given); an
    explicit value that contradicts a given config raises ``ValueError``.
    The grounding noise, when on, draws from a generator seeded from 123
    and the step."""
    device = resolve_device(device)
    if config is None:
        cfg = make_protocol_executor_config(
            vocabs,
            noise=0.0 if noise is None else noise,
            drop=0.0 if drop is None else drop,
            sinkhorn_tau=1.0 if sinkhorn_tau is None else sinkhorn_tau,
            sinkhorn_iters=20 if sinkhorn_iters is None else sinkhorn_iters,
            box_roi=bool(box_roi),
            roi_sim=bool(roi_sim),
            roi_sim_heads=1 if roi_sim_heads is None else roi_sim_heads,
            count_embed=bool(count_embed),
        )
    else:
        cfg = config
        for name, attr, val in (
            ("noise", "input_box_noise", noise),
            ("drop", "input_box_drop", drop),
            ("sinkhorn_tau", "sinkhorn_tau", sinkhorn_tau),
            ("sinkhorn_iters", "sinkhorn_iters", sinkhorn_iters),
            ("box_roi", "box_roi", box_roi),
            ("roi_sim", "roi_sim", roi_sim),
            ("roi_sim_heads", "roi_sim_heads", roi_sim_heads),
            ("count_embed", "count_embed", count_embed),
        ):
            if val is not None and getattr(cfg, attr) != val:
                raise ValueError(
                    f"{name}={val!r} conflicts with config.{attr}="
                    f"{getattr(cfg, attr)!r}; pass one or make them agree")
    arrays = ds.executor_step_arrays(
        annotated, vocabs["function"], vocabs["other"],
        max_input_boxes=cfg.max_input_boxes, max_output_boxes=cfg.num_queries,
    )
    if learning_rate is None:
        learning_rate = default_executor_lr(cfg.d_model)
    model = ProgramExecutor(cfg, torch.float32, device)
    if init_variables is None:
        _init_executor(model, seed)
    else:
        _warm_start(model, init_variables)
    model.train()  # dropout is 0; the plain path, which has a backward
    params = list(model.parameters())
    update = _make_optimizer(params, learning_rate, lr_schedule, steps)
    data = _on(device, arrays)
    images = torch.as_tensor(features, device=device)
    perturb = cfg.input_box_noise > 0.0 or cfg.input_box_drop > 0.0
    rng = np.random.RandomState(seed)
    n = len(arrays["text"])
    loss = torch.zeros(())
    take = min(batch_size, n)
    for it in range(steps):
        idx = torch.as_tensor(rng.choice(n, take, replace=False), device=device)
        b = {k: v[idx] for k, v in data.items()}
        boxes, bmask = b["input_boxes"], b["input_box_mask"]
        if perturb:
            gen = torch.Generator(device).manual_seed(epoch_seed(123, it, 0))
            boxes, bmask = perturb_input_boxes(boxes, bmask, gen, cfg.input_box_noise,
                                               cfg.input_box_drop)
        out = model(images[b["image_index"]], boxes, bmask, b["text"], b["text_mask"])
        loss = executor_set_loss(out, b["target_boxes"], b["target_box_mask"],
                                 b["token_target"], b["is_box_branch"], cfg)["loss"]
        for prm in params:
            prm.grad = None
        loss.backward()
        update(it)
        if log_every and (it + 1) % log_every == 0:
            logger.info("executor step %d/%d loss %.4f", it + 1, steps, float(loss.detach()))
    return model, cfg, float(loss.detach())


def train_executor_scheduled_synthetic(
    annotated: List[dict],
    vocabs: Dict,
    features,
    steps: int = 500,
    batch_size: int = 64,
    learning_rate: Optional[float] = None,
    seed: int = 0,
    p_max: float = 0.5,
    ramp_fraction: float = 0.5,
    max_steps: int = 12,
    config: Optional[ExecutorConfig] = None,
    init_variables: InitVariables = None,
    log_every: int = 100,
    lr_schedule: str = "constant",
    device: Device = "cuda",
) -> Tuple[ProgramExecutor, ExecutorConfig, float]:
    """Executor training with chain-level scheduled sampling
    (``train.scheduled``): the protocol of :func:`train_executor_synthetic`,
    but batches are whole questions and dependency inputs are a p-mixture of
    ground truth and the model's own chained predictions; ``p`` ramps
    0 -> ``p_max`` over the first ``ramp_fraction`` of steps.  The mixture
    draws come from a generator seeded from ``seed + 77`` and the step."""
    from explainable_spatial_vqa_tpu_torch.train.scheduled import make_scheduled_loss_fn

    device = resolve_device(device)
    cfg = config or dataclasses.replace(
        make_protocol_executor_config(vocabs, d_model=96, encoder_layers=2),
        scheduled_p_max=p_max)
    arrays = ds.executor_chain_step_arrays(
        annotated, vocabs["function"], vocabs["other"],
        max_steps=max_steps, max_output_boxes=cfg.num_queries,
    )
    model = ProgramExecutor(cfg, torch.float32, device)
    if init_variables is None:
        _init_executor(model, seed)
    else:
        _warm_start(model, init_variables)
    model.train()
    params = list(model.parameters())
    if learning_rate is None:
        learning_rate = default_executor_lr(cfg.d_model)
    update = _make_optimizer(params, learning_rate, lr_schedule, steps)
    loss_fn = make_scheduled_loss_fn(cfg)
    data = _on(device, arrays)
    images = torch.as_tensor(features, device=device)
    rng = np.random.RandomState(seed)
    n = len(arrays["image_index"])
    take = min(batch_size, n)
    ramp_steps = max(1, int(steps * ramp_fraction))
    loss = torch.zeros(())
    for it in range(steps):
        idx = torch.as_tensor(rng.choice(n, take, replace=False), device=device)
        batch = {k: v[idx] for k, v in data.items() if k != "image_index"}
        batch["image"] = images[data["image_index"][idx]]
        batch["p_sample"] = p_max * min(1.0, (it + 1) / ramp_steps)
        gen = torch.Generator(device).manual_seed(epoch_seed(seed + 77, it, 0))
        loss, _ = loss_fn(model, batch, gen, True)
        for prm in params:
            prm.grad = None
        loss.backward()
        update(it)
        if log_every and (it + 1) % log_every == 0:
            logger.info("scheduled executor step %d/%d loss %.4f", it + 1, steps,
                        float(loss.detach()))
    return model, cfg, float(loss.detach())


def evaluate_pipeline_synthetic(
    generator: ProgramGenerator,
    executor: ProgramExecutor,
    exe_cfg: ExecutorConfig,
    eval_questions: List[dict],
    features,
    clevr_vocab: Dict,
    split_vocab: Dict,
    max_steps: int = 12,
    device: Device = "cuda",
):
    """The full generate -> parse -> chained-execute -> answer pass
    (``InferencePipeline.run``, chain mode ``"sorted"``) over
    ``eval_questions``; ``features`` is the per-image cache, numpy or a
    tensor.  Returns (FaithfulnessTally, accuracy-by-type dict)."""
    device = resolve_device(device)
    enc_eval = encode_questions(eval_questions, clevr_vocab)
    program_inv = invert_vocab(clevr_vocab["program_token_to_idx"])
    answer_inv = invert_vocab(clevr_vocab["answer_token_to_idx"])
    runner = ExecutorChainRunner(executor, exe_cfg, max_steps=max_steps, device=device)
    pipeline = InferencePipeline(generator, runner, program_inv, split_vocab["function"],
                                 device=device)
    gt_value_ids = np.asarray([
        split_vocab["other"].get(canonicalize(answer_inv.get(int(a), "")), -2)
        for a in enc_eval.answers
    ])
    result = pipeline.run(
        enc_eval.questions, torch.as_tensor(features, device=device), enc_eval.image_idxs,
        gt_answers=gt_value_ids, gt_programs=enc_eval.programs,
    )
    final_functions = [q["program"][-1]["function"] for q in eval_questions]
    pred = np.where(result.answer_valid, result.answers, -1)
    acc = answer_accuracy_by_type(pred, gt_value_ids, final_functions)
    return result.tally, acc
