"""Tensor-parallel rules for model-parallel layouts, ported from
``explainable_spatial_vqa_tpu/parallel/sharding.py``.

The thesis-scale models fit replicated, so pure data parallelism is the
production layout; this is the tensor-parallel option.  Regex rules over the
port's module names pick a Megatron style per module, applied with
``torch.distributed.tensor.parallel.parallelize_module`` over the mesh's
``model`` axis: the first projection of a pair column-split (outputs split,
activations stay split between the pair), the second row-split (inputs split,
one all-reduce on exit).  The attention's q/k/v projections give each rank
whole heads, as JAX's ``P(None, "model", None)`` splits the head axis of
its (d, H, D) kernels; the text embedding's rows (the vocabulary) split.  A
module whose split does not divide (heads, FFN width, vocabulary) stays
replicated, as JAX replicates such a leaf.

A split module's parameters are DTensors: the models then keep it off K1 and
K2, which take whole local weights (``models.layers.has_sharded_params``).
"""

from __future__ import annotations

import re
from typing import Sequence, Tuple

from torch import nn

from explainable_spatial_vqa_tpu_torch.parallel.mesh import Mesh

__all__ = ["shard_params_by_rules", "EXECUTOR_TP_RULES", "param_path_strings"]

# (module-name regex, style): "colwise" and "rowwise" for nn.Linear,
# "embedding" (rows split) for nn.Embedding
EXECUTOR_TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r".*ffn\.fc1$", "colwise"),
    (r".*ffn\.fc2$", "rowwise"),
    (r".*attn\.(q|k|v)$", "colwise"),
    (r".*attn\.out$", "rowwise"),
    (r".*text_embed$", "embedding"),
)


def param_path_strings(model: nn.Module) -> Sequence[str]:
    return [name for name, _ in model.named_parameters()]


def _parent(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rpartition(".")[0])


def _divides(model: nn.Module, name: str, module: nn.Module, style: str, size: int) -> bool:
    """Whether ``module`` splits evenly into ``size`` parts under ``style``:
    whole heads for an attention projection, whole rows or columns else."""
    if style == "embedding":
        return isinstance(module, nn.Embedding) and module.num_embeddings % size == 0
    if not isinstance(module, nn.Linear):
        return False
    parent = _parent(model, name)
    if hasattr(parent, "num_heads"):  # q/k/v/out of a MultiHeadAttention
        return parent.num_heads % size == 0
    width = module.out_features if style == "colwise" else module.in_features
    return width % size == 0


def shard_params_by_rules(model: nn.Module, mesh: Mesh,
                          rules: Sequence[Tuple[str, str]] = EXECUTOR_TP_RULES,
                          axis: str = "model") -> nn.Module:
    """Split the modules whose names match a rule (the first that matches)
    over ``axis`` of ``mesh``, in place; the rest stay replicated.  Returns
    ``model``."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    size = mesh.shape[axis]
    if size == 1:
        return model
    styles = {"colwise": ColwiseParallel, "rowwise": RowwiseParallel,
              "embedding": lambda: RowwiseParallel(input_layouts=Replicate())}
    compiled = [(re.compile(pattern), style) for pattern, style in rules]
    plan = {}
    for name, module in model.named_modules():
        for pattern, style in compiled:
            if pattern.match(name):
                if _divides(model, name, module, style, size):
                    plan[name] = styles[style]()
                break
    device_mesh = mesh[axis]
    for name, style in plan.items():
        parallelize_module(model.get_submodule(name), device_mesh, style)
    return model
