"""Weight bridge: Flax parameter trees -> the port's ``state_dict``.

:func:`flax_to_state_dict` takes the ``"params"`` collection of a JAX
``ProgramGenerator``, ``ProgramExecutor``, ``TransformerIQAP``, ``LstmIQAP``,
``StepExecutorSeq2Seq``, a prototype of ``models/prototypes.py`` or any of
their blocks, as nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, variables["params"])``),
and returns the float32 ``state_dict`` of the port's module of the same
configuration.  It needs no JAX: the caller passes numpy.

=========================================  ==================================  ============================================
Flax (linen) parameter                     PyTorch port parameter              conversion
=========================================  ==================================  ============================================
``Dense`` kernel (in, out), bias (out,)    ``Dense.weight`` (out, in), bias    transpose the kernel
``DenseGeneral`` q/k/v kernel (d, H, Dh),  ``attn.{q,k,v}.weight`` (d, d),     reshape to (d, H*Dh), transpose; bias
bias (H, Dh)                               bias (d,)                           flattened head-major (h*Dh + j)
``DenseGeneral`` out kernel (H, Dh, d),    ``attn.out.weight`` (d, d),         reshape to (H*Dh, d), transpose
bias (d,)                                  bias (d,)
``Embed`` embedding (V, E)                 ``nn.Embedding.weight`` (V, E)      as is
``LayerNorm`` scale, bias (d,)             ``LayerNorm.weight``, ``.bias``     as is; the port's LayerNorm uses eps 1e-6
                                                                               (Flax's), not PyTorch's 1e-5
``OptimizedLSTMCell`` ii/if/ig/io kernel   ``LSTMCell.weight_ih`` (4h, in)     concatenate along out in gate order
(in, h), no bias                                                               i, f, g, o, then transpose
``OptimizedLSTMCell`` hi/hf/hg/ho kernel   ``LSTMCell.weight_hh`` (4h, h),     the same; the carry stays Flax's (c, h)
(h, h), bias (h,)                          ``LSTMCell.bias`` (4h,)
``cls`` (1, 1, d), ``text_pos`` (3, d),    parameters of the same name,        as is
``queries`` (Q, d)                         shape and place
module names ``block_{i}``, ``cell_{i}``,  ``blocks.{i}``, ``cells.{i}``,      renamed
``Dense_0``, ``Dense_1`` (in ``ffn``)      ``fc1``, ``fc2``
``sim_roi_proj``, ``sim_img_proj``         ``Dense`` of the same name (d, d)   a ``Dense``: transpose the kernel
kernels (d, d) (``roi_sim``)
``sim_embed`` kernel (S*K, d), bias (d,)   ``sim_embed.weight`` (d, S*K)       a ``Dense``; its inputs stay slot-major,
(``roi_sim``, S box slots, K heads)                                            index s*K + h
``count_embed`` embedding (S+1, d)         ``count_embed.weight`` (S+1, d)     an ``Embed``: as is
(``count_embed``)
the baselines' modules: ``image_proj``,    the same names (``encoder.blocks.   as above by kind: ``Dense``, ``Embed``,
``embed``, ``cls`` (1, 1, d),              {i}``, ``prog_decoder.blocks.{i}``, ``LayerNorm``, ``DenseGeneral``; ``cls``
``encoder``/``decoder``/``prog_decoder``   ``decoder.blocks.{i}``)             as is
``block_{i}`` (``attn``; ``self_attn``,
``cross_attn``, ``ffn``, ``norm1-3``),
``answer_hidden``/``answer_out``,
``prog_embed``/``prog_out``,
``bbox_hidden``/``bbox_out``, ``output``
``q_lstm``, ``dec_lstm``                   ``LSTMCell`` of the same name       an ``OptimizedLSTMCell``, as above
(``OptimizedLSTMCell``)
``image_fc`` kernel (C*H*W, h)             ``image_fc.weight`` (h, C*H*W)      a ``Dense``; its inputs are the (C, H, W)
                                                                               grid flattened C-major, as in JAX
``dec_init_fc``, ``prog_fc``,              ``Dense`` of the same name          a ``Dense``: transpose the kernel
``answer_fc``
the prototypes' ``Dense``s (``img_fc``,    the same names                      a ``Dense``: transpose the kernel
``func_fc``, ``bbox_fc1/2``, ``head_*``,
``branch_head``, ``bbox_*``, ``token_*``,
``box_fc1/2``, ``fc_shared``, ``box_out``,
``stop_out``, ``input_proj``, ``*_head``,
``type_head``, ``bbox_embedding``,
``nonspatial_out``, ``fusion_fc``, ...)
the prototypes' ``Embed``s (``func_emb``,  ``nn.Embedding.weight``             as is
``embedding``, ``question_emb``,
``prog_emb``)
``text_encoder``, ``dec_cell``             ``LSTMCell`` of the same name       an ``OptimizedLSTMCell``, as above
(``OptimizedLSTMCell``)
``start_token`` (h,), ``start_query`` (d,) parameters of the same name         as is
``HierarchicalGenerator``'s ``encoder``,   ``encoder.blocks.{i}``,             as the baselines' blocks
``decoder`` ``block_{i}``                  ``decoder.blocks.{i}``
``Conv_{i}`` kernel (kh, kw, in, out),     ``convs.{i}.weight`` (out, in, kh,  HWIO -> OIHW
bias (out,) (``YoloDetector``)             kw), bias
``YoloDetector``'s ``Dense_0``,            ``fc1``, ``fc2``                    renamed; ``fc1``'s inputs are the
``Dense_1``                                                                    (H, W, C) grid flattened, as in JAX
=========================================  ==================================  ============================================

:func:`resnet_state_from_jax` takes the variables of the JAX package's
``ResNetFeatures`` and returns the torchvision-named state dict of the
port's (``vision/resnet.py``):

=========================================  ==================================  ============================================
Flax (linen) parameter                     PyTorch port parameter or buffer    conversion
=========================================  ==================================  ============================================
a ``Conv`` kernel (kh, kw, in, out):      ``.weight`` (out, in, kh, kw)       HWIO -> OIHW
``conv1``, ``layer{s}_block{b}``'s         of ``conv1``, ``layer{s}.{b}``'s
``conv1``-``conv3``                        ``conv1``-``conv3``
``downsample_conv``, ``downsample_bn``     ``downsample.0``, ``downsample.1``  renamed
``FrozenBatchNorm`` ``scale``, ``bias``,   ``weight``, ``bias``,               as is
``mean``, ``var``                          ``running_mean``, ``running_var``
=========================================  ==================================  ============================================
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "resnet_state_from_jax"]

_LSTM_GATES = ("i", "f", "g", "o")


def _rename(name: str) -> str:
    match = re.fullmatch(r"(block|cell|Conv)_(\d+)", name)
    if match:
        return f"{match.group(1).lower()}s.{match.group(2)}"
    return {"Dense_0": "fc1", "Dense_1": "fc2"}.get(name, name)


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable float32 copy


def _dense(node: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    kernel = np.asarray(node["kernel"])
    bias = np.asarray(node["bias"]) if "bias" in node else None
    if kernel.ndim == 4:  # a convolution: (kh, kw, in, out) -> (out, in, kh, kw)
        out = {"weight": kernel.transpose(3, 2, 0, 1)}
        if bias is not None:
            out["bias"] = bias
        return out
    if kernel.ndim == 3 and bias is not None and bias.ndim == 2:  # q/k/v: (d, H, Dh)
        kernel, bias = kernel.reshape(kernel.shape[0], -1), bias.reshape(-1)
    elif kernel.ndim == 3:  # out projection: (H, Dh, d)
        kernel = kernel.reshape(-1, kernel.shape[-1])
    out = {"weight": kernel.T}
    if bias is not None:
        out["bias"] = bias
    return out


def _lstm_cell(node: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {
        "weight_ih": np.concatenate([np.asarray(node["i" + g]["kernel"]) for g in _LSTM_GATES], 1).T,
        "weight_hh": np.concatenate([np.asarray(node["h" + g]["kernel"]) for g in _LSTM_GATES], 1).T,
        "bias": np.concatenate([np.asarray(node["h" + g]["bias"]) for g in _LSTM_GATES]),
    }


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a Flax ``params`` tree (nested dicts of arrays) to a state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        keys = set(node)
        if {"i" + g for g in _LSTM_GATES} | {"h" + g for g in _LSTM_GATES} <= keys:
            leaves = _lstm_cell(node)
        elif "kernel" in keys:
            leaves = _dense(node)
        elif "embedding" in keys and not isinstance(node["embedding"], Mapping):
            leaves = {"weight": node["embedding"]}
        elif "scale" in keys:
            leaves = {"weight": node["scale"], "bias": node["bias"]}
        else:
            for name, child in node.items():
                if isinstance(child, Mapping):
                    walk(child, prefix + _rename(name) + ".")
                else:
                    out[prefix + name] = _tensor(child)
            return
        for name, value in leaves.items():
            out[prefix + name] = _tensor(value)

    walk(params, "")
    return out


_RESNET_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_RESNET_NAMES = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def resnet_state_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert the variables of the JAX package's ``ResNetFeatures``, or of
    one of its ``Bottleneck`` blocks (``{"params": ...}`` or the params tree,
    arrays of any kind numpy takes), to the port's torchvision-named state
    dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, child in node.items():
            block = re.fullmatch(r"(layer\d+)_block(\d+)", name)
            key = prefix + (f"{block.group(1)}.{block.group(2)}" if block
                            else _RESNET_NAMES.get(name, name))
            if "kernel" in child:
                out[key + ".weight"] = _tensor(np.asarray(child["kernel"]).transpose(3, 2, 0, 1))
            elif "var" in child:
                for leaf, torch_name in _RESNET_BN.items():
                    out[f"{key}.{torch_name}"] = _tensor(child[leaf])
            else:
                walk(child, key + ".")

    walk(variables.get("params", variables), "")
    return out
