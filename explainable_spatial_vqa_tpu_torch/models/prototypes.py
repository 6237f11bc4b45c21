"""The executor's prototype families, ported from
``explainable_spatial_vqa_tpu/models/prototypes.py``:

- :class:`FusedStepEncoder` and :class:`TokenOnlyPredictor`,
  :class:`BBoxOnlyPredictor`, :class:`MultiTaskBBoxTokenPredictor`: the
  pooled image through ``img_fc`` (256), the function embedding through
  ``func_fc`` (32) and the flattened input boxes through ``bbox_fc1/2``
  (64), joined into 352 features, with typed heads;
- :class:`BBoxSelectionPredictor`: per-input-box "in the output set" logits
  over [global image+function features | each box's MLP features];
- :class:`MultiHeadStepModel`: a text LSTM and the flattened image grid ->
  a shared representation -> 8 typed heads, one of them an autoregressive
  LSTM box decoder with scheduled teacher forcing;
- :class:`HierarchicalGenerator`: a transformer encoder over the projected
  image tokens and a start-query decoder routing {spatial, nonspatial};
  the spatial branch emits boxes and stop flags in one causal pass;
- :class:`YoloDetector` and :func:`yolo_grid_loss`: a small conv stack from
  raw pixels to an (S, S, 5) grid;
- :class:`CompositionalStepPredictor`: mean-pooled multimodal fusion ->
  (output box, next-function logits); no preset trains it.

As everywhere in the port, parameters are float32 and the matmuls and
convolutions compute in the module's ``dtype``; the output heads compute in
float32, as their Flax ``Dense(dtype=float32)`` do.  The image features come
as (B, C, H, W) grids or (B, P, C) tokens where both are accepted; the
pooled axis follows.  All layers here are plain PyTorch (cuBLAS, cuDNN): the
JAX package runs none of them in a Pallas kernel.  The encoder of
:class:`HierarchicalGenerator` is the port's
:class:`~.layers.TransformerEncoder`, so in eval mode its blocks run on K2
at head dim 128 and their self-attention on K1 at the preset's 64; in train
mode neither runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.generator import LSTMCell
from explainable_spatial_vqa_tpu_torch.models.layers import (
    Dense,
    Device,
    TransformerDecoder,
    TransformerEncoder,
    cached_on_params,
    embed_or_nan,
)

__all__ = [
    "FusedStepEncoder",
    "TokenOnlyPredictor",
    "BBoxOnlyPredictor",
    "MultiTaskBBoxTokenPredictor",
    "BBoxSelectionPredictor",
    "MultiHeadStepModel",
    "HierarchicalGenerator",
    "CompositionalStepPredictor",
    "YoloDetector",
    "yolo_grid_loss",
]

F32 = torch.float32


def _pool(image_feat: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> mean over H, W; (B, P, C) -> mean over P."""
    return image_feat.mean(dim=(2, 3)) if image_feat.ndim == 4 else image_feat.mean(dim=1)


class FusedStepEncoder(nn.Module):
    """352-d fused (image, function, input-boxes) representation."""

    def __init__(self, function_vocab_size: int = 40, function_emb_dim: int = 32,
                 max_input_boxes: int = 18, image_feature_dim: int = 1024,
                 dtype: torch.dtype = F32, device: Device = "cuda"):
        super().__init__()
        self.dtype = dtype
        self.img_fc = Dense(image_feature_dim, 256, dtype, device)
        self.func_emb = nn.Embedding(function_vocab_size, function_emb_dim, device=device)
        self.func_fc = Dense(function_emb_dim, 32, dtype, device)
        self.bbox_fc1 = Dense(max_input_boxes * 4, 64, dtype, device)
        self.bbox_fc2 = Dense(64, 64, dtype, device)

    def forward(self, image_feat: torch.Tensor, func_token: torch.Tensor,
                input_boxes: torch.Tensor) -> torch.Tensor:
        """image_feat (B, C, H, W) or (B, P, C); func_token (B,); input_boxes
        (B, max_input_boxes, 4) -> (B, 352)."""
        x_img = self.img_fc(_pool(image_feat))
        x_func = self.func_fc(embed_or_nan(self.func_emb, func_token))
        x_box = self.bbox_fc2(torch.relu(self.bbox_fc1(input_boxes.reshape(
            input_boxes.shape[0], -1))))
        return torch.cat([x_img, x_func, x_box], dim=-1)


class _FusedPredictor(nn.Module):
    """A :class:`FusedStepEncoder` named ``encoder``, for the heads below."""

    def __init__(self, function_vocab_size: int, max_input_boxes: int, image_feature_dim: int,
                 dtype: torch.dtype, device: Device):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.encoder = FusedStepEncoder(function_vocab_size, max_input_boxes=max_input_boxes,
                                        image_feature_dim=image_feature_dim, dtype=dtype,
                                        device=device)


class TokenOnlyPredictor(_FusedPredictor):
    """Fused encoder + one token head."""

    def __init__(self, token_vocab_size: int = 29, function_vocab_size: int = 40,
                 max_input_boxes: int = 18, image_feature_dim: int = 1024,
                 dtype: torch.dtype = F32, device: Device = "cuda"):
        super().__init__(function_vocab_size, max_input_boxes, image_feature_dim, dtype, device)
        self.head_hidden = Dense(352, 64, dtype, device)
        self.head_out = Dense(64, token_vocab_size, F32, device)

    def forward(self, image_feat, func_token, input_boxes) -> torch.Tensor:
        fused = self.encoder(image_feat, func_token, input_boxes)
        return self.head_out(torch.relu(self.head_hidden(fused)))


class BBoxOnlyPredictor(_FusedPredictor):
    """Fused encoder + a box-set head: (B, max_output_boxes, 5) in [0, 1],
    the box and its confidence."""

    def __init__(self, max_output_boxes: int = 10, function_vocab_size: int = 40,
                 max_input_boxes: int = 18, image_feature_dim: int = 1024,
                 dtype: torch.dtype = F32, device: Device = "cuda"):
        super().__init__(function_vocab_size, max_input_boxes, image_feature_dim, dtype, device)
        self.max_output_boxes = max_output_boxes
        self.head_hidden = Dense(352, 256, dtype, device)
        self.head_out = Dense(256, max_output_boxes * 5, F32, device)

    def forward(self, image_feat, func_token, input_boxes) -> torch.Tensor:
        fused = self.encoder(image_feat, func_token, input_boxes)
        out = self.head_out(torch.relu(self.head_hidden(fused)))
        return torch.sigmoid(out.reshape(-1, self.max_output_boxes, 5))


class MultiTaskBBoxTokenPredictor(_FusedPredictor):
    """Routing head + box head + token head over the fused representation,
    trained with ``train.losses.executor_set_loss`` (Sinkhorn matcher)."""

    def __init__(self, max_output_boxes: int = 10, token_vocab_size: int = 29,
                 function_vocab_size: int = 40, max_input_boxes: int = 18,
                 image_feature_dim: int = 1024, dtype: torch.dtype = F32,
                 device: Device = "cuda"):
        super().__init__(function_vocab_size, max_input_boxes, image_feature_dim, dtype, device)
        self.max_output_boxes = max_output_boxes
        self.branch_head = Dense(352, 2, F32, device)
        self.bbox_hidden = Dense(352, 256, dtype, device)
        self.bbox_out = Dense(256, max_output_boxes * 5, F32, device)
        self.token_hidden = Dense(352, 64, dtype, device)
        self.token_out = Dense(64, token_vocab_size, F32, device)

    def forward(self, image_feat, func_token, input_boxes) -> Dict[str, torch.Tensor]:
        fused = self.encoder(image_feat, func_token, input_boxes)
        raw = self.bbox_out(torch.relu(self.bbox_hidden(fused)))
        boxes = torch.sigmoid(raw.reshape(-1, self.max_output_boxes, 5))
        return {
            "routing_logits": self.branch_head(fused),
            "pred_boxes": boxes[..., :4],
            "pred_conf": boxes[..., 4],
            "token_logits": self.token_out(torch.relu(self.token_hidden(fused))),
        }


class BBoxSelectionPredictor(nn.Module):
    """Per-input-box selection logits (B, S)."""

    def __init__(self, function_vocab_size: int = 40, function_emb_dim: int = 32,
                 max_input_boxes: int = 18, image_feature_dim: int = 1024,
                 dtype: torch.dtype = F32, device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.img_fc = Dense(image_feature_dim, 128, dtype, device)
        self.func_emb = nn.Embedding(function_vocab_size, function_emb_dim, device=device)
        self.func_fc = Dense(function_emb_dim, 32, dtype, device)
        self.box_fc1 = Dense(4, 16, dtype, device)
        self.box_fc2 = Dense(16, 16, dtype, device)
        self.head_hidden = Dense(176, 64, dtype, device)
        self.head_out = Dense(64, 1, F32, device)

    def forward(self, image_feat, func_token, input_boxes) -> torch.Tensor:
        x_img = self.img_fc(_pool(image_feat))
        x_func = self.func_fc(embed_or_nan(self.func_emb, func_token))
        global_feat = torch.cat([x_img, x_func], dim=-1)  # (B, 160)
        box = self.box_fc2(torch.relu(self.box_fc1(input_boxes)))  # (B, S, 16)
        expanded = global_feat[:, None, :].expand(box.shape[0], box.shape[1], -1)
        h = torch.relu(self.head_hidden(torch.cat([expanded, box], dim=-1)))
        return self.head_out(h)[..., 0]


_TYPED_HEADS = (("integer", 11), ("boolean", 2), ("size", 2), ("color", 8), ("shape", 3),
                ("material", 2))


class MultiHeadStepModel(nn.Module):
    """Shared encoder + 8 typed heads + an autoregressive box decoder.

    The text LSTM runs over [function | input tokens], padding included,
    from a zero carry (Flax's (c, h)), and keeps the final ``h``; the image
    grid (B, C, H, W) is flattened C-major into ``image_fc``.  The box
    decoder starts from the carry (zeros, shared) and ``start_token``; each
    step's next input is ``input_proj`` of the teacher's box where that
    step's coin says so, else of the predicted box, with its gradient.  One
    coin per step, shared across the batch: drawn from ``generator`` with
    probability ``teacher_forcing`` in training mode with teacher boxes,
    all False otherwise."""

    def __init__(self, vocab_size: int = 64, embed_dim: int = 128, hidden_dim: int = 256,
                 image_feat_dim: int = 1024, image_spatial: Tuple[int, int] = (14, 14),
                 max_bbox_steps: int = 10, teacher_forcing: float = 0.5,
                 dtype: torch.dtype = F32, device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.hidden_dim = hidden_dim
        self.max_bbox_steps = max_bbox_steps
        self.teacher_forcing = teacher_forcing
        h = hidden_dim
        self.embedding = nn.Embedding(vocab_size, embed_dim, device=device)
        self.text_encoder = LSTMCell(embed_dim, h, dtype, device)
        self.image_fc = Dense(image_feat_dim * image_spatial[0] * image_spatial[1], h, dtype,
                              device)
        self.fc_shared = Dense(2 * h, h, dtype, device)
        self.dec_cell = LSTMCell(h, h, dtype, device)
        self.start_token = nn.Parameter(torch.zeros(h, device=device))
        self.box_out = Dense(h, 4, F32, device)
        self.stop_out = Dense(h, 2, F32, device)
        self.input_proj = Dense(4, h, dtype, device)
        for name, classes in _TYPED_HEADS:
            setattr(self, f"{name}_head", Dense(h, classes, F32, device))
        self.vocab_head = Dense(h, vocab_size, F32, device)

    def forward(self, function_tokens: torch.Tensor, input_tokens: torch.Tensor,
                image_feats: torch.Tensor, teacher_boxes: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """function_tokens (B,), input_tokens (B, L), image_feats (B, C, H,
        W), teacher_boxes (B, T, 4) or None.  ``generator`` draws the coins
        on the host (they steer the loop)."""
        dt = self.dtype
        batch = function_tokens.shape[0]
        text = torch.cat([embed_or_nan(self.embedding, function_tokens)[:, None],
                          embed_or_nan(self.embedding, input_tokens)], dim=1).to(dt)
        zeros = torch.zeros(batch, self.hidden_dim, device=text.device)
        carry = (zeros, zeros)
        for t in range(text.shape[1]):
            carry, _ = self.text_encoder(carry, text[:, t])
        image_repr = torch.relu(self.image_fc(image_feats.reshape(batch, -1)))
        shared = torch.relu(self.fc_shared(torch.cat([carry[1].to(dt), image_repr], dim=-1)))

        steps = self.max_bbox_steps
        tf_ratio = self.teacher_forcing if (self.training and teacher_boxes is not None) else 0.0
        coins: List[bool] = [False] * steps
        if tf_ratio > 0.0:
            coins = (torch.rand(steps, generator=generator) < tf_ratio).tolist()

        dec_carry = (torch.zeros_like(shared), shared)
        inp = self.start_token.expand(batch, self.hidden_dim).to(dt)
        boxes, stops = [], []
        for t in range(steps):
            dec_carry, h = self.dec_cell(dec_carry, inp)
            box = self.box_out(h)
            boxes.append(box)
            stops.append(self.stop_out(h))
            inp = self.input_proj(teacher_boxes[:, t] if coins[t] else box)
        out = {"bbox": torch.stack(boxes, dim=1), "bbox_stop_logits": torch.stack(stops, dim=1)}
        for name, _classes in _TYPED_HEADS:
            out[name] = getattr(self, f"{name}_head")(shared)
        out["vocab"] = self.vocab_head(shared)
        return out


class HierarchicalGenerator(nn.Module):
    """Image-only encoder + typed decoder branch: the encoder runs over the
    projected image tokens; the decoder runs twice, on the start query alone
    (its output routes {spatial, nonspatial} and gives the nonspatial value)
    and on [start | bbox_embedding(teacher boxes)] under its causal mask,
    the last position dropped (box t from the prefix before t)."""

    def __init__(self, d_model: int = 256, num_heads: int = 4, num_layers: int = 2,
                 num_image_tokens: int = 196, image_feature_dim: int = 1024,
                 max_inner_steps: int = 10, dtype: torch.dtype = F32, device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.d_model = d_model
        self.max_inner_steps = max_inner_steps
        self.image_proj = Dense(image_feature_dim, d_model, dtype, device)
        self.encoder = TransformerEncoder(num_layers, d_model, num_heads, d_model * 4,
                                          dropout=0.0, dtype=dtype, device=device)
        self.decoder = TransformerDecoder(num_layers, d_model, num_heads, d_model * 4,
                                          dropout=0.0, dtype=dtype, device=device)
        self.start_query = nn.Parameter(torch.zeros(d_model, device=device))
        self.type_head = Dense(d_model, 2, F32, device)
        self.bbox_embedding = Dense(4, d_model, dtype, device)
        self.bbox_out = Dense(d_model, 4, F32, device)
        self.stop_out = Dense(d_model, 1, F32, device)
        self.nonspatial_out = Dense(d_model, 1, F32, device)

    def forward(self, image_tokens: torch.Tensor,
                gt_boxes: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """image_tokens (B, P, C); gt_boxes (B, T, 4) teacher boxes or None."""
        batch = image_tokens.shape[0]
        memory = self.encoder(self.image_proj(image_tokens))
        start = self.start_query.expand(batch, 1, self.d_model).to(self.dtype)
        global_rep = self.decoder(start, memory)[:, 0]
        out = {"type_logits": self.type_head(global_rep),
               "nonspatial_value": self.nonspatial_out(global_rep)[:, 0]}
        if gt_boxes is None:
            gt_boxes = torch.zeros(batch, self.max_inner_steps, 4, device=image_tokens.device)
        dec_in = torch.cat([start, self.bbox_embedding(gt_boxes)], dim=1)
        dec_out = self.decoder(dec_in, memory)[:, :-1]
        out["pred_boxes"] = self.bbox_out(dec_out)
        out["stop_logits"] = self.stop_out(dec_out)[..., 0]
        return out


class _Conv(nn.Conv2d):
    """``nn.Conv2d`` with float32 parameters that computes in ``dtype``, as
    a Flax ``Conv(dtype=...)``; without autograd the casts are kept."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, dtype: torch.dtype,
                 device: Device):
        super().__init__(in_channels, out_channels, 3, stride=stride, padding=1,
                         device=device, dtype=F32)
        self.compute_dtype = dtype

    def _cast(self):
        return self.weight.to(self.compute_dtype), self.bias.to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = (self._cast() if torch.is_grad_enabled()
                        else cached_on_params(self, self._cast))
        return self._conv_forward(x.to(self.compute_dtype), weight, bias)


class YoloDetector(nn.Module):
    """A small conv stack from raw pixels to an (S, S, boxes_per_cell * 5)
    grid: four 3x3 SAME convolutions, each with ReLU and a 2x2 max-pool,
    then a 3x3 stride-2 convolution (224 -> 14 -> 7), flattened in JAX's
    (H, W, C) order into ``fc1`` (1024, ReLU) and ``fc2``.  The
    convolutions run in NCHW (cuDNN on the card)."""

    def __init__(self, grid: int = 7, boxes_per_cell: int = 1, image_size: int = 224,
                 dtype: torch.dtype = F32, device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.grid = grid
        self.boxes_per_cell = boxes_per_cell
        widths = (3, 16, 32, 64, 128, 256)
        self.convs = nn.ModuleList(_Conv(widths[i], widths[i + 1], 2 if i == 4 else 1, dtype,
                                         device) for i in range(5))
        side = (image_size // 16 - 1) // 2 + 1  # after the pools and the stride-2 conv
        self.fc1 = Dense(side * side * 256, 1024, dtype, device)
        self.fc2 = Dense(1024, grid * grid * boxes_per_cell * 5, F32, device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, H, W, 3) in [0, 1] -> (N, grid, grid, boxes_per_cell * 5)."""
        x = images.permute(0, 3, 1, 2)
        for conv in self.convs[:4]:
            x = F.max_pool2d(torch.relu(conv(x)), 2, 2)
        x = self.convs[4](x).permute(0, 2, 3, 1)  # back to NHWC for JAX's flatten order
        x = torch.relu(self.fc1(x.reshape(x.shape[0], -1)))
        return self.fc2(x).reshape(-1, self.grid, self.grid, self.boxes_per_cell * 5)


def yolo_grid_loss(pred: torch.Tensor, target: torch.Tensor, lambda_coord: float = 5.0,
                   lambda_noobj: float = 0.5) -> torch.Tensor:
    """The coordinate, object-confidence and no-object-confidence squared
    errors, summed, over the batch."""
    obj = target[..., 4] > 0
    sq = (pred - target) ** 2
    zero = torch.zeros((), device=pred.device)
    loss_coord = torch.where(obj[..., None], sq[..., :4], zero).sum()
    loss_obj = torch.where(obj, sq[..., 4], zero).sum()
    loss_noobj = torch.where(~obj, sq[..., 4], zero).sum()
    return (lambda_coord * loss_coord + loss_obj + lambda_noobj * loss_noobj) / pred.shape[0]


class CompositionalStepPredictor(nn.Module):
    """Mean-pooled multimodal fusion: the pooled image, the mean question
    token, input box and chain-of-thought token embeddings (padding and
    masked boxes left out) -> a 4d fusion -> (output box, next-function
    logits over ``num_functions``)."""

    def __init__(self, d_model: int = 256, question_vocab_size: int = 10000,
                 prog_vocab_size: int = 1000, num_functions: int = 14,
                 image_feature_dim: int = 1024, dtype: torch.dtype = F32,
                 device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.image_fc = Dense(image_feature_dim, d_model, dtype, device)
        self.question_emb = nn.Embedding(question_vocab_size, d_model, device=device)
        self.input_encoder = Dense(4, d_model, dtype, device)
        self.prog_emb = nn.Embedding(prog_vocab_size, d_model, device=device)
        self.fusion_fc = Dense(4 * d_model, d_model, dtype, device)
        self.output_head = Dense(d_model, 4, F32, device)
        self.function_head = Dense(d_model, num_functions, F32, device)

    def forward(self, image_feat: torch.Tensor, question_tokens: torch.Tensor,
                input_boxes: torch.Tensor, input_box_mask: torch.Tensor,
                prog_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """image_feat (B, C, H, W); question_tokens (B, Lq) and prog_tokens
        (B, Lp), 0 = padding; input_boxes (B, N, 4) with input_box_mask (B, N)."""
        dt = self.dtype

        def masked_mean(x, mask):
            total = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                                  device=x.device)).sum(1)
            return total / torch.clamp(mask.sum(1, keepdim=True), min=1).to(total.dtype)

        f_img = self.image_fc(image_feat.mean(dim=(2, 3)))
        q_emb = embed_or_nan(self.question_emb, question_tokens).to(dt)
        f_input = masked_mean(self.input_encoder(input_boxes), input_box_mask)
        p_emb = embed_or_nan(self.prog_emb, prog_tokens).to(dt)
        fused = self.fusion_fc(torch.cat([f_img, masked_mean(q_emb, question_tokens != 0),
                                          f_input, masked_mean(p_emb, prog_tokens != 0)],
                                         dim=-1))
        return {"pred_box": self.output_head(fused),
                "next_function_logits": self.function_head(fused)}
