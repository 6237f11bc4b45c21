"""The Program Executor, ported from ``explainable_spatial_vqa_tpu/models/executor.py``
(thesis §3.4.2, pp.16-22).

One call executes one program step for a batch: cached image tokens, up to
``max_input_boxes`` dependency boxes and the 3-token text ⟨function, arg1,
arg2⟩ are fused by a post-LN transformer encoder over
[CLS | image | boxes | text]; a routing head picks the box branch (a
DETR-style decoder with ``num_queries`` learned queries) or the token branch
(a classifier on CLS).  With ``box_roi`` each box token also receives the
coverage-weighted average of the image tokens under its box.  With
``roi_sim`` every image token also receives a learned embedding of how its
content matches each box's pooled content (``roi_sim_heads`` match maps per
box); with ``count_embed`` CLS receives an embedding of the number of valid
input boxes.  Both channels start at zero, as in the JAX package.

On a CUDA device, in eval mode, the fusion encoder's blocks run on K2 at head
dim 128 (d_model 512) and the box decoder's query self-attention on K1; at
the CoGenT protocol's head dims 24 and 48 (d_model 96, 192) the blocks run
the plain path with their self-attention on K1.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.layers import (
    DecoderBlock,
    Dense,
    Device,
    TransformerEncoder,
    posemb_2d_sincos,
    posemb_2d_sincos_at,
)

__all__ = ["ProgramExecutor", "BoxDecoder", "roi_coverage_weights"]


def roi_coverage_weights(boxes: torch.Tensor, grid: int) -> torch.Tensor:
    """Normalized box->patch coverage weights for ROI content pooling.

    ``boxes``: (..., 4) xyxy in [0, 1].  Returns (..., grid*grid) float32
    weights: the fraction of the box's area over each grid cell (row-major
    r*grid+c), normalized to sum to 1; a zero-area box gives all zeros.
    """
    edges = torch.arange(grid + 1, dtype=torch.float32, device=boxes.device) / grid
    lo, hi = edges[:-1], edges[1:]
    bx = boxes.float()
    ox = torch.clamp(torch.minimum(bx[..., 2:3], hi) - torch.maximum(bx[..., 0:1], lo), min=0.0)
    oy = torch.clamp(torch.minimum(bx[..., 3:4], hi) - torch.maximum(bx[..., 1:2], lo), min=0.0)
    cov = oy[..., :, None] * ox[..., None, :]
    cov = cov.reshape(cov.shape[:-2] + (grid * grid,))
    total = cov.sum(dim=-1, keepdim=True)
    return cov / torch.clamp(total, min=1e-9)


class BoxDecoder(nn.Module):
    """DETR-style set decoder: learned queries cross-attend to fused memory."""

    def __init__(self, config: ExecutorConfig, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        cfg = config
        device = resolve_device(device)
        self.dtype = dtype
        self.queries = nn.Parameter(torch.zeros(cfg.num_queries, cfg.d_model, device=device))
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg.d_model, cfg.num_heads, cfg.d_model * 4, cfg.dropout, dtype, device)
            for _ in range(cfg.box_decoder_layers))
        self.head_hidden = Dense(cfg.d_model, cfg.d_model, dtype, device)
        self.head_out = Dense(cfg.d_model, 5, torch.float32, device)

    def forward(self, memory: torch.Tensor, memory_mask: Optional[torch.Tensor]) -> torch.Tensor:
        batch = memory.shape[0]
        x = self.queries[None].expand(batch, -1, -1).to(self.dtype)
        for block in self.blocks:
            # set prediction: no causal mask on the query self-attention
            x = block(x, memory, None, memory_mask)
        h = torch.relu(self.head_hidden(x))
        return torch.sigmoid(self.head_out(h))  # (B, Q, 5): xyxy + confidence


class ProgramExecutor(nn.Module):
    def __init__(self, config: ExecutorConfig, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        cfg = config
        if cfg.roi_sim and not cfg.box_roi:
            raise ValueError("roi_sim requires box_roi (it reuses the pooled ROI content)")
        if cfg.roi_sim and cfg.d_model % cfg.roi_sim_heads != 0:
            raise ValueError(
                f"roi_sim_heads={cfg.roi_sim_heads} must divide d_model={cfg.d_model}")
        device = resolve_device(device)
        self.config = cfg
        self.dtype = dtype
        d = cfg.d_model
        self.image_proj = Dense(cfg.image_feature_dim, d, dtype, device)
        self.box_mlp_1 = Dense(4, d, dtype, device)
        self.box_mlp_2 = Dense(d, d, dtype, device)
        self.text_embed = nn.Embedding(cfg.vocab_size, d, device=device)
        self.text_pos = nn.Parameter(torch.zeros(cfg.num_text_tokens, d, device=device))
        self.cls = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.fusion = TransformerEncoder(cfg.encoder_layers, d, cfg.num_heads, d * 4,
                                         cfg.dropout, dtype=dtype, device=device,
                                         remat=cfg.remat)
        if cfg.box_roi:
            self.roi_proj = Dense(d, d, dtype, device)
        if cfg.count_embed:
            # indexed by the number of valid input-box slots, 0..max_input_boxes
            self.count_embed = nn.Embedding(cfg.max_input_boxes + 1, d, device=device)
            nn.init.zeros_(self.count_embed.weight)
        if cfg.roi_sim:
            self.sim_roi_proj = Dense(d, d, dtype, device)
            self.sim_img_proj = Dense(d, d, dtype, device)
            # one input per (box slot, match map), slot-major: s * K + h
            self.sim_embed = Dense(cfg.max_input_boxes * cfg.roi_sim_heads, d, dtype, device)
            nn.init.zeros_(self.sim_embed.weight)
        self.routing_head = Dense(d, 2, torch.float32, device)
        self.token_head = Dense(d, cfg.token_classes, torch.float32, device)
        self.box_decoder = BoxDecoder(cfg, dtype, device)
        self.grid = int(round(float(np.sqrt(cfg.num_image_tokens))))
        assert self.grid * self.grid == cfg.num_image_tokens, "image tokens must form a square grid"
        self.register_buffer(
            "image_pos", torch.from_numpy(posemb_2d_sincos(self.grid, self.grid, d)).to(device),
            persistent=False)

    def precompute_image(self, image_tokens: torch.Tensor) -> torch.Tensor:
        """Project raw (B, P, C) features to positioned d_model tokens; chained
        inference does this once per question (the thesis image cache).  With
        ``roi_sim`` the similarity channel's image-side keys depend on these
        tokens alone, so they are computed here too and carried along the
        feature dim: (B, P, 2d) = [tokens | sim keys], split by :meth:`encode`."""
        img = self.image_proj(image_tokens.to(self.dtype))
        img = img + self.image_pos.to(self.dtype)[None]
        if self.config.roi_sim:
            return torch.cat([img, self.sim_img_proj(img)], dim=-1)
        return img

    def encode(
        self,
        image_tokens: torch.Tensor,
        input_boxes: torch.Tensor,
        box_mask: torch.Tensor,
        text_tokens: torch.Tensor,
        text_mask: torch.Tensor,
        image_precomputed: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Fuse modalities.  image_tokens: (B, P, C) raw, or when
        ``image_precomputed`` what :meth:`precompute_image` returns; input_boxes (B, S, 4); box_mask (B, S) bool;
        text_tokens (B, 3) int; text_mask (B, 3) bool.  Returns memory
        (B, L, d), key_mask (B, 1, 1, L), cls and func_slot (B, d)."""
        cfg = self.config
        dt = self.dtype
        batch = image_tokens.shape[0]
        img = image_tokens.to(dt) if image_precomputed else self.precompute_image(image_tokens)
        if cfg.roi_sim:
            img, sim_keys = img[..., :cfg.d_model], img[..., cfg.d_model:]

        centers = torch.stack(
            [(input_boxes[..., 0] + input_boxes[..., 2]) * 0.5,
             (input_boxes[..., 1] + input_boxes[..., 3]) * 0.5], dim=-1)
        box = self.box_mlp_2(torch.relu(self.box_mlp_1(input_boxes.to(dt))))
        box = box + posemb_2d_sincos_at(centers, cfg.d_model).to(dt)
        if cfg.box_roi:
            weights = roi_coverage_weights(input_boxes, self.grid).to(dt)
            pooled = torch.einsum("bsp,bpd->bsd", weights, img)
            box = box + self.roi_proj(pooled)
            if cfg.roi_sim:
                img = img + self.sim_embed(self._similarity(pooled, sim_keys, box_mask))

        text = self.text_embed(text_tokens.long()).to(dt) + self.text_pos[None].to(dt)
        cls = self.cls.expand(batch, 1, cfg.d_model).to(dt)
        if cfg.count_embed:
            # depends on the mask only, never on the boxes' contents
            count = box_mask.to(torch.int32).sum(dim=1)
            cls = cls + self.count_embed(count)[:, None, :].to(dt)
        x = torch.cat([cls, img, box, text], dim=1)

        valid = torch.cat(
            [torch.ones(batch, 1 + img.shape[1], dtype=torch.bool, device=x.device),
             box_mask.bool(), text_mask.bool()], dim=1)
        key_mask = valid[:, None, None, :]
        memory = self.fusion(x, key_mask)
        func_slot_index = 1 + img.shape[1] + box.shape[1]  # first text token
        return {
            "memory": memory,
            "key_mask": key_mask,
            "cls": memory[:, 0],
            "func_slot": memory[:, func_slot_index],
        }

    def _similarity(self, pooled: torch.Tensor, sim_keys: torch.Tensor,
                    box_mask: torch.Tensor) -> torch.Tensor:
        """(B, P, S*K) match maps: for every image token and box slot s, K
        scaled dot products of the box's projected pooled content with the
        token's key, one per head of d/K dims, zero for invalid slots,
        flattened slot-major (index s*K + h)."""
        heads = self.config.roi_sim_heads
        dh = self.config.d_model // heads
        q = self.sim_roi_proj(pooled)
        q = q.reshape(q.shape[:-1] + (heads, dh))
        k = sim_keys.reshape(sim_keys.shape[:-1] + (heads, dh))
        # sqrt(dh) taken in the compute type, as the JAX model takes it
        # (11.3125 in bf16 for dh = 128), held as a Python number
        scale = float(torch.tensor(float(dh), dtype=self.dtype).sqrt())
        sim = torch.einsum("bshd,bphd->bpsh", q, k) / scale
        sim = sim * box_mask.to(self.dtype)[:, None, :, None]
        return sim.reshape(sim.shape[:2] + (-1,))

    def forward(
        self,
        image_tokens: torch.Tensor,
        input_boxes: torch.Tensor,
        box_mask: torch.Tensor,
        text_tokens: torch.Tensor,
        text_mask: torch.Tensor,
        image_precomputed: bool = False,
    ) -> Dict[str, torch.Tensor]:
        fused = self.encode(image_tokens, input_boxes, box_mask, text_tokens, text_mask,
                            image_precomputed)
        boxes = self.box_decoder(fused["memory"], fused["key_mask"])
        return {
            "routing_logits": self.routing_head(fused["func_slot"].float()),  # 0=box, 1=token
            "token_logits": self.token_head(fused["cls"].float()),
            "pred_boxes": boxes[..., :4],  # (B, Q, 4) in [0, 1]
            "pred_conf": boxes[..., 4],  # (B, Q) in [0, 1]
        }
