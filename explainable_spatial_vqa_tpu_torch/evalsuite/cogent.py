"""CLEVR-CoGenT A->B generalisation protocol (thesis §4.2.2, Table 4.6),
ported from ``explainable_spatial_vqa_tpu/evalsuite/cogent.py``.

Condition A trains (cubes in gray/blue/brown/yellow; cylinders in
red/green/purple/cyan; spheres any color); Condition B swaps the cube and
cylinder palettes.  The protocol evaluates:

1. train on A, evaluate on valA and valB zero-shot,
2. fine-tune on 3k images / 30k questions of B, re-evaluate valA and valB.

The palettes, :func:`finetune_subset` and :class:`CoGenTReport` are NumPy
only; :func:`run_cogent_protocol` imports the trainers when it runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

__all__ = [
    "COGENT_A_PALETTE",
    "COGENT_B_PALETTE",
    "finetune_subset",
    "CoGenTReport",
    "run_cogent_protocol",
]

COGENT_A_PALETTE = {
    "cube": {"gray", "blue", "brown", "yellow"},
    "cylinder": {"red", "green", "purple", "cyan"},
    "sphere": {"gray", "blue", "brown", "yellow", "red", "green", "purple", "cyan"},
}
COGENT_B_PALETTE = {
    "cube": COGENT_A_PALETTE["cylinder"],
    "cylinder": COGENT_A_PALETTE["cube"],
    "sphere": COGENT_A_PALETTE["sphere"],
}


def finetune_subset(
    image_indices: np.ndarray,
    num_images: int = 3000,
    num_questions: int = 30000,
    seed: int = 42,
) -> np.ndarray:
    """Question indices for the 3k-image / 30k-question B fine-tune slice
    (thesis §4.2.2 p.36): pick the first ``num_images`` distinct images, then
    sample questions over them."""
    image_indices = np.asarray(image_indices)
    chosen_images = np.unique(image_indices)[:num_images]
    eligible = np.flatnonzero(np.isin(image_indices, chosen_images))
    rng = np.random.RandomState(seed)
    if len(eligible) > num_questions:
        eligible = rng.choice(eligible, num_questions, replace=False)
        eligible.sort()
    return eligible


@dataclass
class CoGenTReport:
    """Assembles the four-cell Table 4.6 row."""

    a_zero_shot: Optional[float] = None
    b_zero_shot: Optional[float] = None
    a_finetuned: Optional[float] = None
    b_finetuned: Optional[float] = None

    def as_dict(self) -> Dict[str, Optional[float]]:
        return {
            "valA_no_finetune": self.a_zero_shot,
            "valB_no_finetune": self.b_zero_shot,
            "valA_finetuned_on_B": self.a_finetuned,
            "valB_finetuned_on_B": self.b_finetuned,
        }

    def report(self) -> str:
        d = self.as_dict()
        fmt = lambda v: "—" if v is None else f"{100 * v:.1f}"  # noqa: E731
        return (
            f"CoGenT: A {fmt(d['valA_no_finetune'])} / B {fmt(d['valB_no_finetune'])}"
            f" (zero-shot); A {fmt(d['valA_finetuned_on_B'])} /"
            f" B {fmt(d['valB_finetuned_on_B'])} (fine-tuned on B)"
        )


def run_cogent_protocol(
    num_scenes_a: int = 80,
    num_scenes_val: int = 20,
    num_scenes_b_pool: int = 40,
    questions_per_scene: int = 6,
    gen_steps: int = 400,
    exe_steps: int = 500,
    ft_steps: int = 150,
    finetune_images: int = 3000,
    finetune_questions: int = 30000,
    noise: float = 0.0,
    drop: float = 0.0,
    seed: int = 0,
    max_chain_steps: int = 12,  # covers the 10-node two-branch compare programs
    entangled: bool = True,
    d_model: int = 0,  # 0 = protocol default (96)
    encoder_layers: int = 2,
    box_roi: bool = False,
    roi_sim: bool = False,
    count_embed: bool = False,
    lr_schedule: str = "constant",
    hop_prob: float = 0.0,
    chain_prob: float = 0.0,
    device="cuda",
) -> Dict:
    """Run the four-cell CoGenT protocol end to end on ``device``: train the
    generator and the executor on condition A, evaluate on valA and valB
    zero-shot, fine-tune on the :func:`finetune_subset` slice of B, and
    re-evaluate both vals.

    The corpora are synthetic (``clevr/synthetic.py``, CoGenT-conditioned
    palettes) with the JAX package's seeds: ``seed`` for A, ``+1`` valA,
    ``+2`` valB, ``+3`` the B pool, ``+10`` the fine-tunes and 42 the
    subset.  ``entangled`` (default True) renders color through the
    per-shape channel permutation (``synthetic.color_channel``), so that an
    A-trained model cannot decode condition-B (shape, color) combinations
    zero-shot; without it valB ≈ valA.  ``d_model``/``encoder_layers``/
    ``box_roi``/``lr_schedule`` scale the executor to the flagship recipe;
    ``hop_prob``/``chain_prob`` extend the corpora through the scene-aware
    relational joins.

    Returns {"report": CoGenTReport, "by_type": {cell: acc-dict},
    "tallies": {cell: FaithfulnessTally}, "sizes": {...}}.
    """
    import torch

    from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
    from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu_torch.core import vocab as voc
    from explainable_spatial_vqa_tpu_torch.device import resolve_device
    from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol as sp

    device = resolve_device(device)

    # --- corpora: disjoint image-index ranges share one feature array ---
    base_val_a = num_scenes_a
    base_val_b = base_val_a + num_scenes_val
    base_ft_b = base_val_b + num_scenes_val
    corpus_kw = dict(hop_prob=hop_prob, chain_prob=chain_prob,
                     max_nodes=max_chain_steps)
    train_a_scenes, train_a_q = syn.synthesize_cogent_dataset(
        num_scenes_a, questions_per_scene, "A", seed=seed, **corpus_kw)
    val_a_scenes, val_a_q = syn.synthesize_cogent_dataset(
        num_scenes_val, questions_per_scene, "A", seed=seed + 1,
        image_index_base=base_val_a, **corpus_kw)
    val_b_scenes, val_b_q = syn.synthesize_cogent_dataset(
        num_scenes_val, questions_per_scene, "B", seed=seed + 2,
        image_index_base=base_val_b, **corpus_kw)
    ft_b_scenes, ft_b_q = syn.synthesize_cogent_dataset(
        num_scenes_b_pool, questions_per_scene, "B", seed=seed + 3,
        image_index_base=base_ft_b, **corpus_kw)

    all_scenes = train_a_scenes + val_a_scenes + val_b_scenes + ft_b_scenes
    features = np.stack([
        syn.scene_feature_map(s, entangled=entangled).reshape(64, -1).T
        for s in all_scenes
    ]).astype(np.float32)
    features = torch.as_tensor(features, device=device)  # one copy for every phase

    # vocab over the union, as the reference builds vocab.json over all splits
    all_q = train_a_q + val_a_q + val_b_q + ft_b_q
    clevr_vocab = voc.build_clevr_vocab([all_q])

    def annotate(questions, scenes_raw):
        scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
        return ann.annotate_questions(questions, scenes)

    train_a_ann = annotate(train_a_q, train_a_scenes)
    ft_b_ann = annotate(ft_b_q, ft_b_scenes)
    split_vocab = voc.build_split_vocab(train_a_ann + ft_b_ann)

    exe_config = None
    if d_model or box_roi or roi_sim or count_embed or encoder_layers != 2:
        exe_config = sp.make_protocol_executor_config(
            split_vocab, d_model=d_model or 96,
            encoder_layers=encoder_layers, noise=noise, drop=drop,
            box_roi=box_roi, roi_sim=roi_sim, count_embed=count_embed,
        )

    # --- phase 1: train on A ---
    generator, gen_cfg, _ = sp.train_generator_synthetic(
        train_a_q, clevr_vocab, steps=gen_steps, seed=seed,
        lr_schedule=lr_schedule, device=device)
    executor, exe_cfg, _ = sp.train_executor_synthetic(
        train_a_ann, split_vocab, features, steps=exe_steps, seed=seed,
        noise=noise, drop=drop, config=exe_config, lr_schedule=lr_schedule,
        device=device)

    def evaluate(questions):
        return sp.evaluate_pipeline_synthetic(
            generator, executor, exe_cfg, questions, features, clevr_vocab,
            split_vocab, max_steps=max_chain_steps, device=device)

    tally_a0, acc_a0 = evaluate(val_a_q)
    tally_b0, acc_b0 = evaluate(val_b_q)

    # --- phase 2: fine-tune on the B subset (thesis: 3k images / 30k qs) ---
    ft_img_idx = np.asarray([q["image_index"] for q in ft_b_q])
    ft_idx = finetune_subset(ft_img_idx, finetune_images, finetune_questions,
                             seed=42)
    ft_q = [ft_b_q[i] for i in ft_idx]
    ft_ann = [ft_b_ann[i] for i in ft_idx]

    generator, gen_cfg, _ = sp.train_generator_synthetic(
        ft_q, clevr_vocab, steps=ft_steps, seed=seed + 10,
        config=gen_cfg, init_variables=generator, lr_schedule=lr_schedule,
        device=device)
    executor, exe_cfg, _ = sp.train_executor_synthetic(
        ft_ann, split_vocab, features, steps=ft_steps, seed=seed + 10,
        noise=noise, drop=drop, config=exe_cfg, init_variables=executor,
        lr_schedule=lr_schedule, device=device)

    tally_a1, acc_a1 = evaluate(val_a_q)
    tally_b1, acc_b1 = evaluate(val_b_q)

    report = CoGenTReport(
        a_zero_shot=acc_a0["overall"],
        b_zero_shot=acc_b0["overall"],
        a_finetuned=acc_a1["overall"],
        b_finetuned=acc_b1["overall"],
    )
    return {
        "report": report,
        "by_type": {
            "valA_no_finetune": acc_a0, "valB_no_finetune": acc_b0,
            "valA_finetuned_on_B": acc_a1, "valB_finetuned_on_B": acc_b1,
        },
        "tallies": {
            "valA_no_finetune": tally_a0, "valB_no_finetune": tally_b0,
            "valA_finetuned_on_B": tally_a1, "valB_finetuned_on_B": tally_b1,
        },
        "sizes": {
            "train_a_questions": len(train_a_q),
            "val_questions": len(val_a_q),
            "finetune_questions": len(ft_q),
        },
    }
