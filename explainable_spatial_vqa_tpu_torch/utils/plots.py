"""Training curves, ported from ``explainable_spatial_vqa_tpu/utils/plots.py``:
per-epoch ratios of a trainer's history (:func:`history_curves`, the
``--history_json`` output of ``train``) and their plot
(:func:`plot_history`; matplotlib is imported inside the call)."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["history_curves", "plot_history"]


def history_curves(
    history: Dict[str, List[Dict[str, float]]],
    ratio: Tuple[str, str] = ("loss_sum", "batches"),
) -> Dict[str, List[float]]:
    """Extract per-epoch metric ratios for each split from a fit() history."""
    out: Dict[str, List[float]] = {}
    for split, rows in history.items():
        values = []
        for row in rows:
            denominator = row.get(ratio[1], 0.0)
            values.append(row.get(ratio[0], 0.0) / denominator if denominator else 0.0)
        out[split] = values
    return out


def plot_history(
    history_or_path,
    output_path: str,
    metrics: Sequence[Tuple[str, str, str]] = (
        ("loss", "loss_sum", "batches"),
        ("token_acc", "token_correct", "token_total"),
        ("answer_acc", "answer_correct", "answer_total"),
    ),
) -> Optional[str]:
    """Render train/val curves to ``output_path`` (png/pdf).  Skips metric
    panes whose counters are absent.  Returns the output path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(history_or_path, str):
        with open(history_or_path) as f:
            history = json.load(f)
    else:
        history = history_or_path

    present = [
        (title, num, den)
        for title, num, den in metrics
        if any(num in row for rows in history.values() for row in rows)
    ]
    if not present:
        return None
    fig, axes = plt.subplots(1, len(present), figsize=(5 * len(present), 4))
    if len(present) == 1:
        axes = [axes]
    for ax, (title, num, den) in zip(axes, present):
        curves = history_curves(history, (num, den))
        for split, values in curves.items():
            if values:
                ax.plot(range(1, len(values) + 1), values, marker="o", label=split)
        ax.set_title(title)
        ax.set_xlabel("epoch")
        ax.legend()
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(output_path, dpi=120)
    plt.close(fig)
    return output_path
