"""Thesis-style evaluation report assembly, copied from
``explainable_spatial_vqa_tpu/evalsuite/report.py``.

Emits the tables of thesis §4 (the formats of BASELINE.md) as markdown from
computed metrics, so a full-parity run produces a directly comparable
document: answer accuracy by question type (Table 4.2), per-function box P/R
(Table 4.3), token-function accuracy (Table 4.4), faithfulness quadrants
(Table 4.5), and CoGenT A->B (Table 4.6).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import CoGenTReport
from explainable_spatial_vqa_tpu_torch.evalsuite.detection import DetectionTally
from explainable_spatial_vqa_tpu_torch.evalsuite.faithfulness import FaithfulnessTally

__all__ = ["assemble_report"]

_TYPE_COLUMNS = ("count", "exist", "compare_number", "compare_attribute",
                 "query_attribute", "overall")


def _pct(value: Optional[float]) -> str:
    return "—" if value is None else f"{100 * value:.1f}"


def assemble_report(
    name: str,
    answer_accuracy: Optional[Mapping[str, float]] = None,
    detection: Optional[DetectionTally] = None,
    faithfulness: Optional[FaithfulnessTally] = None,
    cogent: Optional[CoGenTReport] = None,
    extra: Optional[Mapping[str, float]] = None,
) -> str:
    """Assemble available metrics into one markdown report."""
    lines = [f"# Evaluation report — {name}", ""]

    if answer_accuracy is not None:
        lines += ["## Answer accuracy by question type (Table 4.2 format)", ""]
        header = " | ".join(c.replace("_", " ").title() for c in _TYPE_COLUMNS)
        lines.append(f"| {header} |")
        lines.append("|" + "---|" * len(_TYPE_COLUMNS))
        lines.append(
            "| " + " | ".join(_pct(answer_accuracy.get(c)) for c in _TYPE_COLUMNS) + " |"
        )
        lines.append("")

    if detection is not None:
        pr = detection.precision_recall()
        if pr:
            lines += [f"## Box precision/recall @ IoU ≥ {detection.iou_threshold}"
                      " (Table 4.3 format)", "",
                      "| Function | Precision | Recall |", "|---|---|---|"]
            lines += [
                f"| {fn} | {v['precision']:.2f} | {v['recall']:.2f} |"
                for fn, v in pr.items()
            ]
            lines.append("")
        token_acc = detection.token_accuracy()
        if token_acc:
            lines += ["## Token-output function accuracy (Table 4.4 format)", "",
                      "| Function | Accuracy |", "|---|---|"]
            lines += [f"| {fn} | {acc:.2f} |" for fn, acc in token_acc.items()]
            lines.append("")

    if faithfulness is not None:
        f = faithfulness.as_fractions()
        lines += ["## Faithfulness quadrants (Table 4.5 format)", "",
                  "| Program | Answer | Fraction |", "|---|---|---|",
                  f"| Correct | Correct | {f['correct_program_correct_answer']:.2f} |",
                  f"| Correct | Incorrect | {f['correct_program_incorrect_answer']:.2f} |",
                  f"| Incorrect | Correct | {f['incorrect_program_correct_answer']:.2f} |",
                  f"| Incorrect | Incorrect | {f['incorrect_program_incorrect_answer']:.2f} |",
                  ""]

    if cogent is not None:
        d = cogent.as_dict()
        lines += ["## CLEVR-CoGenT generalisation (Table 4.6 format)", "",
                  "| A (no FT) | B (no FT) | A (FT on B) | B (FT on B) |",
                  "|---|---|---|---|",
                  "| " + " | ".join(_pct(d[k]) for k in (
                      "valA_no_finetune", "valB_no_finetune",
                      "valA_finetuned_on_B", "valB_finetuned_on_B")) + " |",
                  ""]

    if extra:
        lines += ["## Additional metrics", ""]
        lines += [f"- {k}: {v}" for k, v in extra.items()]
        lines.append("")
    return "\n".join(lines)
