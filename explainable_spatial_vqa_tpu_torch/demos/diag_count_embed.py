"""Diagnostic: does the input-box-count embedding fix count/exist readout?
Ported from ``scripts/diag_count_embed.py``.

``ExecutorConfig.count_embed`` gives CLS the input-set size directly (the GT
set size in training, thresholded confident boxes at inference).  Trains the
protocol executor twice on the SAME corpus and seed, box_roi and box_roi +
count_embed, and reports GT-fed per-function token accuracy and box P/R side
by side (the harness of ``demos.diag_box_roi``, whose ``_eval_tally`` this
module shares, as the JAX script does).

Appends/refreshes the '## Count-embedding readout diagnostic' section of
``DEMO_TORCH.md`` (or ``$DEMO_OUT``).  Env knobs: DIAG_SCENES (400), DIAG_QPS
(8), DIAG_STEPS (4000), DIAG_SEED (7), DIAG_DMODEL (0 = the protocol's d=96),
DEMO_DEVICE (default cuda), DEMO_OUT.

    python -m explainable_spatial_vqa_tpu_torch.demos.diag_count_embed
"""

from __future__ import annotations

from explainable_spatial_vqa_tpu_torch.demos.diag_box_roi import _eval_tally, run_diagnostic

__all__ = ["main", "_eval_tally"]

BEGIN = "<!-- count-embed-diag:begin -->"
END = "<!-- count-embed-diag:end -->"


def main() -> None:
    run_diagnostic(
        "diag_count_embed",
        "## Count-embedding readout diagnostic (GT-fed steps, off vs on; both arms box_roi)",
        BEGIN, END,
        arms=(("base", dict(box_roi=True, count_embed=False)),
              ("count", dict(box_roi=True, count_embed=True))),
        synth_kwargs=dict(hop_prob=0.3), corpus_label="", corpus_note="",
        executor_note=" + box_roi",
        token_header="| function | box_roi | + count_embed | n |",
        box_header="| function | base P | base R | cnt P | cnt R | gt boxes |",
    )


if __name__ == "__main__":
    main()
