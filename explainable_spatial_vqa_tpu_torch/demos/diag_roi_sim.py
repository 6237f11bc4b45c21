"""Diagnostic: does the content-similarity channel fix same_*/relate recall?
Ported from ``scripts/diag_roi_sim.py``.

``ExecutorConfig.roi_sim`` exposes a content-content match map: a
learned-bilinear similarity between each input box's pooled ROI content and
every image token, injected into the image tokens through a zero-init
projection.  Trains the protocol executor twice on the SAME relational corpus
and seed, box_roi alone and box_roi + roi_sim, and reports GT-fed
per-function token accuracy and box P/R side by side (the harness of
``demos.diag_box_roi``).

Appends/refreshes the '## Content-similarity (roi_sim) diagnostic' section of
``DEMO_TORCH.md`` (or ``$DEMO_OUT``).  Env knobs: DIAG_SCENES (400), DIAG_QPS
(8), DIAG_STEPS (4000), DIAG_SEED (7), DIAG_DMODEL (0 = the protocol's d=96),
DIAG_SIM_HEADS (1), DEMO_DEVICE (default cuda), DEMO_OUT.

    python -m explainable_spatial_vqa_tpu_torch.demos.diag_roi_sim
"""

from __future__ import annotations

import os

from explainable_spatial_vqa_tpu_torch.demos.diag_box_roi import run_diagnostic

BEGIN = "<!-- roi-sim-diag:begin -->"
END = "<!-- roi-sim-diag:end -->"


def main() -> None:
    sim_heads = int(os.environ.get("DIAG_SIM_HEADS", "1"))
    run_diagnostic(
        "diag_roi_sim",
        "## Content-similarity (roi_sim) diagnostic (GT-fed steps, box_roi vs box_roi+roi_sim)",
        BEGIN, END,
        arms=(("box_roi", dict(box_roi=True, roi_sim=False, roi_sim_heads=sim_heads)),
              ("roi_sim", dict(box_roi=True, roi_sim=True, roi_sim_heads=sim_heads))),
        synth_kwargs=dict(hop_prob=1.0, chain_prob=0.8, max_nodes=16),
        corpus_label="relational ", corpus_note=" on the relational corpus (hop 1.0 / chain 0.8)",
        executor_note="",
        token_header="| function | box_roi | +roi_sim | n |",
        box_header="| function | roi P | roi R | +sim P | +sim R | gt boxes |",
    )


if __name__ == "__main__":
    main()
