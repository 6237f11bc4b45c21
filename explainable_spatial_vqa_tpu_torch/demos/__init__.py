"""The demo and diagnostic scripts, ported from the JAX package's
``scripts/demo_*.py`` and ``scripts/diag_*.py``.

Each module runs as ``python -m explainable_spatial_vqa_tpu_torch.demos.<name>``
with the JAX script's environment knobs, defaults, standard output and
markdown section markers, on the same synthetic CLEVR-factory corpora (no
download).  Two things differ: ``DEMO_DEVICE`` (default ``cuda``; without a
card every demo raises unless it is ``cpu``) takes the place of
``DEMO_PLATFORM``, and the sections go to ``$DEMO_OUT``, by default
``DEMO_TORCH.md`` at the repository root, never to ``DEMO.md``.

=============================  ==========================================
module                         JAX script
=============================  ==========================================
``common``                     ``scripts/demo_common.py``
``accuracy_table``             ``scripts/demo_accuracy_table.py``
``end_to_end``                 ``scripts/demo_end_to_end.py``
``data_efficiency``            ``scripts/demo_data_efficiency.py``
``executor_data_efficiency``   ``scripts/demo_executor_data_efficiency.py``
``scheduled_sampling``         ``scripts/demo_scheduled_sampling.py``
``scheduled_stats``            ``scripts/demo_scheduled_stats.py``
``scheduled_at_scale``         ``scripts/demo_scheduled_at_scale.py``
``diag_box_roi``               ``scripts/diag_box_roi.py``
``diag_roi_sim``               ``scripts/diag_roi_sim.py``
``diag_count_embed``           ``scripts/diag_count_embed.py``
=============================  ==========================================
"""
