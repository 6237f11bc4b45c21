"""The serving path's measurement drivers, the counterparts of the JAX repo's
``scripts/profile_pipeline.py``, ``scripts/profile_segments.py``,
``scripts/mfu_decomposition.py`` and ``scripts/roofline_step.py``.

Each runs as ``python -m explainable_spatial_vqa_tpu_torch.measure.<name>``
at the port bench's widths (:mod:`explainable_spatial_vqa_tpu_torch.bench`),
on the card unless given ``--device cpu``, and prints one JSON object as its
last line.
"""
