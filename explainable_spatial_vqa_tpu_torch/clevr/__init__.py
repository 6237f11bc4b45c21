"""Symbolic CLEVR layer, copied from ``explainable_spatial_vqa_tpu/clevr/``:
scene graphs, symbolic program execution, bounding boxes, per-step
annotation and the synthetic corpus factory.  NumPy only."""
