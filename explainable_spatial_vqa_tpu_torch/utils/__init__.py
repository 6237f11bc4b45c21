"""Logging, plots and box drawing, ported from ``explainable_spatial_vqa_tpu/utils/``."""
