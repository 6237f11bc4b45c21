"""Image input, ported from ``explainable_spatial_vqa_tpu/vision/`` (the
host part of the feature extraction so far)."""
