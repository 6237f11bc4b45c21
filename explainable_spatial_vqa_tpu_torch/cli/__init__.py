"""Command-line entry points of the port, mirroring the thesis pair's
subcommands of the JAX package's CLI:
``python -m explainable_spatial_vqa_tpu_torch.cli [--device cpu] <command> ...``"""
