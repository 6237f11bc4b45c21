"""Evaluation metrics, copied from the JAX package."""
