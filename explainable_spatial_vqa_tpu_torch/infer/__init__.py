"""Chained program execution and the end-to-end inference pipeline."""
