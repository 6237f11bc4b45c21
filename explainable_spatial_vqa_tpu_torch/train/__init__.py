"""Data containers shared by the inference runners."""
