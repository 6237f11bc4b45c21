"""Evaluation metrics, copied from the JAX package."""


def data_efficiency_sweep(train_fn, fractions=(0.01, 0.1, 1.0)):
    """Run ``train_fn(fraction) -> metric`` over subset fractions (the thesis
    data-efficiency protocol, §4.2.3 / Fig 4.4: generator at 500..9k programs,
    executor at 7k..700k questions).  Returns {fraction: metric}."""
    return {fraction: train_fn(fraction) for fraction in fractions}
