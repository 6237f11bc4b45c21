"""The port's losses against the JAX package on the CPU, in float32:
``executor_set_loss`` (every component within 1e-5, and its gradients with
respect to the boxes, confidences and logits within 1e-5), ``cross_entropy``
with an ignore index and label weights, and ``perturb_input_boxes``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig
from explainable_spatial_vqa_tpu.train import losses as jl
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.train import losses as tl

torch.set_num_threads(1)

B, Q, T, V = 12, 10, 10, 9
OUTPUT_KEYS = ("pred_boxes", "pred_conf", "token_logits", "routing_logits")


def _problem(seed):
    """Random executor outputs and targets: box rows with 0-10 targets
    contiguous from slot 0, and token rows."""
    rng = np.random.RandomState(seed)
    lo = rng.rand(B, Q, 2) * 0.6
    outputs = {
        "pred_boxes": np.concatenate([lo, lo + rng.rand(B, Q, 2) * 0.4], -1).astype(np.float32),
        "pred_conf": (1 / (1 + np.exp(-rng.randn(B, Q)))).astype(np.float32),
        "token_logits": rng.randn(B, V).astype(np.float32),
        "routing_logits": rng.randn(B, 2).astype(np.float32),
    }
    lo = rng.rand(B, T, 2) * 0.6
    target_boxes = np.concatenate([lo, lo + rng.rand(B, T, 2) * 0.4], -1).astype(np.float32)
    counts = rng.randint(0, T + 1, B)
    target_mask = np.arange(T)[None] < counts[:, None]
    is_box = rng.rand(B) < 0.6
    target_mask &= is_box[:, None]
    tokens = rng.randint(0, V, B).astype(np.int32)
    return outputs, target_boxes, target_mask, tokens, is_box


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_executor_set_loss_matches_jax(seed, weighted):
    outputs, target_boxes, target_mask, tokens, is_box = _problem(seed)
    weight = np.random.RandomState(seed + 10).rand(B).astype(np.float32) if weighted else None
    jcfg, cfg = JaxExecutorConfig(), ExecutorConfig()

    def jax_loss(outs):
        return jl.executor_set_loss(outs, jnp.asarray(target_boxes), jnp.asarray(target_mask),
                                    jnp.asarray(tokens), jnp.asarray(is_box), jcfg,
                                    None if weight is None else jnp.asarray(weight))

    jouts = {k: jnp.asarray(v) for k, v in outputs.items()}
    ref = jax_loss(jouts)
    ref_grads = jax.grad(lambda o: jax_loss(o)["loss"])(jouts)

    outs = {k: torch.from_numpy(v).requires_grad_() for k, v in outputs.items()}
    got = tl.executor_set_loss(outs, torch.from_numpy(target_boxes), torch.from_numpy(target_mask),
                               torch.from_numpy(tokens), torch.from_numpy(is_box), cfg,
                               None if weight is None else torch.from_numpy(weight))
    np.testing.assert_array_equal(got["assignment"].numpy(), np.asarray(ref["assignment"]))
    for key in ("loss", "routing_loss", "box_loss", "box_reg_loss", "conf_loss", "token_loss"):
        np.testing.assert_allclose(float(got[key].detach()), float(ref[key]), atol=1e-5,
                                   err_msg=key)
    got["loss"].backward()
    for key in OUTPUT_KEYS:
        np.testing.assert_allclose(outs[key].grad.numpy(), np.asarray(ref_grads[key]), atol=1e-5,
                                   err_msg=key)


def test_executor_set_loss_sinkhorn_matches_jax():
    outputs, target_boxes, target_mask, tokens, is_box = _problem(3)
    jcfg, cfg = JaxExecutorConfig(matcher="sinkhorn"), ExecutorConfig(matcher="sinkhorn")
    ref = jl.executor_set_loss({k: jnp.asarray(v) for k, v in outputs.items()},
                               jnp.asarray(target_boxes), jnp.asarray(target_mask),
                               jnp.asarray(tokens), jnp.asarray(is_box), jcfg)
    got = tl.executor_set_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                               torch.from_numpy(target_boxes), torch.from_numpy(target_mask),
                               torch.from_numpy(tokens), torch.from_numpy(is_box), cfg)
    np.testing.assert_array_equal(got["assignment"].numpy(), np.asarray(ref["assignment"]))
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), atol=1e-5)


@pytest.mark.parametrize("ignore_index", [None, 0])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(ignore_index, weighted):
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 5, 11).astype(np.float32)
    targets = rng.randint(0, 11, (6, 5)).astype(np.int32)
    targets[0] = 0  # a row of ignored positions
    weights = rng.rand(6, 5).astype(np.float32) if weighted else None
    ref = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(targets), ignore_index,
                           None if weights is None else jnp.asarray(weights))
    out = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), ignore_index,
                           None if weights is None else torch.from_numpy(weights))
    np.testing.assert_allclose(float(out), float(ref), atol=1e-6)


def test_smooth_l1_and_masked_box_regression_match_jax():
    rng = np.random.RandomState(5)
    pred, target = rng.rand(3, 4, 4).astype(np.float32) * 3, rng.rand(3, 4, 4).astype(np.float32)
    mask = rng.rand(3, 4) < 0.5
    np.testing.assert_allclose(
        tl.smooth_l1(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
        np.asarray(jl.smooth_l1(jnp.asarray(pred), jnp.asarray(target))), atol=1e-6)
    np.testing.assert_allclose(
        float(tl.masked_box_regression_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                            torch.from_numpy(mask))),
        float(jl.masked_box_regression_loss(jnp.asarray(pred), jnp.asarray(target),
                                            jnp.asarray(mask))), atol=1e-6)


def test_perturb_input_boxes():
    rng = np.random.RandomState(6)
    lo = rng.rand(8, 10, 2) * 0.6
    boxes = torch.from_numpy(np.concatenate([lo, lo + rng.rand(8, 10, 2) * 0.4], -1))
    mask = torch.from_numpy(np.arange(10)[None] < rng.randint(0, 11, (8, 1)))
    gen = torch.Generator().manual_seed(0)
    same_boxes, same_mask = tl.perturb_input_boxes(boxes, mask, gen, 0.0, 0.0)
    assert torch.equal(same_boxes, boxes) and torch.equal(same_mask, mask)

    noisy, kept = tl.perturb_input_boxes(boxes, mask, gen, 0.3, 0.5)
    assert noisy.min() >= 0.0 and noisy.max() <= 1.0
    assert not (kept & ~mask).any()  # slots only dropped, never added
    assert (kept != mask).any()
    assert torch.equal(noisy[~mask], boxes[~mask])  # padding untouched
    assert not torch.equal(noisy[mask], boxes[mask])
    # the draws come from the generator alone
    again = tl.perturb_input_boxes(boxes, mask, torch.Generator().manual_seed(7), 0.3, 0.5)
    repeat = tl.perturb_input_boxes(boxes, mask, torch.Generator().manual_seed(7), 0.3, 0.5)
    assert torch.equal(again[0], repeat[0]) and torch.equal(again[1], repeat[1])
