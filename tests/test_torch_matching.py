"""The port's box geometry and matchers against the JAX package on the CPU:
IoU, GIoU and the pairwise forms (atol 1e-6), Sinkhorn (atol 1e-5), and the
exact matcher's assignments equal to ``hungarian_assignment_jax``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.ops import matching as jm
from explainable_spatial_vqa_tpu_torch.ops import matching as tm

torch.set_num_threads(1)


def _boxes(rng, *shape):
    lo = rng.rand(*shape, 2) * 0.7
    return np.concatenate([lo, lo + rng.rand(*shape, 2) * 0.3], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["box_area", "box_iou", "box_giou"])
def test_elementwise_geometry_matches_jax(name):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 5, 7), _boxes(rng, 5, 7)
    a[0, 0] = b[0, 0]  # identical boxes
    a[0, 1, 2:] = a[0, 1, :2]  # a zero-area box
    args = (a,) if name == "box_area" else (a, b)
    ref = np.asarray(getattr(jm, name)(*(jnp.asarray(x) for x in args)))
    out = getattr(tm, name)(*(torch.from_numpy(x) for x in args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("name", ["pairwise_iou", "pairwise_giou", "pairwise_l1"])
def test_pairwise_geometry_matches_jax(name):
    rng = np.random.RandomState(1)
    pred, target = _boxes(rng, 3, 10), _boxes(rng, 3, 6)
    ref = np.asarray(getattr(jm, name)(jnp.asarray(pred), jnp.asarray(target)))
    out = getattr(tm, name)(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    assert out.shape == (3, 10, 6)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_sinkhorn_matches_jax():
    rng = np.random.RandomState(2)
    cost = (rng.rand(4, 10, 7) * 5).astype(np.float32)
    mask = rng.rand(4, 7) < 0.7
    plan_ref = np.asarray(jm.sinkhorn(jnp.asarray(-cost), 20))
    plan = tm.sinkhorn(torch.from_numpy(-cost), 20).numpy()
    np.testing.assert_allclose(plan, plan_ref, atol=1e-5)
    ref = np.asarray(jm.sinkhorn_assignment(jnp.asarray(cost), jnp.asarray(mask), 20, 0.5))
    out = tm.sinkhorn_assignment(torch.from_numpy(cost), torch.from_numpy(mask), 20, 0.5)
    np.testing.assert_array_equal(out.numpy(), ref)


def _problems(seed):
    """200 random masked problems: Q = T, Q < T, Q > T; masks with no
    target, every target, and random scattered targets."""
    rng = np.random.RandomState(seed)
    out = []
    for q, t in ((10, 10), (7, 10), (12, 5), (10, 4)):
        cost = (rng.rand(50, q, t) * 30.0).astype(np.float32)
        mask = np.zeros((50, t), bool)
        for b in range(50):
            if b == 1:
                mask[b] = True
            elif b > 1:
                mask[b, rng.choice(t, size=rng.randint(0, t + 1), replace=False)] = True
        out.append((cost, mask))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_exact_matcher_equals_hungarian_jax(seed):
    problems = _problems(seed)
    assert sum(len(c) for c, _ in problems) == 200
    for cost, mask in problems:
        ref = np.asarray(jm.hungarian_assignment_jax(jnp.asarray(cost), jnp.asarray(mask)))
        out = tm.hungarian_assignment(torch.from_numpy(cost), torch.from_numpy(mask))
        assert out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), ref)
        assert (out[torch.from_numpy(~mask.any(1))] == -1).all()  # no target: all unmatched


def test_exact_matcher_scattered_mask():
    cost = torch.tensor([[[5.0, 1.0, 9.0, 2.0], [5.0, 2.0, 9.0, 1.0]]])
    mask = torch.tensor([[False, True, False, True]])
    np.testing.assert_array_equal(tm.hungarian_assignment(cost, mask).numpy(), [[1, 3]])
