"""The port's device matcher against the JAX package's on the CPU.

``hungarian_assignment_device`` runs its plain version on CPU tensors
(``hungarian_assignment_device_plain``, ``_lap_single`` op for op in float32);
its assignments must equal ``hungarian_assignment_jax``'s exactly: on random
costs, on integer costs with many tied optima (where scipy picks other optimal
assignments), with empty and full masks, Q > T and Q < T, and on a NaN cost.
``assign_targets`` must send ``"auto"`` and ``"hungarian_jax"`` to it and
``"hungarian"`` to scipy.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py`` phase 21.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.ops import matching as jm
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.ops import matching as tm
from explainable_spatial_vqa_tpu_torch.train import losses

torch.set_num_threads(1)

SHAPES = ((10, 10), (8, 8), (10, 4), (7, 10), (12, 5))


def _problems(seed, integer: bool, batch: int = 60):
    """``batch`` masked problems at each (Q, T) of SHAPES: the first with no
    valid target, the second with every target, the rest scattered; costs
    uniform in [0, 30) or integers in {0, 1, 2} (many tied optima)."""
    rng = np.random.RandomState(seed)
    out = []
    for q, t in SHAPES:
        if integer:
            cost = rng.randint(0, 3, (batch, q, t)).astype(np.float32)
        else:
            cost = (rng.rand(batch, q, t) * 30.0).astype(np.float32)
        mask = np.zeros((batch, t), bool)
        mask[1] = True
        for b in range(2, batch):
            mask[b, rng.choice(t, size=rng.randint(0, t + 1), replace=False)] = True
        out.append((cost, mask))
    return out


def _jax(cost, mask):
    return np.asarray(jm.hungarian_assignment_jax(jnp.asarray(cost), jnp.asarray(mask)))


def _device(cost, mask):
    out = tm.hungarian_assignment_device(torch.from_numpy(cost), torch.from_numpy(mask))
    assert out.dtype == torch.int64 and out.shape == cost.shape[:2]
    return out.numpy()


@pytest.mark.parametrize("integer", [False, True], ids=["uniform", "tied"])
@pytest.mark.parametrize("seed", [0, 1])
def test_device_matcher_equals_hungarian_jax(seed, integer):
    for cost, mask in _problems(seed, integer):
        out = _device(cost, mask)
        np.testing.assert_array_equal(out, _jax(cost, mask))
        assert (out[0] == -1).all()  # no valid target: every query unmatched
        matched = out[out >= 0]
        assert mask[np.nonzero(out >= 0)[0], matched].all()  # only valid targets


def test_device_matcher_on_the_existing_problem_sets():
    """The host matcher's problem sets (``test_torch_matching._problems``)."""
    from tests.test_torch_matching import _problems as host_problems

    for seed in (0, 1):
        for cost, mask in host_problems(seed):
            np.testing.assert_array_equal(_device(cost, mask), _jax(cost, mask))


def test_tied_optima_follow_jax_not_scipy():
    """Integer costs in {0, 1, 2} have many optimal assignments: the device
    matcher picks JAX's, scipy often another one of the same cost."""
    rng = np.random.RandomState(7)
    cost = rng.randint(0, 3, (200, 10, 10)).astype(np.float32)
    mask = np.ones((200, 10), bool)
    ref = _jax(cost, mask)
    out = _device(cost, mask)
    host = tm.hungarian_assignment(torch.from_numpy(cost), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(out, ref)
    differ = np.nonzero((host != ref).any(1))[0]
    assert len(differ) > 100, len(differ)
    rows = np.arange(10)
    for b in differ:  # both optimal: the same total cost
        assert cost[b, rows, out[b]].sum() == cost[b, rows, host[b]].sum()
    # one pinned problem where the two pick different optimal assignments
    b = differ[0]
    assert not np.array_equal(out[b], host[b])
    assert np.array_equal(out[b], ref[b])


@pytest.mark.parametrize("q,t", [(6, 3), (3, 6), (5, 5), (1, 4), (4, 1)])
def test_empty_full_and_ragged_masks(q, t):
    rng = np.random.RandomState(q * 10 + t)
    cost = rng.randint(0, 4, (4, q, t)).astype(np.float32)
    mask = np.stack([np.zeros(t, bool), np.ones(t, bool), rng.rand(t) < 0.5,
                     np.arange(t) == t - 1])
    out = _device(cost, mask)
    np.testing.assert_array_equal(out, _jax(cost, mask))
    assert (out[0] == -1).all()
    assert (out[1] >= 0).sum() == min(q, t)  # every query or every target matched
    assert (out[3] >= 0).sum() == 1 and (out[3][out[3] >= 0] == t - 1).all()


def test_nan_cost_matches_jax_and_ends():
    """A NaN cost neither hangs the loops nor parts from JAX: a 3 x 3 cost of
    ones with a NaN at (1, 1) gives [[1, 0, 2]], as hungarian_assignment_jax
    does on the CPU."""
    cost = np.ones((1, 3, 3), np.float32)
    cost[0, 1, 1] = np.nan
    mask = np.ones((1, 3), bool)
    np.testing.assert_array_equal(_device(cost, mask), [[1, 0, 2]])
    np.testing.assert_array_equal(_jax(cost, mask), [[1, 0, 2]])
    rng = np.random.RandomState(5)
    cost = rng.randint(0, 3, (100, 4, 6)).astype(np.float32)
    cost[rng.rand(100, 4, 6) < 0.08] = np.nan
    mask = rng.rand(100, 6) < 0.8
    np.testing.assert_array_equal(_device(cost, mask), _jax(cost, mask))


def test_contract_limits():
    """Shapes are checked first; a tensor on neither the CPU nor a CUDA
    device raises; MAX_SIDE binds the kernel only (one warp lane per column
    of the padded matrix), not the plain version."""
    assert tm.MAX_SIDE == 31
    with pytest.raises(ValueError, match="cost \\(B, Q, T\\)"):
        tm.hungarian_assignment_device(torch.zeros(2, 3, 4), torch.ones(2, 5, dtype=torch.bool))
    meta = torch.zeros(2, 32, 4, device="meta")
    with pytest.raises(ValueError):
        tm.hungarian_assignment_device(meta, torch.ones(2, 4, dtype=torch.bool, device="meta"))
    # the plain version has no such limit: a 40 x 33 problem still equals JAX
    rng = np.random.RandomState(3)
    cost = rng.rand(2, 40, 33).astype(np.float32)
    mask = np.ones((2, 33), bool)
    np.testing.assert_array_equal(_device(cost, mask), _jax(cost, mask))


def test_side_limit_on_cuda_tensor(monkeypatch):
    """On a CUDA tensor, m = 32 raises the contract error, not a launch."""
    calls = []
    monkeypatch.setattr(tm, "_esv_hungarian", lambda: calls.append(1))

    class FakeCuda:
        def __init__(self, shape):
            self.shape = shape
            self.ndim = len(shape)
            self.device = torch.device("cuda", 0)

    with pytest.raises(ValueError, match="exceeds 31"):
        tm.hungarian_assignment_device(FakeCuda((2, 10, 32)), FakeCuda((2, 32)))
    with pytest.raises(ValueError, match="exceeds 31"):
        tm.hungarian_assignment_device(FakeCuda((2, 32, 10)), FakeCuda((2, 10)))
    assert not calls


@pytest.mark.parametrize("matcher,expected", [
    ("auto", "device"), ("hungarian_jax", "device"), ("hungarian", "host"),
])
def test_assign_targets_routing(monkeypatch, matcher, expected):
    called = []

    def spy(name, fn):
        return lambda c, m: called.append(name) or fn(c, m)

    monkeypatch.setattr(losses, "hungarian_assignment_device",
                        spy("device", tm.hungarian_assignment_device))
    monkeypatch.setattr(losses, "hungarian_assignment", spy("host", tm.hungarian_assignment))
    rng = np.random.RandomState(0)
    cost = torch.from_numpy(rng.randint(0, 3, (8, 10, 10)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(8, 10) < 0.7)
    out = losses.assign_targets(cost, mask, ExecutorConfig(matcher=matcher))
    assert called == [expected]
    ref = _jax(cost.numpy(), mask.numpy())
    if expected == "device":
        np.testing.assert_array_equal(out.numpy(), ref)


def test_assign_targets_auto_equals_jax_loss_assignment():
    """``executor_set_loss``'s assignment under the default matcher equals the
    JAX loss's on tied integer costs (through ``assign_targets``)."""
    rng = np.random.RandomState(11)
    cost = rng.randint(0, 3, (32, 8, 8)).astype(np.float32)
    mask = rng.rand(32, 8) < 0.8
    out = losses.assign_targets(torch.from_numpy(cost), torch.from_numpy(mask), ExecutorConfig())
    np.testing.assert_array_equal(out.numpy(), _jax(cost, mask))
