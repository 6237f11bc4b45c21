"""The port's device matcher against the JAX package's on the CPU.

``hungarian_assignment_device`` runs its plain version on CPU tensors
(``hungarian_assignment_device_plain``, ``_lap_single`` op for op in float32);
its assignments must equal ``hungarian_assignment_jax``'s exactly: on random
costs, on integer costs with many tied optima (where scipy picks other optimal
assignments), with empty and full masks, Q > T and Q < T, and on a NaN cost.
``assign_targets`` must send ``"auto"`` and ``"hungarian_jax"`` to it and
``"hungarian"`` to scipy.  JAX's matcher takes any size, and so does the
port's: past 31 columns (the warp kernel's range, ``MAX_SIDE``) the plain
version still equals JAX's, an executor of 40 queries gets JAX's assignment
through ``assign_targets``, and a CUDA tensor reaches the C entry, which
launches the block kernel there.  The CUDA kernels themselves are held
against the plain version on the card by ``chip_smoke.py`` phase 21.
"""

import contextlib
import types

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
    device raises; there is no size limit."""
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


class _FakeCuda:
    """A stand-in for a CUDA tensor on a host with no card: its shape and
    device, and the calls the wrapper makes before its C entry."""

    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)
        self.device = torch.device("cuda", 0)

    def detach(self):
        return self

    def to(self, _dtype):
        return self

    def contiguous(self):
        return self

    def data_ptr(self):
        return 0

    def new_empty(self, shape, dtype):
        assert dtype in (torch.int64, torch.uint8)
        return _FakeCuda(shape)


def test_side_limit_on_cuda_tensor(monkeypatch):
    """On a CUDA tensor there is no side limit: m = 32 (the first size past
    the warp kernel's 31) and m = 300 reach the C entry with their (B, Q, T),
    where ``esv_hungarian`` routes them to the block kernel, with a scratch
    of the size ``esv_hungarian_scratch_bytes`` asks for."""
    calls, scratch = [], []

    def entry(cost, mask, out, scratch_ptr, b, q, t, stream):
        calls.append((b, q, t))
        scratch.append(scratch_ptr)
        return 0

    def scratch_bytes(b, q, t):  # the state of a 300-column problem past shared memory
        return b * 16 if max(q, t) >= 300 else 0

    monkeypatch.setattr(tm, "_esv_hungarian", lambda: (entry, scratch_bytes))
    monkeypatch.setattr(torch.cuda, "device", lambda _device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda _device=None: types.SimpleNamespace(cuda_stream=0))
    for b, q, t in ((2, 10, 32), (2, 32, 10), (3, 300, 300), (1, 12, 300)):
        out = tm.hungarian_assignment_device(_FakeCuda((b, q, t)), _FakeCuda((b, t)))
        assert out.shape == (b, q)
    assert calls == [(2, 10, 32), (2, 32, 10), (3, 300, 300), (1, 12, 300)]
    assert scratch == [None, None, 0, 0]  # a scratch where the C library asks for one


@pytest.mark.parametrize("q,t", [(32, 32), (33, 10), (10, 48), (64, 64)])
def test_plain_matcher_equals_jax_past_the_warp(q, t):
    """Past the warp kernel's 31 columns the plain version (the block
    kernel's reference on the card) equals ``hungarian_assignment_jax`` on
    uniform costs, tied integer costs and integer costs with NaNs, under
    empty, full and ragged masks."""
    rng = np.random.RandomState(q * 100 + t)
    batch = 6
    mask = rng.rand(3 * batch, t) < rng.rand(3 * batch, 1)
    mask[0] = False
    mask[1] = True
    uniform = (rng.rand(batch, q, t) * 30.0).astype(np.float32)
    tied = rng.randint(0, 3, (batch, q, t)).astype(np.float32)
    nan = rng.randint(0, 3, (batch, q, t)).astype(np.float32)
    nan[rng.rand(batch, q, t) < 0.01] = np.nan
    for i, cost in enumerate((uniform, tied, nan)):
        keep = mask[i * batch:(i + 1) * batch]
        out = _device(cost, keep)
        np.testing.assert_array_equal(out, _jax(cost, keep))
        assert (out[0] == -1).all() or i > 0
    # the matched cost of the uniform draw is the optimum (scipy's)
    host = tm.hungarian_assignment(torch.from_numpy(uniform),
                                   torch.from_numpy(mask[:batch])).numpy()
    out = _device(uniform, mask[:batch])
    rows = np.arange(q)
    for b in range(batch):
        picked = out[b] >= 0
        assert picked.sum() == (host[b] >= 0).sum()
        np.testing.assert_allclose(uniform[b, rows[picked], out[b][picked]].sum(),
                                   uniform[b, rows[host[b] >= 0], host[b][host[b] >= 0]].sum(),
                                   rtol=1e-5)


def test_assign_targets_forty_queries_equals_jax():
    """An executor of 40 queries (``ExecutorConfig(num_queries=40)``, past
    the warp kernel's 31) trains in JAX; ``assign_targets`` under the default
    matcher gives JAX's assignment of its 40 x 12 problems."""
    cfg = ExecutorConfig(num_queries=40)
    assert cfg.num_queries == 40 and cfg.matcher == "auto"
    rng = np.random.RandomState(40)
    cost = rng.randint(0, 4, (8, cfg.num_queries, 12)).astype(np.float32)
    mask = rng.rand(8, 12) < 0.7
    out = losses.assign_targets(torch.from_numpy(cost), torch.from_numpy(mask), cfg)
    np.testing.assert_array_equal(out.numpy(), _jax(cost, mask))
    assert ((out.numpy() >= 0).sum(1) == mask.sum(1)).all()  # every valid target matched


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
