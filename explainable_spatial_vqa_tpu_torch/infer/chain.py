"""Vectorized chained program execution, ported from
``explainable_spatial_vqa_tpu/infer/chain.py`` (the executor half).

Step position k of every question runs in one executor call: the outputs of
each step (box sets, value tokens) live in dense device caches, and each
step gathers its dependencies from them.  Program steps are topologically
ordered (inputs always have smaller indices), so position order is a valid
schedule.

* :func:`chained_forward` walks the positions of a whole batch.
* :func:`chained_forward_pool` is continuous batching: a fixed pool of slots,
  each advancing its own question one step per iteration; a finished slot
  admits the next question from a deepest-first queue.  Per (row, step) the
  executor sees the same inputs as in :func:`chained_forward`, so the two
  give the same caches.
* :meth:`ExecutorChainRunner.run_sorted` and :meth:`~ExecutorChainRunner.run_bucketed`
  run :func:`chained_forward` on batches planned on the host
  (:mod:`~explainable_spatial_vqa_tpu_torch.infer.plan`): depth-sorted batches
  that each stop at their deepest chain, or one batch per depth bucket.

* :class:`Seq2SeqChainRunner` chains the step seq2seq baseline: the caches
  hold each step's decoded token sequence, step k's source is its function
  token followed by its dependencies' outputs (valid tokens first,
  :func:`compact_valid_first`), and each step is one encode and a cached
  greedy decode; :func:`run_bucketed_seq2seq` runs it per depth bucket.

With a ``mesh`` (``parallel.mesh``, one process per card), the runners
serve data-parallel over its ``data`` axis: the weights are broadcast from
the axis's first rank, each rank runs its own rows (``run``, ``run_sorted``
and ``run_bucketed``: contiguous slices of each batch padded to a multiple
of the axis; ``run_pool``: the rows :func:`deal_deepest_first` deals it,
drained in a pool of its own), and the outputs are gathered to every rank
and put back in question order on the host.  A one-rank mesh gives the
unsharded runner's results.

JAX's on-device loops become Python loops here; the pool loop reads one
scalar per iteration for its exit test.  The caches are updated in place.
Both passes are deterministic whatever mode the caller left the executor in,
as JAX's are (``deterministic=True``): they run it in eval mode
(:func:`~explainable_spatial_vqa_tpu_torch.models.layers.eval_mode`), so on
the card its fusion blocks run on K2 and its box decoder's self-attention on
K1, and give the caller its mode back.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, StepSeq2SeqConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.infer.plan import plan_sorted
from explainable_spatial_vqa_tpu_torch.models.layers import Device, eval_mode
from explainable_spatial_vqa_tpu_torch.ops.decoding import greedy_decode
from explainable_spatial_vqa_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    pad_to_multiple,
    replicated,
)
from explainable_spatial_vqa_tpu_torch.train.datasets import ChainArrays

__all__ = ["ChainState", "ExecutorChainRunner", "Seq2SeqChainRunner", "chained_forward",
           "chained_forward_pool", "compact_valid_first", "deal_deepest_first", "gather_dep_boxes",
           "gather_dep_token", "gather_step_inputs", "run_bucketed_seq2seq"]


def deal_deepest_first(num_steps: np.ndarray, num_chips: int) -> np.ndarray:
    """Deal question rows to ranks for the sharded pool: sort by descending
    chain length, give rank ``c`` rows ``order[c::num_chips]`` (round-robin
    over the global deepest-first order: near-equal step totals per rank
    even on skewed depth mixes), and pad every rank to the common length
    with ``-1`` sentinels.  Returns ``perm`` of shape (num_chips * per,):
    ``perm[c*per + j]`` is the original row of rank ``c``'s j-th slot, or -1
    for padding."""
    num_steps = np.asarray(num_steps)
    n = num_steps.shape[0]
    order = np.argsort(-num_steps, kind="stable")
    per = -(-n // num_chips)  # ceil
    perm = np.full(num_chips * per, -1, np.int64)
    for c in range(num_chips):
        mine = order[c::num_chips]
        perm[c * per:c * per + len(mine)] = mine
    return perm


def _data_axis(mesh: Optional[Mesh]):
    """(ranks, this rank) of the mesh's data axis; (1, 0) without a mesh."""
    return (1, 0) if mesh is None else (mesh.shape["data"], mesh.rank("data"))


class ChainState(NamedTuple):
    box_cache: torch.Tensor  # (N, S, Q, 4)
    box_mask: torch.Tensor  # (N, S, Q) bool: confident predicted boxes
    conf_cache: torch.Tensor  # (N, S, Q) float32: raw confidences
    token_cache: torch.Tensor  # (N, S) int32
    token_branch: torch.Tensor  # (N, S) bool: the step produced a token
    routing: torch.Tensor  # (N, S) int32: chosen branch per step


def _empty_state(n: int, s: int, q: int, device: torch.device) -> ChainState:
    return ChainState(
        box_cache=torch.zeros(n, s, q, 4, device=device),
        box_mask=torch.zeros(n, s, q, dtype=torch.bool, device=device),
        conf_cache=torch.zeros(n, s, q, device=device),
        token_cache=torch.zeros(n, s, dtype=torch.int32, device=device),
        token_branch=torch.zeros(n, s, dtype=torch.bool, device=device),
        routing=torch.zeros(n, s, dtype=torch.int32, device=device),
    )


def gather_dep_boxes(state: ChainState, dep: torch.Tensor, rows: Optional[torch.Tensor] = None):
    """A dependency's cached box set: (B, Q, 4) boxes and (B, Q) validity.
    ``rows`` picks the cache row of each batch element (the pool's slots);
    by default batch element b reads row b."""
    if rows is None:
        rows = torch.arange(state.box_cache.shape[0], device=dep.device)
    safe = dep.clamp(min=0)
    return state.box_cache[rows, safe], state.box_mask[rows, safe] & (dep >= 0)[:, None]


def gather_dep_token(state: ChainState, dep: torch.Tensor, rows: Optional[torch.Tensor] = None):
    """A dependency's cached value token: (B,) token (0 where invalid) and validity."""
    if rows is None:
        rows = torch.arange(state.token_cache.shape[0], device=dep.device)
    safe = dep.clamp(min=0)
    valid = state.token_branch[rows, safe] & (dep >= 0)
    return torch.where(valid, state.token_cache[rows, safe], 0), valid


def gather_step_inputs(state: ChainState, func: torch.Tensor, dep0: torch.Tensor,
                       dep1: torch.Tensor, max_input_boxes: int,
                       rows: Optional[torch.Tensor] = None):
    """One chain step's executor inputs: both dependencies' box sets
    concatenated, moved valid-first by a stable sort and cut to
    ``max_input_boxes``; text [function, dep0 value, dep1 value] with its
    validity mask."""
    b0, m0 = gather_dep_boxes(state, dep0, rows)
    b1, m1 = gather_dep_boxes(state, dep1, rows)
    all_boxes = torch.cat([b0, b1], dim=1)  # (B, 2Q, 4)
    all_mask = torch.cat([m0, m1], dim=1)
    order = torch.argsort((~all_mask).to(torch.uint8), dim=-1, stable=True)
    all_boxes = torch.gather(all_boxes, 1, order[..., None].expand(-1, -1, 4))
    all_mask = torch.gather(all_mask, 1, order)
    t0, v0 = gather_dep_token(state, dep0, rows)
    t1, v1 = gather_dep_token(state, dep1, rows)
    text = torch.stack([func.long(), t0.long(), t1.long()], dim=1)
    text_mask = torch.stack([torch.ones_like(v0), v0, v1], dim=1)
    return (all_boxes[:, :max_input_boxes], all_mask[:, :max_input_boxes], text, text_mask)


def _decide(out: Dict[str, torch.Tensor], func: torch.Tensor, cfg: ExecutorConfig,
            conf_thresholds: Optional[torch.Tensor]):
    is_box = torch.argmax(out["routing_logits"], dim=-1) == 0
    pred_token = torch.argmax(out["token_logits"], dim=-1).to(torch.int32)
    # per-FUNCTION propagation thresholds when a vector is given, else the
    # config's scalar
    thr = cfg.conf_threshold if conf_thresholds is None else conf_thresholds[func][:, None]
    conf_mask = (out["pred_conf"] >= thr) & is_box[:, None]
    return is_box, pred_token, conf_mask


def _deterministic(fn):
    """``fn(model, ...)`` without autograd and with ``model`` in eval mode."""

    @functools.wraps(fn)
    def run(model, *args, **kwargs):
        with torch.no_grad(), eval_mode(model):
            return fn(model, *args, **kwargs)

    return run


@_deterministic
def chained_forward(
    model,
    image_tokens: torch.Tensor,  # (N, P, C) raw, or (N, P, d) precomputed
    functions: torch.Tensor,  # (N, S)
    deps: torch.Tensor,  # (N, S, 2)
    num_steps: torch.Tensor,  # (N,)
    cfg: ExecutorConfig,
    max_steps: int,
    image_precomputed: bool = False,
    active_steps: Optional[int] = None,
    conf_thresholds: Optional[torch.Tensor] = None,
) -> ChainState:
    """Run every step position of a batch.  ``active_steps`` bounds the loop
    (the batch's deepest chain); positions at or past a question's
    ``num_steps`` write nothing, so any bound >= the deepest chain gives the
    same caches."""
    n = image_tokens.shape[0]
    if not image_precomputed:
        image_tokens = model.precompute_image(image_tokens)
    state = _empty_state(n, max_steps, cfg.num_queries, image_tokens.device)
    rows = torch.arange(n, device=image_tokens.device)
    upper = max_steps if active_steps is None else min(int(active_steps), max_steps)
    for k in range(upper):
        func = functions[:, k]
        input_boxes, input_mask, text, text_mask = gather_step_inputs(
            state, func, deps[:, k, 0], deps[:, k, 1], cfg.max_input_boxes)
        out = model(image_tokens, input_boxes, input_mask, text, text_mask,
                    image_precomputed=True)
        is_box, pred_token, conf_mask = _decide(out, func, cfg, conf_thresholds)
        active = k < num_steps
        state.box_cache[rows, k] = torch.where(active[:, None, None], out["pred_boxes"], 0.0)
        state.box_mask[rows, k] = active[:, None] & conf_mask
        state.conf_cache[rows, k] = torch.where(
            active[:, None] & is_box[:, None], out["pred_conf"], 0.0)
        state.token_cache[rows, k] = torch.where(active & ~is_box, pred_token, 0)
        state.token_branch[rows, k] = active & ~is_box
        state.routing[rows, k] = torch.where(active, (~is_box).to(torch.int32), 0)
    return state


@_deterministic
def chained_forward_pool(
    model,
    image_features: torch.Tensor,  # (M, P, C) per-IMAGE raw feature cache
    image_index: torch.Tensor,  # (N,) question -> image row
    functions: torch.Tensor,  # (N, S)
    deps: torch.Tensor,  # (N, S, 2)
    num_steps: torch.Tensor,  # (N,)
    cfg: ExecutorConfig,
    max_steps: int,
    slots: int = 128,
    return_iterations: bool = False,
    conf_thresholds: Optional[torch.Tensor] = None,
):
    """Continuous-batching chained execution over a pool of ``slots``.

    Admission is deepest-first (stable), so the drain tail is the shallowest
    work; finished slots refill in slot order from the queue (exclusive
    cumulative sum of the finished flags).  Only live slots scatter into the
    caches.  ``return_iterations=True`` also returns the loop trip count."""
    n = functions.shape[0]
    b = min(slots, n)
    device = image_features.device
    image_pre = model.precompute_image(image_features)  # every image once
    # row n is a sink: slots that are not live scatter there, as JAX's
    # mode="drop" drops them, so the scatter needs no host read
    state = _empty_state(n + 1, max_steps, cfg.num_queries, device)

    order = torch.argsort(-num_steps.long(), stable=True)
    rows = order[torch.arange(b, device=device).clamp(max=n - 1)]
    k = torch.zeros(b, dtype=torch.long, device=device)
    act = torch.arange(b, device=device) < n
    ptr = torch.tensor(b, dtype=torch.long, device=device)
    iterations = 0
    while bool(act.any()):
        func = functions[rows, k]
        input_boxes, input_mask, text, text_mask = gather_step_inputs(
            state, func, deps[rows, k, 0], deps[rows, k, 1], cfg.max_input_boxes, rows=rows)
        out = model(image_pre[image_index[rows]], input_boxes, input_mask, text, text_mask,
                    image_precomputed=True)
        is_box, pred_token, conf_mask = _decide(out, func, cfg, conf_thresholds)

        # scatter the live slots to their rows and the others to the sink;
        # zero-step rows are never live, as in chained_forward
        live = act & (k < num_steps[rows])
        r = torch.where(live, rows, n)
        state.box_cache[r, k] = out["pred_boxes"]
        state.box_mask[r, k] = conf_mask
        state.conf_cache[r, k] = torch.where(is_box[:, None], out["pred_conf"], 0.0)
        state.token_cache[r, k] = torch.where(~is_box, pred_token, 0)
        state.token_branch[r, k] = ~is_box
        state.routing[r, k] = (~is_box).to(torch.int32)

        # retire finished rows, admit from the queue
        k_next = k + 1
        finished = act & (k_next >= num_steps[rows])
        cont = act & ~finished
        fin = finished.long()
        cand = ptr + torch.cumsum(fin, 0) - fin  # exclusive: finished slots before me
        has_new = finished & (cand < n)
        rows = torch.where(has_new, order[cand.clamp(max=n - 1)], rows)
        k = torch.where(has_new, 0, torch.where(cont, k_next, k))
        act = cont | has_new
        ptr = ptr + fin.sum()
        iterations += 1
    state = ChainState(*(t[:n] for t in state))
    if return_iterations:
        return state, iterations
    return state


_CACHES = ("box_cache", "box_mask", "conf_cache", "token_cache", "token_branch")


class ExecutorChainRunner:
    """Chained inference for :class:`ProgramExecutor`: ``run`` walks step
    positions over the whole batch, ``run_sorted`` and ``run_bucketed`` over
    host-planned batches, ``run_pool`` is the continuous-batching slot pool.
    Inputs may be numpy arrays or tensors; outputs are numpy, with the JAX
    runner's keys.  ``mesh``: data-parallel serving over its ``data`` axis
    (module docstring); every rank of the axis makes the runner and calls
    the same runs, and each gets every output."""

    def __init__(self, model, config: ExecutorConfig, max_steps: int = 28,
                 conf_thresholds=None, device: Device = "cuda", mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.model = model  # every run is deterministic (chained_forward*)
        self.config = config
        self.max_steps = max_steps
        # data-parallel serving: the weights broadcast from the data axis's
        # first rank, rows split over the axis, outputs gathered
        self.mesh = mesh
        if mesh is not None:
            replicated(model, mesh)
        # optional per-FUNCTION propagation thresholds indexed by function id;
        # None = the config's global scalar
        self.conf_thresholds = (
            None if conf_thresholds is None
            else torch.as_tensor(np.asarray(conf_thresholds, np.float32), device=self.device))

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(device=self.device, dtype=dtype)

    def _chain_tensors(self, chains: ChainArrays):
        return (self._tensor(chains.functions, torch.long), self._tensor(chains.deps, torch.long),
                self._tensor(chains.num_steps, torch.long))

    def _outputs(self, state: ChainState, num_steps) -> Dict[str, np.ndarray]:
        host = {name: getattr(state, name).cpu().numpy() for name in _CACHES}
        return self._with_finals(host, num_steps)

    @staticmethod
    def _with_finals(out: Dict[str, np.ndarray], num_steps) -> Dict[str, np.ndarray]:
        last = np.asarray(num_steps) - 1
        rows = np.arange(len(last))
        out["final_tokens"] = out["token_cache"][rows, last]
        out["final_is_token"] = out["token_branch"][rows, last]
        return out

    def _empty_outputs(self, n: int) -> Dict[str, np.ndarray]:
        """Zero caches of every question for the batched runners to scatter
        into: steps past a question's depth stay zero or False, as inactive
        steps do in ``run``."""
        s, q = self.max_steps, self.config.num_queries
        return {
            "box_cache": np.zeros((n, s, q, 4), np.float32),
            "box_mask": np.zeros((n, s, q), bool),
            "conf_cache": np.zeros((n, s, q), np.float32),
            "token_cache": np.zeros((n, s), np.int32),
            "token_branch": np.zeros((n, s), bool),
        }

    def _gather(self, image_tokens, idx: np.ndarray) -> torch.Tensor:
        """Rows ``idx`` of per-question image tokens: a tensor is indexed on
        its own device, a numpy array on the host."""
        if isinstance(image_tokens, torch.Tensor):
            rows = image_tokens.index_select(0, torch.as_tensor(idx, device=image_tokens.device))
        else:
            rows = torch.from_numpy(np.asarray(image_tokens)[idx])
        return rows.to(device=self.device, dtype=torch.float32)

    def _run_part(self, images: torch.Tensor, chains: ChainArrays, part: np.ndarray,
                  max_steps: int, active_steps: Optional[int] = None) -> ChainState:
        return chained_forward(
            self.model, images, self._tensor(chains.functions[part, :max_steps], torch.long),
            self._tensor(chains.deps[part, :max_steps], torch.long),
            self._tensor(chains.num_steps[part], torch.long), self.config, max_steps,
            active_steps=active_steps, conf_thresholds=self.conf_thresholds)

    @staticmethod
    def _scatter(full: Dict[str, np.ndarray], state: ChainState, idx: np.ndarray) -> None:
        """The first ``len(idx)`` rows of a batch's caches into questions ``idx``."""
        width = state.token_cache.shape[1]
        for name in _CACHES:
            full[name][idx, :width] = getattr(state, name)[:len(idx)].cpu().numpy()

    def _run_sharded(self, image_tokens, chains: ChainArrays, batches) -> Dict[str, np.ndarray]:
        """Each batch ``(part, real, width, active_steps)`` (``part``: question
        rows, a multiple of the data axis long, of which the first ``real``
        are kept) split over the data axis: this rank runs its contiguous
        slice of every batch, then every rank's caches are gathered and
        scattered into question order."""
        world, rank = _data_axis(self.mesh)
        num_steps = np.asarray(chains.num_steps)
        local = {name: [] for name in _CACHES}
        kept = []  # per rank, the destination row of each local row or -1
        for part, real, width, active in batches:
            per = len(part) // world
            mine = part[rank * per:(rank + 1) * per]
            state = self._run_part(self._gather(image_tokens, mine), chains, mine, width, active)
            for name in _CACHES:
                cache = getattr(state, name).cpu().numpy()
                pad = [(0, 0), (0, self.max_steps - cache.shape[1])] + [(0, 0)] * (cache.ndim - 2)
                local[name].append(np.pad(cache, pad))
        for r in range(world):
            for part, real, _width, _active in batches:
                per = len(part) // world
                slot = np.arange(r * per, (r + 1) * per)
                kept.append(np.where(slot < real, part[slot], -1))
        gathered = gather_rows({name: np.concatenate(v) for name, v in local.items()},
                               self.mesh)
        dst = np.concatenate(kept)
        live = dst >= 0
        full = self._empty_outputs(len(num_steps))
        for name in _CACHES:
            full[name][dst[live]] = gathered[name][live]
        return self._with_finals(full, num_steps)

    def run(self, image_tokens, chains: ChainArrays) -> Dict[str, np.ndarray]:
        """``image_tokens``: (N, P, C) raw features, one row per question."""
        if self.mesh is not None:
            world, _ = _data_axis(self.mesh)
            n = len(chains.num_steps)
            part, _ = pad_to_multiple(np.arange(n), world)
            return self._run_sharded(image_tokens, chains, [(part, n, self.max_steps, None)])
        functions, deps, num_steps = self._chain_tensors(chains)
        state = chained_forward(
            self.model, self._tensor(image_tokens, torch.float32), functions, deps, num_steps,
            self.config, self.max_steps, conf_thresholds=self.conf_thresholds)
        return self._outputs(state, chains.num_steps)

    def run_pool(self, image_features, chains: ChainArrays, slots: int = 128) -> Dict[str, np.ndarray]:
        """``image_features``: the per-IMAGE (M, P, C) feature cache, indexed by
        ``chains.image_index`` on the device each iteration.

        With a mesh, the rows are dealt deepest-first round-robin over the
        data axis (:func:`deal_deepest_first`; sentinel rows have no steps),
        every rank drains its own pool of ``slots`` with the whole image
        cache and no collective, and the caches are gathered and
        un-permuted on the host."""
        if self.mesh is None:
            functions, deps, num_steps = self._chain_tensors(chains)
            state = chained_forward_pool(
                self.model, self._tensor(image_features, torch.float32),
                self._tensor(chains.image_index, torch.long), functions, deps, num_steps,
                self.config, self.max_steps, slots=slots, conf_thresholds=self.conf_thresholds)
            return self._outputs(state, chains.num_steps)
        world, rank = _data_axis(self.mesh)
        num_steps = np.asarray(chains.num_steps)
        perm = deal_deepest_first(num_steps, world)
        per = len(perm) // world
        mine = perm[rank * per:(rank + 1) * per]
        safe, real = np.clip(mine, 0, None), mine >= 0
        state = chained_forward_pool(
            self.model, self._tensor(image_features, torch.float32),
            self._tensor(np.where(real, np.asarray(chains.image_index)[safe], 0), torch.long),
            self._tensor(np.where(real[:, None], np.asarray(chains.functions)[safe], 0),
                         torch.long),
            self._tensor(np.where(real[:, None, None], np.asarray(chains.deps)[safe], -1),
                         torch.long),
            self._tensor(np.where(real, num_steps[safe], 0), torch.long),
            self.config, self.max_steps, slots=slots, conf_thresholds=self.conf_thresholds)
        gathered = gather_rows({name: getattr(state, name).cpu().numpy() for name in _CACHES},
                               self.mesh)
        live = perm >= 0
        full = self._empty_outputs(len(num_steps))
        for name in _CACHES:
            full[name][perm[live]] = gathered[name][live]
        return self._with_finals(full, num_steps)

    def run_sorted(self, image_tokens, chains: ChainArrays, batch: int = 128,
                   min_tail: int = 32) -> Dict[str, np.ndarray]:
        """Depth-sorted batches (``plan_sorted``), each run to its own deepest
        chain.  ``image_tokens``: (N, P, C) raw features, one row per
        question; a tensor is gathered per batch on its device.  Padding rows
        repeat the batch's last question and are dropped: only the real
        prefix scatters back."""
        num_steps = np.asarray(chains.num_steps)
        world, _ = _data_axis(self.mesh)
        plan = plan_sorted(num_steps, batch, min_tail, multiple=world)
        if self.mesh is not None:
            return self._run_sharded(image_tokens, chains, [
                (part, real, self.max_steps, depth) for depth, _size, part, real in plan])
        full = self._empty_outputs(len(num_steps))
        for depth, _size, part, real in plan:
            state = self._run_part(self._gather(image_tokens, part), chains, part,
                                   self.max_steps, active_steps=depth)
            self._scatter(full, state, part[:real])
        return self._with_finals(full, num_steps)

    def run_bucketed(self, image_tokens, chains: ChainArrays,
                     buckets: Sequence[int] = (8, 12, 16, 20, 28)) -> Dict[str, np.ndarray]:
        """One batch per depth bucket: every question in the shallowest
        bucket edge that holds its depth, run to that edge.  Edges above
        ``max_steps`` are dropped and ``max_steps`` closes the list; a bucket
        with no questions is skipped.  ``image_tokens`` as in
        :meth:`run_sorted`."""
        num_steps = np.asarray(chains.num_steps)
        full = self._empty_outputs(len(num_steps))
        edges = tuple(b for b in sorted(set(buckets)) if b <= self.max_steps)
        if not edges or edges[-1] < self.max_steps:
            edges = edges + (self.max_steps,)
        assigned = np.zeros(len(num_steps), bool)
        world, _ = _data_axis(self.mesh)
        sharded = []
        for depth in edges:
            select = (~assigned) & (num_steps <= depth)
            assigned |= select
            idx = np.flatnonzero(select)
            if idx.size == 0:
                continue
            if self.mesh is not None:
                sharded.append((pad_to_multiple(idx, world)[0], idx.size, depth, None))
                continue
            state = self._run_part(self._gather(image_tokens, idx), chains, idx, depth)
            self._scatter(full, state, idx)
        if self.mesh is not None:
            return self._run_sharded(image_tokens, chains, sharded)
        return self._with_finals(full, num_steps)


# ---------------------------------------------------------------------------
# the step seq2seq baseline
# ---------------------------------------------------------------------------


def compact_valid_first(tokens: torch.Tensor, valid: torch.Tensor):
    """Valid entries moved to the front along the last axis, in their order:
    (tokens, valid) -> (compacted tokens, compacted valid)."""
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    return torch.gather(tokens, -1, order), torch.gather(valid, -1, order)


def _rows(image_tokens, idx: np.ndarray):
    """Rows ``idx`` of per-question image tokens, a tensor on its own device."""
    if isinstance(image_tokens, torch.Tensor):
        return image_tokens.index_select(0, torch.as_tensor(idx, device=image_tokens.device))
    return np.asarray(image_tokens)[idx]


class Seq2SeqChainRunner:
    """Chained inference for :class:`~..models.step_executor.StepExecutorSeq2Seq`.

    Step k of every chain runs at once: its source is [function] ++ the
    output sequences of its (up to two) dependencies, valid tokens first and
    cut to ``max_src_len``; one encode, then a greedy decode of
    ``max_tgt_len`` tokens over KV caches, whose <END> and what follows
    become padding.  Steps past a chain's depth stay zero.  The JAX runner
    walks all ``max_steps`` positions; this one stops after the deepest
    chain of the batch (read from ``chains.num_steps`` on the host), which
    leaves the outputs equal.  Runs are deterministic (eval mode, the
    caller's mode restored), so on the card the encoder runs on K2 at a head
    dim the kernels are built for."""

    def __init__(self, model, config: StepSeq2SeqConfig, max_steps: int = 28,
                 start_token: int = 1, end_token: int = 2, pad_token: int = 0,
                 device: Device = "cuda", mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.model = model
        self.config = config
        self.max_steps = max_steps
        self.start_token = start_token
        self.end_token = end_token
        self.pad_token = pad_token
        # data-parallel serving, as ExecutorChainRunner's: each rank runs its
        # contiguous rows (padded to a multiple of the data axis)
        self.mesh = mesh
        if mesh is not None:
            replicated(model, mesh)

    def _tensor(self, a, dtype) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(device=self.device, dtype=dtype)

    def _step(self, images: torch.Tensor, cache: torch.Tensor, func: torch.Tensor,
              deps: torch.Tensor) -> torch.Tensor:
        """One chain position of every row: its decoded outputs (N, T)."""
        n = func.shape[0]
        rows = torch.arange(n, device=func.device)
        parts = [func[:, None]]
        masks = [torch.ones(n, 1, dtype=torch.bool, device=func.device)]
        for d in range(2):
            dep = deps[:, d]
            seq = cache[rows, dep.clamp(min=0)]
            parts.append(seq)
            masks.append((seq != self.pad_token) & (dep >= 0)[:, None])
        src, valid = compact_valid_first(torch.cat(parts, 1), torch.cat(masks, 1))
        width = self.config.max_src_len
        src = torch.where(valid, src, self.pad_token)[:, :width]
        memory, key_mask = self.model.encode(images, src, valid[:, :width])
        decoded = greedy_decode(self.model, memory, key_mask, self.start_token,
                                self.config.max_tgt_len, self.end_token, self.pad_token)
        return torch.where(decoded == self.end_token, self.pad_token, decoded).to(torch.int32)

    def run(self, image_tokens, chains: ChainArrays) -> Dict[str, np.ndarray]:
        """``image_tokens``: (N, P, C) features, one row per chain (numpy or a
        tensor).  Returns numpy {"step_outputs": (N, max_steps, T),
        "final_outputs": (N, T), each chain's last step}."""
        return self._run(image_tokens, chains, self.max_steps)

    def _run(self, image_tokens, chains: ChainArrays, max_steps: int) -> Dict[str, np.ndarray]:
        """``run`` with caches ``max_steps`` wide (the chains' arrays at least
        as wide); with a mesh each rank runs its rows and the step outputs
        are gathered."""
        num_steps = np.asarray(chains.num_steps)
        n = len(num_steps)
        if self.mesh is None:
            cache = self._run_rows(image_tokens, chains.functions, chains.deps, num_steps,
                                   max_steps)
        else:
            # this rank's contiguous rows of the question rows padded (with
            # row 0, dropped after the gather) to a multiple of the data axis
            world, rank = _data_axis(self.mesh)
            padded, _ = pad_to_multiple(np.arange(n), world)
            per = len(padded) // world
            rows = padded[rank * per:(rank + 1) * per]
            cache = self._run_rows(_rows(image_tokens, rows), np.asarray(chains.functions)[rows],
                                   np.asarray(chains.deps)[rows], num_steps[rows], max_steps)
            cache = gather_rows({"cache": cache}, self.mesh)["cache"][:n]
        return {"step_outputs": cache, "final_outputs": cache[np.arange(n), num_steps - 1]}

    def _run_rows(self, images, functions, deps, num_steps: np.ndarray,
                  max_steps: int) -> np.ndarray:
        """(N, max_steps, T) decoded outputs of these rows' chains."""
        n, t = len(num_steps), self.config.max_tgt_len
        cache = torch.zeros(n, max_steps, t, dtype=torch.int32, device=self.device)
        depth = min(max_steps, int(num_steps.max())) if n else 0
        images = self._tensor(images, torch.float32)
        functions = self._tensor(functions, torch.long)
        deps = self._tensor(deps, torch.long)
        active = self._tensor(num_steps, torch.long)[:, None]
        with torch.no_grad(), eval_mode(self.model):
            for k in range(depth):
                out = self._step(images, cache, functions[:, k], deps[:, k])
                cache[:, k] = torch.where(active > k, out, 0)
        return cache.cpu().numpy()


def run_bucketed_seq2seq(runner: Seq2SeqChainRunner, image_tokens, chains: ChainArrays,
                         buckets: Sequence[int] = (8, 12, 16, 20, 28)) -> Dict[str, np.ndarray]:
    """Depth-bucketed execution for the seq2seq runner: chains grouped by
    the shallowest bucket edge that holds their depth (edges above
    ``max_steps`` dropped, ``max_steps`` closing the list), one run per
    bucket (on the runner's mesh, if it has one), outputs scattered back."""
    num_steps = np.asarray(chains.num_steps)
    n, t = len(num_steps), runner.config.max_tgt_len
    step_outputs = np.zeros((n, runner.max_steps, t), np.int32)
    final_outputs = np.zeros((n, t), np.int32)
    edges = tuple(b for b in sorted(set(buckets)) if b <= runner.max_steps)
    if not edges or edges[-1] < runner.max_steps:
        edges = edges + (runner.max_steps,)
    assigned = np.zeros(n, bool)
    for depth in edges:
        select = (~assigned) & (num_steps <= depth)
        assigned |= select
        idx = np.flatnonzero(select)
        if idx.size == 0:
            continue
        sub = ChainArrays(chains.image_index[idx], chains.functions[idx, :depth],
                          chains.deps[idx, :depth], num_steps[idx], [])
        out = runner._run(_rows(image_tokens, idx), sub, depth)
        step_outputs[idx, :depth] = out["step_outputs"]
        final_outputs[idx] = out["final_outputs"]
    return {"step_outputs": step_outputs, "final_outputs": final_outputs}
