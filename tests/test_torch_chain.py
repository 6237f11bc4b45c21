"""The port's chain runners (``run``, ``run_sorted``, ``run_bucketed`` and
``run_pool``) and batch plans against the JAX ExecutorChainRunner and
``infer/plan.py`` on CLEVR-shaped chains from ``bench.synth_questions``, in
fp32 on the CPU, with and without a per-function threshold vector, and with
the ``roi_sim``/``count_embed`` executor."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig  # noqa: E402
from explainable_spatial_vqa_tpu.infer import plan as jax_plan  # noqa: E402
from explainable_spatial_vqa_tpu.infer.chain import ExecutorChainRunner as JaxRunner  # noqa: E402
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor  # noqa: E402
from explainable_spatial_vqa_tpu_torch.bench_data import FUNCTION_IDS, synth_questions  # noqa: E402
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig  # noqa: E402
from explainable_spatial_vqa_tpu_torch.infer import plan  # noqa: E402
from explainable_spatial_vqa_tpu_torch.infer.chain import (  # noqa: E402
    ExecutorChainRunner,
    chained_forward,
    chained_forward_pool,
)
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor  # noqa: E402

torch.set_num_threads(1)

CFG = dict(vocab_size=32, d_model=32, num_heads=4, encoder_layers=1, box_decoder_layers=1,
           num_queries=3, num_image_tokens=4, image_feature_dim=8, max_input_boxes=4,
           token_classes=8, box_roi=True)
MAX_STEPS = 27
TOL = 1e-4  # box_cache / conf_cache atol, and the least margin of every decision


def _pair(cfg_kw, seed=0):
    """The JAX executor with random weights and the port's with the same
    weights, on 20 synthetic questions.  Random weights put pred_conf =
    sigmoid(~0) right on the 0.5 threshold and the 2-way routing logits near a
    tie, so both heads are spread; the roi_sim and count_embed channels, zero
    at init, get seeded random values."""
    jcfg = JaxExecutorConfig(**cfg_kw)
    features, _questions, chains = bench.synth_questions(20, jcfg, max_steps=MAX_STEPS, seed=3)
    jmodel = JaxExecutor(jcfg)
    variables = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 4, 8)), jnp.zeros((2, 4, 4)),
        jnp.ones((2, 4), bool), jnp.zeros((2, 3), jnp.int32), jnp.ones((2, 3), bool))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["box_decoder"]["head_out"]["kernel"] *= 20.0
    params["routing_head"]["kernel"] *= 20.0
    rng = np.random.RandomState(seed + 10)
    if "sim_embed" in params:
        params["sim_embed"]["kernel"] = rng.randn(*params["sim_embed"]["kernel"].shape).astype(
            np.float32)
    if "count_embed" in params:
        table = params["count_embed"]["embedding"]
        params["count_embed"]["embedding"] = rng.randn(*table.shape).astype(np.float32)
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    model = ProgramExecutor(ExecutorConfig(**cfg_kw), device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(params))
    return jmodel, jvars, model, features, chains


@pytest.fixture(scope="module")
def setup():
    thresholds = np.linspace(0.3, 0.7, CFG["vocab_size"]).astype(np.float32)
    return _pair(CFG) + (thresholds,)


def _assert_margins(model, features, chains, thresholds, cfg_kw=CFG):
    """Run the port's plain runner with a hook and check that every decision
    of an executed step (routing, token argmax, box confidence against its
    threshold) clears its threshold by more than TOL."""
    outs = []
    hook = model.register_forward_hook(lambda _m, _i, out: outs.append(out))
    try:
        ExecutorChainRunner(model, ExecutorConfig(**cfg_kw), MAX_STEPS, thresholds,
                            device="cpu").run(features[chains.image_index], chains)
    finally:
        hook.remove()
    boxes_seen = tokens_seen = 0
    for k, out in enumerate(outs):
        active = torch.from_numpy(chains.num_steps > k)
        if not active.any():
            continue
        routing = out["routing_logits"][active]
        assert float((routing[:, 0] - routing[:, 1]).abs().min()) > TOL
        is_box = routing[:, 0] > routing[:, 1]
        top2 = torch.topk(out["token_logits"][active][~is_box], 2, dim=-1).values
        if len(top2):
            assert float((top2[:, 0] - top2[:, 1]).min()) > TOL
        thr = (torch.full((len(routing),), 0.5) if thresholds is None
               else torch.from_numpy(thresholds)[torch.from_numpy(chains.functions[:, k])][active])
        conf = out["pred_conf"][active][is_box]
        if len(conf):
            assert float((conf - thr[is_box][:, None]).abs().min()) > TOL
        boxes_seen += int(is_box.sum())
        tokens_seen += int((~is_box).sum())
    assert boxes_seen and tokens_seen  # both branches are exercised


def _compare(got, ref, what):
    for key in ("final_tokens", "final_is_token", "token_cache", "token_branch", "box_mask"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{key} ({what})")
    for key in ("box_cache", "conf_cache"):
        np.testing.assert_allclose(got[key], ref[key], atol=TOL, err_msg=f"{key} ({what})")


@pytest.mark.parametrize("per_function", [False, True])
def test_runners_match_jax(setup, per_function):
    jmodel, jvars, model, features, chains, vec = setup
    thresholds = vec if per_function else None
    _assert_margins(model, features, chains, thresholds)
    jrunner = JaxRunner(jmodel, jvars, JaxExecutorConfig(**CFG), max_steps=MAX_STEPS,
                        conf_thresholds=thresholds)
    runner = ExecutorChainRunner(model, ExecutorConfig(**CFG), MAX_STEPS, thresholds,
                                 device="cpu")
    per_question = features[chains.image_index]
    ref = jrunner.run(jnp.asarray(per_question), chains)
    assert ref["box_mask"].any() and ref["token_branch"].any()
    _compare(runner.run(per_question, chains), ref, "run")
    ref_pool = jrunner.run_pool(features, chains, slots=5)
    _compare(ref_pool, ref, "jax pool vs plain")
    _compare(runner.run_pool(features, chains, slots=5), ref_pool, "run_pool")


def test_synth_questions_matches_bench():
    """The numpy copy draws what bench.synth_questions draws; function ids map
    to the same names."""
    cfg = JaxExecutorConfig(**CFG)
    feats, questions, chains = bench.synth_questions(40, cfg, seed=7)
    pfeats, pquestions, pchains = synth_questions(40, ExecutorConfig(**CFG), seed=7)
    np.testing.assert_array_equal(pfeats, feats)
    np.testing.assert_array_equal(pquestions, questions)
    for key in ("image_index", "deps", "num_steps"):
        np.testing.assert_array_equal(getattr(pchains, key), getattr(chains, key), err_msg=key)
    bench_names = {v: k for k, v in bench._FN_IDS.items()}
    port_names = {v: k for k, v in FUNCTION_IDS.items()}
    live = np.arange(chains.functions.shape[1])[None] < chains.num_steps[:, None]
    assert [bench_names[i] for i in chains.functions[live]] == [
        port_names[i] for i in pchains.functions[live]]
    assert not pchains.functions[~live].any()


def test_loop_bounds_and_pool_packing(setup):
    """chained_forward bounded by the deepest chain, on precomputed image
    tokens, gives the full-depth caches; the pool's trip count is at least
    perfect packing and below the plain runner's positions x rows."""
    _jmodel, _jvars, model, features, chains, vec = setup
    cfg = ExecutorConfig(**CFG)
    thresholds = torch.from_numpy(vec)
    fns, deps, steps = (torch.from_numpy(np.asarray(a)).long()
                        for a in (chains.functions, chains.deps, chains.num_steps))
    image = torch.from_numpy(features[chains.image_index])
    full = chained_forward(model, image, fns, deps, steps, cfg, MAX_STEPS,
                           conf_thresholds=thresholds)
    bounded = chained_forward(model, model.precompute_image(image).detach(), fns, deps, steps,
                              cfg, MAX_STEPS, image_precomputed=True,
                              active_steps=int(steps.max()), conf_thresholds=thresholds)
    for name, a, b in zip(full._fields, full, bounded):
        torch.testing.assert_close(b, a, rtol=0, atol=TOL, msg=name)
    slots = 5
    pool, iterations = chained_forward_pool(
        model, torch.from_numpy(features), torch.from_numpy(chains.image_index).long(), fns, deps,
        steps, cfg, MAX_STEPS, slots=slots, return_iterations=True, conf_thresholds=thresholds)
    torch.testing.assert_close(pool.routing, full.routing, rtol=0, atol=0)
    useful = int(steps.sum())
    assert -(-useful // slots) <= iterations
    assert iterations * slots < len(steps) * MAX_STEPS


@pytest.mark.parametrize("per_function", [False, True])
def test_sorted_and_bucketed_match_jax(setup, per_function):
    """run_sorted (several batches, a padded power-of-two tail) and
    run_bucketed (an empty bucket, edges closed by max_steps) equal the JAX
    runner's and the port's ``run``, on numpy and on tensor image tokens."""
    jmodel, jvars, model, features, chains, vec = setup
    thresholds = vec if per_function else None
    jrunner = JaxRunner(jmodel, jvars, JaxExecutorConfig(**CFG), max_steps=MAX_STEPS,
                        conf_thresholds=thresholds)
    runner = ExecutorChainRunner(model, ExecutorConfig(**CFG), MAX_STEPS, thresholds,
                                 device="cpu")
    per_question = features[chains.image_index]
    ref = runner.run(per_question, chains)
    _depth, size, _part, real = plan.plan_sorted(chains.num_steps, 6, 4)[-1]
    assert size > real  # the tail batch carries padding
    buckets = (2, 8, 12, 20)
    assert not (chains.num_steps <= 2).any()  # the first bucket is empty
    jax_sorted = jrunner.run_sorted(jnp.asarray(per_question), chains, batch=6, min_tail=4)
    jax_bucketed = jrunner.run_bucketed(per_question, chains, buckets=buckets)
    _compare(jax_sorted, ref, "jax sorted vs port run")
    _compare(jax_bucketed, ref, "jax bucketed vs port run")
    for images in (per_question, torch.from_numpy(per_question)):
        _compare(runner.run_sorted(images, chains, batch=6, min_tail=4), jax_sorted, "run_sorted")
        _compare(runner.run_bucketed(images, chains, buckets=buckets), jax_bucketed,
                 "run_bucketed")
    out = runner.run_sorted(per_question, chains, batch=6, min_tail=4)
    past = np.arange(MAX_STEPS)[None] >= chains.num_steps[:, None]
    assert not out["token_branch"][past].any() and not out["box_mask"][past].any()
    assert not out["box_cache"][past].any() and not out["token_cache"][past].any()


def test_plans_match_jax():
    """plan_sorted and plan_buckets equal the JAX package's on random depth
    mixes, tails and multiples, and raise where it raises."""
    rng = np.random.RandomState(11)
    for trial in range(40):
        num_steps = rng.randint(1, 28, rng.randint(1, 300))
        batch, min_tail, multiple = rng.choice([4, 16, 64, 128]), rng.choice([1, 4, 32]), rng.choice(
            [1, 2, 3])
        edges = tuple(sorted(rng.choice(np.arange(2, 28), rng.randint(1, 5), replace=False)))
        if trial % 2:
            edges = edges + (27,)
        got_sorted = plan.plan_sorted(num_steps, batch, min_tail, multiple)
        ref_sorted = jax_plan.plan_sorted(num_steps, batch, min_tail, multiple)
        try:
            ref_buckets = jax_plan.plan_buckets(num_steps, batch, edges, min_tail, multiple)
        except ValueError:
            with pytest.raises(ValueError, match="exceed the deepest bucket"):
                plan.plan_buckets(num_steps, batch, edges, min_tail, multiple)
            ref_buckets, got_buckets = [], []
        else:
            got_buckets = plan.plan_buckets(num_steps, batch, edges, min_tail, multiple)
        for got, ref in ((got_sorted, ref_sorted), (got_buckets, ref_buckets)):
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                assert g[0] == r[0] and g[1] == r[1] and g[3] == r[3]
                np.testing.assert_array_equal(g[2], r[2])


ROI_SIM = dict(CFG, roi_sim=True, count_embed=True)


@pytest.mark.parametrize("heads", [1, 4])
def test_roi_sim_count_chains_match_jax(heads):
    """The roi_sim/count_embed executor, chained: the port's run, run_sorted
    and run_pool (whose precomputed image cache carries the sim keys, width
    2d) give the JAX runner's decisions."""
    cfg_kw = dict(ROI_SIM, roi_sim_heads=heads)
    jmodel, jvars, model, features, chains = _pair(cfg_kw, seed=2)
    thresholds = np.linspace(0.3, 0.7, CFG["vocab_size"]).astype(np.float32)
    _assert_margins(model, features, chains, thresholds, cfg_kw)
    jrunner = JaxRunner(jmodel, jvars, JaxExecutorConfig(**cfg_kw), max_steps=MAX_STEPS,
                        conf_thresholds=thresholds)
    runner = ExecutorChainRunner(model, ExecutorConfig(**cfg_kw), MAX_STEPS, thresholds,
                                 device="cpu")
    per_question = features[chains.image_index]
    ref = jrunner.run(jnp.asarray(per_question), chains)
    assert ref["box_mask"].any() and ref["token_branch"].any()
    assert model.precompute_image(torch.from_numpy(features)).shape[-1] == 2 * CFG["d_model"]
    _compare(runner.run(per_question, chains), ref, "run")
    _compare(runner.run_sorted(per_question, chains, batch=8, min_tail=4), ref, "run_sorted")
    _compare(runner.run_pool(features, chains, slots=5), ref, "run_pool")
