"""The port's chain runners (``run`` and ``run_pool``) against the JAX
ExecutorChainRunner on CLEVR-shaped chains from ``bench.synth_questions``, in
fp32 on the CPU, with and without a per-function threshold vector."""

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
from explainable_spatial_vqa_tpu.infer.chain import ExecutorChainRunner as JaxRunner  # noqa: E402
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor  # noqa: E402
from explainable_spatial_vqa_tpu_torch.bench_data import FUNCTION_IDS, synth_questions  # noqa: E402
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig  # noqa: E402
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


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxExecutorConfig(**CFG)
    features, _questions, chains = bench.synth_questions(20, jcfg, max_steps=MAX_STEPS, seed=3)
    jmodel = JaxExecutor(jcfg)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 4, 8)), jnp.zeros((2, 4, 4)),
        jnp.ones((2, 4), bool), jnp.zeros((2, 3), jnp.int32), jnp.ones((2, 3), bool))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    # random weights put pred_conf = sigmoid(~0) right on the 0.5 threshold and
    # the 2-way routing logits near a tie: spread both heads before handing the
    # same weights to both packages
    params["box_decoder"]["head_out"]["kernel"] *= 20.0
    params["routing_head"]["kernel"] *= 20.0
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    model = ProgramExecutor(ExecutorConfig(**CFG), device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(params))
    thresholds = np.linspace(0.3, 0.7, CFG["vocab_size"]).astype(np.float32)
    return jmodel, jvars, model, features, chains, thresholds


def _assert_margins(model, features, chains, thresholds):
    """Run the port's plain runner with a hook and check that every decision
    of an executed step (routing, token argmax, box confidence against its
    threshold) clears its threshold by more than TOL."""
    outs = []
    hook = model.register_forward_hook(lambda _m, _i, out: outs.append(out))
    try:
        ExecutorChainRunner(model, ExecutorConfig(**CFG), MAX_STEPS, thresholds,
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
