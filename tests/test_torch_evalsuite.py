"""The port's evaluation suite against the JAX package on the CPU, in float32.

- detection (IoU, greedy matching, ``DetectionTally``), accuracy by question
  type, program accuracy and ``calibrate_conf_threshold``: equal outputs on
  seeded numpy inputs;
- the per-step tally on predicted chains, both calibrators and the
  threshold vector: equal tallies and maps on the same ``run_out``, whose
  confidences lie at least 1e-3 from every threshold the tally and the
  calibrators apply;
- ``chain_arrays`` equal to JAX's on records from its synthetic tools, with
  truncation;
- ``evaluate_executor_steps`` equal per-function counts to JAX's on the same
  weights, with every confidence more than 1e-5 from the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig
from explainable_spatial_vqa_tpu.evalsuite import accuracy as jacc
from explainable_spatial_vqa_tpu.evalsuite import detection as jdet
from explainable_spatial_vqa_tpu.evalsuite import executor_eval as jeval
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.evalsuite import accuracy as tacc
from explainable_spatial_vqa_tpu_torch.evalsuite import detection as tdet
from explainable_spatial_vqa_tpu_torch.evalsuite import executor_eval as teval
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.train import datasets as tds

torch.set_num_threads(1)

GRID = np.linspace(0.05, 0.95, 19)  # the calibrators' scan


@pytest.fixture(scope="module")
def corpus():
    """Annotated synthetic CLEVR questions and their split vocabulary, made
    with the JAX package's own tools."""
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import vocab as voc

    scenes_raw, questions = syn.synthesize_dataset(24, 4, seed=5)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = ann.annotate_questions(questions, scenes)
    return annotated, voc.build_split_vocab(annotated), len(scenes_raw)


def _boxes(rng, n):
    lo = rng.rand(n, 2) * 0.7
    return np.concatenate([lo, lo + 0.05 + rng.rand(n, 2) * 0.25], -1).astype(np.float32)


def test_detection_and_accuracy_match_jax():
    rng = np.random.RandomState(0)
    jtally, ttally = jdet.DetectionTally(), tdet.DetectionTally()
    for step in range(60):
        pred, gt = _boxes(rng, rng.randint(0, 8)), _boxes(rng, rng.randint(0, 6))
        if len(gt) and len(pred):  # some predictions close to their targets
            k = min(len(pred), len(gt))
            pred[:k] = gt[:k] + rng.randn(k, 4).astype(np.float32) * 0.02
        np.testing.assert_array_equal(tdet.box_iou_matrix(pred, gt), jdet.box_iou_matrix(pred, gt))
        for thr in (0.3, 0.5, 0.7):
            assert tdet.greedy_box_match(pred, gt, thr) == jdet.greedy_box_match(pred, gt, thr)
        fn = ["filter_color[red]", "relate[left]", "scene"][step % 3]
        jtally.add_box_step(fn, pred, gt)
        ttally.add_box_step(fn, pred, gt)
        token = ["count", "exist[]", "query_shape"][step % 3]
        jtally.add_token_step(token, step % 4, step % 3)
        ttally.add_token_step(token, step % 4, step % 3)
    assert ttally.precision_recall() == jtally.precision_recall()
    assert ttally.token_accuracy() == jtally.token_accuracy()
    assert ttally.report() == jtally.report()

    confs = rng.rand(300)
    tps = rng.rand(300) < confs  # confident predictions hit more often
    for kwargs in (dict(), dict(total_gt=400), dict(thresholds=np.linspace(0.1, 0.9, 7))):
        assert tdet.calibrate_conf_threshold(confs, tps, **kwargs) == \
            jdet.calibrate_conf_threshold(confs, tps, **kwargs)

    finals = ["count", "exist", "equal_integer", "less_than", "equal_color[]", "query_size",
              "query_color", "unique", "relate[front]"]
    functions = [finals[i % len(finals)] for i in range(50)]
    pred_answers, gt_answers = rng.randint(0, 4, 50), rng.randint(0, 4, 50)
    assert [tacc.question_type(f) for f in finals] == [jacc.question_type(f) for f in finals]
    assert tacc.answer_accuracy_by_type(pred_answers, gt_answers, functions) == \
        jacc.answer_accuracy_by_type(pred_answers, gt_answers, functions)
    programs = rng.randint(0, 5, (30, 9))
    guesses = np.where(rng.rand(30, 9) < 0.8, programs, rng.randint(0, 5, (30, 9)))
    guesses[:6] = programs[:6]
    assert tacc.program_accuracy(guesses, programs) == jacc.program_accuracy(guesses, programs)
    assert tacc.answer_accuracy_by_type([], [], []) == jacc.answer_accuracy_by_type([], [], [])


def _run_out(corpus, seed=0, max_steps=28):
    """A chain run's caches on the corpus's questions: box steps hold
    jittered ground-truth boxes and random ones, confidences on odd
    multiples of 1/400 (never within 1e-3 of a threshold of the 0.05 grid
    or of 0.5), token steps a right or a random token or none (routed to
    the box branch)."""
    annotated, vocab, _ = corpus
    rng = np.random.RandomState(seed)
    n, q = len(annotated), 10
    out = {"box_cache": np.zeros((n, max_steps, q, 4), np.float32),
           "conf_cache": np.zeros((n, max_steps, q), np.float32),
           "token_cache": np.zeros((n, max_steps), np.int32),
           "token_branch": np.zeros((n, max_steps), bool)}
    for i, record in enumerate(annotated):
        steps = tds._parse_question_steps(record, vocab["function"], vocab["other"])
        for k, p in enumerate(steps[:max_steps]):
            if p["is_box"]:
                boxes = _boxes(rng, q)
                gt = p["target_boxes"][:q]
                hit = rng.rand(len(gt)) < 0.7
                boxes[:len(gt)][hit] = gt[hit] + rng.randn(int(hit.sum()), 4) * 0.01
                out["box_cache"][i, k] = boxes
                out["conf_cache"][i, k] = (2 * rng.randint(0, 200, q) + 1) / 400.0
            else:
                out["token_branch"][i, k] = rng.rand() < 0.9
                out["token_cache"][i, k] = (p["token_id"] if rng.rand() < 0.5
                                            else rng.randint(0, len(vocab["other"])))
    return out


def test_chain_tally_and_calibration_match_jax(corpus):
    annotated, vocab, _ = corpus
    fv, ov = vocab["function"], vocab["other"]
    run_out = _run_out(corpus)
    conf = run_out["conf_cache"][run_out["conf_cache"] > 0]
    assert np.abs(conf[:, None] - GRID[None]).min() > 1e-3  # no threshold decides by rounding

    thr, f1 = teval.calibrate_chain_conf_threshold(run_out, annotated, fv, ov)
    assert (thr, f1) == jeval.calibrate_chain_conf_threshold(run_out, annotated, fv, ov)
    assert 0 < f1 < 1
    for min_preds in (50, 5000):
        got = teval.calibrate_chain_conf_thresholds_per_function(
            run_out, annotated, fv, ov, iou_threshold=0.4, min_preds=min_preds)
        assert got == jeval.calibrate_chain_conf_thresholds_per_function(
            run_out, annotated, fv, ov, iou_threshold=0.4, min_preds=min_preds)
    thr_map, _ = teval.calibrate_chain_conf_thresholds_per_function(run_out, annotated, fv, ov)
    assert len(thr_map) > 2 and len(set(thr_map.values())) > 1  # several operating points
    for default in (0.5, 0.3):
        np.testing.assert_array_equal(
            teval.build_conf_threshold_vector(fv, thr_map, default),
            jeval.build_conf_threshold_vector(fv, thr_map, default))
        np.testing.assert_array_equal(teval.build_conf_threshold_vector(fv, {}, default),
                                      jeval.build_conf_threshold_vector(fv, {}, default))
    for conf_threshold, kwargs in ((0.5, {}), (thr, dict(iou_threshold=0.3)),
                                   (thr_map, {}), ({"filter_color": 0.8}, dict(max_steps=5))):
        got = teval.tally_predicted_chains(run_out, annotated, fv, ov, conf_threshold, **kwargs)
        ref = jeval.tally_predicted_chains(run_out, annotated, fv, ov, conf_threshold, **kwargs)
        assert got.precision_recall() == ref.precision_recall()
        assert got.token_accuracy() == ref.token_accuracy()
        assert got.report() == ref.report()
    empty = {k: np.zeros_like(v) for k, v in run_out.items()}
    assert teval.calibrate_chain_conf_threshold(empty, annotated[:0], fv, ov) == (0.5, 0.0)
    assert teval.calibrate_chain_conf_thresholds_per_function(empty, annotated[:0], fv, ov) == \
        ({"__global__": 0.5}, {"__global__": 0.0})


def test_chain_arrays_match_jax(corpus):
    annotated, vocab, _ = corpus
    depths = [len(q["annotated_program"]) for q in annotated]
    for max_steps in (28, int(np.median(depths))):
        got = tds.chain_arrays(annotated, vocab["function"], max_steps)
        ref = jds.chain_arrays(annotated, vocab["function"], max_steps)
        for key in ("image_index", "functions", "deps", "num_steps"):
            assert getattr(got, key).dtype == getattr(ref, key).dtype, key
            np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), key)
        assert got.answers == ref.answers and got.truncated == ref.truncated
    assert got.truncated > 0


def test_evaluate_executor_steps_matches_jax(corpus):
    """The same weights in both packages, the confidence head scaled by 4 so
    that confidences spread: equal per-function counts."""
    annotated, vocab, num_images = corpus
    cfg = dict(vocab_size=64, d_model=32, num_heads=4, encoder_layers=2, box_decoder_layers=1,
               num_queries=6, num_image_tokens=4, image_feature_dim=8, max_input_boxes=6,
               token_classes=48, box_roi=True)
    jmodel = JaxExecutor(JaxExecutorConfig(**cfg))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 8)), jnp.zeros((2, 6, 4)),
                            jnp.ones((2, 6), bool), jnp.zeros((2, 3), jnp.int32),
                            jnp.ones((2, 3), bool))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["box_decoder"]["head_out"]["kernel"][:, 4] *= 4.0
    model = ProgramExecutor(ExecutorConfig(**cfg), device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    model.train()  # evaluation runs deterministic whatever the caller's mode

    arrays = tds.executor_step_arrays(annotated, vocab["function"], vocab["other"],
                                      max_input_boxes=6, max_output_boxes=6)
    features = np.random.RandomState(1).rand(num_images, 4, 8).astype(np.float32)
    batches = [{**{k: v[s:s + 64] for k, v in arrays.items()},
                "image": features[arrays["image_index"][s:s + 64]]}
               for s in range(0, len(arrays["text"]), 64)]
    names = {i: name for name, i in vocab["function"].items()}

    confs = []
    hook = model.register_forward_hook(lambda _m, _i, out: confs.append(out["pred_conf"]))
    try:
        got = teval.evaluate_executor_steps(model, batches, names, device="cpu")
    finally:
        hook.remove()
    assert model.training
    conf = torch.cat([c.flatten() for c in confs])
    assert float((conf - 0.5).abs().min()) > 1e-5
    assert 0.05 < float((conf >= 0.5).float().mean()) < 0.95  # both sides of the threshold
    ref = jeval.evaluate_executor_steps(jmodel, {"params": params}, batches, names)
    for counts in ("box_tp", "box_pred", "box_gt", "token_correct", "token_total"):
        assert dict(getattr(got, counts)) == dict(getattr(ref, counts)), counts
    assert sum(got.box_pred.values()) > 0 and sum(got.token_total.values()) > 0
