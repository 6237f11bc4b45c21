"""The port's training slice against the JAX package on the CPU, in float32.

- One training step of the executor (``executor_roi``,
  ``executor_roi_sim_count``) and of the generator through each package's
  ``build_pipeline`` on the same h5 artifacts: batches equal, loss within
  1e-5 relative, every parameter's gradient within 1e-4 of its tensor's
  max |g| (the JAX side is ``jax.value_and_grad`` of its pipeline's
  ``loss_fn``);
- the optimizer (Adam, AdamW, clipping, staircase decay) against optax on
  fixed gradients, parameters within 1e-6;
- the splits, ``batches`` and ``executor_step_arrays`` equal to JAX's;
- ``Trainer.fit`` then resume equal, bit for bit, to one uninterrupted run;
- an eval forward after ``optimizer.step()`` equal to a fresh module loaded
  with the new ``state_dict``;
- the device rule: the entry points raise without ``device="cpu"`` here.
"""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from explainable_spatial_vqa_tpu.core import artifacts as jart
from explainable_spatial_vqa_tpu.core import config as jconfig
from explainable_spatial_vqa_tpu.train import data as jdata
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu.train.pipelines import build_pipeline as jax_build_pipeline
from explainable_spatial_vqa_tpu.train.trainer import build_optimizer as jax_build_optimizer
from explainable_spatial_vqa_tpu_torch import bench_data
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.train import data as tdata
from explainable_spatial_vqa_tpu_torch.train import datasets as tds
from explainable_spatial_vqa_tpu_torch.train.checkpoints import CheckpointStore
from explainable_spatial_vqa_tpu_torch.train.pipelines import (
    build_pipeline,
    executor_pipeline_from_arrays,
)
from explainable_spatial_vqa_tpu_torch.train.prefetch import prefetch, to_device
from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL_EXECUTOR = dict(d_model=32, num_heads=4, encoder_layers=2, box_decoder_layers=1,
                      num_queries=6, num_image_tokens=4, image_feature_dim=8, max_input_boxes=6,
                      dropout=0.0)
SMALL_GENERATOR = dict(embed_dim=12, hidden_dim=16, encoder_layers=2, decoder_layers=2,
                       dropout=0.0, teacher_forcing=1.0)


def _configs(preset, data, model_kw, batch_size):
    """The preset in both packages, with a small model and the test's files."""
    out = []
    for cfg_mod in (jconfig, tconfig):
        base = cfg_mod.get_preset(preset)
        out.append(base.replace(
            model=dataclasses.replace(base.model, **model_kw),
            data=cfg_mod.DataConfig(**data),
            train=dataclasses.replace(base.train, batch_size=batch_size)))
    return out


@pytest.fixture(scope="module")
def corpus():
    """Annotated synthetic CLEVR questions and their split vocabulary, made
    with the JAX package's own tools."""
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import vocab as voc

    scenes_raw, questions = syn.synthesize_dataset(16, 3, seed=3)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = ann.annotate_questions(questions, scenes)
    return annotated, voc.build_split_vocab(annotated), len(scenes_raw)


@pytest.fixture(scope="module")
def executor_files(corpus, tmp_path_factory):
    annotated, vocab, num_images = corpus
    root = tmp_path_factory.mktemp("executor")
    jart.write_annotated_h5(annotated, str(root / "annotated.h5"))
    with open(root / "vocab3.json", "w") as f:
        json.dump(vocab, f)
    feats = np.random.RandomState(0).rand(num_images, 8, 2, 2).astype(np.float32)
    with h5py.File(root / "features.h5", "w") as f:
        f.create_dataset("features", data=feats)
    return dict(annotated_h5=str(root / "annotated.h5"), features_h5=str(root / "features.h5"),
                split_vocab_json=str(root / "vocab3.json"))


def _noisy_params(params, seed):
    """The JAX parameters with every all-zero leaf (biases, the zero-init
    roi_sim and count channels) given small random values, so that every
    gradient path carries signal."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.05 * rng.randn(*np.shape(p)) if not np.any(p) else 0)
                   ).astype(np.float32), params)


def _check_grads(model, jax_grads):
    """Every gradient within 1e-4 of its tensor's max |g|.  An attention key
    bias adds one constant to a query's scores, which the softmax ignores:
    its gradient is zero, and both packages' are rounding noise, held
    within 1e-6 of the largest gradient of the model instead."""
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_grads))
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    largest = max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        assert got is not None, name
        if name.endswith(".k.bias"):
            assert max(float(got.abs().max()), float(g.abs().max())) <= 1e-6 * largest, name
            continue
        tol = 1e-4 * float(g.abs().max())
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=tol, rtol=0, err_msg=name)


def _first_batches(jpipe, tpipe):
    jbatch = next(iter(jpipe.train_batches(0)))
    tbatch = next(iter(tpipe.train_batches(0)))
    assert set(jbatch) == set(tbatch)
    for key in jbatch:
        np.testing.assert_array_equal(np.asarray(tbatch[key]), np.asarray(jbatch[key]), key)
    return jbatch, to_device(tbatch, CPU)


@pytest.mark.parametrize("preset", ["executor_roi", "executor_roi_sim_count"])
def test_executor_train_step_matches_jax(preset, executor_files):
    jcfg, tcfg = _configs(preset, executor_files, SMALL_EXECUTOR, batch_size=24)
    jpipe = jax_build_pipeline(jcfg)
    tpipe = build_pipeline(tcfg, device="cpu")
    params = _noisy_params(jpipe.params, 1)
    tpipe.model.load_state_dict(flax_to_state_dict(params))
    jbatch, tbatch = _first_batches(jpipe, tpipe)
    assert 0 < tbatch["is_box_branch"].sum() < len(tbatch["is_box_branch"])  # both branches

    (jloss, jmetrics), jgrads = jax.value_and_grad(jpipe.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in jbatch.items()}, jax.random.PRNGKey(0), True)
    tpipe.model.train()
    loss, metrics = tpipe.loss_fn(tpipe.model, tbatch, torch.Generator().manual_seed(0), True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for key, value in jmetrics.items():
        assert int(metrics[key]) == int(value), key
    _check_grads(tpipe.model, jgrads)


@pytest.fixture(scope="module")
def generator_files(tmp_path_factory):
    rng = np.random.RandomState(4)
    questions = rng.randint(4, 30, (40, 11)).astype(np.int32)
    programs = rng.randint(3, 20, (40, 9)).astype(np.int32)
    for i, pad in enumerate(rng.randint(0, 5, 40)):  # <NULL> padding
        questions[i, 11 - pad:] = 0
        programs[i, 9 - pad:] = 0
    programs[:, 0] = 1
    path = str(tmp_path_factory.mktemp("generator") / "questions.h5")
    jart.write_questions_h5(jart.EncodedQuestions(questions, np.arange(40) % 7, np.arange(40),
                                                  programs), path)
    return dict(questions_h5=path)


def test_generator_train_step_matches_jax(generator_files):
    jcfg, tcfg = _configs("generator", generator_files, SMALL_GENERATOR, batch_size=8)
    jpipe = jax_build_pipeline(jcfg)
    tpipe = build_pipeline(tcfg, device="cpu")
    params = _noisy_params(jpipe.params, 2)
    model = tpipe.model
    model.load_state_dict(flax_to_state_dict(params))
    jbatch, tbatch = _first_batches(jpipe, tpipe)

    (jloss, _), jgrads = jax.value_and_grad(jpipe.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in jbatch.items()}, jax.random.PRNGKey(0), True)
    model.train()
    gen = torch.Generator().manual_seed(0)
    loss, _ = tpipe.loss_fn(model, tbatch, gen, True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _check_grads(model, jgrads)

    # teacher forcing 1.0: every logit; 0.0: the tokens greedy decoding picks
    jout = jpipe.model.apply({"params": params}, jnp.asarray(jbatch["questions"]),
                             jnp.asarray(jbatch["programs"]), deterministic=False,
                             rngs={"sample": jax.random.PRNGKey(1),
                                   "dropout": jax.random.PRNGKey(2)})
    with torch.no_grad():
        out = model(tbatch["questions"], tbatch["programs"], generator=gen)
        np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jout["logits"]), atol=1e-5)
        free = model(tbatch["questions"], tbatch["programs"], teacher_forcing=0.0, generator=gen)
        np.testing.assert_array_equal(free["tokens"].numpy(),
                                      model.generate(tbatch["questions"], max_len=9).numpy())


OPTIMS = {
    "adam": dict(learning_rate=1e-2),
    "adamw": dict(learning_rate=1e-2, weight_decay=0.05),
    "clip": dict(learning_rate=1e-2, grad_clip_norm=0.5),
    "clip_inactive": dict(learning_rate=1e-2, grad_clip_norm=1e3),
    "staircase": dict(learning_rate=1e-2, lr_step_size=1, lr_gamma=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_optimizer_matches_optax(name):
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jax_build_optimizer(jconfig.OptimConfig(**OPTIMS[name]), steps_per_epoch=1)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    trainer = Trainer(None, module, tconfig.OptimConfig(**OPTIMS[name]), tconfig.TrainConfig(),
                      steps_per_epoch=1, checkpoint_dir=False, device="cpu")
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        trainer.apply_gradients()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("n,test,val,seed", [(137, 0.1, 0.1, 42), (50, 0.2, 0.1, 3), (9, 0.1, 0.1, 0)])
def test_splits_and_batches_match_jax(n, test, val, seed):
    splits = tdata.train_val_test_split(n, test, val, seed)
    for a, b in zip(splits, jdata.train_val_test_split(n, test, val, seed)):
        np.testing.assert_array_equal(a, b)
    arrays = {"x": np.arange(n * 2).reshape(n, 2), "y": np.arange(n) % 3}
    double = lambda batch: {**batch, "z": batch["x"] * 2}  # noqa: E731
    for kwargs in (dict(shuffle=True, seed=seed, epoch=2), dict(shuffle=False),
                   dict(shuffle=True, epoch=1, drop_last=False, transform=double)):
        got = list(tdata.batches(tdata.Subset(arrays, splits[0]), 4, **kwargs))
        ref = list(jdata.batches(jdata.Subset(arrays, splits[0]), 4, **kwargs))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_executor_step_arrays_match_jax(corpus):
    annotated, vocab, _ = corpus
    for kwargs in (dict(), dict(max_input_boxes=3, max_output_boxes=4, subset_fraction=0.5)):
        got = tds.executor_step_arrays(annotated, vocab["function"], vocab["other"], **kwargs)
        ref = jds.executor_step_arrays(annotated, vocab["function"], vocab["other"], **kwargs)
        assert set(got) == set(ref)
        for key in ref:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], key)
    assert got["is_box_branch"].any() and not got["is_box_branch"].all()
    text = "[0.1 0.2 0.3 0.4] [0.5 0.6 0.7 0.8]"
    np.testing.assert_array_equal(tds.parse_boxes(text), jds.parse_boxes(text))


def _small_executor_pipeline(tmp_path, dtype="auto", **model_kw):
    cfg = tconfig.get_preset("executor_roi")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **{**SMALL_EXECUTOR, **model_kw}),
        optim=tconfig.OptimConfig(learning_rate=3e-3),
        train=tconfig.TrainConfig(batch_size=8, num_epochs=6, patience=10, checkpoint_interval=2,
                                  log_every=0, checkpoint_dir=str(tmp_path / "ckpt"),
                                  dtype=dtype))
    arrays, features = bench_data.synth_executor_steps(160, cfg.model, seed=0)
    return cfg, executor_pipeline_from_arrays(cfg, arrays, features, device="cpu")


def _fit(cfg, pipe, num_epochs):
    trainer = Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, pipe.steps_per_epoch,
                      device="cpu")
    history = trainer.fit(pipe.train_batches, pipe.val_batches, pipe.monitor,
                          num_epochs=num_epochs)
    trainer.store.close()
    return trainer, history


def test_fit_and_resume_bit_exact(tmp_path):
    """Four epochs, then a new trainer resuming to six, equal to six
    uninterrupted epochs; dropout and the grounding noise draw from the
    epoch-keyed generators."""
    noise = dict(dropout=0.1, input_box_noise=0.05, input_box_drop=0.1)
    cfg, pipe = _small_executor_pipeline(tmp_path / "resumed", **noise)
    first, history = _fit(cfg, pipe, 4)
    assert len(history["train"]) == 4 and len(history["val"]) == 4
    mean_loss = [h["loss_sum"] / h["batches"] for h in history["train"]]
    assert mean_loss[-1] < mean_loss[0]
    assert first.epoch == 4 and first.step == 4 * pipe.steps_per_epoch

    cfg, pipe = _small_executor_pipeline(tmp_path / "resumed", **noise)
    resumed, history = _fit(cfg, pipe, 6)
    assert resumed.epoch == 6 and len(history["train"]) == 2

    cfg, pipe = _small_executor_pipeline(tmp_path / "straight", **noise)
    straight, _ = _fit(cfg, pipe, 6)
    for (name, a), (_, b) in zip(resumed.model.state_dict().items(),
                                 straight.model.state_dict().items()):
        assert torch.equal(a, b), name
    assert resumed.best_metric == straight.best_metric
    assert torch.equal(resumed.optimizer.state_dict()["state"][0]["exp_avg_sq"],
                       straight.optimizer.state_dict()["state"][0]["exp_avg_sq"])
    best = resumed.evaluate_best(pipe.val_batches())
    assert best.totals["batches"] == len(list(pipe.val_batches()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_after_step_uses_the_new_weights(tmp_path, dtype):
    """The executor keeps K2's fused weights and its layers' cast weights
    between eval calls; after an optimizer step an eval forward must use
    the stepped weights, as a fresh module loaded with them does."""
    cfg, pipe = _small_executor_pipeline(tmp_path, dtype)
    trainer = Trainer(pipe.loss_fn, pipe.model, cfg.optim, cfg.train, checkpoint_dir=False,
                      device="cpu")
    batch = next(prefetch(pipe.train_batches(0), CPU))
    inputs = [batch[k] for k in ("image", "input_boxes", "input_box_mask", "text", "text_mask")]

    def eval_forward(model):
        model.eval()
        with torch.no_grad():
            return model(*inputs)

    before = eval_forward(pipe.model)  # fills the kept weights
    trainer.train_step(batch, torch.Generator().manual_seed(0))
    after = eval_forward(pipe.model)
    fresh = ProgramExecutor(cfg.model, getattr(torch, dtype), device="cpu")
    fresh.load_state_dict(pipe.model.state_dict())
    reference = eval_forward(fresh)
    for key in reference:
        assert torch.equal(after[key], reference[key]), key
    assert not torch.equal(after["pred_boxes"], before["pred_boxes"])


def test_remat_matches_plain_backward(tmp_path):
    """``remat`` recomputes each fusion block in the backward, dropout
    included: the same loss and gradients as keeping the activations."""
    grads = []
    for remat in (False, True):
        cfg, pipe = _small_executor_pipeline(tmp_path, dropout=0.1, remat=remat)
        batch = next(prefetch(pipe.train_batches(0), CPU))
        pipe.model.train()
        torch.manual_seed(3)
        loss, _ = pipe.loss_fn(pipe.model, batch, torch.Generator().manual_seed(0), True)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in pipe.model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-5, atol=1e-7, msg=name)


def test_metrics_match_jax():
    from explainable_spatial_vqa_tpu.train import metrics as jmetrics
    from explainable_spatial_vqa_tpu_torch.train import metrics as tmetrics

    rng = np.random.RandomState(7)
    logits, answers = rng.randn(12, 5).astype(np.float32), rng.randint(0, 5, 12)
    pred, targets = rng.randint(0, 3, (12, 6)), rng.randint(0, 3, (12, 6))
    lo = rng.rand(12, 4, 2) * 0.6
    boxes = [np.concatenate([lo, lo + rng.rand(12, 4, 2) * 0.4], -1).astype(np.float32)
             for _ in range(2)]
    mask = rng.rand(12, 4) < 0.5
    cases = [("answer_metrics", (logits, answers)), ("program_metrics", (pred, targets)),
             ("masked_token_metrics", (pred, targets)), ("mean_iou", (*boxes, mask)),
             ("mean_iou", tuple(boxes))]
    acc = tmetrics.MetricAccumulator()
    for name, args in cases:
        ref = getattr(jmetrics, name)(*(jnp.asarray(a) for a in args))
        got = getattr(tmetrics, name)(*(torch.from_numpy(a) for a in args))
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-6, err_msg=key)
        acc.update(got)
    acc.update({"answer_correct": torch.tensor(2), "batches": 1})
    correct = int((logits.argmax(-1) == answers).sum())
    assert acc.totals["batches"] == 1.0
    assert acc.ratio("answer_correct", "answer_total") == pytest.approx((correct + 2) / 12)


def test_checkpoint_store_keeps_the_newest(tmp_path):
    store = CheckpointStore(str(tmp_path), max_to_keep=2)
    assert store.latest_step() is None and store.restore() is None
    for step in (1, 2, 3):
        store.save(step, {"w": torch.full((2,), float(step)), "step": step})
    store.save_best({"w": torch.zeros(1)})
    assert store.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["best.pt", "step_2.pt", "step_3.pt"]
    assert store.restore()["step"] == 3 and torch.equal(store.restore(2)["w"], torch.full((2,), 2.0))
    assert torch.equal(store.restore_best()["w"], torch.zeros(1))
    store.close()


def test_prefetch():
    batches = [{"x": np.full(3, i), "n": i} for i in range(10)]
    got = list(prefetch(iter(batches), CPU, depth=3))
    assert [b["n"] for b in got] == list(range(10))
    assert all(isinstance(b["x"], torch.Tensor) and int(b["x"][0]) == b["n"] for b in got)
    assert list(prefetch([], CPU)) == []

    def failing():
        yield {"x": np.zeros(1)}
        raise ValueError("bad batch")

    with pytest.raises(ValueError, match="bad batch"):
        list(prefetch(failing(), CPU))


def test_entry_points_need_cpu_named_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid")
    cfg = tconfig.get_preset("executor_roi")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(None, torch.nn.Linear(2, 2), cfg.optim, cfg.train, checkpoint_dir=False)
    small = cfg.replace(model=dataclasses.replace(cfg.model, **SMALL_EXECUTOR))
    arrays, features = bench_data.synth_executor_steps(16, small.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        executor_pipeline_from_arrays(small, arrays, features)
    for preset in ("transformer_iqap_cot", "multihead"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_pipeline(tconfig.get_preset(preset))
