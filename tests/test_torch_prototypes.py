"""The port's prototype step models against the JAX package on the CPU, in
float32, at small widths, with the JAX models' random weights carried across
by ``convert.py`` (every all-zero leaf given small random values first):

- every model of ``models/prototypes.py``: outputs within 1e-5;
  ``FusedStepEncoder``'s and ``BBoxSelectionPredictor``'s heads on (B, C, H,
  W) grids and on (B, P, C) tokens; ``MultiHeadStepModel`` with its coins all
  False (eval) and all True (``teacher_forcing=1.0``, training);
  ``YoloDetector`` at 64 px; the predicted box fed back through
  ``input_proj`` keeps its gradient (a weight's gradient against
  ``jax.grad`` with the coins all False);
- the three target builders equal to JAX's on v3 step records;
- one step of each prototype preset through each package's
  ``build_pipeline`` on h5 artifacts written with the JAX package's tools:
  batches equal, loss within 1e-5 relative, metrics equal, every gradient
  within 1e-5 of its tensor's max |g|;
- ``HierarchicalGenerator`` at head dim 128 reaches K2 (and K1, on the
  one-token start query) in eval mode, never in a train step;
- the eight presets equal JAX's field for field; ``train --device cpu``
  trains each for two epochs, the loss finite and the second epoch's at
  most 1.2x the first's (the JAX package's bound,
  ``tests/test_prototype_presets.py``).
"""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core import config as jconfig
from explainable_spatial_vqa_tpu.models import prototypes as jproto
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu.train.pipelines import build_pipeline as jax_build_pipeline
from explainable_spatial_vqa_tpu_torch.cli.main import main
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models import prototypes as tproto
from explainable_spatial_vqa_tpu_torch.train import datasets as tds
from explainable_spatial_vqa_tpu_torch.train.pipelines import build_pipeline
from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device

torch.set_num_threads(1)

CPU = torch.device("cpu")
PRESETS = ("token_only", "bb_only", "bb_only_iou", "yolo_bb", "multitask_bb", "bbinout",
           "multihead", "hierarchical")
C, H, W = 16, 2, 3  # the features' grid
NARROW = dict(image_feature_dim=C, image_spatial=(H, W), num_image_tokens=H * W, image_size=64)


def _noisy(params, seed):
    """Every all-zero leaf (the biases) given small random values, so that
    every gradient path carries signal."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.05 * rng.randn(*np.shape(p)) if not np.any(p) else 0)
                   ).astype(np.float32), params)


def _port(module, params):
    module.load_state_dict(flax_to_state_dict(params))
    return module


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=tol * max(1.0, np.abs(ref).max()),
                               rtol=0)


def _step_inputs(rng, b=5, s=4, grid=True):
    image = rng.rand(b, C, H, W) if grid else rng.rand(b, H * W, C)
    corner = rng.uniform(0, 0.6, (b, s, 2))
    return (image.astype(np.float32), rng.randint(1, 9, b).astype(np.int32),
            np.concatenate([corner, corner + 0.3], -1).astype(np.float32))


FUSED = {
    "token_only": (lambda: jproto.TokenOnlyPredictor(token_vocab_size=7, function_vocab_size=9,
                                                     max_input_boxes=4),
                   lambda: tproto.TokenOnlyPredictor(7, 9, 4, C, device="cpu")),
    "bb_only": (lambda: jproto.BBoxOnlyPredictor(max_output_boxes=3, function_vocab_size=9,
                                                 max_input_boxes=4),
                lambda: tproto.BBoxOnlyPredictor(3, 9, 4, C, device="cpu")),
    "multitask_bb": (lambda: jproto.MultiTaskBBoxTokenPredictor(
        max_output_boxes=3, token_vocab_size=7, function_vocab_size=9, max_input_boxes=4),
        lambda: tproto.MultiTaskBBoxTokenPredictor(3, 7, 9, 4, C, device="cpu")),
    "selection": (lambda: jproto.BBoxSelectionPredictor(function_vocab_size=9,
                                                        max_input_boxes=4),
                  lambda: tproto.BBoxSelectionPredictor(9, max_input_boxes=4,
                                                        image_feature_dim=C, device="cpu")),
}


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "tokens"])
@pytest.mark.parametrize("name", sorted(FUSED))
def test_fused_models_match_jax(name, grid):
    make_jax, make_port = FUSED[name]
    inputs = _step_inputs(np.random.RandomState(1), grid=grid)
    jmodel = make_jax()
    params = _noisy(jmodel.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))["params"], 2)
    ref = jmodel.apply({"params": params}, *map(jnp.asarray, inputs))
    got = _port(make_port(), params)(*map(torch.from_numpy, inputs))
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for key in ref:
            _close(got[key], ref[key])
    else:
        _close(got, ref)


def _multihead(rng, teacher_forcing):
    kw = dict(vocab_size=11, embed_dim=12, hidden_dim=24, image_feat_dim=C, image_spatial=(H, W),
              max_bbox_steps=4, teacher_forcing=teacher_forcing)
    b = 5
    corner = rng.uniform(0, 0.6, (b, 4, 2))
    inputs = (rng.randint(1, 11, b).astype(np.int32), rng.randint(0, 11, (b, 2)).astype(np.int32),
              rng.rand(b, C, H, W).astype(np.float32),
              np.concatenate([corner, corner + 0.3], -1).astype(np.float32))
    jmodel = jproto.MultiHeadStepModel(**kw)
    params = _noisy(jmodel.init({"params": jax.random.PRNGKey(0),
                                 "sample": jax.random.PRNGKey(1)},
                                *map(jnp.asarray, inputs), deterministic=False)["params"], 3)
    port = _port(tproto.MultiHeadStepModel(**kw, device="cpu"), params)
    return jmodel, params, port, inputs


@pytest.mark.parametrize("coins", ["all_false", "all_true"])
def test_multihead_matches_jax(coins):
    """Eval: no teacher box is fed; training at teacher_forcing 1.0: JAX's
    bernoulli(p=1) and the port's coins are all True, every step fed the
    teacher's box."""
    teach = coins == "all_true"
    jmodel, params, port, inputs = _multihead(np.random.RandomState(4), 1.0 if teach else 0.5)
    ref = jmodel.apply({"params": params}, *map(jnp.asarray, inputs), deterministic=not teach,
                       rngs={"sample": jax.random.PRNGKey(7)})
    port.train(teach)
    got = port(*map(torch.from_numpy, inputs), generator=torch.Generator().manual_seed(0))
    assert set(got) == set(ref)
    for key in ref:
        _close(got[key], ref[key])


def test_multihead_feeds_the_predicted_box_with_its_gradient():
    """With the coins all False the box fed back keeps its gradient: the
    gradient of the last step's boxes with respect to ``box_out`` equals
    jax.grad's, and differs from the one with the fed box detached."""
    jmodel, params, port, inputs = _multihead(np.random.RandomState(5), 0.5)

    def jax_loss(p):
        return jnp.sum(jmodel.apply({"params": p}, *map(jnp.asarray, inputs))["bbox"][:, -1])

    ref = jax.grad(jax_loss)(params)["box_out"]["kernel"]

    def box_out_grad():
        port.zero_grad()
        port(*map(torch.from_numpy, inputs))["bbox"][:, -1].sum().backward()
        return port.box_out.weight.grad.T.clone()

    port.eval()
    _close(box_out_grad(), ref)
    project = port.input_proj.forward
    port.input_proj.forward = lambda x: project(x.detach())
    assert not np.allclose(box_out_grad().numpy(), np.asarray(ref), atol=1e-6)


def test_hierarchical_matches_jax():
    rng = np.random.RandomState(6)
    kw = dict(d_model=32, num_heads=4, num_layers=2, num_image_tokens=6, image_feature_dim=C,
              max_inner_steps=4)
    image, boxes = rng.rand(3, 6, C).astype(np.float32), rng.rand(3, 4, 4).astype(np.float32)
    jmodel = jproto.HierarchicalGenerator(**kw)
    params = _noisy(jmodel.init(jax.random.PRNGKey(0), image, boxes)["params"], 4)
    port = _port(tproto.HierarchicalGenerator(**kw, device="cpu"), params)
    for gt in (boxes, None):
        ref = jmodel.apply({"params": params}, image, gt)
        got = port(torch.from_numpy(image), None if gt is None else torch.from_numpy(gt))
        assert set(got) == set(ref)
        for key in ref:
            _close(got[key], ref[key])


def test_yolo_matches_jax():
    rng = np.random.RandomState(7)
    images = rng.rand(2, 64, 64, 3).astype(np.float32)
    jmodel = jproto.YoloDetector(grid=7)
    params = _noisy(jmodel.init(jax.random.PRNGKey(0), images)["params"], 5)
    ref = jmodel.apply({"params": params}, images)
    got = _port(tproto.YoloDetector(grid=7, image_size=64, device="cpu"), params)(
        torch.from_numpy(images))
    assert got.shape == (2, 7, 7, 5)
    _close(got, ref)
    target = np.zeros((2, 7, 7, 5), np.float32)
    target[0, 3, 2] = (0.4, 0.6, 0.2, 0.1, 1.0)
    np.testing.assert_allclose(
        float(tproto.yolo_grid_loss(got, torch.from_numpy(target))),
        float(jproto.yolo_grid_loss(ref, jnp.asarray(target))), rtol=1e-5)


def test_compositional_matches_jax():
    rng = np.random.RandomState(8)
    kw = dict(d_model=16, question_vocab_size=30, prog_vocab_size=20, num_functions=5)
    b = 4
    q = rng.randint(0, 30, (b, 6)).astype(np.int32)
    q[0] = 0  # an all-padding row: the count clamps to 1
    inputs = (rng.rand(b, C, H, W).astype(np.float32), q, rng.rand(b, 3, 4).astype(np.float32),
              rng.rand(b, 3) < 0.5, rng.randint(0, 20, (b, 5)).astype(np.int32))
    jmodel = jproto.CompositionalStepPredictor(**kw)
    params = _noisy(jmodel.init(jax.random.PRNGKey(0), *inputs)["params"], 6)
    ref = jmodel.apply({"params": params}, *inputs)
    got = _port(tproto.CompositionalStepPredictor(**kw, image_feature_dim=C, device="cpu"),
                params)(*map(torch.from_numpy, inputs))
    for key in ref:
        _close(got[key], ref[key])


# ---------------------------------------------------------------------------
# targets, pipelines, presets, CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """v3 annotations of the synthetic corpus with their split vocabulary,
    (24, 16, 2, 3) features and 64 px PNGs, written with the JAX package's
    tools."""
    from PIL import Image

    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import vocab as voc
    from explainable_spatial_vqa_tpu.core.artifacts import write_annotated_h5

    root = tmp_path_factory.mktemp("proto")
    scenes_raw, questions = syn.synthesize_dataset(24, 4, seed=7)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = ann.annotate_questions(questions, scenes)
    split = voc.build_split_vocab(annotated)
    write_annotated_h5(annotated, str(root / "annotated.h5"))
    voc.save_vocab(split, str(root / "split_vocab.json"))
    rng = np.random.RandomState(0)
    with h5py.File(root / "features.h5", "w") as f:
        f.create_dataset("features", data=rng.rand(len(scenes_raw), C, H, W).astype(np.float32))
    (root / "images").mkdir()
    for i in range(len(scenes_raw)):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
            root / "images" / f"CLEVR_val_{i:06d}.png")
    paths = dict(annotated_h5=str(root / "annotated.h5"),
                 split_vocab_json=str(root / "split_vocab.json"),
                 features_h5=str(root / "features.h5"), image_dir=str(root / "images"))
    return paths, annotated, split


@pytest.mark.parametrize("builder", ["multihead_typed_targets", "selection_targets",
                                     "yolo_grid_targets"])
def test_target_builders_equal_jax(builder, files):
    _, annotated, split = files
    arrays = jds.executor_step_arrays(annotated, split["function"], split["other"],
                                      max_input_boxes=18, max_output_boxes=10)
    if builder == "multihead_typed_targets":
        ref = jds.multihead_typed_targets(arrays, split["function"], split["other"])
        got = tds.multihead_typed_targets(arrays, split["function"], split["other"])
        assert set(got) == set(ref) and len(set(ref["head_id"].tolist())) >= 4
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
            assert got[key].dtype == ref[key].dtype
    elif builder == "selection_targets":
        ref = jds.selection_targets(arrays)
        got = tds.selection_targets(arrays)
        assert 0 < ref.sum() < arrays["input_box_mask"].sum()
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    else:
        for grid in (7, 5):
            ref = jds.yolo_grid_targets(arrays["target_boxes"], arrays["target_box_mask"], grid)
            got = tds.yolo_grid_targets(arrays["target_boxes"], arrays["target_box_mask"], grid)
            assert ref[..., 4].sum() > 0
            np.testing.assert_array_equal(got, ref)


def _configs(preset, files, batch_size=8):
    paths, _, _ = files
    out = []
    for cfg_mod in (jconfig, tconfig):
        base = cfg_mod.PRESETS[preset]
        out.append(base.replace(
            model=dataclasses.replace(base.model, **NARROW), data=cfg_mod.DataConfig(**paths),
            train=dataclasses.replace(base.train, batch_size=batch_size, log_every=0)))
    return out


@pytest.mark.parametrize("preset", PRESETS)
def test_train_step_matches_jax(preset, files):
    jcfg, tcfg = _configs(preset, files)
    jpipe, tpipe = jax_build_pipeline(jcfg), build_pipeline(tcfg, device="cpu")
    assert tpipe.monitor == jpipe.monitor
    params = _noisy(jpipe.params, 1)
    model = tpipe.model
    model.load_state_dict(flax_to_state_dict(params))
    jbatch = next(iter(jpipe.train_batches(0)))
    tbatch = next(iter(tpipe.train_batches(0)))
    assert set(jbatch) == set(tbatch)
    for key in jbatch:
        np.testing.assert_array_equal(np.asarray(tbatch[key]), np.asarray(jbatch[key]), key)

    train = preset != "multihead"  # eval draws no coin; the others have no randomness
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jpipe.loss_fn, has_aux=True),
                                       static_argnums=3)(
        params, {k: jnp.asarray(v) for k, v in jbatch.items()}, jax.random.PRNGKey(0), train)
    model.train(train)
    loss, metrics = tpipe.loss_fn(model, to_device(tbatch, CPU), torch.Generator().manual_seed(0),
                                  train)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5, err_msg=key)

    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    for name, g in ref.items():
        got = named[name].grad
        if name.endswith(".k.bias"):  # softmax ignores a constant shift: zero, up to noise
            assert got is None or float(got.abs().max()) <= 1e-6, name
            continue
        if not g.abs().max():  # a parameter no loss term reaches in this batch
            assert got is None or not got.abs().max(), name
            continue
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-5 * float(g.abs().max()),
                                   rtol=0, err_msg=name)


def _spied(monkeypatch):
    calls = {"K2": 0, "K1": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return wrapped

    monkeypatch.setattr(layers, "fused_encoder_block", spy("K2", layers.fused_encoder_block))
    monkeypatch.setattr(layers, "fused_attention", spy("K1", layers.fused_attention))
    return calls


def test_hierarchical_routes_to_k2_only_in_eval(monkeypatch):
    """d 512, 4 heads (head dim 128): an eval forward runs each encoder layer
    on K2 (2) and each decoder layer's self-attention on the one-token start
    query on K1 (2, JAX's rule: same length, a (1, 1, 1, 1) mask); a train
    step in train mode reaches neither, and its gradients exist."""
    calls = _spied(monkeypatch)
    model = layers.init_parameters(tproto.HierarchicalGenerator(
        d_model=512, num_heads=4, num_layers=2, image_feature_dim=C, max_inner_steps=3,
        device="cpu"), 0)
    rng = np.random.RandomState(9)
    image = torch.from_numpy(rng.rand(2, 5, C).astype(np.float32))
    boxes = torch.from_numpy(rng.rand(2, 3, 4).astype(np.float32))
    with torch.no_grad():
        model.eval()(image, boxes)
    assert calls == {"K2": 2, "K1": 2}
    calls.update(K2=0, K1=0)
    model.train()
    out = model(image, boxes)
    (out["pred_boxes"].sum() + out["type_logits"].sum()).backward()
    assert calls == {"K2": 0, "K1": 0}
    assert model.encoder.blocks[0].attn.q.weight.grad.abs().max() > 0


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_equal_jax(preset):
    got, ref = tconfig.get_preset(preset), jconfig.get_preset(preset)
    assert type(got.model).__name__ == type(ref.model).__name__ == "PrototypeStepConfig"
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.model_family == "prototype_step"


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_trains_two_epochs(preset, files, tmp_path, monkeypatch):
    paths, _, _ = files
    monkeypatch.setattr(tconfig, "get_preset",
                        lambda name: _configs(name, files, batch_size=16)[1])
    history = tmp_path / "history.json"
    args = ["--device", "cpu", "train", "--preset", preset, "--annotated_h5",
            paths["annotated_h5"], "--split_vocab_json", paths["split_vocab_json"],
            "--features_h5", paths["features_h5"], "--epochs", "2", "--checkpoint_dir",
            str(tmp_path / "ckpt"), "--history_json", str(history)]
    if preset == "yolo_bb":
        args += ["--image_dir", paths["image_dir"]]
    main(args)
    with open(history) as f:
        record = json.load(f)
    losses = [e["loss_sum"] / e["batches"] for e in record["train"]]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert losses[-1] <= 1.2 * losses[0], losses
