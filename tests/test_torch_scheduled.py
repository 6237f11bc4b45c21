"""The port's chain-level scheduled sampling against the JAX package on the
CPU, in float32, and the chained passes' determinism.

- ``schedule_p``, ``gt_chain_state`` and ``executor_chain_step_arrays``
  equal to JAX's;
- the scheduled loss and its gradients against ``jax.value_and_grad`` at
  p=0 and p=1 (dropout 0, no noise): loss within 1e-5 relative, every
  gradient within 1e-4 of its tensor's max |g|; the port's loops stop at the
  batch's deepest chain, below the batch's ``max_steps``, and JAX's run all
  of them.  At p=1 every decision of the chained pass (routing, token argmax,
  confidence against its threshold) clears its threshold by more than 1e-5;
- the ``executor_scheduled`` pipeline's batches equal JAX's on the same h5
  files;
- ``chained_forward`` in train mode with dropout equals its eval-mode
  result and gives the caller its mode back; a runner built before
  ``model.train()`` serves deterministic; a scheduled train step enters the
  K2 and K1 wrappers from its chained pass only.
"""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core import artifacts as jart
from explainable_spatial_vqa_tpu.core import config as jconfig
from explainable_spatial_vqa_tpu.infer.chain import gather_step_inputs as jax_gather_step_inputs
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu.train import scheduled as jsched
from explainable_spatial_vqa_tpu.train.pipelines import build_pipeline as jax_build_pipeline
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from explainable_spatial_vqa_tpu_torch.infer.chain import (
    ExecutorChainRunner,
    chained_forward,
    gather_step_inputs,
)
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.train import datasets as tds
from explainable_spatial_vqa_tpu_torch.train import scheduled as tsched
from explainable_spatial_vqa_tpu_torch.train.pipelines import build_pipeline
from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device

torch.set_num_threads(1)

CPU = torch.device("cpu")
SMALL = dict(vocab_size=64, d_model=32, num_heads=4, encoder_layers=2, box_decoder_layers=1,
             num_queries=6, num_image_tokens=4, image_feature_dim=8, max_input_boxes=6,
             token_classes=48, dropout=0.0)
MAX_STEPS = 16
MARGIN = 1e-5


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


def _pair(seed=0, **model_kw):
    """The JAX executor's parameters, every zero leaf given small values
    and the confidence and routing heads scaled by 4 so that the chained
    pass's decisions spread away from their thresholds, and the port's
    executor with the same weights."""
    cfg = dict(SMALL, **model_kw)
    jmodel = JaxExecutor(jconfig.ExecutorConfig(**cfg))
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, 4, 8)), jnp.zeros((2, 6, 4)),
                            jnp.ones((2, 6), bool), jnp.zeros((2, 3), jnp.int32),
                            jnp.ones((2, 3), bool))
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.05 * rng.randn(*np.shape(p)) if not np.any(p) else 0)
                   ).astype(np.float32), variables["params"])
    params["box_decoder"]["head_out"]["kernel"][:, 4] *= 4.0
    params["routing_head"]["kernel"] *= 4.0
    model = ProgramExecutor(tconfig.ExecutorConfig(**cfg), device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    return jmodel, params, model, cfg


def _batch(corpus, n=8):
    annotated, vocab, _ = corpus
    arrays = tds.executor_chain_step_arrays(annotated, vocab["function"], vocab["other"],
                                            max_steps=MAX_STEPS,
                                            max_output_boxes=SMALL["num_queries"])
    batch = {k: v[:n] for k, v in arrays.items()}
    batch["image"] = np.random.RandomState(0).rand(n, 4, 8).astype(np.float32)
    return batch


def test_parsers_and_gt_state_match_jax(corpus):
    annotated, vocab, _ = corpus
    for kwargs in (dict(), dict(max_steps=6, max_output_boxes=4, subset_fraction=0.5)):
        got = tds.executor_chain_step_arrays(annotated, vocab["function"], vocab["other"],
                                             **kwargs)
        ref = jds.executor_chain_step_arrays(annotated, vocab["function"], vocab["other"],
                                             **kwargs)
        assert set(got) == set(ref)
        for key in ref:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], key)
    for epoch in range(8):
        for p_max, ramp in ((0.5, 5), (0.0, 5), (0.8, 0), (1.0, 3)):
            kw = dict(scheduled_p_max=p_max, scheduled_ramp_epochs=ramp)
            assert tsched.schedule_p(epoch, tconfig.ExecutorConfig(**kw)) == jsched.schedule_p(
                epoch, jconfig.ExecutorConfig(**kw))
    batch = _batch(corpus, n=24)
    cfg_kw = dict(max_input_boxes=SMALL["max_input_boxes"], num_queries=SMALL["num_queries"])
    got = tsched.gt_chain_state(to_device(batch, CPU), tconfig.ExecutorConfig(**cfg_kw))
    ref = jsched.gt_chain_state({k: jnp.asarray(v) for k, v in batch.items()},
                                jconfig.ExecutorConfig(**cfg_kw))
    for name, a, b in zip(got._fields, got, ref):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    # the ground-truth caches feed each step its dependencies' inputs
    for k in range(MAX_STEPS):
        args = (batch["functions"][:, k], batch["deps"][:, k, 0], batch["deps"][:, k, 1])
        for a, b in zip(gather_step_inputs(got, *(torch.from_numpy(x) for x in args),
                                           SMALL["max_input_boxes"]),
                        jax_gather_step_inputs(ref, *(jnp.asarray(x) for x in args),
                                               SMALL["max_input_boxes"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_decision_margins(model, batch, cfg):
    """Every decision of the chained pass clears its threshold by more than
    MARGIN: the port and JAX cannot take different branches."""
    outs = []
    hook = model.register_forward_hook(lambda _m, _i, out: outs.append(out))
    try:
        tb = to_device(batch, CPU)
        chained_forward(model, model.precompute_image(tb["image"]), tb["functions"], tb["deps"],
                        tb["num_steps"], tconfig.ExecutorConfig(**cfg), MAX_STEPS,
                        image_precomputed=True)
    finally:
        hook.remove()
    boxes = tokens = 0
    for k, out in enumerate(outs):
        active = torch.from_numpy(batch["num_steps"] > k)
        if not active.any():
            continue
        routing = out["routing_logits"][active]
        assert float((routing[:, 0] - routing[:, 1]).abs().min()) > MARGIN
        is_box = routing[:, 0] > routing[:, 1]
        top2 = torch.topk(out["token_logits"][active][~is_box], 2, dim=-1).values
        if len(top2):
            assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
        conf = out["pred_conf"][active][is_box]
        if len(conf):
            assert float((conf - 0.5).abs().min()) > MARGIN
        boxes += int(is_box.sum())
        tokens += int((~is_box).sum())
    assert boxes and tokens


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_scheduled_loss_and_grads_match_jax(corpus, p):
    jmodel, params, model, cfg = _pair()
    batch = _batch(corpus)
    depth = int(batch["num_steps"].max())
    assert depth < MAX_STEPS  # the port's loops stop early, JAX's run all positions
    if p:
        _assert_decision_margins(model, batch, cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["p_sample"] = jnp.float32(p)
    jax_loss_fn = jsched.make_scheduled_loss_fn(jmodel, jconfig.ExecutorConfig(**cfg))
    (jloss, jmetrics), jgrads = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jbatch, jax.random.PRNGKey(1), True)

    tbatch = to_device({**batch, "p_sample": np.float32(p)}, CPU)
    model.train()
    loss, metrics = tsched.make_scheduled_loss_fn(tconfig.ExecutorConfig(**cfg))(
        model, tbatch, torch.Generator().manual_seed(0), True)
    loss.backward()
    assert model.training and all(m.training for m in model.modules())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        assert float(metrics[key]) == float(value), key

    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    largest = max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        if name.endswith(".k.bias"):  # exactly zero: rounding noise on both sides
            assert max(float(got.abs().max()), float(g.abs().max())) <= 1e-6 * largest, name
            continue
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-4 * float(g.abs().max()),
                                   rtol=0, err_msg=name)

    # validation: the ground-truth caches, no chained pass
    model.eval()
    with torch.no_grad():
        eval_loss, _ = tsched.make_scheduled_loss_fn(tconfig.ExecutorConfig(**cfg))(
            model, tbatch, torch.Generator().manual_seed(0), False)
    jeval, _ = jax_loss_fn(jax.tree_util.tree_map(jnp.asarray, params), jbatch,
                           jax.random.PRNGKey(2), False)
    np.testing.assert_allclose(float(eval_loss), float(jeval), rtol=1e-5)


@pytest.fixture(scope="module")
def executor_files(corpus, tmp_path_factory):
    annotated, vocab, num_images = corpus
    root = tmp_path_factory.mktemp("scheduled")
    jart.write_annotated_h5(annotated, str(root / "annotated.h5"))
    with open(root / "vocab3.json", "w") as f:
        json.dump(vocab, f)
    with h5py.File(root / "features.h5", "w") as f:
        f.create_dataset("features",
                         data=np.random.RandomState(0).rand(num_images, 8, 2, 2).astype(np.float32))
    return dict(annotated_h5=str(root / "annotated.h5"), features_h5=str(root / "features.h5"),
                split_vocab_json=str(root / "vocab3.json"))


def test_scheduled_pipeline_batches_match_jax(executor_files):
    configs = []
    for cfg_mod in (jconfig, tconfig):
        base = cfg_mod.get_preset("executor_scheduled")
        configs.append(base.replace(
            model=dataclasses.replace(base.model, **SMALL, scheduled_ramp_epochs=2),
            data=cfg_mod.DataConfig(**executor_files),
            train=dataclasses.replace(base.train, batch_size=4)))
    jpipe = jax_build_pipeline(configs[0])
    tpipe = build_pipeline(configs[1], device="cpu")
    assert tpipe.steps_per_epoch == jpipe.steps_per_epoch > 0
    assert tpipe.monitor == jpipe.monitor
    for name, jit, tit in (("epoch 0", jpipe.train_batches(0), tpipe.train_batches(0)),
                           ("epoch 1", jpipe.train_batches(1), tpipe.train_batches(1)),
                           ("val", jpipe.val_batches(), tpipe.val_batches()),
                           ("test", jpipe.test_batches(), tpipe.test_batches())):
        jb, tb = next(iter(jit)), next(iter(tit))
        assert set(jb) == set(tb), name
        for key in jb:
            np.testing.assert_array_equal(np.asarray(tb[key]), np.asarray(jb[key]),
                                          f"{key} ({name})")
    assert float(next(iter(tpipe.train_batches(1)))["p_sample"]) == 0.25


def _dropout_model(seed=3, **model_kw):
    cfg = dict(SMALL, dropout=0.5, **model_kw)
    model = layers.init_parameters(ProgramExecutor(tconfig.ExecutorConfig(**cfg), device="cpu"),
                                   seed)
    return model, cfg


def test_chained_passes_are_deterministic_in_any_mode(corpus):
    """JAX's chained passes are always deterministic: with the executor in
    train mode and dropout 0.5, the port's equal their eval-mode results, the
    runners' too (one built before ``model.train()``), and every module gets
    its mode back."""
    model, cfg = _dropout_model()
    ecfg = tconfig.ExecutorConfig(**cfg)
    batch = to_device(_batch(corpus), CPU)
    args = (batch["image"], batch["functions"], batch["deps"], batch["num_steps"], ecfg,
            MAX_STEPS)
    runner = ExecutorChainRunner(model, ecfg, MAX_STEPS, device="cpu")
    chains = tds.ChainArrays(np.zeros(len(batch["image"]), np.int32),
                             batch["functions"].numpy(), batch["deps"].numpy(),
                             batch["num_steps"].numpy(), [])
    model.eval()
    reference = chained_forward(model, *args)
    served = runner.run(batch["image"].numpy(), chains)
    model.train()
    model.box_decoder.eval()  # a mixed mode must come back as it was
    modes = [m.training for m in model.modules()]
    torch.manual_seed(0)
    again = chained_forward(model, *args)
    assert [m.training for m in model.modules()] == modes
    for name, a, b in zip(reference._fields, again, reference):
        assert torch.equal(a, b), name
    for key, value in runner.run(batch["image"].numpy(), chains).items():
        np.testing.assert_array_equal(value, served[key], key)
    assert [m.training for m in model.modules()] == modes
    # the mode matters: a train-mode forward with dropout 0.5 differs
    inputs = gather_step_inputs(reference, batch["functions"][:, 1], batch["deps"][:, 1, 0],
                                batch["deps"][:, 1, 1], ecfg.max_input_boxes)
    model.train()
    with torch.no_grad():
        noisy = model(batch["image"], *inputs)["pred_boxes"]
        model.eval()
        clean = model(batch["image"], *inputs)["pred_boxes"]
    assert not torch.equal(noisy, clean)


def test_scheduled_step_runs_the_kernels_in_its_chained_pass_only(corpus, monkeypatch):
    """The wrappers of K2 and K1 (their plain versions on the CPU) are
    entered once per fusion layer and once per box-decoder layer at each
    position of a train step's chained pass, and never by its loss pass,
    which runs the plain path in train mode."""
    calls = {"K2": 0, "K1": 0}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(layers, "fused_encoder_block", counting("K2", layers.fused_encoder_block))
    monkeypatch.setattr(layers, "fused_attention", counting("K1", layers.fused_attention))
    # one head of 128: the models route to K2 and K1 only at the head dim they
    # are built for
    model, cfg = _dropout_model(d_model=128, num_heads=1)
    batch = to_device({**_batch(corpus), "p_sample": np.float32(0.5)}, CPU)
    depth = int(batch["num_steps"].max())
    loss_fn = tsched.make_scheduled_loss_fn(tconfig.ExecutorConfig(**cfg))
    model.train()
    loss, _ = loss_fn(model, batch, torch.Generator().manual_seed(0), True)
    loss.backward()
    assert calls == {"K2": cfg["encoder_layers"] * depth, "K1": cfg["box_decoder_layers"] * depth}
    assert model.training
    # a validation step runs no chained pass; its loss pass is deterministic
    calls.update(K2=0, K1=0)
    model.eval()
    with torch.no_grad():
        loss_fn(model, batch, torch.Generator().manual_seed(0), False)
    assert calls == {"K2": cfg["encoder_layers"] * depth, "K1": cfg["box_decoder_layers"] * depth}
