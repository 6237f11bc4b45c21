"""The port's baseline training pipelines against the JAX package on the CPU,
in float32, on h5 artifacts written with the JAX package's own tools:

- one training step of ``transformer_iqap_bb`` (with the scenes h5's
  boxes; ``transformer_iqap``'s is in ``test_torch_iqap.py``),
  ``lstm_iqap``, ``lstm_iqa``, ``step_seq2seq`` and ``lstm_qp`` (the
  generator's one-layer variant) through each package's
  ``build_pipeline``: batches equal, loss within
  1e-5 relative, metrics equal, every gradient within 1e-4 of its tensor's
  max |g| (JAX: ``jax.value_and_grad`` of its pipeline's ``loss_fn``;
  dropout off: the IQAP's answer dropout is fixed at 0.1, so its step runs
  deterministic as evaluation does; teacher forcing 1 for the LSTM so no
  coin is drawn);
- a fixed batch's loss falls, below 0.97 of its first, over eight
  ``Trainer.train_step``s of each baseline family;
- ``build_pipeline`` builds ``iqap_cot`` and ``prototype_step`` from their
  artifacts (the families ported last) and raises for an unknown family;
- the six baseline presets equal JAX's field for field.
"""

import copy
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
from explainable_spatial_vqa_tpu.train.pipelines import build_pipeline as jax_build_pipeline
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from explainable_spatial_vqa_tpu_torch.train.pipelines import build_pipeline
from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CPU = torch.device("cpu")
PRESETS = ("lstm_qp", "transformer_iqap", "transformer_iqap_bb", "lstm_iqap", "lstm_iqa",
           "step_seq2seq")
IQAP = dict(vocab_size=20, program_vocab_size=12, num_answer_classes=7, embed_dim=32,
            hidden_dim=24, num_heads=4, num_image_tokens=6, image_feature_dim=8,
            program_len=9, max_question_len=5, dropout=0.0, num_bbox_slots=4)
LSTM = dict(vocab_size=20, program_vocab_size=12, num_answer_classes=7, embed_dim=12,
            hidden_dim=16, image_feature_dim=8, image_spatial=(2, 3), dropout=0.0,
            teacher_forcing=1.0)
SEQ2SEQ = dict(d_model=32, num_heads=4, encoder_layers=2, decoder_layers=2, ffn_dim=64,
               dropout=0.0, max_src_len=30, max_tgt_len=8, num_image_tokens=6,
               image_feature_dim=8)
LSTM_QP = dict(embed_dim=12, hidden_dim=16, dropout=0.0, teacher_forcing=1.0)
MODEL_KW = {"transformer_iqap": IQAP, "transformer_iqap_bb": IQAP, "lstm_iqap": LSTM,
            "lstm_iqa": LSTM, "step_seq2seq": SEQ2SEQ, "lstm_qp": LSTM_QP}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Encoded questions with answers and programs, per-image boxes, "full"
    annotations in the joint vocabulary and (8, 8, 2, 3) features."""
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import vocab as voc

    root = tmp_path_factory.mktemp("baselines")
    rng = np.random.RandomState(5)
    n, images = 48, 8
    questions = rng.randint(1, 20, (n, 5)).astype(np.int32)
    programs = rng.randint(1, 12, (n, 9)).astype(np.int32)
    for i, pad in enumerate(rng.randint(0, 3, n)):
        questions[i, 5 - pad:] = 0
        programs[i, 9 - 2 * pad:] = 0
    jart.write_questions_h5(jart.EncodedQuestions(
        questions, np.arange(n) % images, np.arange(n), programs, rng.randint(0, 7, n)),
        str(root / "questions.h5"))
    jart.write_scenes_h5(str(root / "scenes.h5"), rng.rand(images, 5, 4),
                         rng.randint(0, 3, (images, 5)), np.arange(images),
                         [f"{i}.png" for i in range(images)])
    with h5py.File(root / "features.h5", "w") as f:
        f.create_dataset("features", data=rng.rand(images, 8, 2, 3).astype(np.float32))

    scenes_raw, corpus = syn.synthesize_dataset(images, 3, seed=7)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = [ann.annotate_question_full(q, scenes[q["image_index"]]) for q in corpus]
    joint = voc.build_joint_vocab(annotated)
    jart.write_annotated_h5([voc.apply_joint_vocab(copy.deepcopy(q), joint) for q in annotated],
                            str(root / "annotated.h5"))
    return dict(questions_h5=str(root / "questions.h5"), features_h5=str(root / "features.h5"),
                scenes_h5=str(root / "scenes.h5"), annotated_h5=str(root / "annotated.h5"),
                ), len(joint) + 3


def _pipelines(preset, files, batch_size=8):
    paths, joint_size = files
    kw = dict(MODEL_KW[preset])
    if preset == "step_seq2seq":
        kw["vocab_size"] = joint_size
    configs = []
    for cfg_mod in (jconfig, tconfig):
        base = cfg_mod.get_preset(preset)
        configs.append(base.replace(
            model=dataclasses.replace(base.model, **kw), data=cfg_mod.DataConfig(**paths),
            train=dataclasses.replace(base.train, batch_size=batch_size, log_every=0)))
    return jax_build_pipeline(configs[0]), build_pipeline(configs[1], device="cpu"), configs[1]


def _noisy(params, seed):
    """Every all-zero leaf (the biases) given small random values, so that
    every gradient path carries signal."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.05 * rng.randn(*np.shape(p)) if not np.any(p) else 0)
                   ).astype(np.float32), params)


@pytest.mark.parametrize("preset", sorted(set(MODEL_KW) - {"transformer_iqap"}))
def test_train_step_matches_jax(preset, files):
    jpipe, tpipe, _ = _pipelines(preset, files)
    params = _noisy(jpipe.params, 1)
    model = tpipe.model
    model.load_state_dict(flax_to_state_dict(params))
    jbatch = next(iter(jpipe.train_batches(0)))
    tbatch = next(iter(tpipe.train_batches(0)))
    assert set(jbatch) == set(tbatch)
    for key in jbatch:
        np.testing.assert_array_equal(np.asarray(tbatch[key]), np.asarray(jbatch[key]), key)
    if preset == "transformer_iqap_bb":
        assert 0 < tbatch["target_box_mask"].sum() < tbatch["target_box_mask"].size

    train = preset != "transformer_iqap_bb"
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
        if key == "iou_sum":
            np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-5)
        else:
            assert int(metrics[key]) == int(value), key

    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    largest = max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        got = named[name].grad
        assert got is not None, name
        if name.endswith(".k.bias"):  # softmax ignores a constant shift: zero, up to noise
            assert max(float(got.abs().max()), float(g.abs().max())) <= 1e-6 * largest, name
            continue
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-4 * float(g.abs().max()),
                                   rtol=0, err_msg=name)


# the three baseline families; lstm_qp trains the generator's family
@pytest.mark.parametrize("preset", sorted(set(MODEL_KW) - {"lstm_qp"}))
def test_fixed_batch_loss_falls(preset, files):
    _, tpipe, config = _pipelines(preset, files)
    trainer = Trainer(tpipe.loss_fn, tpipe.model, config.optim, config.train,
                      tpipe.steps_per_epoch, checkpoint_dir=False, device="cpu")
    batch = to_device(next(iter(tpipe.train_batches(0))), CPU)
    gen = torch.Generator().manual_seed(0)
    losses = [float(trainer.train_step(batch, gen)["loss_sum"]) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < 0.97 * losses[0], losses


@pytest.mark.parametrize("family", ["iqap_cot", "prototype_step"])
def test_unported_families_still_raise(family, files, tmp_path):
    """The two families ported last build through ``build_pipeline`` from
    their h5 artifacts (``iqap_cot``: mapped sequences of single-string
    annotations; ``prototype_step``: v3 annotations, ``token_only``) and
    take a finite step; an unknown family still raises."""
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import annotated_strings as astr
    from explainable_spatial_vqa_tpu.core import vocab as voc

    paths, _ = files
    scenes_raw, corpus = syn.synthesize_dataset(8, 3, seed=7)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    if family == "iqap_cot":
        arrays, vocab = astr.build_mapped_sequences(
            [ann.annotate_question_string(q, scenes[q["image_index"]]) for q in corpus])
        astr.write_mapped_sequences(arrays, str(tmp_path / "mapped.h5"))
        (tmp_path / "vocab.json").write_text(json.dumps({"token_to_id": vocab}))
        data = dict(mapped_sequences_h5=str(tmp_path / "mapped.h5"),
                    string_vocab_json=str(tmp_path / "vocab.json"))
        base, kw = tconfig.get_preset("transformer_iqap_cot"), IQAP
    else:
        annotated = ann.annotate_questions(corpus, scenes)
        jart.write_annotated_h5(annotated, str(tmp_path / "v3.h5"))
        voc.save_vocab(voc.build_split_vocab(annotated), str(tmp_path / "vocab3.json"))
        data = dict(annotated_h5=str(tmp_path / "v3.h5"),
                    split_vocab_json=str(tmp_path / "vocab3.json"))
        base = tconfig.get_preset("token_only")
        kw = dict(image_feature_dim=8, image_spatial=(2, 3), num_image_tokens=6)
    config = base.replace(model=dataclasses.replace(base.model, **kw),
                          data=tconfig.DataConfig(features_h5=paths["features_h5"], **data),
                          train=dataclasses.replace(base.train, batch_size=4, log_every=0))
    pipe = build_pipeline(config, device="cpu")
    assert config.model_family == family
    batch = to_device(next(iter(pipe.train_batches(0))), CPU)
    pipe.model.eval()
    loss, metrics = pipe.loss_fn(pipe.model, batch, torch.Generator().manual_seed(0), False)
    assert np.isfinite(float(loss)) and set(pipe.monitor) <= set(metrics)
    with pytest.raises(KeyError, match="unknown model family"):
        build_pipeline(config.replace(model_family=family + "_x"), device="cpu")


@pytest.mark.parametrize("name", PRESETS)
def test_baseline_presets_equal_jax(name):
    got, ref = tconfig.get_preset(name), jconfig.get_preset(name)
    assert type(got.model).__name__ == type(ref.model).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
