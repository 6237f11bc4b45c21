"""The port's IQAP baselines against the JAX package on the CPU, in fp32, with
the JAX models' random weights carried over by the weight bridge:

- ``TransformerIQAP`` with and without the bbox head: memory, answer logits,
  boxes and teacher-forced program logits within 1e-5, ``generate_programs``'
  tokens equal and logits within 1e-5;
- ``LstmIQAP`` with and without the program decoder, at teacher forcing 0
  and 1 (eval mode) and in training mode at forcing 1;
- the ``transformer_iqap`` pipeline's loss, which trains through the
  program's own greedy decode, and its gradients against
  ``jax.value_and_grad`` of JAX's ``loss_fn`` (dropout off): loss within
  1e-5, every gradient within 1e-4 of its tensor's max |g|.
"""

import dataclasses

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core import artifacts as jart
from explainable_spatial_vqa_tpu.core import config as jconfig
from explainable_spatial_vqa_tpu.models.iqap import TransformerIQAP as JaxIQAP
from explainable_spatial_vqa_tpu.models.iqap import generate_programs as jax_generate_programs
from explainable_spatial_vqa_tpu.models.lstm_iqap import LstmIQAP as JaxLstmIQAP
from explainable_spatial_vqa_tpu.train.pipelines import build_pipeline as jax_build_pipeline
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from explainable_spatial_vqa_tpu_torch.models.iqap import TransformerIQAP, generate_programs
from explainable_spatial_vqa_tpu_torch.models.lstm_iqap import LstmIQAP
from explainable_spatial_vqa_tpu_torch.train.pipelines import build_pipeline
from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device

torch.set_num_threads(1)

ATOL = 1e-5
IQAP = dict(vocab_size=20, program_vocab_size=12, num_answer_classes=7, embed_dim=32,
            hidden_dim=24, num_heads=4, encoder_layers=2, decoder_layers=2, num_image_tokens=6,
            image_feature_dim=8, program_len=9, max_question_len=5, dropout=0.0,
            num_bbox_slots=3)
LSTM = dict(vocab_size=20, program_vocab_size=12, num_answer_classes=7, embed_dim=12,
            hidden_dim=16, image_feature_dim=8, image_spatial=(2, 3), program_len=6,
            dropout=0.0)


def _np(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inputs(seed, image_shape):
    rng = np.random.RandomState(seed)
    image = rng.rand(4, *image_shape).astype(np.float32)
    questions = rng.randint(1, 20, (4, 5)).astype(np.int32)
    questions[1, 3:] = 0
    questions[3, 2:] = 0
    programs = rng.randint(1, 12, (4, 6)).astype(np.int32)
    return image, questions, programs


@pytest.mark.parametrize("bbox", [False, True])
def test_transformer_iqap_matches_jax(bbox):
    kw = dict(IQAP, with_bbox_head=bbox)
    image, questions, _ = _inputs(0, (6, 8))
    programs = np.random.RandomState(1).randint(0, 12, (4, 9)).astype(np.int32)
    jmodel = JaxIQAP(jconfig.IQAPConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(image), jnp.asarray(questions),
                            method=jmodel.init_all)
    ref = jmodel.apply(variables, jnp.asarray(image), jnp.asarray(questions))
    ref_tokens, ref_logits = jax_generate_programs(jmodel, variables, ref["memory"])
    ref_tf = jmodel.apply(variables, jnp.asarray(programs), ref["memory"],
                          method=jmodel.decode_programs_tf)

    model = TransformerIQAP(tconfig.IQAPConfig(**kw), device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(_np(variables)))
    with torch.no_grad():
        out = model(_t(image), _t(questions))
        tokens, logits = generate_programs(model, out["memory"])
        tf = model.decode_programs_tf(_t(programs), out["memory"])
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(ref_tf), atol=ATOL)
    assert out["answer_logits"].dtype == torch.float32


def test_transformer_iqap_bf16_heads_compute_in_float32():
    """On a bf16 model the answer and program heads still compute in
    float32 (Flax's ``Dense(dtype=float32)`` promotes their inputs), and the
    memory is bf16."""
    image, questions, _ = _inputs(2, (6, 8))
    model = TransformerIQAP(tconfig.IQAPConfig(**dict(IQAP, with_bbox_head=True)),
                            dtype=torch.bfloat16, device="cpu").eval()
    with torch.no_grad():
        out = model(_t(image), _t(questions))
        _, logits = generate_programs(model, out["memory"], max_len=3)
    assert out["memory"].dtype == torch.bfloat16
    assert out["answer_logits"].dtype == logits.dtype == out["pred_boxes"].dtype == torch.float32


@pytest.mark.parametrize("decoder,forcing,training",
                         [(False, 0.0, False), (True, 0.0, False), (True, 1.0, False),
                          (True, 1.0, True)])
def test_lstm_iqap_matches_jax(decoder, forcing, training):
    kw = dict(LSTM, with_program_decoder=decoder, teacher_forcing=forcing)
    image, questions, programs = _inputs(3, (8, 2, 3))
    jmodel = JaxLstmIQAP(jconfig.LstmIQAPConfig(**kw))
    targets = jnp.asarray(programs) if decoder else None
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                            jnp.asarray(image), jnp.asarray(questions), targets)
    ref = jmodel.apply(variables, jnp.asarray(image), jnp.asarray(questions), targets,
                       deterministic=not training,
                       rngs={"sample": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)})
    model = LstmIQAP(tconfig.LstmIQAPConfig(**kw), device="cpu").train(training)
    model.load_state_dict(flax_to_state_dict(_np(variables)))
    with torch.no_grad():
        out = model(_t(image), _t(questions), _t(programs) if decoder else None,
                    generator=torch.Generator().manual_seed(0))
    assert set(out) == set(ref)
    np.testing.assert_allclose(out["answer_logits"].numpy(), np.asarray(ref["answer_logits"]),
                               atol=ATOL)
    if decoder:
        np.testing.assert_allclose(out["program_logits"].numpy(),
                                   np.asarray(ref["program_logits"]), atol=ATOL)
        np.testing.assert_array_equal(out["program_tokens"].numpy(),
                                      np.asarray(ref["program_tokens"]))
        # the image reads C-major: image_fc's input is the flattened (C, H, W) grid
        assert model.image_fc.in_features == 8 * 2 * 3


@pytest.fixture(scope="module")
def iqap_files(tmp_path_factory):
    """Encoded questions with answers and programs, and (8, 8, 2, 3) features,
    written with the JAX package's own tools."""
    rng = np.random.RandomState(5)
    n = 40
    questions = rng.randint(1, 20, (n, 5)).astype(np.int32)
    programs = rng.randint(1, 12, (n, 9)).astype(np.int32)
    for i, pad in enumerate(rng.randint(0, 3, n)):
        questions[i, 5 - pad:] = 0
        programs[i, 9 - 2 * pad:] = 0
    root = tmp_path_factory.mktemp("iqap")
    path = str(root / "questions.h5")
    jart.write_questions_h5(jart.EncodedQuestions(
        questions, np.arange(n) % 8, np.arange(n), programs, rng.randint(0, 7, n)), path)
    with h5py.File(root / "features.h5", "w") as f:
        f.create_dataset("features", data=rng.rand(8, 8, 2, 3).astype(np.float32))
    return dict(questions_h5=path, features_h5=str(root / "features.h5"))


def _pipelines(preset, files, model_kw, batch_size):
    out = []
    for cfg_mod in (jconfig, tconfig):
        base = cfg_mod.get_preset(preset)
        out.append(base.replace(
            model=dataclasses.replace(base.model, **model_kw),
            data=cfg_mod.DataConfig(**files),
            train=dataclasses.replace(base.train, batch_size=batch_size)))
    return jax_build_pipeline(out[0]), build_pipeline(out[1], device="cpu")


def test_iqap_loss_and_gradients_match_jax(iqap_files):
    """The loss of the answer and of the program the model generates itself
    (greedy, no teacher forcing).  JAX's gradient flows through every step's
    logits and through the KV caches into earlier steps' K/V projections; a
    cache write that dropped those paths would part the decoder's K and V
    gradients from JAX's."""
    kw = {k: v for k, v in IQAP.items() if k not in ("num_bbox_slots",)}
    kw.update(num_image_tokens=6, image_feature_dim=8)
    jpipe, tpipe = _pipelines("transformer_iqap", iqap_files, kw, batch_size=8)
    params = jax.tree_util.tree_map(lambda p: np.asarray(p, np.float32), jpipe.params)
    tpipe.model.load_state_dict(flax_to_state_dict(params))
    jbatch = next(iter(jpipe.train_batches(0)))
    tbatch = next(iter(tpipe.train_batches(0)))
    for key in jbatch:
        np.testing.assert_array_equal(np.asarray(tbatch[key]), np.asarray(jbatch[key]), key)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jpipe.loss_fn, has_aux=True),
                                       static_argnums=3)(
        params, {k: jnp.asarray(v) for k, v in jbatch.items()}, jax.random.PRNGKey(0), False)
    model = tpipe.model.eval()
    loss, metrics = tpipe.loss_fn(model, to_device(tbatch, torch.device("cpu")),
                                  torch.Generator().manual_seed(0), False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=ATOL)
    for key, value in jmetrics.items():
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
