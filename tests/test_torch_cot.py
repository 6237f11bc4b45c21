"""The port's chain-of-thought (bbox-as-tokens) IQAP against the JAX package
on the CPU, in float32, at a small width:

- the annotated-string tokenizer, vocabulary and mapped-sequence arrays
  against ``tests/data/golden_mapped_sequences.json`` and JAX's; the h5
  written by the port read back by both packages;
- ``annotate_question_string`` equal to JAX's, character for character, on
  the CLEVR factory's questions and on programs that go INVALID half way
  (poisoned steps, side inputs dropped), with coordinates printed by
  ``repr(round(c, 3))``;
- ``bbox_token_table``, ``cross_entropy_skip_bbox``,
  ``parse_bboxes_from_tokens`` and ``mean_sequential_iou`` against JAX's;
- one ``transformer_iqap_cot`` step through each package's
  ``build_pipeline`` on files written with the JAX package's tools:
  batches equal, loss within 1e-5 relative, metrics equal, every gradient
  within 1e-5 of its tensor's max |g| (deterministic, as the IQAP's answer
  dropout is fixed at 0.1); a fixed batch's loss falls;
- the preset equals JAX's field for field; ``train --device cpu`` trains it
  for two epochs from ``DataConfig``'s default ``data/`` paths, the loss
  finite and the second epoch's at most 1.2x the first's.
"""

import dataclasses
import json
import pathlib

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.clevr import annotate as jann
from explainable_spatial_vqa_tpu.clevr import synthetic as jsyn
from explainable_spatial_vqa_tpu.clevr.scenes import Scene as JScene
from explainable_spatial_vqa_tpu.core import annotated_strings as jastr
from explainable_spatial_vqa_tpu.core import config as jconfig
from explainable_spatial_vqa_tpu.models import cot as jcot
from explainable_spatial_vqa_tpu.train.pipelines import build_pipeline as jax_build_pipeline
from explainable_spatial_vqa_tpu_torch.cli.main import main
from explainable_spatial_vqa_tpu_torch.clevr import annotate as tann
from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene as TScene
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core import annotated_strings as tastr
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from explainable_spatial_vqa_tpu_torch.models import cot as tcot
from explainable_spatial_vqa_tpu_torch.train.pipelines import build_pipeline
from explainable_spatial_vqa_tpu_torch.train.prefetch import to_device
from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CPU = torch.device("cpu")
DATA = pathlib.Path(__file__).parent / "data"
NARROW = dict(embed_dim=32, hidden_dim=24, num_heads=4, num_image_tokens=6, image_feature_dim=8,
              dropout=0.0)
COLORS = ("gray", "red", "blue", "green", "brown", "purple", "cyan", "yellow")


def test_mapped_sequences_match_golden_and_jax():
    g = json.load(open(DATA / "golden_mapped_sequences.json"))
    arrays, vocab = tastr.build_mapped_sequences(g["records"])
    assert vocab == g["token_to_id"]
    for key, ref in (("question_tokens", "q_ids"), ("answer_tokens", "a_ids"),
                     ("program_tokens", "p_ids"), ("image_index", "image_index")):
        np.testing.assert_array_equal(arrays[key], np.asarray(g[ref]))
    jarrays, jvocab = jastr.build_mapped_sequences(g["records"], 12, 3, 40)
    arrays, vocab = tastr.build_mapped_sequences(g["records"], 12, 3, 40)
    assert vocab == jvocab and list(vocab) == list(jvocab)
    for key in jarrays:
        np.testing.assert_array_equal(arrays[key], jarrays[key])
        assert arrays[key].dtype == jarrays[key].dtype


def test_mapped_sequences_h5_roundtrip(tmp_path):
    g = json.load(open(DATA / "golden_mapped_sequences.json"))
    arrays, _ = tastr.build_mapped_sequences(g["records"])
    path = str(tmp_path / "mapped.h5")
    tastr.write_mapped_sequences(arrays, path)
    for back in (tastr.read_mapped_sequences(path), jastr.read_mapped_sequences(path)):
        assert set(back) == set(arrays)
        for key in arrays:
            np.testing.assert_array_equal(back[key], arrays[key])


@pytest.mark.parametrize("text", [
    "scene[]:(0.494,0.175,0.627,0.375) | count[] 2",
    "filter_color[red]:(0.1,0.25,0.3,0.5) ; (0.2,0.3,0.4,0.6)|unique[]:none",
    "  relate[left]:none |query_shape[]:(0.0,1.0,0.125,0.9)  ",
])
def test_program_string_tokenizer_matches_jax(text):
    got = tastr.parse_program_string(text)
    assert got == jastr.parse_program_string(text)
    assert "|" in got and ":" in got


@pytest.fixture(scope="module")
def factory():
    """300 questions of 60 factory scenes, and on 40 of them a program per color
    that goes INVALID at ``unique`` where the color is absent or repeated."""
    scenes_raw, questions = jsyn.synthesize_dataset(60, 5, seed=11)
    crafted = []
    for s in scenes_raw[:40]:
        for color in COLORS:
            crafted.append({"image_index": s["image_index"], "question": "q", "answer": "a",
                            "program": [
                                {"function": "scene", "inputs": [], "value_inputs": []},
                                {"function": "filter_color", "inputs": [0],
                                 "value_inputs": [color]},
                                {"function": "unique", "inputs": [1], "value_inputs": []},
                                {"function": "relate", "inputs": [2], "value_inputs": ["left"]},
                                {"function": "filter_size", "inputs": [3],
                                 "value_inputs": ["large"]},
                                {"function": "count", "inputs": [4], "value_inputs": []}]})
    return scenes_raw, questions + crafted


def test_annotate_question_string_matches_jax(factory):
    scenes_raw, questions = factory
    jscenes = {s["image_index"]: JScene.from_raw(s) for s in scenes_raw}
    tscenes = {s["image_index"]: TScene.from_raw(s) for s in scenes_raw}
    strings = []
    for q in questions:
        ref = jann.annotate_question_string(q, jscenes[q["image_index"]])
        got = tann.annotate_question_string(q, tscenes[q["image_index"]])
        assert got == ref
        strings.append(got["annotated_program_string"])
    text = " ".join(strings)
    tokens = set(tastr.parse_program_string(text))
    assert "relate[]:none" in text  # a poisoned step drops its side input
    assert any(t.startswith("relate[left]:(") for t in text.split(" | "))
    short = {t for t in tokens if t[:2] in ("0.", "1.") and len(t) < 5}
    assert short and not any(tcot.is_bbox_token(t) for t in short)  # repr(round(c, 3))
    assert any(tcot.is_bbox_token(t) for t in tokens)


def test_single_string_golden(fixture_scene):
    g = json.load(open(DATA / "golden_single_string.json"))
    scene = TScene.from_raw(fixture_scene)
    for q, expected in zip(g["questions"], g["strings"]):
        assert tann.annotate_question_string(q, scene)["annotated_program_string"] == expected


def test_cot_helpers_match_jax():
    rng = np.random.RandomState(3)
    idx_to_token = {0: "<PAD>", 1: "<UNK>", 2: "(", 3: ")", 4: ",", 5: ";", 6: "scene[]",
                    7: "0.123", 8: "0.456", 9: "1.000", 10: "0.5", 11: ":", 12: "none",
                    13: "0.789"}
    v = 16  # two ids past the table's tokens
    table = tcot.bbox_token_table(idx_to_token, v)
    np.testing.assert_array_equal(table, jcot.bbox_token_table(idx_to_token, v))
    assert table.sum() == 4 and not table[10]

    logits = rng.randn(3, 9, v).astype(np.float32)
    targets = rng.randint(0, v, (3, 9)).astype(np.int32)
    targets[0, -2:] = 0
    got = tcot.cross_entropy_skip_bbox(torch.from_numpy(logits), torch.from_numpy(targets),
                                       torch.from_numpy(table))
    ref = jcot.cross_entropy_skip_bbox(jnp.asarray(logits), jnp.asarray(targets), table)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)

    group = [2, 7, 4, 8, 4, 9, 4, 13, 3]  # ( 0.123 , 0.456 , 1.000 , 0.789 )
    seqs = [group + [5] + [2, 8, 4, 7, 4, 13, 4, 9, 3] + [0, 0], group + [0] * 12,
            [6, 11, 12] + [0] * 18, [2, 7, 4, 10, 4, 9, 4, 13, 3] + [0] * 12]
    pred, gt = np.asarray(seqs), np.asarray(seqs[1:] + seqs[:1])
    for row in pred:
        assert tcot.parse_bboxes_from_tokens(row, idx_to_token) == \
            jcot.parse_bboxes_from_tokens(row, idx_to_token)
    got = tcot.mean_sequential_iou(pred, gt, idx_to_token)
    ref = jcot.mean_sequential_iou(pred, gt, idx_to_token)
    assert got["evaluated"] == ref["evaluated"] == 1.0
    np.testing.assert_allclose(got["mean_iou"], ref["mean_iou"], rtol=1e-12)


@pytest.fixture(scope="module")
def files(tmp_path_factory, factory):
    """Mapped sequences of the factory's questions annotated as single
    strings, their vocabulary JSON and (60, 8, 2, 3) features, written with
    the JAX package's tools, under ``data/`` as ``DataConfig`` names them."""
    scenes_raw, questions = factory
    scenes = {s["image_index"]: JScene.from_raw(s) for s in scenes_raw}
    records = [jann.annotate_question_string(q, scenes[q["image_index"]]) for q in questions[:96]]
    arrays, vocab = jastr.build_mapped_sequences(records)
    root = tmp_path_factory.mktemp("cot")
    (root / "data").mkdir()
    jastr.write_mapped_sequences(arrays, str(root / "data" / "mapped_sequences.h5"))
    with open(root / "data" / "string_vocab.json", "w") as f:
        json.dump({"token_to_id": vocab}, f)
    with h5py.File(root / "features.h5", "w") as f:
        f.create_dataset("features", data=np.random.RandomState(0).rand(
            len(scenes_raw), 8, 2, 3).astype(np.float32))
    return root


def _configs(files, batch_size=8):
    out = []
    for cfg_mod in (jconfig, tconfig):
        base = cfg_mod.PRESETS["transformer_iqap_cot"]
        out.append(base.replace(
            model=dataclasses.replace(base.model, **NARROW),
            data=cfg_mod.DataConfig(
                mapped_sequences_h5=str(files / "data" / "mapped_sequences.h5"),
                string_vocab_json=str(files / "data" / "string_vocab.json"),
                features_h5=str(files / "features.h5")),
            train=dataclasses.replace(base.train, batch_size=batch_size, log_every=0)))
    return out


def _noisy(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + (0.05 * rng.randn(*np.shape(p)) if not np.any(p) else 0)
                   ).astype(np.float32), params)


def test_train_step_matches_jax(files):
    jcfg, tcfg = _configs(files)
    jpipe, tpipe = jax_build_pipeline(jcfg), build_pipeline(tcfg, device="cpu")
    assert tpipe.monitor == jpipe.monitor
    cfg = tpipe.model.config
    assert cfg.vocab_size == cfg.program_vocab_size == cfg.num_answer_classes > 45
    assert cfg.program_len == 100 and cfg.max_question_len == 20
    params = _noisy(jpipe.params, 1)
    model = tpipe.model
    model.load_state_dict(flax_to_state_dict(params))
    jbatch = next(iter(jpipe.train_batches(0)))
    tbatch = next(iter(tpipe.train_batches(0)))
    assert set(jbatch) == set(tbatch)
    for key in jbatch:
        np.testing.assert_array_equal(np.asarray(tbatch[key]), np.asarray(jbatch[key]), key)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jpipe.loss_fn, has_aux=True),
                                       static_argnums=3)(
        params, {k: jnp.asarray(v) for k, v in jbatch.items()}, jax.random.PRNGKey(0), False)
    model.eval()
    loss, metrics = tpipe.loss_fn(model, to_device(tbatch, CPU), torch.Generator().manual_seed(0),
                                  False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        assert int(metrics[key]) == int(value), key

    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    for name, g in ref.items():
        got = named[name].grad
        if name.endswith(".k.bias"):  # softmax ignores a constant shift: zero, up to noise
            assert float(got.abs().max()) <= 1e-6 * max(float(g.abs().max()), 1.0), name
            continue
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-5 * float(g.abs().max()),
                                   rtol=0, err_msg=name)


def test_skip_mask_leaves_out_coordinates(files):
    """The sequence CE averages over the non-coordinate, non-padding targets
    only: a coordinate target's logits carry no gradient."""
    _, tcfg = _configs(files)
    tpipe = build_pipeline(tcfg, device="cpu")
    batch = to_device(next(iter(tpipe.train_batches(0))), CPU)
    with open(files / "data" / "string_vocab.json") as f:
        vocab = json.load(f)["token_to_id"]
    table = torch.from_numpy(tcot.bbox_token_table({v: k for k, v in vocab.items()},
                                                   tpipe.model.config.vocab_size))
    programs = batch["programs"]
    is_coord = table[programs.long()]
    assert is_coord.any() and (~is_coord & (programs != 0)).any()
    logits = torch.randn(*programs.shape, table.shape[0], requires_grad=True)
    tcot.cross_entropy_skip_bbox(logits, programs, table).backward()
    per_position = logits.grad.abs().sum(-1)
    assert not per_position[is_coord | (programs == 0)].any()
    assert per_position[~is_coord & (programs != 0)].all()


def test_fixed_batch_loss_falls(files):
    _, tcfg = _configs(files)
    tpipe = build_pipeline(tcfg, device="cpu")
    trainer = Trainer(tpipe.loss_fn, tpipe.model, tcfg.optim, tcfg.train, tpipe.steps_per_epoch,
                      checkpoint_dir=False, device="cpu")
    batch = to_device(next(iter(tpipe.train_batches(0))), CPU)
    gen = torch.Generator().manual_seed(0)
    losses = [float(trainer.train_step(batch, gen)["loss_sum"]) for _ in range(8)]
    assert all(np.isfinite(losses)) and losses[-1] < 0.8 * losses[0], losses


def test_preset_equals_jax():
    got, ref = tconfig.get_preset("transformer_iqap_cot"), jconfig.get_preset(
        "transformer_iqap_cot")
    assert type(got.model).__name__ == type(ref.model).__name__ == "IQAPConfig"
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.model_family == "iqap_cot"


def test_cli_trains_two_epochs(files, tmp_path, monkeypatch):
    """No flag names the mapped sequences or the string vocabulary: the
    preset reads DataConfig's defaults, relative to the working directory."""
    base = tconfig.PRESETS["transformer_iqap_cot"]
    monkeypatch.setattr(tconfig, "get_preset", lambda name: base.replace(
        model=dataclasses.replace(base.model, **NARROW),
        train=dataclasses.replace(base.train, batch_size=16, log_every=0)))
    monkeypatch.chdir(files)
    history = tmp_path / "history.json"
    main(["--device", "cpu", "train", "--preset", "transformer_iqap_cot", "--features_h5",
          str(files / "features.h5"), "--epochs", "2", "--checkpoint_dir",
          str(tmp_path / "ckpt"), "--history_json", str(history)])
    with open(history) as f:
        record = json.load(f)
    losses = [e["loss_sum"] / e["batches"] for e in record["train"]]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    assert losses[-1] <= 1.2 * losses[0], losses
    assert record["train"][-1]["token_total"] > 0
