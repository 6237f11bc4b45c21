"""The port's CLI (``python -m explainable_spatial_vqa_tpu_torch.cli``) on the
CPU against the JAX package's CLI, on small h5 files written by the JAX
package's own tools and the same weights on both sides (JAX checkpoints for
the JAX CLI, their conversion for the port's).  The presets are narrowed by
monkeypatching both packages' ``get_preset``.

- ``eval-generator --beam_size 2 --compare_tf`` and ``tally --annotated_h5 …
  --calibrate_conf_per_function --save_conf_thresholds`` print what the JAX
  CLI prints, and save the same thresholds; every decision of the tally's
  chain runs clears its threshold (0.5, each threshold the calibration
  scans) by more than 1e-5;
- ``train --preset executor_scheduled`` trains one epoch and writes the
  history and a checkpoint that ``tally --executor_preset
  executor_scheduled`` restores;
- ``eval-iqap`` prints the summary the JAX CLI prints (the seconds aside)
  and writes the same records; ``infer-chain`` on joint-vocab "full"
  annotations prints what the JAX CLI prints and writes the same records;
- ``--device`` defaults to cuda and raises without a card; ``--plot``
  writes the training curves; ``train --preset transformer_iqap_cot`` trains from
  ``DataConfig``'s default ``data/`` paths; ``presets`` lists the port's
  presets, every preset of the JAX package.
"""

import dataclasses
import json

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.cli.main import main as jax_main
from explainable_spatial_vqa_tpu.core import artifacts as jart
from explainable_spatial_vqa_tpu.core import config as jconfig
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
from explainable_spatial_vqa_tpu.models.generator import ProgramGenerator as JaxGenerator
from explainable_spatial_vqa_tpu.train.checkpoints import CheckpointStore as JaxCheckpointStore
from explainable_spatial_vqa_tpu_torch.cli.main import main
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import build_conf_threshold_vector
from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.train.checkpoints import CheckpointStore
from explainable_spatial_vqa_tpu_torch.train.datasets import chain_arrays

torch.set_num_threads(1)

GENERATOR = dict(vocab_size=1, program_vocab_size=1, embed_dim=8, hidden_dim=12,
                 encoder_layers=2, decoder_layers=2, dropout=0.0)
EXECUTOR = dict(vocab_size=1, token_classes=1, d_model=32, num_heads=4, encoder_layers=2,
                box_decoder_layers=1, num_image_tokens=4, image_feature_dim=8, dropout=0.0)
IQAP = dict(embed_dim=32, hidden_dim=24, num_heads=4, encoder_layers=2, decoder_layers=2,
            dropout=0.0)
SEQ2SEQ = dict(d_model=32, num_heads=4, encoder_layers=2, decoder_layers=2, ffn_dim=64,
               dropout=0.0)
NARROW = {"generator": GENERATOR, "iqap": IQAP, "step_seq2seq": SEQ2SEQ,
          "iqap_cot": dict(IQAP, num_image_tokens=4, image_feature_dim=8)}
GRID = np.linspace(0.05, 0.95, 19)  # the calibrators' scan; 0.5, the gate, is on it
MARGIN = 1e-5


_GET_PRESET = {jconfig: jconfig.get_preset, tconfig: tconfig.get_preset}


def _narrow(cfg_mod, name):
    base = _GET_PRESET[cfg_mod](name)
    kw = NARROW.get(base.model_family, EXECUTOR)
    return base.replace(model=dataclasses.replace(base.model, **kw),
                        train=dataclasses.replace(base.train, log_every=0))


@pytest.fixture(autouse=True)
def narrow_presets(monkeypatch):
    for cfg_mod in (jconfig, tconfig):
        monkeypatch.setattr(cfg_mod, "get_preset",
                            lambda name, _m=cfg_mod: _narrow(_m, name))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Synthetic CLEVR questions as the JAX package's tools write them: the
    questions h5 and its vocabulary, the annotated h5 and its split
    vocabulary, and (N, 8, 2, 2) features."""
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import vocab as voc

    root = tmp_path_factory.mktemp("cli")
    scenes_raw, questions = syn.synthesize_dataset(16, 3, seed=3)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    vocab = voc.build_clevr_vocab([questions])
    enc = jart.encode_questions(questions, vocab)
    annotated = ann.annotate_questions(questions, scenes)
    paths = {name: str(root / name) for name in (
        "questions.h5", "vocab.json", "annotated.h5", "vocab3.json", "features.h5")}
    jart.write_questions_h5(enc, paths["questions.h5"])
    voc.save_vocab(vocab, paths["vocab.json"])
    jart.write_annotated_h5(annotated, paths["annotated.h5"])
    voc.save_vocab(voc.build_split_vocab(annotated), paths["vocab3.json"])
    with h5py.File(paths["features.h5"], "w") as f:
        f.create_dataset("features", data=np.random.RandomState(0).rand(
            len(scenes_raw), 8, 2, 2).astype(np.float32))
    return paths, enc, annotated


def _save(root, name, jax_params):
    """The same weights as a JAX checkpoint and a port checkpoint."""
    jstore = JaxCheckpointStore(str(root / f"jax_{name}"))
    jstore.save_best({"params": jax_params})
    jstore.wait()
    store = CheckpointStore(str(root / f"torch_{name}"))
    store.save_best({"model": flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                        jax_params))})
    store.close()
    return str(root / f"jax_{name}"), str(root / f"torch_{name}")


def _generator_params(enc, seed=0):
    cfg = dataclasses.replace(
        _narrow(jconfig, "generator").model,
        vocab_size=int(enc.questions.max()) + 1, program_vocab_size=int(enc.programs.max()) + 1,
        program_len=enc.programs.shape[1])
    model = JaxGenerator(cfg)
    q = jnp.asarray(enc.questions[:2])
    return model.init({"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)}, q,
                      jnp.zeros((2, cfg.program_len), jnp.int32))["params"]


def _executor_params(vocab3):
    """The executor's weights with the confidence head scaled by 200 and the
    routing head by 20, so that confidences and routing sit far from their
    thresholds: the two packages' runs cannot part on a rounding."""
    cfg = dataclasses.replace(_narrow(jconfig, "executor").model,
                              vocab_size=len(vocab3["function"]) + 1,
                              token_classes=len(vocab3["other"]) + 1)
    params = jax.tree_util.tree_map(np.array, JaxExecutor(cfg).init(
        jax.random.PRNGKey(2), jnp.zeros((2, 4, 8)), jnp.zeros((2, cfg.max_input_boxes, 4)),
        jnp.ones((2, cfg.max_input_boxes), bool), jnp.zeros((2, 3), jnp.int32),
        jnp.ones((2, 3), bool))["params"])
    params["box_decoder"]["head_out"]["kernel"][:, 4] *= 200.0
    params["routing_head"]["kernel"] *= 20.0
    return params, cfg


def _stdout(capsys, run, argv):
    capsys.readouterr()
    run(argv)
    return capsys.readouterr().out


def test_eval_generator_prints_what_jax_prints(files, tmp_path, capsys):
    paths, enc, _ = files
    jdir, tdir = _save(tmp_path, "generator", _generator_params(enc))
    args = ["eval-generator", "--questions_h5", paths["questions.h5"], "--beam_size", "2",
            "--compare_tf", "--batch_size", "16", "--show", "2", "--vocab_json",
            paths["vocab.json"]]
    ref = _stdout(capsys, jax_main, args + ["--checkpoint_dir", jdir])
    got = _stdout(capsys, main, ["--device", "cpu"] + args + ["--checkpoint_dir", tdir])
    assert got == ref
    payload = json.loads(got[:got.index("\n}\n") + 2])
    assert set(payload) == {"exact_match", "token_acc", "token_acc_nonpad", "teacher_forced",
                            "beam"}
    assert payload["beam"]["beam_size"] == 2


def _assert_chain_margins(executor, cfg, annotated, vocab3, features, thresholds):
    """Every decision of the annotated chains' runs (routing, token argmax,
    each confidence against every threshold the tally may apply) clears it
    by more than MARGIN."""
    chains = chain_arrays(annotated, vocab3["function"], 28)
    tokens = torch.from_numpy(features.reshape(len(features), 8, 4).transpose(0, 2, 1).copy())
    outs = []
    hook = executor.register_forward_hook(lambda _m, _i, out: outs.append(out))
    try:
        for vec in thresholds:
            ExecutorChainRunner(executor, cfg, 28, vec, device="cpu").run_sorted(
                tokens[chains.image_index], chains)
    finally:
        hook.remove()
    routing = torch.cat([o["routing_logits"] for o in outs])
    assert float((routing[:, 0] - routing[:, 1]).abs().min()) > MARGIN
    top2 = torch.topk(torch.cat([o["token_logits"] for o in outs]), 2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
    conf = torch.cat([o["pred_conf"].flatten() for o in outs]).numpy()
    assert np.abs(conf[:, None] - GRID[None]).min() > MARGIN
    assert 0.05 < (conf >= 0.5).mean() < 0.95


def test_tally_prints_what_jax_prints(files, tmp_path, capsys):
    paths, enc, annotated = files
    with open(paths["vocab3.json"]) as f:
        vocab3 = json.load(f)
    jgen, tgen = _save(tmp_path, "generator", _generator_params(enc, seed=4))
    exe_params, exe_cfg = _executor_params(vocab3)
    jexe, texe = _save(tmp_path, "executor", exe_params)
    args = ["tally", "--questions_h5", paths["questions.h5"], "--features_h5",
            paths["features.h5"], "--vocab_json", paths["vocab.json"], "--split_vocab_json",
            paths["vocab3.json"], "--annotated_h5", paths["annotated.h5"],
            "--calibrate_conf_per_function"]
    ref = _stdout(capsys, jax_main, args + [
        "--generator_checkpoint", jgen, "--executor_checkpoint", jexe,
        "--save_conf_thresholds", str(tmp_path / "jax_thresholds.json")])
    got = _stdout(capsys, main, ["--device", "cpu"] + args + [
        "--generator_checkpoint", tgen, "--executor_checkpoint", texe,
        "--save_conf_thresholds", str(tmp_path / "thresholds.json")])
    assert got == ref
    with open(tmp_path / "thresholds.json") as f, open(tmp_path / "jax_thresholds.json") as g:
        thr_map = json.load(f)
        assert thr_map == json.load(g)
    assert "Box P/R @ IoU>=0.5" in got and '"per_function_box_pr"' in got
    assert len(thr_map) > 1  # the functions with enough predictions have their own

    executor = ProgramExecutor(tconfig.ExecutorConfig(**dataclasses.asdict(exe_cfg)),
                               device="cpu")
    executor.load_state_dict(flax_to_state_dict(exe_params))
    with h5py.File(paths["features.h5"], "r") as f:
        features = f["features"][()]
    _assert_chain_margins(executor, tconfig.ExecutorConfig(**dataclasses.asdict(exe_cfg)),
                          annotated, vocab3, features,
                          [None, build_conf_threshold_vector(vocab3["function"], thr_map)])


def test_train_then_tally_restores(files, tmp_path, capsys):
    paths, _, _ = files
    history = tmp_path / "history.json"
    main(["--device", "cpu", "train", "--preset", "executor_scheduled", "--annotated_h5",
          paths["annotated.h5"], "--features_h5", paths["features.h5"], "--split_vocab_json",
          paths["vocab3.json"], "--epochs", "1", "--batch_size", "4", "--checkpoint_dir",
          str(tmp_path / "ckpt"), "--history_json", str(history), "--eval_test"])
    with open(history) as f:
        record = json.load(f)
    assert set(record) == {"train", "val", "test"} and len(record["train"]) == 1
    train = record["train"][0]
    assert train["batches"] > 0 and np.isfinite(train["loss_sum"])
    assert 0 < train["routing_total"] and train["routing_correct"] <= train["routing_total"]
    assert (tmp_path / "ckpt" / "best.pt").exists()

    capsys.readouterr()
    main(["--device", "cpu", "tally", "--questions_h5", paths["questions.h5"], "--features_h5",
          paths["features.h5"], "--vocab_json", paths["vocab.json"], "--split_vocab_json",
          paths["vocab3.json"], "--executor_preset", "executor_scheduled",
          "--executor_checkpoint", str(tmp_path / "ckpt"), "--annotated_h5",
          paths["annotated.h5"], "--chain_mode", "pool", "--calibrate_conf", "--limit", "20"])
    out = capsys.readouterr()
    assert "restored executor checkpoint" in out.err
    assert '"truncated_gt_programs": 0' in out.out


def test_cli_device_rule_and_presets(files, capsys, tmp_path, monkeypatch):
    paths, _, _ = files
    train = ["train", "--preset", "executor_roi", "--annotated_h5", paths["annotated.h5"]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(train)
    # --plot draws the history's curves, as the JAX CLI's does
    main(["--device", "cpu"] + train + [
        "--features_h5", paths["features.h5"], "--split_vocab_json", paths["vocab3.json"],
        "--epochs", "1", "--checkpoint_dir", str(tmp_path / "plot_ckpt"), "--plot",
        str(tmp_path / "curves.png")])
    assert (tmp_path / "curves.png").stat().st_size > 0
    # the chain-of-thought preset resolves and trains from DataConfig's
    # default data/ paths (the CLI has no flag for them)
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import annotated_strings as astr

    scenes_raw, questions = syn.synthesize_dataset(16, 3, seed=3)  # the fixture's corpus
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    records = [ann.annotate_question_string(q, scenes[q["image_index"]]) for q in questions]
    arrays, vocab = astr.build_mapped_sequences(records)
    (tmp_path / "data").mkdir()
    astr.write_mapped_sequences(arrays, str(tmp_path / "data" / "mapped_sequences.h5"))
    (tmp_path / "data" / "string_vocab.json").write_text(json.dumps({"token_to_id": vocab}))
    monkeypatch.chdir(tmp_path)
    history = tmp_path / "cot_history.json"
    main(["--device", "cpu", "train", "--preset", "transformer_iqap_cot", "--features_h5",
          paths["features.h5"], "--epochs", "1", "--batch_size", "8", "--checkpoint_dir",
          str(tmp_path / "cot_ckpt"), "--history_json", str(history)])
    record = json.loads(history.read_text())
    assert record["train"][0]["batches"] > 0 and np.isfinite(record["train"][0]["loss_sum"])
    for command in (["eval-iqap", "--questions_h5", paths["questions.h5"], "--features_h5",
                     paths["features.h5"], "--vocab_json", paths["vocab.json"]],
                    ["infer-chain", "--annotated_h5", paths["annotated.h5"], "--features_h5",
                     paths["features.h5"], "--vocab_size", "64"]):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                main(command)
    assert _stdout(capsys, main, ["presets"]).split() == sorted(tconfig.PRESETS)
    assert "executor_scheduled" in tconfig.PRESETS
    for name in ("lstm_qp", "transformer_iqap", "transformer_iqap_bb", "lstm_iqap", "lstm_iqa",
                 "step_seq2seq", "transformer_iqap_cot", "token_only", "bb_only", "bb_only_iou",
                 "yolo_bb", "multitask_bb", "bbinout", "multihead", "hierarchical"):
        assert name in tconfig.PRESETS
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)


def _masked_seconds(text):
    """The eval-iqap summary with its wall-clock seconds blanked."""
    return "\n".join('  "seconds": …,' if line.startswith('  "seconds":') else line
                     for line in text.splitlines())


def test_eval_iqap_prints_what_jax_prints(files, tmp_path, capsys):
    from explainable_spatial_vqa_tpu.models.iqap import TransformerIQAP as JaxIQAP

    paths, enc, _ = files
    questions, answers, programs = enc.questions[:30], enc.answers[:30], enc.programs[:30]
    cfg = dataclasses.replace(  # sized to the 30 questions, as both CLIs size it
        _narrow(jconfig, "transformer_iqap").model,
        vocab_size=int(questions.max()) + 1, num_answer_classes=int(answers.max()) + 1,
        program_vocab_size=int(programs.max()) + 1, program_len=programs.shape[1],
        max_question_len=questions.shape[1], image_feature_dim=8, num_image_tokens=4)
    model = JaxIQAP(cfg)
    params = model.init(jax.random.PRNGKey(5), jnp.zeros((2, 4, 8)), jnp.asarray(questions[:2]),
                        method=model.init_all)["params"]
    jdir, tdir = _save(tmp_path, "iqap", params)
    args = ["eval-iqap", "--questions_h5", paths["questions.h5"], "--features_h5",
            paths["features.h5"], "--vocab_json", paths["vocab.json"], "--limit", "30"]
    ref = _stdout(capsys, jax_main, args + ["--checkpoint_dir", jdir, "--output_json",
                                            str(tmp_path / "jax_iqap.json")])
    got = _stdout(capsys, main, ["--device", "cpu"] + args + [
        "--checkpoint_dir", tdir, "--output_json", str(tmp_path / "iqap.json")])
    assert _masked_seconds(got) == _masked_seconds(ref)
    summary = json.loads(got)
    assert summary["samples"] == 30 and {"answer_accuracy", "exact_match"} <= set(summary)
    with open(tmp_path / "iqap.json") as f, open(tmp_path / "jax_iqap.json") as g:
        assert json.load(f)["results"] == json.load(g)["results"]


def test_infer_chain_prints_what_jax_prints(files, tmp_path, capsys):
    """infer-chain on "full" annotations in the joint vocabulary (the step
    seq2seq's input) and a checkpoint of the same weights on both sides."""
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import vocab as voc
    from explainable_spatial_vqa_tpu.models.step_executor import StepExecutorSeq2Seq

    paths, _, _ = files
    scenes_raw, questions = syn.synthesize_dataset(16, 3, seed=3)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = [ann.annotate_question_full(q, scenes[q["image_index"]]) for q in questions]
    joint = voc.build_joint_vocab(annotated)
    annotated = [voc.apply_joint_vocab(q, joint) for q in annotated]
    jart.write_annotated_h5(annotated, str(tmp_path / "full.h5"))
    with open(tmp_path / "joint.json", "w") as f:
        json.dump(joint, f)
    vocab_size = len(joint) + 3
    cfg = dataclasses.replace(_narrow(jconfig, "step_seq2seq").model, vocab_size=vocab_size,
                              image_feature_dim=8, num_image_tokens=4)
    model = StepExecutorSeq2Seq(cfg)
    params = model.init(jax.random.PRNGKey(6), jnp.zeros((1, 4, 8)), jnp.zeros((1, 5), jnp.int32),
                        jnp.zeros((1, 3), jnp.int32))["params"]
    jdir, tdir = _save(tmp_path, "seq2seq", params)
    args = ["infer-chain", "--annotated_h5", str(tmp_path / "full.h5"), "--features_h5",
            paths["features.h5"], "--vocab_json", str(tmp_path / "joint.json"), "--vocab_size",
            str(vocab_size), "--max_steps", "8", "--limit", "20"]
    ref = _stdout(capsys, jax_main, args + ["--checkpoint_dir", jdir, "--output_json",
                                            str(tmp_path / "jax_chain.json")])
    got = _stdout(capsys, main, ["--device", "cpu"] + args + [
        "--checkpoint_dir", tdir, "--output_json", str(tmp_path / "chain.json")])
    assert got == ref and got.startswith("truncated_programs: ")
    assert int(got.split()[1]) > 0  # chains deeper than --max_steps are counted
    with open(tmp_path / "chain.json") as f, open(tmp_path / "jax_chain.json") as g:
        records = json.load(f)
        assert records == json.load(g)
    assert len(records) == 20 and any(r["predicted_ids"] for r in records)
