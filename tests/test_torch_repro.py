"""The port's ``repro-clevr`` (``cli/repro.py``) on the CPU:

- its orchestration with the heavy subcommands stubbed, as
  tests/test_repro_clevr.py drives the JAX package's: the same cases (the
  CoGenT fine-tune branch's ``--batch_size``, ``--executor_preset`` reaching
  every train and tally, ``--per_fn_conf``'s out-of-sample thresholds, the
  labelled train-for-val substitution, a condition-B root that lacks inputs),
  each also run through the JAX package's ``cmd_repro_clevr`` with the same
  stubs: the same sequence of subcommand argv and the same REPORT.md;
- one real invocation of the port's CLI on a CLEVR-layout mini root from the
  CLEVR factory (extract-features at full depth with torchvision-layout
  weights, vocab, questions, v3 annotation, both trainings, the tallies),
  with no file written by the JAX package; the presets narrowed (d_model 32)
  so that it runs in seconds.
"""

import argparse
import dataclasses
import json
import pathlib

import h5py
import pytest
import torch

from explainable_spatial_vqa_tpu.cli import repro as jrepro
from explainable_spatial_vqa_tpu_torch.cli import repro as trepro
from explainable_spatial_vqa_tpu_torch.cli.main import main
from explainable_spatial_vqa_tpu_torch.core import config as tconfig
from tests.test_torch_dataprep import mini_clevr_root
from tests.test_torch_vision import scaled_random_state

torch.set_num_threads(1)

FULL = {"questions_h5": "q.h5", "features_h5": "f.h5",
        "annotated_h5": "a.h5", "split_vocab": "sv.json"}
BOTH = {("A", "train"): FULL, ("A", "val"): FULL, ("B", "train"): FULL, ("B", "val"): FULL}


def _stubbed(module, monkeypatch, tmp_path, splits, cogent_b=None, executor_preset="executor",
             per_fn_conf=False):
    """``module.cmd_repro_clevr`` with ``_prepare_split`` returning canned
    artifact dicts per (root, split) and ``_sub`` recording its argv:
    (the recorded argv, REPORT.md)."""
    calls = []
    work = tmp_path / module.__name__.split(".")[0]
    monkeypatch.setattr(module, "_sub", lambda argv, *a, **k: calls.append(list(argv))
                        or "stub-tally-output")
    monkeypatch.setattr(module, "_prepare_split",
                        lambda root, split, work, *a, **k: dict(splits[(root, split)]))
    monkeypatch.setattr(module, "_find", lambda root, *cands: str(tmp_path / "q.json"))
    monkeypatch.setattr(module.shutil, "copytree", lambda *a, **k: None)
    args = dict(clevr_root="A", workdir=str(work), torch_weights=None, resize="pil",
                feature_batch=8, gen_epochs=1, exe_epochs=1, ft_epochs=1, batch_size=4,
                eval_limit=8, cogent_b_root=cogent_b, executor_preset=executor_preset,
                per_fn_conf=per_fn_conf)
    args["platform" if module is jrepro else "device"] = "cpu"
    module.cmd_repro_clevr(argparse.Namespace(**args))
    report = (work / "REPORT.md").read_text()
    return calls, report


def _port_and_jax(monkeypatch, tmp_path, splits, **kw):
    """The port's stubbed run, after holding it equal to the JAX package's
    (the working directory's name aside)."""
    ours, report = _stubbed(trepro, monkeypatch, tmp_path, splits, **kw)
    theirs, jreport = _stubbed(jrepro, monkeypatch, tmp_path, splits, **kw)
    strip = str(tmp_path) + "/"

    def rel(calls):
        return [[a.replace(strip + "explainable_spatial_vqa_tpu_torch", "W")
                 .replace(strip + "explainable_spatial_vqa_tpu", "W") for a in c] for c in calls]

    assert rel(ours) == rel(theirs)
    assert report == jreport
    return ours, report


def test_repro_cogent_branch_uses_batch_size(monkeypatch, tmp_path, capsys):
    calls, report = _port_and_jax(monkeypatch, tmp_path, BOTH, cogent_b="B")
    ft_trains = [c for c in calls if c[0] == "train" and "ftB" in " ".join(c)]
    assert len(ft_trains) == 2
    for c in ft_trains:
        assert "--batch_size" in c and "4" in c
    assert "## Table 4.6 (CoGenT A->B)" in report
    assert "fine-tune B, eval valB" in report


def test_repro_executor_preset_threads_through(monkeypatch, tmp_path, capsys):
    calls, _ = _port_and_jax(monkeypatch, tmp_path, BOTH, cogent_b="B",
                             executor_preset="executor_roi")
    exe_trains = [c for c in calls if c[0] == "train" and "--annotated_h5" in c]
    assert len(exe_trains) == 2
    for c in exe_trains:
        assert c[c.index("--preset") + 1] == "executor_roi"
    tallies = [c for c in calls if c[0] == "tally"]
    assert len(tallies) == 4
    for c in tallies:
        assert c[c.index("--executor_preset") + 1] == "executor_roi"


def test_repro_per_fn_conf_is_out_of_sample(monkeypatch, tmp_path, capsys):
    calls, report = _port_and_jax(monkeypatch, tmp_path, BOTH, cogent_b="B", per_fn_conf=True)
    tallies = [c for c in calls if c[0] == "tally"]
    assert len(tallies) == 5  # one extra calibration tally on train
    calib = tallies[0]
    assert "--calibrate_conf_per_function" in calib
    assert "--save_conf_thresholds" in calib
    assert calib[calib.index("--annotated_h5") + 1] == "a.h5"
    for c in tallies[1:3]:  # val + zero-shot-B: same model, saved map
        assert "--conf_thresholds" in c
        assert "--calibrate_conf" not in c
        assert "--calibrate_conf_per_function" not in c
    for c in tallies[3:]:  # fine-tuned model: the A-train map is stale
        assert "--calibrate_conf" in c
    assert "fitted on train chains" in report


def test_repro_val_substitution_is_labeled(monkeypatch, tmp_path, capsys):
    splits = {("A", "train"): FULL, ("A", "val"): {"questions_h5": "q.h5"}}  # no features
    _, report = _port_and_jax(monkeypatch, tmp_path, splits)
    assert "TRAIN split substituted" in report
    assert "not held-out" in report


def test_repro_condb_missing_inputs_fails_loud(monkeypatch, tmp_path, capsys):
    splits = {("A", "train"): FULL, ("A", "val"): FULL,
              ("B", "train"): {"questions_h5": "q.h5"},  # no features/annot
              ("B", "val"): FULL}
    for module in (trepro, jrepro):
        with pytest.raises(SystemExit, match="condition-B train split"):
            _stubbed(module, monkeypatch, tmp_path, splits, cogent_b="B")
    with pytest.raises(SystemExit, match="not an executor-family preset"):
        _stubbed(trepro, monkeypatch, tmp_path, BOTH, executor_preset="generator")


NARROW = {
    "generator": dict(embed_dim=16, hidden_dim=24, encoder_layers=1, decoder_layers=1),
    "executor": dict(d_model=32, num_heads=4, encoder_layers=1, box_decoder_layers=1),
}


@pytest.fixture
def narrow_presets(monkeypatch):
    get_preset = tconfig.get_preset

    def narrowed(name):
        base = get_preset(name)
        kw = NARROW["generator" if base.model_family == "generator" else "executor"]
        return base.replace(model=dataclasses.replace(base.model, **kw),
                            train=dataclasses.replace(base.train, log_every=0))

    monkeypatch.setattr(tconfig, "get_preset", narrowed)


def test_repro_clevr_single_invocation(tmp_path, capsys, narrow_presets):
    root = tmp_path / "CLEVR_v1.0"
    mini_clevr_root(root, splits=(("train", 1, 2), ("val", 2, 1)))
    weights = tmp_path / "resnet101.pth"
    torch.save(scaled_random_state(3, seed=11), weights)
    work = tmp_path / "work"
    main(["--device", "cpu", "repro-clevr", "--clevr_root", str(root), "--workdir", str(work),
          "--torch_weights", str(weights), "--gen_epochs", "1", "--exe_epochs", "1",
          "--batch_size", "8", "--eval_limit", "8", "--feature_batch", "2",
          "--executor_preset", "executor_roi", "--per_fn_conf"])
    out = capsys.readouterr().out

    with h5py.File(work / "train_features.h5") as f:  # the full-depth network's layout
        assert f["features"].shape == (2, 1024, 14, 14)
    report = (work / "REPORT.md").read_text()
    for marker in ("Program generator", "Tables 4.2 / 4.3 / 4.4 / 4.5",
                   "correct_program_correct_answer", "per_function_box_pr",
                   "per_function_token_acc", "Table 4.6", "fitted on train chains"):
        assert marker in report, marker
    assert "__global__" in json.load(open(work / "conf_thresholds.json"))
    payload = json.loads(out.strip().splitlines()[-1])
    assert payload["report"].endswith("REPORT.md")
    assert payload["artifacts"]["val"]["annotated_h5"].endswith("annotated_val.h5")
    assert all(pathlib.Path(p).exists() for p in payload["checkpoints"])
