"""The port's demo and diagnostic scripts (``explainable_spatial_vqa_tpu_torch.demos``)
on the CPU, against the JAX package's scripts.

- Parity: JAX's ``scripts/demo_accuracy_table.py`` runs in a subprocess on
  the CPU at 30 scenes x 4 questions, 250 generator and 60 executor steps,
  d_model 32 (enough for a nonzero program EM and nonzero box P/R rows); its
  pickled Flax variables, converted with ``convert.flax_to_state_dict``,
  become the port's checkpoint, so the port's demo resumes with 0 steps.
  The port's section must equal JAX's line for line, but for the header line
  (the script's name, the platform and the wall time).  The subprocess starts
  with the module's first test and runs beside the others.
- Smoke: every other demo once at a tiny size with ``DEMO_DEVICE=cpu``;
  it writes its marked section (or report), and the parts that do not depend
  on training equal what the JAX package's own functions give on the same
  corpus: corpus and evaluation sizes, gt box and token counts per function,
  and row labels.
- No card: each demo raises unless ``DEMO_DEVICE=cpu``; the sections never
  go to ``DEMO.md``.
"""

import importlib
import os
import pickle
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.clevr import annotate as jann
from explainable_spatial_vqa_tpu.clevr import synthetic as jsyn
from explainable_spatial_vqa_tpu.clevr.scenes import Scene as JScene
from explainable_spatial_vqa_tpu.core import vocab as jvoc
from explainable_spatial_vqa_tpu.evalsuite.detection import DetectionTally as JTally
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.demos import accuracy_table, common

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = ("accuracy_table", "end_to_end", "data_efficiency", "executor_data_efficiency",
           "scheduled_sampling", "scheduled_stats", "scheduled_at_scale", "diag_box_roi",
           "diag_roi_sim", "diag_count_embed")
PARITY = dict(DEMO_SCENES="30", DEMO_QPS="4", DEMO_GEN_STEPS="250", DEMO_EXE_STEPS="60",
              DEMO_DMODEL="32")


@pytest.fixture(scope="module", autouse=True)
def jax_accuracy_table(tmp_path_factory):
    """JAX's accuracy table at PARITY's sizes, started in the background
    with the module's first test: (process, its DEMO_OUT, its checkpoint)."""
    out_dir = tmp_path_factory.mktemp("jax_demo")
    tag = f"torch_parity_{uuid.uuid4().hex[:12]}"
    out = out_dir / f"{tag}.md"
    ckpt = os.path.join(REPO, "results", f"acc_ckpt_{tag}.pkl")
    env = dict(os.environ, JAX_PLATFORMS="cpu", DEMO_PLATFORM="cpu", DEMO_OUT=str(out), **PARITY)
    log = open(out_dir / "jax.log", "w")
    proc = subprocess.Popen([sys.executable, os.path.join(REPO, "scripts",
                                                          "demo_accuracy_table.py")],
                            env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    yield proc, out, ckpt, out_dir / "jax.log"
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()
    for path in (ckpt, ckpt + ".tmp"):
        if os.path.exists(path):
            os.remove(path)


@pytest.fixture
def demo_env(monkeypatch, tmp_path):
    """DEMO_DEVICE=cpu and a DEMO_OUT under tmp_path; returns the out path."""
    out = tmp_path / "demo.md"
    monkeypatch.setenv("DEMO_DEVICE", "cpu")
    monkeypatch.setenv("DEMO_OUT", str(out))
    return out


def _section(text, begin, end):
    assert begin in text and end in text, text[-2000:]
    return text.split(begin, 1)[1].split(end, 1)[0]


def _jax_corpus(num_scenes, qps, seed, **kwargs):
    """The JAX package's corpus: (questions, annotated, split vocab)."""
    scenes_raw, questions = jsyn.synthesize_dataset(num_scenes, qps, seed=seed, **kwargs)
    scenes = {s["image_index"]: JScene.from_raw(s) for s in scenes_raw}
    annotated = jann.annotate_questions(questions, scenes)
    return questions, annotated, jvoc.build_split_vocab(annotated)


def _held_out(records, num_scenes):
    train = set(range(int(num_scenes * 0.8)))
    return [r for r in records if r["image_index"] not in train]


def _gt_fed_counts(eval_ann, vocabs):
    """The GT-fed tally's ground-truth counts by function, by JAX's own
    step arrays and DetectionTally (no predictions)."""
    arrays = jds.executor_step_arrays(eval_ann, vocabs["function"], vocabs["other"],
                                      max_input_boxes=8, max_output_boxes=8)
    names = {v: k for k, v in vocabs["function"].items()}
    tally = JTally()
    for i in range(len(arrays["text"])):
        fn = names.get(int(arrays["text"][i][0]), "unknown")
        if arrays["is_box_branch"][i]:
            tally.add_box_step(fn, np.zeros((0, 4)),
                               arrays["target_boxes"][i][arrays["target_box_mask"][i]])
        else:
            tally.add_token_step(fn, -1, int(arrays["token_target"][i]))
    return dict(tally.box_gt), dict(tally.token_total)


def _table_rows(section, header_start):
    """{first cell: cells} of the markdown table whose header starts with
    ``header_start``."""
    lines = section.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(header_start))
    rows = {}
    for line in lines[start + 2:]:
        if not line.startswith("|"):
            break
        cells = [c.strip() for c in line.strip("|").split("|")]
        rows[cells[0]] = cells[1:]
    return rows


@pytest.mark.parametrize("name", DEMOS)
def test_demo_needs_a_card_unless_asked_for_the_cpu(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DEMO_DEVICE", raising=False)
    monkeypatch.setenv("DEMO_OUT", str(tmp_path / "out.md"))
    module = importlib.import_module(f"explainable_spatial_vqa_tpu_torch.demos.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main()
    assert not (tmp_path / "out.md").exists()


def test_sections_never_go_to_demo_md(monkeypatch):
    monkeypatch.delenv("DEMO_OUT", raising=False)
    assert common.out_path() == common.DEFAULT_OUT
    assert common.DEFAULT_OUT.name == "DEMO_TORCH.md"
    monkeypatch.setenv("DEMO_OUT", os.path.join(REPO, "DEMO.md"))
    with pytest.raises(ValueError, match="JAX package's record"):
        common.splice_section("x", "<!-- a -->", "<!-- b -->")


def test_splice_section_is_idempotent(demo_env):
    demo_env.write_text("# title\n\n<!-- s:begin -->old<!-- s:end -->\ntail\n")
    common.splice_section("<!-- s:begin -->new<!-- s:end -->", "<!-- s:begin -->",
                          "<!-- s:end -->")
    assert demo_env.read_text() == "# title\n\n<!-- s:begin -->new<!-- s:end -->\ntail\n"
    common.splice_section("<!-- t:begin -->x<!-- t:end -->", "<!-- t:begin -->", "<!-- t:end -->")
    assert demo_env.read_text().endswith("tail\n\n<!-- t:begin -->x<!-- t:end -->\n")


def test_end_to_end_smoke(demo_env, monkeypatch, capsys):
    from explainable_spatial_vqa_tpu_torch.demos import end_to_end

    for k, v in dict(DEMO_SCENES="10", DEMO_GEN_STEPS="3", DEMO_EXE_STEPS="3").items():
        monkeypatch.setenv(k, v)
    end_to_end.main()
    text = demo_env.read_text()
    assert text == capsys.readouterr().out.split("running full pipeline on ")[1].split(
        "\n", 1)[1]
    _, questions = jsyn.synthesize_dataset(10, 6, seed=3)
    n_eval = len(_held_out(questions, 10))
    assert (f"- corpus: {len(questions)} questions / 10 scenes; eval: {n_eval} questions on 2 "
            f"held-out scenes") in text
    assert f"Faithfulness over {n_eval} samples:" in text


def test_data_efficiency_smoke(monkeypatch, capsys):
    from explainable_spatial_vqa_tpu_torch.demos import data_efficiency

    monkeypatch.setenv("DEMO_DEVICE", "cpu")
    monkeypatch.setattr(data_efficiency, "STEPS", 2)
    data_efficiency.main()
    out = capsys.readouterr().out
    _, questions = jsyn.synthesize_dataset(150, 5, seed=9)
    pool = len(questions) - 150
    sizes = [max(int(pool * f), 16) for f in (0.1, 0.3, 1.0)]
    found = [int(line.split()[0]) for line in out.splitlines()
             if "training questions -> held-out program EM" in line]
    assert found == sizes
    assert out.splitlines()[-1].startswith("{'0.1': ")


def test_executor_data_efficiency_smoke(demo_env, monkeypatch):
    from explainable_spatial_vqa_tpu_torch.demos import executor_data_efficiency as ede

    steps = 2
    knobs = dict(DEMO_SCENES="10", DEMO_QPS="2", DEMO_SIZES="4,9", DEMO_EXE_STEPS=str(steps))
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    rows_path = os.path.join(REPO, "results", f"dataeff_rows_torch_{steps}.json")
    if os.path.exists(rows_path):  # left by an interrupted run of this test
        os.remove(rows_path)
    try:
        ede.main()
    finally:
        if os.path.exists(rows_path):
            os.remove(rows_path)
    section = _section(demo_env.read_text(), ede.BEGIN, ede.END)
    _, annotated, vocabs = _jax_corpus(10, 2, 0, hop_prob=1.0, chain_prob=0.8, max_nodes=16)
    eval_ann = [a for a in _held_out(annotated, 10)
                if 0 < len(jds._parse_question_steps(a, vocabs["function"], vocabs["other"]))
                <= 16]
    assert f"FIXED {len(eval_ann)}-question held-out-scene set" in section
    assert "PARTIAL" not in section
    assert sorted(int(r) for r in _table_rows(section, "| train questions")) == [4, 9]


def test_scheduled_sampling_smoke(demo_env, monkeypatch):
    from explainable_spatial_vqa_tpu_torch.demos import scheduled_sampling

    for k, v in dict(DEMO_SCENES="5", DEMO_GEN_STEPS="2", DEMO_EXE_STEPS="1").items():
        monkeypatch.setenv(k, v)
    scheduled_sampling.main()
    section = _section(demo_env.read_text(), scheduled_sampling.BEGIN, scheduled_sampling.END)
    assert list(_table_rows(section, "| training regime")) == [
        "teacher-forced (reference protocol)", "grounding noise (noise=0.05, drop=0.15)",
        "scheduled sampling (p_max=0.5, chain-level)"]
    assert "— 5 scenes, 1 executor steps per regime" in section


@pytest.mark.parametrize("name", ["scheduled_stats", "scheduled_at_scale"])
def test_multi_seed_smoke(name, demo_env, monkeypatch, tmp_path):
    module = importlib.import_module(f"explainable_spatial_vqa_tpu_torch.demos.{name}")
    knobs = dict(DEMO_SEEDS="2", DEMO_SCENES="3", DEMO_GEN_STEPS="2", DEMO_EXE_STEPS="1",
                 DEMO_EVAL_SCENES="2", DEMO_CKPT=str(tmp_path / "ckpt.json"))
    if name == "scheduled_stats":
        knobs["DEMO_EVAL_QPS"] = "2"
    else:  # its cosine schedule, as optax's, needs more steps than its warmup of 1
        knobs.update(DEMO_EXE_STEPS="2", DEMO_DMODEL="32", DEMO_LAYERS="1")
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    module.main()
    section = _section(demo_env.read_text(), module.BEGIN, module.END)
    if name == "scheduled_stats":
        _, eval_q = jsyn.synthesize_dataset(2, 2, seed=999)
        labels = ["teacher-forced (reference protocol)", "grounding noise (0.05/0.15)",
                  "scheduled sampling (p_max=0.3, from scratch)",
                  "TF then scheduled fine-tune (last 20% @ p=0.3)"]
        assert (tmp_path / "scheduled_stats_torch.json").exists()
    else:
        _, eval_q = jsyn.synthesize_dataset(2, 8, seed=999, hop_prob=1.0, chain_prob=0.8,
                                            max_nodes=16)
        labels = ["flagship recipe (noise 0.03/0.1, cosine, d=32, 1L, box_roi)",
                  "+ scheduled sampling (p_max=0.3, from scratch)"]
    assert f"ONE fixed {len(eval_q)}-question eval set on 2 never-trained scenes" in section
    rows = _table_rows(section, "| training regime")
    assert list(rows) == labels
    assert all(len(cells[-1].split()) == 2 for cells in rows.values())  # two seeds each


@pytest.mark.parametrize("name,synth,arms", [
    ("diag_box_roi", dict(hop_prob=0.3), ("base", "box_roi")),
    ("diag_roi_sim", dict(hop_prob=1.0, chain_prob=0.8, max_nodes=16), ("box_roi", "+roi_sim")),
    ("diag_count_embed", dict(hop_prob=0.3), ("box_roi", "+ count_embed")),
])
def test_diagnostic_smoke(name, synth, arms, demo_env, monkeypatch):
    module = importlib.import_module(f"explainable_spatial_vqa_tpu_torch.demos.{name}")
    for k, v in dict(DIAG_SCENES="10", DIAG_QPS="2", DIAG_STEPS="2").items():
        monkeypatch.setenv(k, v)
    module.main()
    section = _section(demo_env.read_text(), module.BEGIN, module.END)
    _, annotated, vocabs = _jax_corpus(10, 2, 7, **synth)
    box_gt, token_total = _gt_fed_counts(_held_out(annotated, 10), vocabs)
    tokens = _table_rows(section, "| function | " + arms[0])
    assert section.count(f"| function | {arms[0]} | {arms[1]} | n |") == 1
    assert {fn: int(cells[-1]) for fn, cells in tokens.items()} == token_total
    boxes = _table_rows(section.split("### Box P/R")[1], "| function |")
    assert {fn: int(cells[-1]) for fn, cells in boxes.items()} == box_gt


def test_accuracy_table_parity_with_jax(jax_accuracy_table, monkeypatch, tmp_path):
    """The port's section from JAX's converted weights equals JAX's, line for
    line, apart from the header line."""
    proc, jax_out, jax_ckpt, log = jax_accuracy_table
    try:
        proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, log.read_text()[-3000:]
    with open(jax_ckpt, "rb") as f:
        ck = pickle.load(f)
    port_out = tmp_path / f"{jax_out.stem}_port.md"
    monkeypatch.setenv("DEMO_DEVICE", "cpu")
    monkeypatch.setenv("DEMO_OUT", str(port_out))
    for k, v in PARITY.items():
        monkeypatch.setenv(k, v)
    port_ckpt = accuracy_table.ckpt_path()
    converted = {"sig": ck["sig"]}
    for part in ("gen", "exe"):
        state = flax_to_state_dict(ck[part]["vars"]["params"])
        converted[part] = {"vars": {k: v.numpy() for k, v in state.items()},
                           "loss": float(ck[part]["loss"])}
    with open(port_ckpt, "wb") as f:
        pickle.dump(converted, f)
    try:
        t0 = time.time()
        accuracy_table.run()
        assert time.time() - t0 < 120
    finally:
        os.remove(port_ckpt)
    jax_lines = _section(jax_out.read_text(), accuracy_table.BEGIN,
                         accuracy_table.END).splitlines()
    port_lines = _section(port_out.read_text(), accuracy_table.BEGIN,
                          accuracy_table.END).splitlines()
    assert len(port_lines) == len(jax_lines)
    header = [i for i, line in enumerate(jax_lines) if line.startswith("`scripts/")]
    assert header == [3]
    assert port_lines[3].startswith("`python -m explainable_spatial_vqa_tpu_torch.demos."
                                    "accuracy_table` — 30 scenes × 4 questions")
    for i, (a, b) in enumerate(zip(jax_lines, port_lines)):
        if i != 3:
            assert a == b, (i, a, b)
    # the sizes chosen show a nonzero program EM and a nonzero box P/R row
    em = next(line for line in jax_lines if line.startswith("Program EM"))
    assert float(em.split()[2]) > 0
    pr = _table_rows("\n".join(jax_lines), "| function | precision")
    assert any(float(cells[0]) > 0 or float(cells[1]) > 0 for cells in pr.values())
