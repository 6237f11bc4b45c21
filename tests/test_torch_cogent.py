"""The port's four-cell CoGenT protocol and its CLI subcommand on the CPU.

- ``run_cogent_protocol`` at the sizes of the JAX package's tests
  (``tests/test_cogent_protocol.py``: the tiny run and the capacity knobs)
  passes that file's structural checks, and its ``sizes`` equal the JAX
  package's (the corpora and the fine-tune slice are the same, computed
  here with the JAX package's own functions).  Training is not bit-equal
  across frameworks, so the cells are checked for range, not value.
- ``cogent-protocol --device cpu`` prints what the JAX package's CLI prints
  for the same result (its report line and per-cell table, by the JAX
  command's own code) and writes the same JSON; without ``--device cpu``
  on a host with no card it raises.
- ``assemble_report`` renders what the JAX package's renders.
"""

import json

import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.clevr import synthetic as jsyn
from explainable_spatial_vqa_tpu.evalsuite import cogent as jcogent
from explainable_spatial_vqa_tpu_torch.cli import main as tcli
from explainable_spatial_vqa_tpu_torch.evalsuite import cogent as tcogent

torch.set_num_threads(1)

TINY = dict(num_scenes_a=8, num_scenes_val=3, num_scenes_b_pool=4, questions_per_scene=4,
            gen_steps=12, exe_steps=12, ft_steps=6, finetune_images=2, finetune_questions=6,
            seed=0)
KNOBS = dict(num_scenes_a=8, num_scenes_val=3, num_scenes_b_pool=4, questions_per_scene=3,
             gen_steps=10, exe_steps=10, ft_steps=5, finetune_images=2, finetune_questions=6,
             seed=0, d_model=48, encoder_layers=1, box_roi=True, lr_schedule="cosine",
             hop_prob=0.8, chain_prob=0.5, max_chain_steps=14)


def _jax_sizes(kw):
    """The protocol's sizes from the JAX package's corpora and subset."""
    corpus = dict(hop_prob=kw.get("hop_prob", 0.0), chain_prob=kw.get("chain_prob", 0.0),
                  max_nodes=kw.get("max_chain_steps", 12))
    q = kw["questions_per_scene"]
    a, val = kw["num_scenes_a"], kw["num_scenes_val"]
    _, train_a = jsyn.synthesize_cogent_dataset(a, q, "A", seed=kw["seed"], **corpus)
    _, val_a = jsyn.synthesize_cogent_dataset(val, q, "A", seed=kw["seed"] + 1,
                                              image_index_base=a, **corpus)
    _, ft_b = jsyn.synthesize_cogent_dataset(kw["num_scenes_b_pool"], q, "B",
                                             seed=kw["seed"] + 3,
                                             image_index_base=a + 2 * val, **corpus)
    subset = jcogent.finetune_subset(np.asarray([x["image_index"] for x in ft_b]),
                                     kw["finetune_images"], kw["finetune_questions"], seed=42)
    return {"train_a_questions": len(train_a), "val_questions": len(val_a),
            "finetune_questions": len(subset)}


def _check_structure(result, kw):
    cells = result["report"].as_dict()
    for name, v in cells.items():
        assert v is not None and 0.0 <= v <= 1.0, (name, v)
    assert list(cells) == list(result["by_type"]) == list(result["tallies"])
    for acc in result["by_type"].values():
        assert set(acc) == {"overall", "count", "exist", "compare_number", "compare_attribute",
                            "query_attribute"}
    for name, tally in result["tallies"].items():
        assert tally.total == result["sizes"]["val_questions"], name
    assert result["sizes"]["finetune_questions"] <= kw["finetune_questions"]
    assert result["sizes"] == _jax_sizes(kw)


@pytest.mark.parametrize("kw", [TINY, KNOBS], ids=["tiny", "capacity_knobs"])
def test_run_cogent_protocol(kw):
    _check_structure(tcogent.run_cogent_protocol(**kw, device="cpu"), kw)


def test_cli_prints_and_writes_what_jax_does(tmp_path, monkeypatch, capsys):
    from explainable_spatial_vqa_tpu.cli import main as jcli

    runs = []

    def recording(**kw):
        runs.append((kw, real(**kw)))
        return runs[-1][1]

    real = tcogent.run_cogent_protocol
    monkeypatch.setattr(tcogent, "run_cogent_protocol", recording)
    flags = ["--scenes_a", "6", "--scenes_val", "2", "--scenes_b_pool", "3",
             "--questions_per_scene", "3", "--gen_steps", "4", "--exe_steps", "3",
             "--ft_steps", "2", "--finetune_images", "2", "--finetune_questions", "5",
             "--d_model", "32", "--encoder_layers", "1", "--box_roi", "--lr_schedule", "cosine",
             "--hop_prob", "0.5", "--seed", "3"]
    tcli.main(["--device", "cpu", "cogent-protocol", *flags,
               "--output_json", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    (kw, result), = runs
    assert kw["device"] == torch.device("cpu")
    _check_structure(result, dict(
        num_scenes_a=6, num_scenes_val=2, num_scenes_b_pool=3, questions_per_scene=3,
        finetune_images=2, finetune_questions=5, seed=3, hop_prob=0.5))

    # the JAX command, handed the port's result: same arguments, same output
    def replay(**jax_kw):
        assert jax_kw == {k: v for k, v in kw.items() if k != "device"}
        return result

    monkeypatch.setattr(jcogent, "run_cogent_protocol", replay)
    jcli.main(["--platform", "cpu", "cogent-protocol", *flags,
               "--output_json", str(tmp_path / "jax.json")])
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    assert port_out.splitlines()[0].startswith("CoGenT: A ")
    assert port_out.splitlines()[2].split() == ["cell", "overall", "count", "exist", "cmp_num",
                                                "cmp_attr", "query"]
    port_json = json.loads((tmp_path / "port.json").read_text())
    assert port_json == json.loads((tmp_path / "jax.json").read_text())
    assert list(port_json) == ["four_cell", "by_type", "sizes"]


def test_cli_needs_cpu_named_without_a_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["cogent-protocol", "--scenes_a", "2"])


def test_assemble_report_equal():
    from explainable_spatial_vqa_tpu.evalsuite import detection as jdet
    from explainable_spatial_vqa_tpu.evalsuite import faithfulness as jfaith
    from explainable_spatial_vqa_tpu.evalsuite.report import assemble_report as jassemble
    from explainable_spatial_vqa_tpu_torch.evalsuite import detection as tdet
    from explainable_spatial_vqa_tpu_torch.evalsuite import faithfulness as tfaith
    from explainable_spatial_vqa_tpu_torch.evalsuite.report import assemble_report

    def parts(det_mod, faith_mod, cogent_mod):
        det = det_mod.DetectionTally()
        boxes = np.asarray([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.8]])
        det.add_box_step("filter_color[red]", boxes, boxes[:1])
        det.add_box_step("relate[left]", boxes[1:], boxes)
        det.add_token_step("count", 3, 3)
        det.add_token_step("exist", "yes", "no")
        faith = faith_mod.FaithfulnessTally(both_correct=5, program_only=2, answer_only=1,
                                            neither=4)
        cogent = cogent_mod.CoGenTReport(0.61, 0.48, None, 0.57)
        return dict(answer_accuracy={"overall": 0.5, "count": 0.25, "exist": None},
                    detection=det, faithfulness=faith, cogent=cogent, extra={"steps": 7})

    t, j = parts(tdet, tfaith, tcogent), parts(jdet, jfaith, jcogent)
    assert assemble_report("run", **t) == jassemble("run", **j)
    assert assemble_report("run", cogent=t["cogent"]) == jassemble("run", cogent=j["cogent"])
