"""The port's timing scripts for the CoGenT protocol
(``python -m explainable_spatial_vqa_tpu_torch.bench_cogent``) and for the
generator's decoding (``bench_decode``): ``ProtocolParts`` records
``run_cogent_protocol``'s eight calls in ``PART_LABELS``' order, with one
step time per optimizer step and the module's functions restored after;
without a card both scripts raise instead of timing anything."""

import time

import pytest
import torch

from explainable_spatial_vqa_tpu_torch import bench_cogent, bench_decode
from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import run_cogent_protocol
from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol as sp

torch.set_num_threads(1)

SMALL = dict(num_scenes_a=6, num_scenes_val=3, num_scenes_b_pool=4, questions_per_scene=3,
             gen_steps=4, exe_steps=3, ft_steps=2, finetune_images=2, finetune_questions=4,
             d_model=48, encoder_layers=1, box_roi=True, lr_schedule="cosine", seed=0)


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.mark.parametrize("module,argv", [(bench_cogent, ["--", "--gen_steps", "1"]),
                                         (bench_decode, ["--questions", "2"])],
                         ids=["bench_cogent", "bench_decode"])
def test_main_needs_a_card(module, argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert "{" not in capsys.readouterr().out


def test_protocol_parts_record_the_protocol(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    originals = {name: getattr(sp, name) for name in bench_cogent.ProtocolParts.NAMES}
    with bench_cogent.ProtocolParts() as parts:
        result = run_cogent_protocol(**SMALL, device="cpu")
    assert {name: getattr(sp, name) for name in originals} == originals
    rows = bench_cogent.part_rows(parts)
    assert [r["part"] for r in rows] == [label for _, label in bench_cogent.PART_LABELS]
    assert [r["steps"] for r in rows] == [4, 3, 0, 0, 2, 2, 0, 0]
    assert all(r["seconds"] > 0 and (r["K2"], r["K1"]) == (0, 0) for r in rows)
    assert all((r["median_step_ms"] is None) == (r["steps"] == 0) for r in rows)
    evaluations = parts.of("evaluate_pipeline_synthetic")
    assert [c["result"][0] for c in evaluations] == list(result["tallies"].values())
    parts.calls.reverse()
    with pytest.raises(RuntimeError, match="protocol's calls"):
        bench_cogent.part_rows(parts)
