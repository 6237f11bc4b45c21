"""The port's block bench (``python -m explainable_spatial_vqa_tpu_torch.bench_block``)
against ``scripts/bench_pallas_block.py``: the same shapes, FLOP count and
variants; without a card it raises instead of timing anything."""

import importlib.util
import os

import pytest
import torch

from explainable_spatial_vqa_tpu_torch import bench_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "bench_pallas_block", os.path.join(REPO, "scripts", "bench_pallas_block.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_shapes_and_flops_match_the_script():
    script = _script()
    assert (bench_block.D_MODEL, bench_block.HEADS, bench_block.FFN, bench_block.LENGTH) == (
        script.D_MODEL, script.HEADS, script.FFN, script.LENGTH) == (512, 4, 2048, 224)
    for batch in (1, 128, 256, 512):
        assert bench_block.block_flops(batch) == script.block_flops(batch)


def test_variants_match_the_script():
    """The script's loop (bench_pallas_block.py:102-103): chunks 1 and 2 for
    TB <= 2, TB chunks otherwise."""
    assert bench_block.variants([2, 4, 8]) == [(2, 1), (2, 2), (4, 4), (8, 8)]
    assert bench_block.variants([1, 16]) == [(1, 1), (1, 2), (16, 16)]


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_block.main(["--batches", "2", "--iters", "1"])
    assert "ms" not in capsys.readouterr().out
