"""The port's profiling utilities (``utils/profiling.py``) against the JAX
package's: the phase timers report what JAX's report on the same clock
readings, and ``trace`` writes a Chrome trace naming the ``annotate``
regions (on the CPU here; ``chip_smoke.py`` phase 20.5 checks the card's
kernels in it)."""

import json
import os

import torch

from explainable_spatial_vqa_tpu.utils import profiling as jprof
from explainable_spatial_vqa_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


class _Clock:
    """A perf_counter stand-in that advances by a fixed series of steps."""

    def __init__(self):
        self.now = 100.0
        self.steps = iter([0.25, 1.5, 0.125, 3.0, 0.5, 2.25] * 4)

    def __call__(self):
        self.now += next(self.steps)
        return self.now


def _phases(mod, monkeypatch):
    monkeypatch.setattr(mod.time, "perf_counter", _Clock())
    mod.reset_phases()
    for name in ("annotate", "train", "annotate", "eval", "train", "train"):
        with mod.phase(name, log=True):
            pass
    report = mod.phase_report()
    mod.reset_phases()
    return report


def test_phase_report_equals_jax(monkeypatch):
    report = _phases(tprof, monkeypatch)
    assert report == _phases(jprof, monkeypatch)
    assert report.splitlines()[0] == "phase timings:" and "3 calls" in report
    assert tprof.phase_report() == "phase timings:"  # reset


def test_trace_writes_annotated_regions(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as path:
        with tprof.annotate("esv_region_outer"):
            with tprof.annotate("esv_region_inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"esv_region_outer", "esv_region_inner"} <= names
    assert any(n and "mm" in n for n in names)  # the matmul's host op


def test_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with tprof.trace(log_dir) as path:
            with tprof.annotate("region"):
                pass
        assert path is None
    assert not os.listdir(tmp_path)
