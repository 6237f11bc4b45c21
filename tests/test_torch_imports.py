"""The port imports neither JAX nor the JAX package (the modules of the
last slice, the native engine, lowp, parallel/ and the profiler, the
demos of demos/, the bench and the drivers of measure/ included),
and its entry points
(the CLI, the evaluation functions and the feature extractor included) run on
the card unless asked for the CPU; no module imports h5py, PIL or matplotlib
when it is imported.  Checked in a
fresh interpreter: this test process has JAX
loaded already (tests/conftest.py)."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from explainable_spatial_vqa_tpu_torch import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = textwrap.dedent("""
    import importlib, pkgutil, sys
    import explainable_spatial_vqa_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                           "explainable_spatial_vqa_tpu"))
    assert not leaked, leaked
    # only the file readers and writers, the image decode and the plot import
    # these, inside the call
    for lazy in ("h5py", "PIL", "matplotlib"):
        assert lazy not in sys.modules, lazy + " at import"
    assert len(names) >= 20, names
    for name in ("cli", "cli.main", "evalsuite.detection", "evalsuite.accuracy",
                 "evalsuite.executor_eval", "train.scheduled", "clevr.scenes", "clevr.executor",
                 "clevr.bboxes", "clevr.annotate", "clevr.synthetic", "core.tokenizer",
                 "evalsuite.cogent", "evalsuite.report", "train.synthetic_protocol",
                 "ops.decoding", "models.iqap", "models.lstm_iqap", "models.step_executor",
                 "core.annotated_strings", "models.cot", "models.prototypes", "vision",
                 "vision.extract", "vision.resnet", "core.reshape", "core.artifacts",
                 "utils", "utils.logging", "utils.plots", "utils.visualize", "cli.repro",
                 "clevr.native", "ops.lowp", "parallel", "parallel.mesh", "parallel.multihost",
                 "parallel.sharding", "utils.profiling", "ops.matching", "demos",
                 "demos.common", "demos.accuracy_table", "demos.end_to_end",
                 "demos.data_efficiency", "demos.executor_data_efficiency",
                 "demos.scheduled_sampling", "demos.scheduled_stats",
                 "demos.scheduled_at_scale", "demos.diag_box_roi", "demos.diag_roi_sim",
                 "demos.diag_count_embed", "bench", "measure", "measure.profile_pipeline",
                 "measure.profile_segments", "measure.mfu_decomposition",
                 "measure.roofline_step"):
        assert pkg.__name__ + "." + name in names, name
    import torch
    assert not torch.cuda.is_available()
    from explainable_spatial_vqa_tpu_torch.cli.main import (
        main, run_eval_generator, run_eval_iqap, run_infer_chain, run_tally)
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
    from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import evaluate_executor_steps
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor

    def needs_cpu_named(call):
        try:
            call()
        except RuntimeError as err:
            assert "device='cpu'" in str(err), err
        else:
            raise AssertionError("an entry point without device= ran on a host with no GPU")

    cfg = ExecutorConfig(d_model=32, num_heads=4)
    needs_cpu_named(lambda: ProgramExecutor(cfg))
    executor = ProgramExecutor(cfg, device="cpu")
    needs_cpu_named(lambda: evaluate_executor_steps(executor, [], {}))
    needs_cpu_named(lambda: run_eval_generator(None, None, None))
    needs_cpu_named(lambda: run_tally(None, executor, cfg, None, None, None, {}, {}, {}))
    needs_cpu_named(lambda: main(["train", "--preset", "executor_scheduled"]))
    needs_cpu_named(lambda: main(["cogent-protocol"]))
    from explainable_spatial_vqa_tpu_torch.core import config as tconfig
    from explainable_spatial_vqa_tpu_torch.infer.chain import Seq2SeqChainRunner
    from explainable_spatial_vqa_tpu_torch.models.iqap import TransformerIQAP
    from explainable_spatial_vqa_tpu_torch.models.lstm_iqap import LstmIQAP
    from explainable_spatial_vqa_tpu_torch.models.step_executor import StepExecutorSeq2Seq
    from explainable_spatial_vqa_tpu_torch.train.pipelines import (
        iqap_pipeline_from_arrays, lstm_iqap_pipeline_from_arrays,
        step_seq2seq_pipeline_from_arrays)
    needs_cpu_named(lambda: TransformerIQAP(tconfig.IQAPConfig(embed_dim=32)))
    needs_cpu_named(lambda: LstmIQAP(tconfig.LstmIQAPConfig(hidden_dim=8, image_spatial=(1, 1))))
    needs_cpu_named(lambda: StepExecutorSeq2Seq(tconfig.StepSeq2SeqConfig(d_model=32)))
    needs_cpu_named(lambda: Seq2SeqChainRunner(None, None))
    needs_cpu_named(lambda: run_eval_iqap(None, None, None, None))
    needs_cpu_named(lambda: run_infer_chain(None, None, None, []))
    for preset, build in (("transformer_iqap", iqap_pipeline_from_arrays),
                          ("lstm_iqa", lstm_iqap_pipeline_from_arrays),
                          ("step_seq2seq", step_seq2seq_pipeline_from_arrays)):
        needs_cpu_named(lambda: build(tconfig.get_preset(preset), {}, None))
    needs_cpu_named(lambda: main(["train", "--preset", "transformer_iqap"]))
    from explainable_spatial_vqa_tpu_torch.models import prototypes as proto
    from explainable_spatial_vqa_tpu_torch.train.pipelines import (
        iqap_cot_pipeline_from_arrays, prototype_step_pipeline_from_arrays)
    for make in (proto.TokenOnlyPredictor, proto.BBoxOnlyPredictor,
                 proto.MultiTaskBBoxTokenPredictor, proto.BBoxSelectionPredictor,
                 proto.MultiHeadStepModel, proto.HierarchicalGenerator, proto.YoloDetector,
                 proto.CompositionalStepPredictor):
        needs_cpu_named(make)
    needs_cpu_named(lambda: iqap_cot_pipeline_from_arrays(
        tconfig.get_preset("transformer_iqap_cot"), {}, {}, None))
    needs_cpu_named(lambda: prototype_step_pipeline_from_arrays(
        tconfig.get_preset("multihead"), {}, {}, {}, None))
    for preset in ("transformer_iqap_cot", "yolo_bb", "hierarchical"):
        needs_cpu_named(lambda: main(["train", "--preset", preset]))

    from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import run_cogent_protocol
    from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol as sp
    needs_cpu_named(lambda: run_cogent_protocol())
    needs_cpu_named(lambda: sp.train_generator_synthetic([], {}))
    needs_cpu_named(lambda: sp.train_executor_synthetic([], {}, None))
    needs_cpu_named(lambda: sp.train_executor_scheduled_synthetic([], {}, None))
    needs_cpu_named(lambda: sp.evaluate_pipeline_synthetic(None, None, None, [], None, {}, {}))
    from explainable_spatial_vqa_tpu_torch.vision.extract import extract_features
    from explainable_spatial_vqa_tpu_torch.vision.resnet import Bottleneck, ResNetFeatures
    needs_cpu_named(lambda: ResNetFeatures())
    needs_cpu_named(lambda: Bottleneck(64, 16, 64))
    needs_cpu_named(lambda: extract_features([], "features.h5"))
    needs_cpu_named(lambda: main(["extract-features", "--input_image_dir", ".",
                                  "--output_h5_file", "features.h5"]))
    needs_cpu_named(lambda: main(["repro-clevr", "--clevr_root", ".", "--workdir", "w"]))
    for demo in ("accuracy_table", "end_to_end", "diag_box_roi"):
        needs_cpu_named(importlib.import_module(pkg.__name__ + ".demos." + demo).main)
    for driver in ("bench", "measure.profile_pipeline", "measure.profile_segments",
                   "measure.mfu_decomposition", "measure.roofline_step"):
        needs_cpu_named(lambda: importlib.import_module(pkg.__name__ + "." + driver).main([]))
    print("ok", len(names))
""")


def test_port_imports_no_jax_and_defaults_to_cuda():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A kernel build with no nvcc anywhere raises and writes nothing."""
    from explainable_spatial_vqa_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_HOMES", ())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["fused_attention", "fused_block"])
    assert not (tmp_path / "_build").exists()


def test_library_path_follows_the_source(monkeypatch, tmp_path):
    """The built library's name carries a hash of its source and headers, so
    an edited source builds anew."""
    from explainable_spatial_vqa_tpu_torch.ops import _build

    for name in ("fused_attention.cu", "fused_block.cu", "common.cuh"):
        (tmp_path / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {n: _build._library_path(n) for n in ("fused_attention", "fused_block")}
    assert before["fused_attention"] != before["fused_block"]
    (tmp_path / "common.cuh").write_text("// edited\n")
    after = {n: _build._library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
