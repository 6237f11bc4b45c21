"""The port's measurement drivers (``explainable_spatial_vqa_tpu_torch.measure``)
against the JAX repo's ``scripts/``: the MFU decomposition's step and FLOP
accounting on bench.py's N=1024 questions computed with JAX's
``plan_sorted`` and the script's own statements; the roofline's 15 classes
and the segment profile's FLOP and bytes models equal to the scripts'
statements (read from their syntax trees and run); each driver's last line
with its JAX counterpart's keys (the JAX pipeline and roofline scripts print
text: their quantities under the port's keys) on a small CPU run; and
without a card each ``main`` raises unless given ``--device cpu``.  The
float32 GEMM's variants (``gemm_variants``) patch the shipped source and
run on the card only."""

import ast
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench as jax_bench  # noqa: E402
from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig  # noqa: E402
from explainable_spatial_vqa_tpu.core.config import GeneratorConfig as JaxGeneratorConfig  # noqa: E402
from explainable_spatial_vqa_tpu.infer.plan import plan_sorted as jax_plan_sorted  # noqa: E402
from explainable_spatial_vqa_tpu_torch import bench  # noqa: E402
from explainable_spatial_vqa_tpu_torch.bench_data import synth_questions  # noqa: E402
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig  # noqa: E402
from explainable_spatial_vqa_tpu_torch.infer.plan import plan_sorted  # noqa: E402
from explainable_spatial_vqa_tpu_torch.ops import _build  # noqa: E402
from explainable_spatial_vqa_tpu_torch.measure import (  # noqa: E402
    gemm_variants,
    mfu_decomposition,
    profile_pipeline,
    profile_segments,
    roofline_step,
    variants,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GEN = dict(vocab_size=96, program_vocab_size=45, program_len=27)
JAX_EXE = dict(vocab_size=64, token_classes=32)
SMALL_EXE = dict(vocab_size=64, token_classes=32, d_model=64, num_heads=4, encoder_layers=2,
                 num_image_tokens=16, image_feature_dim=32)


def script_main(name):
    """The ``main`` function of ``scripts/<name>.py``, as a syntax tree."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", f"{name}.py")).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def run_statements(main, first, last, namespace):
    """Run ``main``'s top-level statements from the one that assigns
    ``first`` to the one that defines or assigns ``last`` in ``namespace``."""
    def names(stmt):
        if isinstance(stmt, ast.FunctionDef):
            return {stmt.name}
        return {t.id for node in getattr(stmt, "targets", []) for t in ast.walk(node)
                if isinstance(t, ast.Name)}

    body = main.body
    start = next(i for i, s in enumerate(body) if first in names(s))
    stop = next(i for i, s in enumerate(body) if last in names(s))
    code = compile(ast.Module(body=body[start:stop + 1], type_ignores=[]), "<script>", "exec")
    exec(code, namespace)
    return namespace


def dict_keys(name, marker):
    """The keys of the dict literal in ``scripts/<name>.py`` that holds ``marker``."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", f"{name}.py")).read())
    found = [n for n in ast.walk(tree) if isinstance(n, ast.Dict) and any(
        isinstance(k, ast.Constant) and k.value == marker for k in n.keys)]
    assert len(found) == 1
    return {k.value for k in found[0].keys}


def test_mfu_accounting_matches_jax_plan():
    """Steps, rows and FLOPs of the sorted run on bench.py's 1024 questions:
    the port's ``flop_accounting`` over its own plan equals the script's
    statements (``mfu_decomposition.py:124-141``) over JAX's ``plan_sorted``."""
    _features, _questions, chains = synth_questions(1024, bench.EXE_CFG)
    num_steps = np.asarray(chains.num_steps)
    jgen, jexe = JaxGeneratorConfig(**JAX_GEN), JaxExecutorConfig(**JAX_EXE)
    jax_plan = [(None, None, depth, size, real)
                for depth, size, _part, real in jax_plan_sorted(num_steps, 128)]
    ref = run_statements(script_main("mfu_decomposition"), "useful_steps", "executed_gen", {
        "np": np, "plan": jax_plan, "n": 1024, "num_steps_np": num_steps, "gen_cfg": jgen,
        "c": jax_bench.flop_components(jgen, jexe)})
    got = mfu_decomposition.flop_accounting(
        bench.GEN_CFG, bench.EXE_CFG, num_steps,
        [(depth, size) for depth, size, _part, _real in plan_sorted(num_steps, 128)])
    for key in ("useful_steps", "executed_steps", "executed_rows", "useful_chain",
                "executed_chain", "useful_gen", "executed_gen"):
        assert got[key] == ref[key], key
    assert got["executed_steps"] > got["useful_steps"] > 0


@pytest.mark.parametrize("batch", [2, 5])
def test_roofline_classes_match_script(batch):
    """The 15 classes of one chain step, their shapes, counts and FLOPs,
    equal the script's list (``roofline_step.py:109-126``) built by its own
    ``matmul_class``, at bench.py's widths."""
    spec = importlib.util.spec_from_file_location(
        "roofline_step_script", os.path.join(REPO, "scripts", "roofline_step.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    cfg = JaxExecutorConfig(**JAX_EXE)
    d, H = cfg.d_model, cfg.num_heads
    L = 1 + cfg.num_image_tokens + cfg.max_input_boxes + 3

    def recorded(name, m, k, n, batch=1):
        got_name, flops, _fn, x0 = script.matmul_class(name, m, k, n, batch)
        return got_name, flops, (m, k, n, batch, tuple(x0.shape))

    ref = run_statements(script_main("roofline_step"), "classes", "classes", {
        "matmul_class": recorded, "B": batch, "L": L, "d": d, "H": H, "hd": d // H,
        "ffn": 4 * d, "Q": cfg.num_queries, "EL": cfg.encoder_layers,
        "DL": cfg.box_decoder_layers, "exe_cfg": cfg})["classes"]
    got = roofline_step.matmul_classes(bench.EXE_CFG, batch)
    assert len(got) == len(ref) == 15
    for c, ((name, flops, (m, k, n, b, x0_shape)), mult) in zip(got, ref):
        assert (c.name, c.m, c.k, c.n, c.batch, c.mult) == (name, m, k, n, b, mult)
        assert c.flops == flops
        assert x0_shape == ((b, m, k) if b > 1 else (m, k))


@pytest.mark.parametrize("exe", ["bench", "small"])
@pytest.mark.parametrize("batch", [1, 128])
def test_segment_models_match_script(exe, batch):
    """One forward's encoder and decoder FLOPs and the encoder block's bytes
    model (fp32-IO and bf16-IO) equal the script's statements
    (``profile_segments.py:145-173``)."""
    kw = JAX_EXE if exe == "bench" else SMALL_EXE
    ref = run_statements(script_main("profile_segments"), "d", "enc_block_bytes",
                         {"exe_cfg": JaxExecutorConfig(**kw), "B": batch})
    cfg = ExecutorConfig(**kw)
    assert profile_segments.forward_flops(cfg, batch) == (ref["enc_flops"], ref["dec_flops"])
    for score_b, ln_b in ((4, 4), (2, 2)):
        assert profile_segments.enc_block_bytes(
            batch, ref["L"], ref["d"], ref["H"], ref["ffn"], score_b, ln_b) == \
            ref["enc_block_bytes"](score_b, ln_b)


def test_chained_matmul_feeds_each_output_forward():
    """A class with n < k writes each product into the first n columns of
    the next left operand; with n >= k the next operand is the product's
    first k columns."""
    for c in roofline_step.matmul_classes(ExecutorConfig(**SMALL_EXE), 1):
        run = roofline_step.chained_matmul(c, torch.device("cpu"), torch.float32)
        one = run(1).clone()  # the n < k buffers are reused by the next run
        two = run(2)
        lead = (c.batch,) if c.batch > 1 else ()
        assert one.shape == two.shape == lead + (c.m, c.k)
        assert torch.isfinite(two).all()
        width = min(c.n, c.k)
        rhs = ((torch.arange(c.batch * c.k * c.n) % 13).reshape(lead + (c.k, c.n))
               * (0.02 / c.k)).float()
        torch.testing.assert_close(two[..., :width], (one @ rhs)[..., :width])


MAINS = {  # module, small arguments, the keys its last line must carry
    "profile_pipeline": (profile_pipeline, [], profile_pipeline.KEYS),
    "profile_segments": (profile_segments, ["--batch", "2", "--depth", "3", "--iters", "1"],
                         dict_keys("profile_segments", "dispatch_ms")),
    "mfu_decomposition": (mfu_decomposition, [], dict_keys("mfu_decomposition",
                                                           "mfu_step_executed")),
    "roofline_step": (roofline_step, ["--batch", "1", "--iters", "1"], roofline_step.KEYS),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_prints_script_keys(monkeypatch, capsys, name):
    """``main --device cpu`` at a small width prints its JSON last, with the
    JAX script's keys; no device number on the CPU."""
    module, argv, keys = MAINS[name]
    monkeypatch.setattr(bench, "GEN_CFG", GeneratorConfig(
        vocab_size=96, program_vocab_size=45, program_len=27, embed_dim=8, hidden_dim=16,
        encoder_layers=2, decoder_layers=2))
    monkeypatch.setattr(bench, "EXE_CFG", ExecutorConfig(**SMALL_EXE))
    for key, value in dict(BENCH_N="12", BENCH_BATCH="4", BENCH_REPEATS="1", PROF_BATCH="4",
                           BENCH_DTYPE="fp32").items():
        monkeypatch.setenv(key, value)
    for key in ("BENCH_PEAK_TFLOPS", "PROF_HBM_GBS"):
        monkeypatch.delenv(key, raising=False)
    result = module.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu (no card)"
    assert json.loads(lines[-1]) == result
    assert set(result) == set(keys) == set(module.KEYS)
    if name == "profile_segments":
        assert set(result["fwd_ms"]) == set(result["chain_ms"]) == {
            v for v, _flags in profile_segments.VARIANTS}
        assert result["fwd_mfu_default"] is None
    if name == "mfu_decomposition":
        assert result["measured_e2e_mfu"] is None and result["chain_time_share"] > 0
    if name == "roofline_step":
        assert len(result["classes"]) == 15 and set(result["k2_gemm_ms"]) == {
            "qkv", "out", "ffn1", "ffn2"}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_needs_a_card_or_cpu(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MAINS[name][0].main(MAINS[name][1])


@pytest.mark.parametrize("name", sorted(gemm_variants.VARIANTS))
def test_gemm_variants_patch_the_shipped_source(name):
    """Each variant of the float32 GEMM is the shipped ``csrc/fused_block.cu``
    with its replacements, each matching exactly once: a source edit that
    moves a patched line fails here, not on the card."""
    patched = variants.variant_sources(gemm_variants.VARIANTS, name)
    assert set(patched) == {"fused_block.cu"}
    source = (_build.CSRC_DIR / "fused_block.cu").read_text()
    assert patched["fused_block.cu"] != source
    for _, old, new in gemm_variants.VARIANTS[name]:
        assert new in patched["fused_block.cu"] or not new


def test_ptxas_usage_reads_each_function():
    """The variant drivers' and ``chip_smoke.py``'s reading of ptxas's
    report: each entry function's registers and spilled bytes, 0 spilled
    where ptxas reports none, the last report of a function kept."""
    log = "\n".join([
        "--- fused_block.cu: exit 0, 70.1 s ---",
        "ptxas info    : Compiling entry function '_ZN3esv15gemm_tf32_wgmmaIfLb0EE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3esv15gemm_tf32_wgmmaIfLb0EE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 536 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN3esv15gemm_bf16_wgmmaIfLb0ELb1EE' for 'sm_90a'",
        "    144 bytes stack frame, 144 bytes spill stores, 144 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 540 bytes cmem[0]",
        "ptxas info    : Compiling entry function 'add_layernorm' for 'sm_90a'",
        "ptxas info    : Used 32 registers, 380 bytes cmem[0]",
    ])
    assert variants.ptxas_usage(log) == {"_ZN3esv15gemm_tf32_wgmmaIfLb0EE": (168, 0),
                                         "_ZN3esv15gemm_bf16_wgmmaIfLb0ELb1EE": (168, 144),
                                         "add_layernorm": (32, 0)}


def test_gemm_variants_need_a_card(monkeypatch):
    """The variants run on the card only (they build with nvcc and launch);
    without one ``main`` raises before building, and an unknown name is
    refused first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gemm_variants.main(["--variants", "long_chain"])
    with pytest.raises(ValueError, match="unknown variants"):
        gemm_variants.main(["--variants", "chain9"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gemm_variants.main(["--variants", "", "--against", "parent=csrc"])
