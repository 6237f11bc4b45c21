"""The port bench (``python -m explainable_spatial_vqa_tpu_torch.bench``)
against the root ``bench.py`` on the CPU: the FLOP accounting integer for
integer, and, at a small width in float32 with the JAX modules' weights
(``flax_to_state_dict``), the programs and answer token caches of both
modes equal to what bench.py's pieces compute with JAX (argmax-exact: every
decision's margin is held above 1e-4, far above float32's disagreement);
the reference-style loop's answers equal the vectorized run's; the last
line carries bench.py's keys; without a card ``main`` raises unless given
``--device cpu``."""

import ast
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench as jax_bench  # noqa: E402
from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig  # noqa: E402
from explainable_spatial_vqa_tpu.core.config import GeneratorConfig as JaxGeneratorConfig  # noqa: E402
from explainable_spatial_vqa_tpu.infer.chain import chained_forward as jax_chained_forward  # noqa: E402
from explainable_spatial_vqa_tpu.infer.chain import (  # noqa: E402
    chained_forward_pool as jax_chained_forward_pool,
)
from explainable_spatial_vqa_tpu.infer.plan import plan_sorted as jax_plan_sorted  # noqa: E402
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor  # noqa: E402
from explainable_spatial_vqa_tpu.models.generator import ProgramGenerator as JaxGenerator  # noqa: E402
from explainable_spatial_vqa_tpu_torch import bench  # noqa: E402
from explainable_spatial_vqa_tpu_torch.bench_data import synth_questions  # noqa: E402
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_GEN = dict(vocab_size=96, program_vocab_size=45, program_len=27, embed_dim=16,
                 hidden_dim=32)
SMALL_EXE = dict(vocab_size=64, token_classes=32, d_model=64, num_heads=4, encoder_layers=2,
                 num_image_tokens=16, image_feature_dim=32)
N, BATCH = 16, 6  # 16 questions: sorted batches of 6, 6 and a padded tail of 4
MARGIN = 1e-4


def json_keys(path, holder):
    """The keys of the dict literal that ``holder(node)`` picks from ``path``'s
    syntax tree."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    found = [node for node in ast.walk(tree) if holder(node)]
    assert len(found) == 1, path
    return {k.value for k in found[0].keys}


def bench_json_keys():
    """The keys bench.py prints (``json.dumps({...})`` in ``main``)."""
    return json_keys("bench.py", lambda node: isinstance(node, ast.Dict) and any(
        isinstance(k, ast.Constant) and k.value == "vs_baseline" for k in node.keys))


@pytest.mark.parametrize("configs", ["bench", "small"])
def test_flops_match_bench(configs):
    """flop_components and analytic_flops_per_question equal bench.py's,
    integer for integer; the count as built differs only in the encode."""
    gen_kw, exe_kw = ({}, {}) if configs == "bench" else (SMALL_GEN, SMALL_EXE)
    if configs == "bench":
        gen, exe = bench.GEN_CFG, bench.EXE_CFG
        jgen = JaxGeneratorConfig(vocab_size=96, program_vocab_size=45, program_len=27)
        jexe = JaxExecutorConfig(vocab_size=64, token_classes=32)
    else:
        gen, exe = GeneratorConfig(**gen_kw), ExecutorConfig(**exe_kw)
        jgen, jexe = JaxGeneratorConfig(**gen_kw), JaxExecutorConfig(**exe_kw)
    for q_len in (46, 9):
        ref = jax_bench.flop_components(jgen, jexe, q_len)
        got = bench.flop_components(gen, exe, q_len)
        assert got == ref
        assert all(isinstance(v, int) for v in got.values())
        built = bench.flop_components(gen, exe, q_len, as_built=True)
        assert {k: v for k, v in built.items() if k != "gen_encode"} == {
            k: v for k, v in ref.items() if k != "gen_encode"}
        for steps in range(1, 28):
            assert bench.analytic_flops_per_question(gen, exe, q_len, steps) == \
                jax_bench.analytic_flops_per_question(jgen, jexe, q_len, steps)
    if configs == "bench":  # 46 tokens: 1.4636 GFLOP by bench.py's formula, 1.0777 as built
        assert jax_bench.flop_components(jgen, jexe)["gen_encode"] == 1_463_615_488
        assert bench.flop_components(gen, exe, as_built=True)["gen_encode"] == 1_077_739_520


def _seeded(shapes, seed):
    """A parameter tree of the JAX module's shapes (``jax.eval_shape`` of its
    init: nothing compiles), filled from ``seed`` with flax's initialisers'
    scales: kernels normal / sqrt(fan in) (an attention ``out`` kernel's fan
    in is heads x head dim), biases 0, LayerNorm scales 1, embeddings
    N(0, 1) / sqrt(width), the rest (CLS, positions, queries) 0.02 N(0, 1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("bias", "scale"):
            return np.full(s.shape, float(name == "scale"), np.float32)
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]) if path[-2].key == "out" else s.shape[0])
        else:
            std = 1.0 / np.sqrt(s.shape[-1]) if name == "embedding" else 0.02
        return (std * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


@pytest.fixture(scope="module")
def pair():
    """The port's pipeline, float32 on the CPU, with the JAX generator's and
    executor's weights (the heads scaled up so that decisions spread), and
    what bench.py's pieces give with JAX on ``N`` questions: the programs,
    the pool's token cache and each sorted batch's."""
    jgen_cfg, jexe_cfg = JaxGeneratorConfig(**SMALL_GEN), JaxExecutorConfig(**SMALL_EXE)
    jgen, jexe = JaxGenerator(jgen_cfg), JaxExecutor(jexe_cfg)
    c = jexe_cfg
    gparams = _seeded(jax.eval_shape(
        jgen.init, {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.zeros((2, 46), jnp.int32), jnp.zeros((2, 27), jnp.int32)), 0)
    eparams = _seeded(jax.eval_shape(
        jexe.init, jax.random.PRNGKey(2), jnp.zeros((2, c.num_image_tokens, c.image_feature_dim)),
        jnp.zeros((2, c.max_input_boxes, 4)), jnp.ones((2, c.max_input_boxes), bool),
        jnp.zeros((2, 3), jnp.int32), jnp.ones((2, 3), bool)), 1)
    gparams["out_proj"]["kernel"] *= 10.0
    for head in (eparams["box_decoder"]["head_out"], eparams["routing_head"],
                 eparams["token_head"]):
        head["kernel"] *= 20.0
    pipe = bench.build_pipeline(force_fp32=True, device="cpu", gen_cfg=GeneratorConfig(**SMALL_GEN),
                                exe_cfg=ExecutorConfig(**SMALL_EXE))
    pipe.generator.load_state_dict(flax_to_state_dict(gparams))
    pipe.executor.load_state_dict(flax_to_state_dict(eparams))

    gvars = {"params": jax.tree_util.tree_map(jnp.asarray, gparams)}
    evars = {"params": jax.tree_util.tree_map(jnp.asarray, eparams)}
    features, questions, chains = synth_questions(N, pipe.exe_cfg)
    programs = np.asarray(jax.jit(lambda q: jgen.apply(gvars, q, method=jgen.generate))(
        jnp.asarray(questions)))
    args = tuple(jnp.asarray(a) for a in (features, chains.image_index, chains.functions,
                                          chains.deps, chains.num_steps))
    max_steps = chains.functions.shape[1]
    pool = jax.jit(lambda *a: jax_chained_forward_pool(
        jexe, evars, *a, jexe_cfg, max_steps=max_steps, slots=BATCH))(*args)

    def batch_step(sel, depth, feats, img_idx, fns, dps, nsteps):  # bench.py:298-308
        img = jnp.take(feats, jnp.take(img_idx, sel, axis=0), axis=0)
        return jax_chained_forward(jexe, evars, img, jnp.take(fns, sel, axis=0),
                                   jnp.take(dps, sel, axis=0), jnp.take(nsteps, sel, axis=0),
                                   jexe_cfg, max_steps=max_steps, active_steps=depth)

    batch_fn = jax.jit(batch_step)
    plan = jax_plan_sorted(chains.num_steps, BATCH)
    assert len(plan) == 3 and plan[-1][3] < plan[-1][1]  # a padded tail
    sorted_caches = [np.asarray(batch_fn(jnp.asarray(part), jnp.asarray(depth, jnp.int32), *args)
                                .token_cache) for depth, _size, part, _real in plan]
    ref = {"programs": programs, "pool": [np.asarray(pool.token_cache)], "sorted": sorted_caches}
    return pipe, (features, questions, chains), ref


def _margins_hold(pipe, run):
    """Run ``run()`` with hooks on the port's generator head and executor and
    check every decision clears its threshold by more than MARGIN: the
    program argmaxes, and the routing, token and box-confidence decisions
    of each executed (row, step).  Rows past their depth are checked too:
    their decisions are never read, and a margin there costs nothing."""
    logits, outs = [], []
    hooks = [pipe.generator.out_proj.register_forward_hook(lambda _m, _i, o: logits.append(o)),
             pipe.executor.register_forward_hook(lambda _m, _i, o: outs.append(o))]
    try:
        value = run()
    finally:
        for h in hooks:
            h.remove()
    for lg in logits:
        top2 = torch.topk(lg, 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
    for out in outs:
        routing = out["routing_logits"]
        assert float((routing[:, 0] - routing[:, 1]).abs().min()) > MARGIN
        top2 = torch.topk(out["token_logits"], 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
        assert float((out["pred_conf"] - pipe.exe_cfg.conf_threshold).abs().min()) > MARGIN
    assert logits and outs
    return value


@pytest.mark.parametrize("mode", ["pool", "sorted"])
def test_runs_match_jax(pair, mode):
    """The port bench's run of each mode gives JAX's programs
    (``generator.generate``) and answer token caches (``chained_forward_pool``
    over ``BATCH`` slots; ``chained_forward`` over ``plan_sorted``'s batches,
    each to its own depth)."""
    pipe, (features, questions, chains), ref = pair
    data = bench.to_device(features, questions, chains, "cpu")
    run_all = bench.make_run_all(mode, pipe, data, BATCH, chains.num_steps)
    programs, caches = _margins_hold(pipe, run_all)
    np.testing.assert_array_equal(programs, ref["programs"])
    assert len(caches) == len(ref[mode])
    for got, want in zip(caches, ref[mode]):
        np.testing.assert_array_equal(got, want)
    assert any((c != 0).any() for c in caches)  # the token branch is taken


def test_reference_loop_answers_match_vectorized(pair):
    """The reference-style loop (batch 1, step by step, host caches) gives
    the vectorized run's final answers on bench.py's baseline questions."""
    pipe = pair[0]
    n = 8
    qps, se, answers = _margins_hold(pipe, lambda: bench.run_reference_style(n, "cpu", pipe))
    assert qps > 0 and se >= 0
    features, questions, chains = synth_questions(n, pipe.exe_cfg, seed=1)
    state = bench.pool_run(pipe, bench.to_device(features, questions, chains, "cpu"), BATCH)
    last = chains.num_steps - 1
    rows = np.arange(n)
    is_token = state.token_branch.numpy()[rows, last]
    tokens = state.token_cache.numpy()[rows, last]
    assert [a[0] for a in answers] == list(is_token)
    assert [a[1] for a in answers] == [int(t) if f else 0 for t, f in zip(tokens, is_token)]
    active = np.arange(chains.functions.shape[1])[None] < chains.num_steps[:, None]
    branch = state.token_branch.numpy()[active]
    assert branch.any() and (~branch).any() and state.box_mask.numpy().any()  # both branches


def _small_configs(monkeypatch):
    monkeypatch.setattr(bench, "GEN_CFG", GeneratorConfig(**SMALL_GEN))
    monkeypatch.setattr(bench, "EXE_CFG", ExecutorConfig(**SMALL_EXE))


@pytest.mark.parametrize("mode", ["pool", "sorted"])
def test_main_prints_bench_keys(monkeypatch, capsys, mode):
    """``main --device cpu`` at a small width: the card line, every repeat,
    the launches, the as-built count and the host CPU before the last line,
    which has bench.py's keys; no device number on the CPU (``mfu`` null)."""
    _small_configs(monkeypatch)
    for key, value in dict(BENCH_N="12", BENCH_BATCH="4", BENCH_BASELINE_N="2",
                           BENCH_MODE=mode, BENCH_REPEATS="3", BENCH_DTYPE="fp32").items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    result = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    assert set(result) == bench_json_keys() == set(bench.KEYS)
    assert lines[0] == "device: cpu (no card)"
    assert lines[1].startswith(f"{mode}: 12 questions, batch 4, 3 timed runs")
    assert len(lines[1].split(": ")[-1].split(", ")) == 3
    assert "K1 0, K2 0" in lines[2] and "as the generator is built" in lines[3]
    assert f"torch {torch.get_num_threads()} threads" in lines[4]
    assert result["mfu"] is None and result["truncated_programs"] == 0
    assert result["value"] > 0 and result["baseline_n"] == 2


def test_main_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


def test_peak_of_the_card(monkeypatch):
    """The H100 SXM's dense bf16 peak by name; an unknown card raises unless
    BENCH_PEAK_TFLOPS names its peak; the CPU has none."""
    from explainable_spatial_vqa_tpu_torch import device

    monkeypatch.delenv("BENCH_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("PROF_HBM_GBS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda _d=None: "NVIDIA H100 80GB HBM3")
    assert device.chip_peak_flops("cuda") == 989e12 == device.PEAK_OPS["bf16"]
    assert device.hbm_bytes_per_s("cuda") == 3.35e12 == device.PEAK_BYTES
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda _d=None: "Some Other GPU")
    with pytest.raises(ValueError, match="BENCH_PEAK_TFLOPS"):
        device.chip_peak_flops("cuda")
    with pytest.raises(ValueError, match="PROF_HBM_GBS"):
        device.hbm_bytes_per_s("cuda")
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "500")
    monkeypatch.setenv("PROF_HBM_GBS", "2000")
    assert device.chip_peak_flops("cuda") == 500e12
    assert device.hbm_bytes_per_s("cuda") == 2000e9
    monkeypatch.delenv("BENCH_PEAK_TFLOPS")
    monkeypatch.delenv("PROF_HBM_GBS")
    assert np.isnan(device.chip_peak_flops("cpu")) and np.isnan(device.hbm_bytes_per_s("cpu"))
