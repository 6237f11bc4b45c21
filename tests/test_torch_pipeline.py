"""The port's inference pipeline against the JAX pipeline on the CPU: program
parsing on the tests/data goldens, and end-to-end answers at a small size."""

import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core import programs as jax_programs
from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig
from explainable_spatial_vqa_tpu.core.config import GeneratorConfig as JaxGeneratorConfig
from explainable_spatial_vqa_tpu.infer import pipeline as jax_pipeline
from explainable_spatial_vqa_tpu.infer.chain import ExecutorChainRunner as JaxRunner
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
from explainable_spatial_vqa_tpu.models.generator import ProgramGenerator as JaxGenerator
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig
from explainable_spatial_vqa_tpu_torch.infer import pipeline
from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"


def _golden_programs():
    return [q["program"] for name in ("golden_synthetic.json", "golden_full_annotation.json")
            for q in json.load(open(DATA / name))["questions"]]


@pytest.mark.parametrize("mode", ["postfix", "prefix"])
def test_decode_and_chains_match_jax_on_goldens(mode):
    programs = _golden_programs()
    vocab = {"<NULL>": 0, "<START>": 1, "<END>": 2}
    rows = []
    for program in programs:
        tokens = jax_programs.program_tokens(program, mode)
        for t in tokens:
            vocab.setdefault(t, len(vocab))
        rows.append([1] + [vocab[t] for t in tokens] + [2])
    reference = json.load(open(DATA / "golden_reference.json"))
    for split in ("val", "train"):  # the reference scripts' own serializations
        tokens = reference[split][mode].split()
        for t in tokens:
            vocab.setdefault(t, len(vocab))
        rows.append([1] + [vocab[t] for t in tokens] + [2])
    rows.append([1, vocab["count"], 2])  # malformed: count with no operand
    rows.append([1, 2] + rows[0][1:])  # empty program: <END> first
    rows.append(rows[0][:-3] + [2])  # cut short
    width = max(map(len, rows)) + 2
    ids = np.zeros((len(rows), width), np.int64)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
    inv = {v: k for k, v in vocab.items()}
    ref = jax_pipeline.decode_program_ids(ids, inv, mode)
    got = pipeline.decode_program_ids(ids, inv, mode)
    assert got == ref
    assert sum(p is None for p in got) >= 2 and all(p is not None for p in got[:len(programs)])
    fn_vocab = {}
    for program in programs:
        for node in program:
            fn_vocab.setdefault(jax_programs.function_token(node), len(fn_vocab) + 1)
    image_index = np.arange(len(rows)) % 3
    for max_steps in (6, 28):  # 6 truncates the deeper goldens
        ref_chains = jax_pipeline.programs_to_chains(ref, image_index, fn_vocab, max_steps)
        chains = pipeline.programs_to_chains(got, image_index, fn_vocab, max_steps)
        for key in ("image_index", "functions", "deps", "num_steps"):
            np.testing.assert_array_equal(getattr(chains, key), getattr(ref_chains, key))
        assert chains.truncated == ref_chains.truncated
    assert pipeline.programs_to_chains(got, image_index, fn_vocab, 6).truncated > 0


def test_decode_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        pipeline.decode_program_ids(np.zeros((1, 3), np.int64), {}, "infix")


PROGRAM_TOKENS = ["scene", "count", "exist", "filter_size[large]", "filter_color[red]",
                  "relate[left]", "unique", "query_shape", "equal_integer", "scene", "scene",
                  "filter_shape[cube]", "same_color"]


GEN_KW = dict(vocab_size=24, program_vocab_size=16, embed_dim=8, hidden_dim=12,
              encoder_layers=2, decoder_layers=2, program_len=10, dropout=0.0)
EXE_KW = dict(vocab_size=16, d_model=32, num_heads=4, encoder_layers=1,
              box_decoder_layers=1, num_queries=3, num_image_tokens=4, image_feature_dim=8,
              max_input_boxes=4, token_classes=8, box_roi=True)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline and the port's with the same random weights, and 16
    questions over 4 images."""
    rng = np.random.RandomState(4)
    questions = rng.randint(4, 24, (16, 7)).astype(np.int32)
    features = rng.rand(4, 4, 8).astype(np.float32)
    image_index = rng.randint(0, 4, 16)

    jgen = JaxGenerator(JaxGeneratorConfig(**GEN_KW))
    gen_vars = jgen.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                         jnp.asarray(questions), jnp.zeros((16, 10), jnp.int32))
    jexe = JaxExecutor(JaxExecutorConfig(**EXE_KW))
    exe_vars = jexe.init(jax.random.PRNGKey(2), jnp.asarray(features[:2]), jnp.zeros((2, 4, 4)),
                         jnp.ones((2, 4), bool), jnp.zeros((2, 3), jnp.int32),
                         jnp.ones((2, 3), bool))
    params = jax.tree_util.tree_map(np.array, exe_vars["params"])
    params["box_decoder"]["head_out"]["kernel"] *= 20.0  # keep decisions off their thresholds
    params["routing_head"]["kernel"] *= 20.0
    exe_vars = {"params": jax.tree_util.tree_map(jnp.asarray, params)}

    inv = {0: "<NULL>", 1: "<START>", 2: "<END>"}
    inv.update({i: t for i, t in enumerate(PROGRAM_TOKENS, start=3)})
    fn_vocab = {t: i for i, t in enumerate(dict.fromkeys(PROGRAM_TOKENS), start=1)}
    thresholds = np.linspace(0.35, 0.65, 16).astype(np.float32)
    jpipe = jax_pipeline.InferencePipeline(
        jgen, gen_vars,
        JaxRunner(jexe, exe_vars, JaxExecutorConfig(**EXE_KW), max_steps=10,
                  conf_thresholds=thresholds), inv, fn_vocab)

    generator = ProgramGenerator(GeneratorConfig(**GEN_KW), device="cpu")
    generator.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, gen_vars["params"])))
    executor = ProgramExecutor(ExecutorConfig(**EXE_KW), device="cpu")
    executor.load_state_dict(flax_to_state_dict(params))
    runner = ExecutorChainRunner(executor, ExecutorConfig(**EXE_KW), 10, thresholds, device="cpu")
    pipe = pipeline.InferencePipeline(generator, runner, inv, fn_vocab, device="cpu")
    return jpipe, pipe, questions, features, image_index, inv, fn_vocab


@pytest.mark.parametrize("chain_mode", ["sorted", "bucketed", "pool", "plain"])
def test_pipeline_matches_jax(pipelines, chain_mode):
    """Program ids, answers and answer validity equal the JAX pipeline's."""
    jpipe, pipe, questions, features, image_index, inv, fn_vocab = pipelines
    ref = jpipe.run(questions, features, image_index, chain_mode=chain_mode)
    gt_programs = np.zeros((16, 10), np.int64)
    got = pipe.run(questions, features, image_index, gt_answers=np.arange(16) % 8,
                   gt_programs=gt_programs, chain_mode=chain_mode)

    np.testing.assert_array_equal(got.program_ids, ref.program_ids)
    np.testing.assert_array_equal(got.answers, ref.answers)
    np.testing.assert_array_equal(got.answer_valid, ref.answer_valid)
    assert got.truncated == ref.truncated
    assert got.tally is not None and got.tally.total == 16
    # the generated programs drive real chains, not only 1-step no-ops
    programs = pipeline.decode_program_ids(got.program_ids, inv)
    chains = pipeline.programs_to_chains(programs, image_index, fn_vocab, 10)
    assert (chains.num_steps > 1).sum() >= 2 and chains.num_steps.max() >= 5
    # a tensor image cache gives the same answers
    on_tensor = pipe.run(questions, torch.from_numpy(features), image_index,
                         chain_mode=chain_mode)
    np.testing.assert_array_equal(on_tensor.answers, ref.answers)


def test_pipeline_default_chain_mode_is_sorted(pipelines, monkeypatch):
    """InferencePipeline.run with no chain_mode runs "sorted", the JAX
    pipeline's default; an unknown mode raises."""
    _jpipe, pipe, questions, features, image_index, _inv, _fn_vocab = pipelines
    default = inspect.signature(pipeline.InferencePipeline.run).parameters["chain_mode"].default
    assert default == "sorted" == inspect.signature(
        jax_pipeline.InferencePipeline.run).parameters["chain_mode"].default
    calls = []
    run_sorted = pipe.runner.run_sorted
    monkeypatch.setattr(pipe.runner, "run_sorted",
                        lambda *a, **k: calls.append(1) or run_sorted(*a, **k))
    for name in ("run", "run_bucketed", "run_pool"):
        monkeypatch.setattr(pipe.runner, name, None)  # any other runner would fail
    result = pipe.run(questions, features, image_index)
    assert calls == [1] and result.answers.shape == (16,)
    with pytest.raises(ValueError, match="chain_mode"):
        pipe.run(questions, features, image_index, chain_mode="streamed")
