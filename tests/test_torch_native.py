"""The port's native CLEVR engine (``clevr/native.py``, built from
``csrc/clevr_exec.cpp`` with g++ at first use) against its own Python
executor and the JAX package's native binding, as tests/test_native.py holds
JAX's, and the annotations that run on it: every output exactly equal.

The scenes are the CLEVR factory's (the reference's fixture scene is not in
the repository); the programs are the golden synthetic questions', the
factory's and tests/test_native.py's fuzz."""

import copy
import logging
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_native import _random_program  # noqa: E402

from explainable_spatial_vqa_tpu.clevr import annotate as jann  # noqa: E402
from explainable_spatial_vqa_tpu.clevr import native as jnative  # noqa: E402
from explainable_spatial_vqa_tpu.clevr import scenes as jscenes  # noqa: E402
from explainable_spatial_vqa_tpu.clevr import synthetic as jsyn  # noqa: E402
from explainable_spatial_vqa_tpu.core import vocab as jvoc  # noqa: E402
from explainable_spatial_vqa_tpu_torch.clevr import annotate as tann  # noqa: E402
from explainable_spatial_vqa_tpu_torch.clevr import native  # noqa: E402
from explainable_spatial_vqa_tpu_torch.clevr import scenes as tscenes  # noqa: E402
from explainable_spatial_vqa_tpu_torch.clevr.executor import (  # noqa: E402
    INVALID,
    Executor,
    execute_program,
)
from explainable_spatial_vqa_tpu_torch.core import vocab as tvoc  # noqa: E402

torch.set_num_threads(1)


def execute_tolerant(scene, program):
    """The port's Python executor with the annotation layer's poisoning: stop
    at the first error or INVALID (tests/test_native.py's rule)."""
    ex = Executor(scene)
    outputs = []
    for node in program:
        try:
            inputs = [outputs[i] for i in node.get("inputs", [])]
            value = ex.apply(node["function"], inputs, node.get("value_inputs", []))
        except Exception:  # noqa: BLE001 - an ill-typed fuzz program stops here
            break
        outputs.append(value)
        if value == INVALID:
            break
    return outputs


@pytest.fixture(scope="module")
def corpus():
    """(raw scenes, the port's and JAX's Scene objects, the questions)."""
    raw, questions = jsyn.synthesize_dataset(num_scenes=4, questions_per_scene=6, seed=11,
                                             hop_prob=0.6, chain_prob=0.5)
    return (raw, [tscenes.Scene.from_raw(r) for r in raw],
            [jscenes.Scene.from_raw(r) for r in raw], questions)


def test_builds_and_loads():
    assert native.native_available()
    assert native.build_library().name.startswith("clevr_exec-")
    assert jnative.native_available()  # the reference binding this file compares with


def test_parity_programs(corpus, golden_synthetic):
    raw, tsc, jsc, questions = corpus
    programs = [q["program"] for q in golden_synthetic["questions"]]
    programs += [q["program"] for q in questions]
    for t_scene, j_scene in zip(tsc, jsc):
        packed = native.PackedScene(t_scene)
        for program in programs:
            got = native.execute_native(t_scene, program, packed)
            assert got == execute_program(t_scene, program), program
            assert got == jnative.execute_native(j_scene, program), program


def test_parity_fuzz(corpus):
    _, tsc, jsc, _ = corpus
    rng = np.random.RandomState(0)
    mismatches = []
    for trial in range(500):
        t_scene, j_scene = tsc[trial % len(tsc)], jsc[trial % len(jsc)]
        program = _random_program(rng)
        nat = native.execute_native(t_scene, program)
        if nat != execute_tolerant(t_scene, program) or nat != jnative.execute_native(
                j_scene, program):
            mismatches.append((trial, program))
    assert not mismatches, mismatches[:2]


def test_annotation_engines_equal(corpus, golden_synthetic):
    """The annotation layer's two engines (the native one and the Python
    executor) give the same outputs and relevant-object sets, fuzz
    included (chip_smoke.py phase 20.1 on the card's host)."""
    _, tsc, _, questions = corpus
    rng = np.random.RandomState(2)
    programs = [q["program"] for q in questions + golden_synthetic["questions"]]
    programs += [_random_program(rng) for _ in range(200)]
    for i, program in enumerate(programs):
        scene = tsc[i % len(tsc)]
        assert (tann._execute_with_poisoning(scene, program)
                == tann._execute_python(scene, program)), program


def test_batch_and_packing_equal(corpus, golden_synthetic):
    _, tsc, jsc, _ = corpus
    packed, jpacked = native.PackedScene(tsc[0]), jnative.PackedScene(jsc[0])
    for name in ("attrs", "rel_offsets", "rel_values"):
        np.testing.assert_array_equal(getattr(packed, name), getattr(jpacked, name))
    progs = [q["program"] for q in golden_synthetic["questions"]]
    steps = [native.pack_program(p) for p in progs]
    for got, p in zip(steps, progs):
        np.testing.assert_array_equal(got, jnative.pack_program(p))
    out = native.execute_batch_native(packed, steps)
    np.testing.assert_array_equal(out, jnative.execute_batch_native(jpacked, steps))
    assert out.shape[0] == sum(s.shape[0] for s in steps)
    first = progs[0]
    assert (native._decode(out[:len(first)], first, packed.n_obj)
            == native.execute_native(tsc[0], first, packed))


def test_annotation_runs_native_and_matches_jax(corpus, golden_synthetic):
    """The corpus sweep runs its programs on the engine (counted) and gives
    JAX's annotations."""
    raw, tsc, jsc, questions = corpus
    golden = [dict(q, image_index=raw[0]["image_index"]) for q in golden_synthetic["questions"]]
    qs = questions + golden
    native.execute_native.programs = 0
    got = tann.annotate_questions(copy.deepcopy(qs), {s.image_index: s for s in tsc})
    assert native.execute_native.programs == len(qs)
    want = jann.annotate_questions(copy.deepcopy(qs), {s.image_index: s for s in jsc})
    assert got == want


def test_part_timing_leaves_outputs_alone(corpus, golden_synthetic):
    """``execute_native.parts`` (phase 20.1's packing, C call and decoding
    times) sums three non-negative times over the programs the engine runs,
    gives the same outputs as an untimed call, and is off by default."""
    _, tsc, _, _ = corpus
    progs = [q["program"] for q in golden_synthetic["questions"]]
    assert native.execute_native.parts is None
    want = [native.execute_native(tsc[0], p) for p in progs]
    native.execute_native.parts = [0.0, 0.0, 0.0]
    try:
        got = [native.execute_native(tsc[0], p) for p in progs]
        parts = native.execute_native.parts
    finally:
        native.execute_native.parts = None
    assert got == want
    assert len(parts) == 3 and all(t >= 0.0 for t in parts) and sum(parts) > 0.0


def test_structured_annotation_equal(corpus, golden_synthetic):
    raw, tsc, jsc, questions = corpus
    by_index = {t.image_index: (t, j) for t, j in zip(tsc, jsc)}
    golden = [dict(q, image_index=raw[1]["image_index"]) for q in golden_synthetic["questions"]]
    for q in questions + golden:
        t_scene, j_scene = by_index[q["image_index"]]
        got = tann.annotate_question_structured(copy.deepcopy(q), t_scene)
        assert got == jann.annotate_question_structured(copy.deepcopy(q), j_scene)
        assert got["annotated_program"][-1]["function"] == "end"


def test_noboxes_vocab_equal(corpus, golden_synthetic):
    raw, tsc, jsc, questions = corpus
    annotated = jann.annotate_questions(copy.deepcopy(questions),
                                        {s.image_index: s for s in jsc})
    annotated += golden_synthetic["annotated"]
    vocab = tvoc.build_joint_noboxes_vocab(annotated)
    assert vocab == jvoc.build_joint_noboxes_vocab(annotated)
    assert len(vocab) > 10
    for q in annotated:
        assert (tvoc.apply_joint_noboxes_vocab(copy.deepcopy(q), vocab)
                == jvoc.apply_joint_noboxes_vocab(copy.deepcopy(q), vocab))


def test_native_faster_than_python(corpus):
    """The engine must beat the Python executor clearly (JAX's
    test_native_speedup)."""
    _, tsc, _, _ = corpus
    rng = np.random.RandomState(1)
    programs = [_random_program(rng) for _ in range(3000)]
    packed = native.PackedScene(tsc[0])
    steps = [native.pack_program(p) for p in programs]
    t0 = time.perf_counter()
    for p in programs:
        execute_tolerant(tsc[0], p)
    python_s = time.perf_counter() - t0
    native_s = min(_timed(lambda: native.execute_batch_native(packed, steps)) for _ in range(3))
    assert native_s < python_s, (python_s, native_s)


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def test_failed_build_is_logged_and_python_runs(corpus, monkeypatch, tmp_path, caplog):
    """With no compiler the engine is unavailable, the error names the
    compiler, and execution falls back to the Python executor."""
    _, tsc, _, questions = corpus
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "no-such-compiler")
    native._load.cache_clear()
    try:
        with caplog.at_level(logging.ERROR, logger=native.__name__):
            assert not native.native_available()
        assert "no-such-compiler" in caplog.text
        native.execute_native.programs = 0
        program = questions[0]["program"]
        assert native.execute_native(tsc[0], program) == execute_program(tsc[0], program)
        assert native.execute_native.programs == 0
        assert not (tmp_path / "_build").exists()
    finally:
        native._load.cache_clear()
