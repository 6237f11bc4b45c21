"""The port's copies of the baselines' data path against the JAX package:
``annotate_question_full`` in both styles, ``build_joint_vocab`` and
``apply_joint_vocab``, ``flatten_steps`` (with and without
``reference_compat``, and with ``subset_fraction``), ``chain_arrays`` on
joint-vocab records as ``infer-chain`` builds them, and ``read_scenes_h5``:
equal to JAX's on ``tests/data/golden_synthetic.json`` and on a seeded
synthetic corpus."""

import copy
import json
import pathlib

import numpy as np
import pytest

from explainable_spatial_vqa_tpu.clevr import annotate as jann
from explainable_spatial_vqa_tpu.clevr import synthetic as jsyn
from explainable_spatial_vqa_tpu.clevr.scenes import Scene as JaxScene
from explainable_spatial_vqa_tpu.core import artifacts as jart
from explainable_spatial_vqa_tpu.core import vocab as jvoc
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene
from explainable_spatial_vqa_tpu_torch.core import artifacts, vocab
from explainable_spatial_vqa_tpu_torch.train import datasets

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_synthetic.json"


def _golden_corpus():
    """The golden questions on a synthetic scene of their image."""
    with open(GOLDEN) as f:
        questions = json.load(f)["questions"]
    raw = jsyn.random_scene(np.random.RandomState(0), 0)
    return [raw], questions


def _seeded_corpus():
    return jsyn.synthesize_dataset(10, 4, seed=11, hop_prob=0.5, chain_prob=0.5)


CORPORA = {"golden": _golden_corpus, "seeded": _seeded_corpus}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpus(request):
    scenes_raw, questions = CORPORA[request.param]()
    return scenes_raw, questions


@pytest.mark.parametrize("style", ["repr1", "fixed4"])
def test_annotate_question_full_matches_jax(corpus, style):
    scenes_raw, questions = corpus
    jscenes = {s["image_index"]: JaxScene.from_raw(s) for s in scenes_raw}
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    ref = [jann.annotate_question_full(q, jscenes[q["image_index"]], style=style)
           for q in questions]
    got = [ann.annotate_question_full(q, scenes[q["image_index"]], style=style)
           for q in questions]
    assert got == ref
    assert any(step["input_values"].startswith("[") for q in got
               for step in q["annotated_program"])  # grounded box inputs


def _joint(corpus):
    scenes_raw, questions = corpus
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    return [ann.annotate_question_full(q, scenes[q["image_index"]]) for q in questions]


def test_joint_vocab_matches_jax(corpus):
    annotated = _joint(corpus)
    ref_vocab = jvoc.build_joint_vocab(annotated)
    got_vocab = vocab.build_joint_vocab(annotated)
    assert got_vocab == ref_vocab
    ref = [jvoc.apply_joint_vocab(copy.deepcopy(q), ref_vocab) for q in annotated]
    got = [vocab.apply_joint_vocab(copy.deepcopy(q), got_vocab) for q in annotated]
    assert got == ref


def test_joint_vocab_on_golden_v3_records():
    with open(GOLDEN) as f:
        annotated = json.load(f)["annotated"]
    assert vocab.build_joint_vocab(annotated) == jvoc.build_joint_vocab(annotated)


@pytest.mark.parametrize("reference_compat,subset_fraction",
                         [(False, 1.0), (True, 1.0), (False, 0.5)])
def test_flatten_steps_matches_jax(corpus, reference_compat, subset_fraction):
    annotated = _joint(corpus)
    joint = jvoc.build_joint_vocab(annotated)
    converted = [jvoc.apply_joint_vocab(copy.deepcopy(q), joint) for q in annotated]
    kw = dict(max_src_len=12, max_tgt_len=9, reference_compat=reference_compat,
              subset_fraction=subset_fraction)
    ref = jds.flatten_steps(converted, **kw)
    got = datasets.flatten_steps(converted, **kw)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert len(got["src"]) > 0
    assert datasets.SPECIALS_OFFSET == jds.SPECIALS_OFFSET
    assert (datasets.PAD, datasets.START, datasets.END) == (jds.PAD, jds.START, jds.END)


def test_chain_arrays_with_the_identity_vocab(corpus):
    """``infer-chain``'s chains: joint-vocab ids shifted by SPECIALS_OFFSET."""
    annotated = _joint(corpus)
    joint = jvoc.build_joint_vocab(annotated)
    converted = [jvoc.apply_joint_vocab(copy.deepcopy(q), joint) for q in annotated]
    identity = {}
    for q in converted:
        for step in q["annotated_program"]:
            fn = step["function"]
            identity.setdefault(fn, int(fn) + jds.SPECIALS_OFFSET if fn.isdigit() else 0)
    ref = jds.chain_arrays(converted, identity, max_steps=6)
    got = datasets.chain_arrays(converted, identity, max_steps=6)
    for key in ("image_index", "functions", "deps", "num_steps"):
        np.testing.assert_array_equal(getattr(got, key), getattr(ref, key), err_msg=key)
    assert got.answers == ref.answers and got.truncated == ref.truncated


def test_read_scenes_h5_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "scenes.h5")
    jart.write_scenes_h5(path, rng.rand(4, 6, 4), rng.randint(0, 5, (4, 6)),
                         np.array([3, 5, 7, 9]), [f"img_{i}.png" for i in range(4)])
    ref = jart.read_scenes_h5(path)
    got = artifacts.read_scenes_h5(path)
    assert set(got) == set(ref)
    for key in ("bounding_boxes", "class_labels", "image_index"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        assert got[key].dtype == ref[key].dtype
    assert got["image_filename"] == ref["image_filename"]
