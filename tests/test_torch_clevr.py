"""The port's CLEVR factory against the JAX package's, on the CPU: for the
same seeds, the scenes, programs, symbolic executions, boxes, annotations,
feature maps, vocabularies and encoded questions are equal (``==``, or
``np.array_equal`` for arrays).  Scenes come from seeded ``random_scene`` /
``random_scene_cogent``; the hand-written programs from
``tests/data/golden_synthetic.json`` run on them too.
"""

import copy

import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.clevr import annotate as jann
from explainable_spatial_vqa_tpu.clevr import bboxes as jbb
from explainable_spatial_vqa_tpu.clevr import executor as jexe
from explainable_spatial_vqa_tpu.clevr import scenes as jscenes
from explainable_spatial_vqa_tpu.clevr import synthetic as jsyn
from explainable_spatial_vqa_tpu.core import artifacts as jart
from explainable_spatial_vqa_tpu.core import tokenizer as jtok
from explainable_spatial_vqa_tpu.core import vocab as jvoc
from explainable_spatial_vqa_tpu.evalsuite import cogent as jcogent
from explainable_spatial_vqa_tpu_torch.clevr import annotate as tann
from explainable_spatial_vqa_tpu_torch.clevr import bboxes as tbb
from explainable_spatial_vqa_tpu_torch.clevr import executor as texe
from explainable_spatial_vqa_tpu_torch.clevr import scenes as tscenes
from explainable_spatial_vqa_tpu_torch.clevr import synthetic as tsyn
from explainable_spatial_vqa_tpu_torch.core import artifacts as tart
from explainable_spatial_vqa_tpu_torch.core import tokenizer as ttok
from explainable_spatial_vqa_tpu_torch.core import vocab as tvoc
from explainable_spatial_vqa_tpu_torch.evalsuite import cogent as tcogent

torch.set_num_threads(1)

CORPORA = {  # name -> (kwargs of synthesize_cogent_dataset or synthesize_dataset)
    "plain": dict(num_scenes=6, questions_per_scene=4, seed=5),
    "hops": dict(num_scenes=6, questions_per_scene=4, seed=6, hop_prob=0.8, chain_prob=0.5,
                 max_nodes=14),
    "A": dict(num_scenes=6, questions_per_scene=4, condition="A", seed=7, hop_prob=0.6,
              chain_prob=0.5),
    "B": dict(num_scenes=6, questions_per_scene=4, condition="B", seed=8, image_index_base=6,
              hop_prob=0.6, chain_prob=0.5),
}


def _corpus(mod, name):
    kw = dict(CORPORA[name])
    if "condition" in kw:
        return mod.synthesize_cogent_dataset(**kw)
    return mod.synthesize_dataset(**kw)


@pytest.fixture(scope="module", params=sorted(CORPORA))
def corpus(request):
    """(name, JAX scenes and questions, the port's) for one corpus."""
    name = request.param
    return name, _corpus(jsyn, name), _corpus(tsyn, name)


def test_corpora_equal(corpus):
    name, (jscn, jq), (tscn, tq) = corpus
    assert tscn == jscn
    assert tq == jq
    assert len(tq) == CORPORA[name]["num_scenes"] * CORPORA[name]["questions_per_scene"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scenes_equal(seed):
    for palette_size in (4, 8):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        assert (tsyn.random_scene(tr, seed, palette_size=palette_size)
                == jsyn.random_scene(jr, seed, palette_size=palette_size))
        assert tr.randint(1 << 30) == jr.randint(1 << 30)  # the streams stay in step
    for condition in ("A", "B"):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        assert (tsyn.random_scene_cogent(tr, seed, condition)
                == jsyn.random_scene_cogent(jr, seed, condition))


def test_scene_indices_and_load(tmp_path):
    raw = [jsyn.random_scene(np.random.RandomState(s), s) for s in range(3)]
    for r in raw:
        t, j = tscenes.Scene.from_raw(r), jscenes.Scene.from_raw(r)
        assert (t.relationships, t.same_attr, t.image_index) == (
            j.relationships, j.same_attr, j.image_index)
    path = tmp_path / "scenes.json"
    import json

    path.write_text(json.dumps({"scenes": raw}))
    tl, jl = tscenes.load_scenes(str(path)), jscenes.load_scenes(str(path))
    assert {k: v.raw for k, v in tl.items()} == {k: v.raw for k, v in jl.items()}
    assert tscenes.ATTRIBUTES == jscenes.ATTRIBUTES


def _scenes(raw):
    return {s["image_index"]: s for s in raw}


def _outputs(mod, scene_mod, raw, program):
    try:
        return mod.execute_program(scene_mod.Scene.from_raw(raw), program)
    except Exception as err:  # noqa: BLE001 - the same failure in both
        return type(err).__name__


def test_execute_program_equal(corpus, golden_synthetic):
    _, (jscn, jq), _ = corpus
    scenes = _scenes(jscn)
    runs = [(scenes[q["image_index"]], q["program"]) for q in jq]
    runs += [(raw, q["program"]) for raw in jscn[:3] for q in golden_synthetic["questions"]]
    for raw, program in runs:
        assert (_outputs(texe, tscenes, raw, program)
                == _outputs(jexe, jscenes, raw, program)), program
    assert texe.INVALID == jexe.INVALID
    assert texe.SPATIAL_FUNCTIONS == jexe.SPATIAL_FUNCTIONS
    assert texe.NON_SPATIAL_FUNCTIONS == jexe.NON_SPATIAL_FUNCTIONS
    assert sorted(texe.FUNCTION_CATALOG) == sorted(jexe.FUNCTION_CATALOG)


def test_boxes_labels_and_export_equal(corpus):
    _, (jscn, _), _ = corpus
    for raw in jscn:
        for decimals in (4, 1, None):
            assert np.array_equal(tbb.scene_bounding_boxes(raw, decimals),
                                  jbb.scene_bounding_boxes(raw, decimals))
        box = tbb.scene_bounding_boxes(raw)[0]
        assert tbb.format_bbox(box) == jbb.format_bbox(box)
    names, label_to_id = tbb.generate_label_map()
    assert (names, label_to_id) == jbb.generate_label_map()
    assert np.array_equal(tbb.scene_class_labels(jscn[0], label_to_id),
                          jbb.scene_class_labels(jscn[0], label_to_id))
    t, j = tbb.export_scenes(jscn), jbb.export_scenes(jscn)
    assert t.keys() == j.keys()
    for key in t:
        assert np.array_equal(t[key], j[key]), key


@pytest.mark.parametrize("num_workers", [0, 2])
def test_annotate_questions_equal(corpus, golden_synthetic, num_workers):
    _, (jscn, jq), _ = corpus
    jsc = {i: jscenes.Scene.from_raw(r) for i, r in _scenes(jscn).items()}
    tsc = {i: tscenes.Scene.from_raw(r) for i, r in _scenes(jscn).items()}
    # the golden programs, moved onto this corpus's first scene
    golden = [dict(q, image_index=jscn[0]["image_index"]) for q in golden_synthetic["questions"]]
    questions = jq + golden + [dict(jq[0], image_index=-1)]  # an unknown scene is dropped
    got = tann.annotate_questions(copy.deepcopy(questions), tsc, num_workers=num_workers)
    want = jann.annotate_questions(copy.deepcopy(questions), jsc, num_workers=0)
    assert got == want
    assert len(got) == len(questions) - 1
    q = jq[0]
    assert (tann.annotate_question(q, tsc[q["image_index"]])
            == jann.annotate_question(q, jsc[q["image_index"]]))


def test_feature_maps_equal(corpus):
    _, (jscn, _), _ = corpus
    for raw in jscn:
        for entangled in (False, True):
            t = tsyn.scene_feature_map(raw, entangled=entangled)
            assert t.dtype == np.float32
            assert np.array_equal(t, jsyn.scene_feature_map(raw, entangled=entangled))
    for shape in tsyn.ATTRIBUTE_VALUES["shape"]:
        for color in tsyn.ATTRIBUTE_VALUES["color"]:
            for entangled in (False, True):
                assert (tsyn.color_channel(color, shape, entangled)
                        == jsyn.color_channel(color, shape, entangled))
    assert tsyn.ATTRIBUTE_VALUES == jsyn.ATTRIBUTE_VALUES


def test_vocabularies_and_encoding_equal(golden_synthetic):
    corpora = {name: _corpus(jsyn, name) for name in CORPORA}
    questions = [q for _, qs in corpora.values() for q in qs] + golden_synthetic["questions"]
    clevr = tvoc.build_clevr_vocab([questions, golden_synthetic["questions"]])
    assert clevr == jvoc.build_clevr_vocab([questions, golden_synthetic["questions"]])
    for mode in ("postfix", "prefix"):
        t, j = tart.encode_questions(questions, clevr, mode), jart.encode_questions(
            questions, clevr, mode)
        for field in ("questions", "image_idxs", "orig_idxs", "programs", "answers",
                      "question_families"):
            assert np.array_equal(getattr(t, field), getattr(j, field)), (mode, field)

    scenes = {}
    for scn, _ in corpora.values():
        scenes.update({s["image_index"]: jscenes.Scene.from_raw(s) for s in scn})
    annotated = jann.annotate_questions([q for q in questions if q["image_index"] in scenes
                                         and q not in golden_synthetic["questions"]], scenes)
    annotated += golden_synthetic["annotated"]
    split = tvoc.build_split_vocab(annotated)
    assert split == jvoc.build_split_vocab(annotated)
    for record in annotated[:40] + golden_synthetic["annotated"]:
        assert (tvoc.apply_split_vocab(copy.deepcopy(record), split)
                == jvoc.apply_split_vocab(copy.deepcopy(record), split))
    for text in ("[0.1234 0.5 0.2500 0.3]", "[0.1234 0.5000 0.2500 0.3000]", "red cube", ""):
        assert tvoc.is_bounding_box_text(text) == jvoc.is_bounding_box_text(text)
        for field in ("function", "other"):
            assert tvoc.tokenize_field(text, field) == jvoc.tokenize_field(text, field)
    assert tvoc.EMPTY_TOKEN == jvoc.EMPTY_TOKEN


def test_tokenizer_equal(golden_synthetic):
    texts = [q["question"] for q in golden_synthetic["questions"]]
    texts += ["What  color is it; the big, red?", "It's a cube.", "a  b  c"]
    for text in texts:
        assert ttok.word_tokenize(text) == jtok.word_tokenize(text)
        for kw in (dict(), dict(punct_to_keep=[";", ","], punct_to_remove=["?", "."]),
                   dict(add_start_token=False, add_end_token=False)):
            assert ttok.tokenize(text, **kw) == jtok.tokenize(text, **kw)
    vocab = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3, "a": 4, "b": 5}
    assert ttok.encode(["a", "z", "b"], vocab, allow_unk=True) == jtok.encode(
        ["a", "z", "b"], vocab, allow_unk=True)
    with pytest.raises(KeyError):
        ttok.encode(["z"], vocab)
    inv = {v: k for k, v in vocab.items()}
    for delim in (None, " "):
        assert ttok.decode([1, 4, 2, 5], inv, delim) == jtok.decode([1, 4, 2, 5], inv, delim)
    assert ttok.SPECIAL_TOKENS == jtok.SPECIAL_TOKENS


def test_finetune_subset_and_report_equal():
    idx = np.repeat(np.arange(40), 7)
    for images, questions in ((3000, 30000), (5, 20), (12, 1000)):
        assert np.array_equal(tcogent.finetune_subset(idx, images, questions),
                              jcogent.finetune_subset(idx, images, questions))
    cells = dict(a_zero_shot=0.5, b_zero_shot=0.25, a_finetuned=None, b_finetuned=1.0)
    t, j = tcogent.CoGenTReport(**cells), jcogent.CoGenTReport(**cells)
    assert (t.as_dict(), t.report()) == (j.as_dict(), j.report())


def test_cogent_scene_palettes_disjoint_for_restricted_shapes():
    """The conditions produce the palette split (as the JAX package's test
    of the same name checks its own scenes)."""
    assert tcogent.COGENT_A_PALETTE == jcogent.COGENT_A_PALETTE
    assert tcogent.COGENT_B_PALETTE == jcogent.COGENT_B_PALETTE
    rng = np.random.RandomState(0)
    for cond, palette in (("A", tcogent.COGENT_A_PALETTE), ("B", tcogent.COGENT_B_PALETTE)):
        for i in range(20):
            scene = tsyn.random_scene_cogent(rng, i, cond)
            for obj in scene["objects"]:
                assert obj["color"] in palette[obj["shape"]], (cond, obj)
    for shape in ("cube", "cylinder"):
        a = {tsyn.color_channel(c, shape, True) for c in tcogent.COGENT_A_PALETTE[shape]}
        b = {tsyn.color_channel(c, shape, True) for c in tcogent.COGENT_B_PALETTE[shape]}
        assert not (a & b), shape
