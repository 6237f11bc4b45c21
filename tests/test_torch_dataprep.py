"""The port's data preparation on the CPU against the JAX package's, on one
CLEVR-layout mini root built from the port's CLEVR factory
(``clevr/synthetic.py``: scenes, questions and seeded random 320x480 PNGs):

- each subcommand (``build-vocab``, ``preprocess-questions``,
  ``extract-features``, ``export-scenes`` in both layouts, ``annotate`` in its
  three modes, ``stats``, ``visualize``, ``inspect``) in both CLIs: every JSON
  file byte-equal, every h5 dataset equal (the features within 1e-4 *
  max(|ref|, 1), JAX's rule for the network), ``stats`` and ``inspect``
  stdout equal, the ``visualize`` PNG pixel-equal;
- ``extract_features`` (small model, size 32) against JAX's, both resize
  modes, read back by JAX's ``read_features`` and the port's ``H5Features``;
  the PIL resize byte-equal;
- the writers of ``core/artifacts.py`` and ``core/reshape.py`` read by the
  JAX package's readers and the other way round, and ``core/reshape.py``'s
  arrays and split files equal to JAX's;
- ``utils``: ``history_curves`` equal and ``plot_history`` writing its file,
  ``MetricsWriter``'s CSV, ``decode_yolo_grid`` and ``draw_boxes``.
"""

import json
import pathlib

import h5py
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.cli.main import main as jax_main
from explainable_spatial_vqa_tpu.core import artifacts as jart
from explainable_spatial_vqa_tpu.core import reshape as jreshape
from explainable_spatial_vqa_tpu.utils import logging as jlogging
from explainable_spatial_vqa_tpu.utils import plots as jplots
from explainable_spatial_vqa_tpu.utils import visualize as jvisualize
from explainable_spatial_vqa_tpu.vision import extract as jextract
from explainable_spatial_vqa_tpu.vision import resnet as jresnet
from explainable_spatial_vqa_tpu_torch.cli.main import main
from explainable_spatial_vqa_tpu_torch.core import artifacts as tart
from explainable_spatial_vqa_tpu_torch.core import reshape as treshape
from explainable_spatial_vqa_tpu_torch.utils import logging as tlogging
from explainable_spatial_vqa_tpu_torch.utils import plots as tplots
from explainable_spatial_vqa_tpu_torch.utils import visualize as tvisualize
from explainable_spatial_vqa_tpu_torch.vision import extract as textract
from explainable_spatial_vqa_tpu_torch.vision import resnet as tresnet
from tests.test_torch_vision import scaled_random_state

torch.set_num_threads(1)

SPLITS = (("train", 1, 6), ("val", 2, 3))  # name, seed, scenes (4 questions each)


def mini_clevr_root(root: pathlib.Path, splits=SPLITS) -> None:
    """A CLEVR v1.0 directory layout (``questions/``, ``scenes/``,
    ``images/{split}/CLEVR_{split}_{i:06d}.png``) of the CLEVR factory's
    scenes and questions, hops and chains on, with seeded random 320x480
    images; ``splits``: (name, seed, scenes) with 4 questions a scene."""
    from PIL import Image

    from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn

    (root / "questions").mkdir(parents=True)
    (root / "scenes").mkdir()
    rng = np.random.RandomState(0)
    for split, seed, n in splits:
        scenes, questions = syn.synthesize_dataset(n, 4, seed=seed, hop_prob=0.5, chain_prob=0.5)
        for record in scenes + questions:
            record["split"] = split
            record["image_filename"] = f"CLEVR_{split}_{record['image_index']:06d}.png"
        json.dump({"questions": questions},
                  open(root / "questions" / f"CLEVR_{split}_questions.json", "w"))
        json.dump({"scenes": scenes}, open(root / "scenes" / f"CLEVR_{split}_scenes.json", "w"))
        images = root / "images" / split
        images.mkdir(parents=True)
        for scene in scenes:
            Image.fromarray(rng.randint(0, 256, (320, 480, 3), np.uint8)).save(
                images / scene["image_filename"])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("clevr") / "CLEVR_v1.0"
    mini_clevr_root(path)
    return path


def _run(cli, argv, capsys):
    """One CLI call; its stdout."""
    capsys.readouterr()
    if cli is jax_main:
        jax_main(["--platform", "cpu"] + argv)
    else:
        main(["--device", "cpu"] + argv)
    return capsys.readouterr().out


def _both(tmp_path, capsys, argv_of):
    """``argv_of(out_dir)`` through the JAX CLI into ``tmp_path/jax`` and the
    port's into ``tmp_path/port``: (their directories, their stdouts)."""
    dirs, outs = [], []
    for name, cli in (("jax", jax_main), ("port", main)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        outs.append(_run(cli, argv_of(d), capsys))
        dirs.append(d)
    return dirs, outs


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj.dtype, obj.shape, obj[()])
        f.visititems(visit)
    return out


def _assert_h5_equal(a, b, float_rule=False):
    ours, theirs = _h5_items(b), _h5_items(a)
    assert sorted(ours) == sorted(theirs)
    for name, (dtype, shape, value) in theirs.items():
        assert ours[name][:2] == (dtype, shape), name
        if float_rule and dtype.kind == "f":
            scale = np.abs(value).max()
            assert np.abs(ours[name][2] - value).max() <= 1e-4 * max(scale, 1.0), name
        elif isinstance(value, bytes):  # a JSON string dataset
            assert ours[name][2] == value, name
        elif dtype.kind == "O":  # vlen bytes: the scenes' file names
            assert list(ours[name][2]) == list(value), name
        else:
            np.testing.assert_array_equal(ours[name][2], value, err_msg=name)


def _same_bytes(a, b):
    assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes(), (a, b)


def _q(root, split="train"):
    return str(root / "questions" / f"CLEVR_{split}_questions.json")


def _s(root, split="train"):
    return str(root / "scenes" / f"CLEVR_{split}_scenes.json")


def test_build_vocab_and_preprocess_questions_equal(root, tmp_path, capsys):
    (j, p), _ = _both(tmp_path, capsys, lambda d: [
        "build-vocab", "--inputs", _q(root, "val"), _q(root), "--output", str(d / "vocab.json")])
    _same_bytes(j / "vocab.json", p / "vocab.json")
    for mode in ("postfix", "prefix"):
        (j, p), _ = _both(tmp_path, capsys, lambda d: [
            "preprocess-questions", "--input_questions_json", _q(root), "--input_vocab_json",
            str(d / "vocab.json"), "--output_h5_file", str(d / f"q_{mode}.h5"), "--mode", mode])
        _assert_h5_equal(j / f"q_{mode}.h5", p / f"q_{mode}.h5")
    # the factory's hops make trees, which the chain form refuses in both
    for cli in (jax_main, main):
        with pytest.raises(ValueError, match="not a chain"):
            _run(cli, ["preprocess-questions", "--input_questions_json", _q(root),
                       "--input_vocab_json", str(p / "vocab.json"), "--output_h5_file",
                       str(tmp_path / "chain.h5"), "--mode", "chain"], capsys)
    assert set(_h5_items(p / "q_postfix.h5")) == {"questions", "image_idxs", "orig_idxs",
                                                  "programs", "answers", "question_families"}


def test_extract_features_cli_equal(root, tmp_path, capsys):
    weights = tmp_path / "resnet.pth"
    torch.save(scaled_random_state(1, seed=7), weights)
    (j, p), _ = _both(tmp_path, capsys, lambda d: [
        "extract-features", "--input_image_dir", str(root / "images" / "train"),
        "--output_h5_file", str(d / "features.h5"), "--model_stage", "1", "--image_height",
        "32", "--image_width", "32", "--batch_size", "4", "--torch-weights", str(weights)])
    _assert_h5_equal(j / "features.h5", p / "features.h5", float_rule=True)
    assert _h5_items(p / "features.h5")["features"][1] == (6, 256, 8, 8)


@pytest.mark.parametrize("resize", ["device", "pil"])
def test_extract_features_matches_jax(root, tmp_path, resize):
    """The function: 3 PNGs, ResNetFeatures(stage_sizes=(1, 1, 1)) at 32x32,
    batches of 2; both files read by both readers."""
    state = scaled_random_state(3, seed=8)
    small = {k: v for k, v in state.items() if not any(
        k.startswith(f"layer{s}.{b}.") for s in (1, 2, 3) for b in range(1, 23))}
    port = tresnet.ResNetFeatures(stage_sizes=(1, 1, 1), device="cpu")
    tresnet.load_torchvision_state_dict(port, small)
    paths = textract.collect_image_paths(str(root / "images" / "train"), max_images=3)
    assert paths == jextract.collect_image_paths(str(root / "images" / "train"), max_images=3)
    textract.extract_features(paths, str(tmp_path / "port.h5"), model=port, batch_size=2,
                              size=(32, 32), resize=resize, device="cpu")
    jextract.extract_features(paths, str(tmp_path / "jax.h5"),
                              model=jresnet.ResNetFeatures(stage_sizes=(1, 1, 1)),
                              variables=jresnet.params_from_torch_state_dict(small),
                              batch_size=2, size=(32, 32), resize=resize)
    ref = jart.read_features(str(tmp_path / "jax.h5"))
    ours = tart.read_features(str(tmp_path / "port.h5"))
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (3, 1024, 2, 2)
    assert np.abs(ours - ref).max() <= 1e-4 * max(np.abs(ref).max(), 1.0)
    np.testing.assert_array_equal(jart.read_features(str(tmp_path / "port.h5"), [2, 0]),
                                  ours[[2, 0]])
    tokens = tart.H5Features(str(tmp_path / "port.h5"))
    np.testing.assert_array_equal(tokens[np.array([1])],
                                  ours[1:2].reshape(1, 1024, 4).transpose(0, 2, 1))
    tokens.close()
    if resize == "pil":
        for path in paths:
            np.testing.assert_array_equal(textract._decode_resize_pil(path, (32, 32)),
                                          jextract._decode_resize_pil(path, (32, 32)))


@pytest.mark.parametrize("layout", ["boxes", "attributes"])
def test_export_scenes_equal(root, tmp_path, capsys, layout):
    (j, p), _ = _both(tmp_path, capsys, lambda d: [
        "export-scenes", "--input_scenes_json", _s(root), "--output_h5_file",
        str(d / "scenes.h5"), "--layout", layout, "--vocab_output", str(d / "attrs.json")])
    _assert_h5_equal(j / "scenes.h5", p / "scenes.h5")
    if layout == "attributes":
        _same_bytes(j / "attrs.json", p / "attrs.json")
    else:
        assert tart.read_scenes_h5(str(p / "scenes.h5"))["image_filename"][0] == \
            "CLEVR_train_000000.png"


@pytest.mark.parametrize("mode", ["v3", "full", "string"])
def test_annotate_equal(root, tmp_path, capsys, mode):
    (j, p), _ = _both(tmp_path, capsys, lambda d: [
        "annotate", "--mode", mode, "--scenes", _s(root), "--questions", _q(root),
        "--output_h5", str(d / "annotated.h5"), "--vocab_output", str(d / "vocab.json"),
        "--raw_json", str(d / "raw.json")])
    _assert_h5_equal(j / "annotated.h5", p / "annotated.h5")
    _same_bytes(j / "vocab.json", p / "vocab.json")
    _same_bytes(j / "raw.json", p / "raw.json")
    if mode != "string":
        annotated = tart.read_annotated_h5(str(p / "annotated.h5"))
        assert len(annotated) == 24 and annotated == jart.read_annotated_h5(str(j / "annotated.h5"))


def test_stats_and_inspect_print_what_jax_prints(root, tmp_path, capsys):
    for mode in ("v3", "full"):
        main(["--device", "cpu", "annotate", "--mode", mode, "--scenes", _s(root), "--questions",
              _q(root), "--output_h5", str(tmp_path / f"{mode}.h5"), "--vocab_output",
              str(tmp_path / f"{mode}.json")])
        argv = ["stats", "--annotated_h5", str(tmp_path / f"{mode}.h5")]
        ours = _run(main, argv, capsys)
        assert ours == _run(jax_main, argv, capsys)
        assert json.loads(ours)["questions"] == 24
    main(["--device", "cpu", "build-vocab", "--inputs", _q(root), "--output",
          str(tmp_path / "vocab.json")])
    main(["--device", "cpu", "preprocess-questions", "--input_questions_json", _q(root),
          "--input_vocab_json", str(tmp_path / "vocab.json"), "--output_h5_file",
          str(tmp_path / "questions.h5")])
    for name, n in (("questions.h5", "2"), ("v3.h5", "1"), ("full.h5", "0")):
        argv = ["inspect", str(tmp_path / name), "-n", n]
        ours = _run(main, argv, capsys)
        assert ours == _run(jax_main, argv, capsys)
        assert ours.startswith(f"datasets in {tmp_path / name}:")


@pytest.mark.parametrize("image,labels", [(True, True), (False, False)])
def test_visualize_draws_what_jax_draws(root, tmp_path, capsys, image, labels):
    from PIL import Image

    def argv(d):
        extra = ["--image", str(root / "images" / "train" / "CLEVR_train_000002.png")] * image
        return (["visualize", "--input_scenes_json", _s(root), "--image_index", "2",
                 "--output", str(d / "boxes.png")] + extra + ["--labels"] * labels)

    (j, p), _ = _both(tmp_path, capsys, argv)
    ours, theirs = (np.asarray(Image.open(d / "boxes.png")) for d in (p, j))
    assert ours.shape == (320, 480, 3)
    np.testing.assert_array_equal(ours, theirs)


def test_reshape_matches_jax(root, tmp_path):
    scenes = tart.load_scenes_json(_s(root))
    assert treshape.build_attribute_vocab(scenes) == jreshape.build_attribute_vocab(scenes)
    ours, vocab = treshape.export_scene_attributes(scenes)
    theirs, jvocab = jreshape.export_scene_attributes(scenes)
    assert vocab == jvocab and sorted(ours) == sorted(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key])

    questions = tart.load_questions_json(_q(root))
    treshape.save_questions_grouped(questions, str(tmp_path / "grouped_port.h5"))
    jreshape.save_questions_grouped(questions, str(tmp_path / "grouped_jax.h5"))
    _assert_h5_equal(tmp_path / "grouped_jax.h5", tmp_path / "grouped_port.h5")
    treshape.flatten_question_groups(str(tmp_path / "grouped_port.h5"),
                                     str(tmp_path / "flat_port.h5"))
    jreshape.flatten_question_groups(str(tmp_path / "grouped_jax.h5"),
                                     str(tmp_path / "flat_jax.h5"))
    _assert_h5_equal(tmp_path / "flat_jax.h5", tmp_path / "flat_port.h5")
    assert treshape.read_question_groups(str(tmp_path / "grouped_jax.h5")) == questions
    assert jreshape.read_question_groups(str(tmp_path / "flat_port.h5"), flat=True) == questions
    assert treshape.read_question_groups(str(tmp_path / "flat_jax.h5"), flat=True) == questions
    with pytest.raises(KeyError, match="no 'questions' group"):
        treshape.flatten_question_groups(str(tmp_path / "flat_port.h5"),
                                         str(tmp_path / "again.h5"))

    # a read block smaller than one record: each record spans several reads
    ours = treshape.stream_split_questions(_q(root), str(tmp_path / "split_port"), chunk_size=5,
                                           read_block=97)
    theirs = jreshape.stream_split_questions(_q(root), str(tmp_path / "split_jax"),
                                             chunk_size=5, read_block=97)
    assert [pathlib.Path(p).name for p in ours] == [pathlib.Path(p).name for p in theirs]
    assert len(ours) == 5  # 24 questions in chunks of 5
    for a, b in zip(ours, theirs):
        _same_bytes(b, a)
    assert sum((tart.load_questions_json(p) for p in ours), []) == questions


def test_artifact_writers_cross_read(root, tmp_path):
    from explainable_spatial_vqa_tpu_torch.clevr.bboxes import export_scenes
    from explainable_spatial_vqa_tpu_torch.core.vocab import build_clevr_vocab, save_vocab

    questions = tart.load_questions_json(_q(root))
    vocab = build_clevr_vocab([questions])
    save_vocab(vocab, str(tmp_path / "vocab.json"))
    assert jart.load_questions_json(_q(root)) == questions
    assert json.load(open(tmp_path / "vocab.json")) == vocab
    encoded = tart.encode_questions(questions, vocab)
    tart.write_questions_h5(encoded, str(tmp_path / "q.h5"))
    back = jart.read_questions_h5(str(tmp_path / "q.h5"))
    for field in ("questions", "image_idxs", "orig_idxs", "programs", "answers",
                  "question_families"):
        np.testing.assert_array_equal(getattr(back, field), getattr(encoded, field))

    scenes = export_scenes(tart.load_scenes_json(_s(root)))
    tart.write_scenes_h5(str(tmp_path / "s.h5"), scenes["bounding_boxes"],
                         scenes["class_labels"], scenes["image_index"], scenes["image_filename"])
    back = jart.read_scenes_h5(str(tmp_path / "s.h5"))
    assert back["image_filename"] == scenes["image_filename"]
    np.testing.assert_array_equal(back["bounding_boxes"], scenes["bounding_boxes"])

    records = [{"question": q["question"], "answer": q["answer"], "n": i}
               for i, q in enumerate(questions)]
    for layout in ("blob", "per_question"):
        tart.write_annotated_h5(records, str(tmp_path / f"a_{layout}.h5"), layout=layout)
        jart.write_annotated_h5(records, str(tmp_path / f"j_{layout}.h5"), layout=layout)
        assert jart.read_annotated_h5(str(tmp_path / f"a_{layout}.h5")) == records
        assert tart.read_annotated_h5(str(tmp_path / f"j_{layout}.h5")) == records
        _assert_h5_equal(tmp_path / f"j_{layout}.h5", tmp_path / f"a_{layout}.h5")
    with pytest.raises(ValueError, match="unknown layout"):
        tart.write_annotated_h5(records, str(tmp_path / "x.h5"), layout="rows")

    feats = np.random.RandomState(9).rand(5, 8, 2, 2).astype(np.float32)
    with tart.FeatureWriter(str(tmp_path / "f.h5"), total=5) as writer:
        writer.append(feats[:3])
        writer.append(feats[3:].astype(np.float64))
    np.testing.assert_array_equal(jart.read_features(str(tmp_path / "f.h5")), feats)
    np.testing.assert_array_equal(tart.read_features(str(tmp_path / "f.h5"), [4, 1]),
                                  feats[[4, 1]])


HISTORY = {
    "train": [{"loss_sum": 4.0, "batches": 2.0, "token_correct": 3.0, "token_total": 4.0},
              {"loss_sum": 3.0, "batches": 2.0, "token_correct": 4.0, "token_total": 4.0}],
    "val": [{"loss_sum": 1.0, "batches": 0.0}, {"loss_sum": 2.5, "batches": 1.0}],
}


def test_plots_match_jax(tmp_path):
    for ratio in (("loss_sum", "batches"), ("token_correct", "token_total")):
        assert tplots.history_curves(HISTORY, ratio) == jplots.history_curves(HISTORY, ratio)
    (tmp_path / "history.json").write_text(json.dumps(HISTORY))
    for source in (HISTORY, str(tmp_path / "history.json")):
        out = tplots.plot_history(source, str(tmp_path / "curves.png"))
        assert out == str(tmp_path / "curves.png") and (tmp_path / "curves.png").stat().st_size
        (tmp_path / "curves.png").unlink()
    assert tplots.plot_history({"train": [{"x": 1.0}]}, str(tmp_path / "none.png")) is None
    assert not (tmp_path / "none.png").exists()


def test_logging_and_visualize_match_jax(tmp_path):
    from PIL import Image

    for module, name in ((tlogging, "port.csv"), (jlogging, "jax.csv")):
        writer = module.MetricsWriter(str(tmp_path / "logs" / name), ["loss", "epoch", "acc"])
        writer.write(1, "train", {"loss": np.float32(0.5), "acc": 1})
        writer.write(2, "val", {"loss": 0.25, "acc": 0.75, "extra": 3.0})
        writer.close()
    _same_bytes(tmp_path / "logs" / "jax.csv", tmp_path / "logs" / "port.csv")

    grid = np.random.RandomState(10).rand(7, 7, 5).astype(np.float32)
    for threshold in (0.5, 0.9):
        np.testing.assert_array_equal(tvisualize.decode_yolo_grid(grid, threshold),
                                      jvisualize.decode_yolo_grid(grid, threshold))
    boxes = [[0.1, 0.2, 0.5, 0.6], [0.6, 0.1, 0.4, 0.9], [0.3, 0.3, 0.9, 0.8, 0.7]]
    drawn = [np.asarray(module.draw_boxes(Image.new("RGB", (96, 64)), boxes, labels=["a", "b"]))
             for module in (tvisualize, jvisualize)]
    np.testing.assert_array_equal(drawn[0], drawn[1])
    assert drawn[0].any()
