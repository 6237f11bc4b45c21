"""The port's synthetic-protocol trainers and evaluation against the JAX
package's ``train/synthetic_protocol.py`` on the CPU, in float32.

- ``warmup_cosine_lr`` equals optax's ``warmup_cosine_decay_schedule`` at
  every step (within 1e-7 relative; both raise at ``steps == 1``), and the
  optimizer (clip at 1.0, Adam, the schedule) equals optax's chain on fixed
  gradients within 1e-6;
- one ``train_generator_synthetic`` step (constant rate) and one
  ``train_executor_synthetic`` step (cosine, ``box_roi`` on and off) from
  the same weights (the JAX module's, carried over by the weight bridge):
  the loss within 1e-5 relative, as the trainer's step tests hold it (the
  same batch drawn), and the updated parameters within 1e-6 where the
  gradient's sign is settled (|g| above 1e-3 of the tensor's max), within
  the Adam step's own size 2·lr elsewhere (``tests/test_torch_train.py``
  holds each gradient against ``jax.value_and_grad``);
- the executor's kwargs that contradict a given config raise.

- ``evaluate_pipeline_synthetic`` with the same trained float32 weights
  gives JAX's faithfulness tally and accuracy by type exactly.

The four-cell protocol and its CLI are in ``tests/test_torch_cogent.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from explainable_spatial_vqa_tpu.clevr import annotate as jann
from explainable_spatial_vqa_tpu.clevr import synthetic as jsyn
from explainable_spatial_vqa_tpu.clevr.scenes import Scene
from explainable_spatial_vqa_tpu.core import vocab as jvoc
from explainable_spatial_vqa_tpu.core.artifacts import encode_questions
from explainable_spatial_vqa_tpu.train import synthetic_protocol as jsp
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import GeneratorConfig
from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol as tsp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus():
    """A small CoGenT-A corpus: questions, annotations, vocabularies and the
    entangled feature maps (image index = position)."""
    scenes_raw, questions = jsyn.synthesize_cogent_dataset(10, 4, "A", seed=1, hop_prob=0.5)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = jann.annotate_questions(questions, scenes)
    features = np.stack([jsyn.scene_feature_map(s, entangled=True).reshape(64, -1).T
                         for s in scenes_raw]).astype(np.float32)
    return dict(questions=questions, annotated=annotated, features=features,
                clevr_vocab=jvoc.build_clevr_vocab([questions]),
                split_vocab=jvoc.build_split_vocab(annotated))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the schedule and the optimizer ------------------------------------------

@pytest.mark.parametrize("steps", [1, 20, 57, 400])
@pytest.mark.parametrize("peak", [2e-3, 1e-3, 1e-3 * 0.5 ** 1.5])
def test_warmup_cosine_matches_optax(steps, peak):
    warmup = max(1, steps // 20)
    if steps == 1:  # no decay step: optax refuses the schedule, and so does the port
        with pytest.raises(ValueError):
            optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps, peak * 0.05)
        with pytest.raises(ValueError):
            tsp.warmup_cosine_lr(0, peak, steps)
        return
    ref = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, steps, peak * 0.05)
    counts = np.arange(steps + 3, dtype=np.int32)
    want = np.asarray(jax.vmap(ref)(counts), np.float64)
    got = np.asarray([tsp.warmup_cosine_lr(int(i), peak, steps) for i in counts])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert got[0] == 0.0 and got[warmup] == np.float32(peak)


@pytest.mark.parametrize("schedule, steps", [("constant", 5), ("cosine", 5), ("cosine", 0),
                                             ("cosine", -1)])
def test_optimizer_matches_optax(schedule, steps):
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (0.05, 3.0, 0.5, 10.0, 0.01)]  # some clipped, some not
    tx = jsp._make_optimizer(1e-2, schedule, steps)
    params, state = dict(init), tx.init(init)
    tparams = [torch.nn.Parameter(torch.from_numpy(init[k].copy())) for k in shapes]
    update = tsp._make_optimizer(tparams, 1e-2, schedule, steps)
    for it, g in enumerate(grads):
        upd, state = tx.update(g, state, params)
        params = optax.apply_updates(params, upd)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(g[k].copy())
        update(it)
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), atol=1e-6,
                                       rtol=0, err_msg=f"{k} step {it}")
    with pytest.raises(ValueError):
        tsp._make_optimizer(tparams, 1e-2, "linear", 5)


def test_protocol_config_and_lr_equal():
    vocabs = {"function": {"a": 0, "b": 1}, "other": {"x": 0}}
    for kw in (dict(), dict(d_model=192, encoder_layers=3, box_roi=True, noise=0.1),
               dict(roi_sim=True, box_roi=True, roi_sim_heads=2, count_embed=True)):
        assert (dataclasses.asdict(tsp.make_protocol_executor_config(vocabs, **kw))
                == dataclasses.asdict(jsp.make_protocol_executor_config(vocabs, **kw)))
    for d in (48, 96, 192, 512):
        assert tsp.default_executor_lr(d) == jsp.default_executor_lr(d)


# -- one train step ----------------------------------------------------------

def _check_step(model, jax_before, jax_after, lr):
    """The updated parameters within 2·lr (the Adam step's own size)
    everywhere, and within 1e-6 where the step's gradient (clipped, as it
    was applied) is above 1e-3 of its tensor's max |g|: there its sign, and
    so the step's direction, is settled, while a gradient within a rounding
    of 0 can turn it.  A key bias's gradient is all rounding (the softmax
    ignores a constant per query).  Every other tensor moved by about lr."""
    after = flax_to_state_dict(_np(jax_after))
    before = flax_to_state_dict(_np(jax_before))
    named = dict(model.named_parameters())
    assert set(named) == set(after)
    for name, p in named.items():
        p = p.detach()
        assert float((p - after[name]).abs().max()) <= 2 * lr + 1e-6, name
        if name.endswith(".k.bias"):
            continue
        moved = float((after[name] - before[name]).abs().max())
        assert lr * 0.5 <= moved <= lr * 1.01 + 1e-6, name
        g = named[name].grad.abs()
        settled = g > 1e-3 * float(g.max())
        np.testing.assert_allclose(p[settled].numpy(), after[name][settled].numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_generator_step_matches_jax(corpus):
    questions, vocab = corpus["questions"], corpus["clevr_vocab"]
    enc = encode_questions(questions, vocab)
    q, p = enc.questions, enc.programs
    jcfg_kw = dict(vocab_size=int(q.max()) + 1, program_vocab_size=int(p.max()) + 1,
                   embed_dim=64, hidden_dim=128, encoder_layers=1, decoder_layers=1,
                   dropout=0.0, program_len=p.shape[1])
    from explainable_spatial_vqa_tpu.core.config import GeneratorConfig as JaxGeneratorConfig
    from explainable_spatial_vqa_tpu.models.generator import ProgramGenerator as JaxGenerator

    jcfg = JaxGeneratorConfig(**jcfg_kw)
    jmodel = JaxGenerator(jcfg)
    variables = jmodel.init({"params": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)},
                            jnp.asarray(q[:2]), jnp.asarray(p[:2]))
    lr = 2e-3
    _, jvars, _, jloss = jsp.train_generator_synthetic(
        questions, vocab, steps=1, batch_size=16, learning_rate=lr, seed=5, config=jcfg,
        init_variables=variables)
    model, cfg, loss = tsp.train_generator_synthetic(
        questions, vocab, steps=1, batch_size=16, learning_rate=lr, seed=5,
        config=GeneratorConfig(**jcfg_kw), init_variables=flax_to_state_dict(_np(variables["params"])),
        device="cpu")
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)

    _check_step(model, variables["params"], jvars["params"], lr)


@pytest.mark.parametrize("box_roi", [False, True])
def test_executor_step_matches_jax(corpus, box_roi):
    """Two steps under ``cosine``: the first step's rate is 0, so the second
    runs from the initial weights on the second batch, at the peak rate."""
    schedule, steps = "cosine", 2
    ann, vocabs, features = corpus["annotated"], corpus["split_vocab"], corpus["features"]
    jcfg = jsp.make_protocol_executor_config(vocabs, d_model=32, encoder_layers=1, box_roi=box_roi)
    tcfg = tsp.make_protocol_executor_config(vocabs, d_model=32, encoder_layers=1, box_roi=box_roi)
    arrays = jds.executor_step_arrays(ann, vocabs["function"], vocabs["other"],
                                      max_input_boxes=8, max_output_boxes=8)
    from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor

    jmodel = JaxExecutor(jcfg)
    images = features[arrays["image_index"]]
    variables = jmodel.init(jax.random.PRNGKey(7), jnp.asarray(images[:2]),
                            jnp.asarray(arrays["input_boxes"][:2]),
                            jnp.asarray(arrays["input_box_mask"][:2]),
                            jnp.asarray(arrays["text"][:2]), jnp.asarray(arrays["text_mask"][:2]))
    lr = 1e-3
    kw = dict(steps=steps, batch_size=24, learning_rate=lr, seed=2, lr_schedule=schedule)
    _, jvars, _, jloss = jsp.train_executor_synthetic(ann, vocabs, features, config=jcfg,
                                                      init_variables=variables, **kw)
    model, cfg, loss = tsp.train_executor_synthetic(
        ann, vocabs, features, config=tcfg,
        init_variables=flax_to_state_dict(_np(variables["params"])), device="cpu", **kw)
    assert cfg is tcfg
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)

    _check_step(model, variables["params"], jvars["params"], lr)


def test_executor_kwargs_contradicting_the_config_raise(corpus):
    vocabs = corpus["split_vocab"]
    cfg = tsp.make_protocol_executor_config(vocabs, d_model=32, encoder_layers=1)
    for kw in (dict(box_roi=True), dict(noise=0.1), dict(sinkhorn_iters=5), dict(count_embed=True)):
        with pytest.raises(ValueError, match="conflicts with config"):
            tsp.train_executor_synthetic(corpus["annotated"], vocabs, corpus["features"],
                                         steps=0, config=cfg, device="cpu", **kw)
    # agreeing values are fine
    tsp.train_executor_synthetic(corpus["annotated"], vocabs, corpus["features"], steps=0,
                                 config=cfg, box_roi=False, noise=0.0, device="cpu")


def test_scheduled_trainer(corpus):
    """The scheduled trainer's default config is the JAX package's literal
    (the protocol config at d_model 96 with ``scheduled_p_max``); two steps
    at a small width train (finite loss, most tensors move)."""
    ann, vocabs, features = corpus["annotated"], corpus["split_vocab"], corpus["features"]
    _, tcfg, _ = tsp.train_executor_scheduled_synthetic(ann, vocabs, features, steps=0,
                                                        p_max=0.25, device="cpu")
    jcfg = dataclasses.replace(jsp.make_protocol_executor_config(vocabs), scheduled_p_max=0.25)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    small = dataclasses.replace(tcfg, d_model=32, encoder_layers=1)
    model, cfg, loss = tsp.train_executor_scheduled_synthetic(
        ann, vocabs, features, steps=2, batch_size=4, config=small, device="cpu", seed=3)
    fresh, _, _ = tsp.train_executor_scheduled_synthetic(
        ann, vocabs, features, steps=0, config=small, device="cpu", seed=3)
    assert cfg is small and np.isfinite(loss)
    before = fresh.state_dict()
    moved = [name for name, p in model.state_dict().items() if not torch.equal(p, before[name])]
    assert len(moved) > len(before) // 2


def test_out_of_range_ids_read_nan_as_in_jax():
    """A question word or program token past the generator's tables (the
    fine-tune corpus can hold one the A-sized model lacks) reads a NaN row,
    as Flax's ``Embed`` fills it, and a target past the logits a NaN loss, as
    the JAX package's cross entropy gives: the port neither raises nor
    asserts on the card."""
    import flax.linen as fnn

    from explainable_spatial_vqa_tpu.train.losses import cross_entropy as jce
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.train.losses import cross_entropy as tce

    logits = np.random.RandomState(0).randn(2, 3, 5).astype(np.float32)
    for targets in ([[1, 4, 0], [2, 3, 1]], [[1, 7, 0], [2, 3, 1]]):
        t = np.asarray(targets)
        want = float(jce(jnp.asarray(logits), jnp.asarray(t)))
        got = float(tce(torch.from_numpy(logits), torch.from_numpy(t)))
        assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, rel=1e-6)
    embed = fnn.Embed(4, 3)
    ids = jnp.asarray([[1, 6, 3]])
    jrows = np.asarray(embed.apply(embed.init(jax.random.PRNGKey(0), ids), ids))
    cfg = GeneratorConfig(vocab_size=4, program_vocab_size=6, embed_dim=3, hidden_dim=8,
                          encoder_layers=1, decoder_layers=1, program_len=4)
    model = ProgramGenerator(cfg, device="cpu")
    out = model.generate(torch.tensor([[1, 2, 3], [1, 6, 3]]))
    assert np.isnan(jrows[0, 1]).all() and np.isfinite(jrows[0, [0, 2]]).all()
    assert out[1].tolist() == [0, 0, 0, 0]  # argmax of NaN logits, in JAX too


def test_out_of_range_program_target_poisons_only_its_sequence():
    """A teacher-forced program target past the program table is fed as a
    NaN row (Flax's ``Embed`` fill) from the step after it on, in its own
    sequence only; the steps before it and the other sequences match a
    forward whose targets are all in range."""
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator

    cfg = GeneratorConfig(vocab_size=5, program_vocab_size=6, embed_dim=3, hidden_dim=8,
                          encoder_layers=1, decoder_layers=1, program_len=4)
    model = ProgramGenerator(cfg, device="cpu").eval()
    questions = torch.tensor([[1, 2, 3], [4, 2, 0]])
    inside = torch.tensor([[3, 4, 2, 0], [5, 1, 2, 0]])
    outside = inside.clone()
    outside[0, 1] = 9
    with torch.no_grad():
        want = model(questions, inside, teacher_forcing=1.0)["logits"]
        got = model(questions, outside, teacher_forcing=1.0)["logits"]
    assert torch.equal(got[1], want[1]) and torch.equal(got[0, :2], want[0, :2])
    assert torch.isnan(got[0, 2:]).all()


# -- evaluation --------------------------------------------------------------

def _to_flax(state_dict, template):
    """The inverse of the weight bridge for ``template``'s tree: every leaf
    element gets a unique id, the bridge maps the ids like the weights, and
    each weight goes back to the element its id names."""
    leaves, treedef = jax.tree_util.tree_flatten(_np(template))
    starts = np.cumsum([0] + [leaf.size for leaf in leaves])
    assert starts[-1] < 2 ** 24  # ids stay exact in the bridge's float32
    ids = [np.arange(a, b, dtype=np.float32).reshape(leaf.shape)
           for a, b, leaf in zip(starts, starts[1:], leaves)]
    placed = flax_to_state_dict(jax.tree_util.tree_unflatten(treedef, ids))
    flat = np.zeros(starts[-1], np.float32)
    for name, where in placed.items():
        flat[where.numpy().astype(np.int64).ravel()] = state_dict[name].numpy().ravel()
    return jax.tree_util.tree_unflatten(
        treedef, [flat[a:b].reshape(leaf.shape) for a, b, leaf in zip(starts, starts[1:], leaves)])


def test_evaluate_pipeline_matches_jax(corpus):
    """The port trains both models briefly (the generator until its programs
    parse, so the chains run); JAX evaluates the same float32 weights, sent
    back through the inverse of the weight bridge."""
    from explainable_spatial_vqa_tpu.core.config import GeneratorConfig as JaxGeneratorConfig
    from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
    from explainable_spatial_vqa_tpu.models.generator import ProgramGenerator as JaxGenerator

    questions, ann = corpus["questions"], corpus["annotated"]
    clevr_vocab, split_vocab, features = (corpus["clevr_vocab"], corpus["split_vocab"],
                                          corpus["features"])
    generator, gcfg, _ = tsp.train_generator_synthetic(questions, clevr_vocab, steps=40,
                                                       learning_rate=5e-3, seed=0, device="cpu")
    tcfg = tsp.make_protocol_executor_config(split_vocab, d_model=32, encoder_layers=1,
                                             box_roi=True)
    executor, _, _ = tsp.train_executor_synthetic(ann, split_vocab, features, steps=40,
                                                  batch_size=16, learning_rate=3e-3, seed=0,
                                                  config=tcfg, device="cpu")
    tally_t, acc_t = tsp.evaluate_pipeline_synthetic(generator, executor, tcfg, questions,
                                                     features, clevr_vocab, split_vocab,
                                                     device="cpu")

    jgcfg = JaxGeneratorConfig(**dataclasses.asdict(gcfg))
    jgen = JaxGenerator(jgcfg)
    q = jnp.zeros((2, 4), jnp.int32)
    gtemplate = jgen.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                          q, jnp.zeros((2, gcfg.program_len), jnp.int32))["params"]
    jcfg = jsp.make_protocol_executor_config(split_vocab, d_model=32, encoder_layers=1,
                                             box_roi=True)
    jexe = JaxExecutor(jcfg)
    etemplate = jexe.init(jax.random.PRNGKey(0), jnp.asarray(features[:2]),
                          jnp.zeros((2, 8, 4)), jnp.ones((2, 8), bool),
                          jnp.zeros((2, 3), jnp.int32), jnp.ones((2, 3), bool))["params"]
    gvars = {"params": _to_flax(generator.state_dict(), gtemplate)}
    evars = {"params": _to_flax(executor.state_dict(), etemplate)}
    tally_j, acc_j = jsp.evaluate_pipeline_synthetic(jgen, gvars, jexe, evars, jcfg, questions,
                                                     features, clevr_vocab, split_vocab)
    assert acc_t == acc_j
    assert dataclasses.asdict(tally_t) == dataclasses.asdict(tally_j)
    assert tally_t.total == len(questions)
    # programs parse and chains answer: right and wrong programs, right answers
    assert tally_t.both_correct > 0 and tally_t.program_only > 0 and tally_t.neither > 0
