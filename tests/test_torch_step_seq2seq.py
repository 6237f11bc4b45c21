"""The port's step seq2seq baseline and its chain runner against the JAX
package on the CPU, in fp32, with the JAX model's random weights carried
over by the weight bridge:

- ``StepExecutorSeq2Seq``'s teacher-forced forward (logits within 1e-5) and
  cached greedy decode (tokens equal);
- the src padding mask: masked positions do not reach the other tokens'
  memory;
- ``compact_valid_first`` equal to JAX's;
- ``Seq2SeqChainRunner.run`` and ``run_bucketed_seq2seq`` on the chains of
  synthetic CLEVR questions in the joint vocabulary (as ``infer-chain``
  reads them): ``step_outputs`` and ``final_outputs`` exactly equal to the
  JAX runners'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core.config import StepSeq2SeqConfig as JaxSeq2SeqConfig
from explainable_spatial_vqa_tpu.infer import chain as jax_chain
from explainable_spatial_vqa_tpu.models.step_executor import StepExecutorSeq2Seq as JaxSeq2Seq
from explainable_spatial_vqa_tpu.ops.decoding import greedy_decode as jax_greedy_decode
from explainable_spatial_vqa_tpu.train import datasets as jds
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import StepSeq2SeqConfig
from explainable_spatial_vqa_tpu_torch.infer.chain import (
    Seq2SeqChainRunner,
    compact_valid_first,
    run_bucketed_seq2seq,
)
from explainable_spatial_vqa_tpu_torch.models.step_executor import (
    StepExecutorSeq2Seq,
    image_grid_to_tokens,
)
from explainable_spatial_vqa_tpu_torch.ops.decoding import greedy_decode

torch.set_num_threads(1)

ATOL = 1e-5
MAX_STEPS = 10
BUCKETS = (4, 7)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _config(vocab_size):
    return dict(vocab_size=vocab_size, d_model=32, num_heads=4, encoder_layers=2,
                decoder_layers=2, ffn_dim=64, dropout=0.0, max_src_len=12, max_tgt_len=5,
                num_image_tokens=6, image_feature_dim=8)


def _models(vocab_size, seed=0):
    kw = _config(vocab_size)
    jmodel = JaxSeq2Seq(JaxSeq2SeqConfig(**kw))
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 6, 8)),
                            jnp.zeros((1, 5), jnp.int32), jnp.zeros((1, 3), jnp.int32))
    model = StepExecutorSeq2Seq(StepSeq2SeqConfig(**kw), device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    return jmodel, variables, model


def test_forward_and_cached_decode_match_jax():
    jmodel, variables, model = _models(24)
    rng = np.random.RandomState(1)
    img = rng.rand(3, 6, 8).astype(np.float32)
    src = rng.randint(3, 24, (3, 7)).astype(np.int32)
    valid = np.ones((3, 7), bool)
    valid[0, 5:] = valid[2, 3:] = False
    src[~valid] = 0
    tgt = rng.randint(0, 24, (3, 5)).astype(np.int32)
    ref = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(src), jnp.asarray(tgt),
                       jnp.asarray(valid))
    memory, key_mask = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(src),
                                    jnp.asarray(valid), method=jmodel.encode)
    ref_tokens = jax_greedy_decode(jmodel, variables, memory, key_mask, 1, 5, end_token=2)
    with torch.no_grad():
        got = model(_t(img), _t(src), _t(tgt), _t(valid))
        tmem, tmask = model.encode(_t(img), _t(src), _t(valid))
        tokens = greedy_decode(model, tmem, tmask, 1, 5, end_token=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))


def test_padding_mask_effect():
    """Padded src positions do not reach the other positions' memory."""
    _, _, model = _models(24, seed=2)
    rng = np.random.RandomState(3)
    img = _t(rng.rand(2, 6, 8).astype(np.float32))
    src = torch.from_numpy(rng.randint(3, 24, (2, 6)))
    mask = torch.ones(2, 6, dtype=torch.bool)
    mask[:, -2:] = False
    src_a, src_b = src.clone(), src.clone()
    src_a[:, -2:], src_b[:, -2:] = 0, 7
    with torch.no_grad():
        mem_a, key_mask = model.encode(img, src_a, mask)
        mem_b, _ = model.encode(img, src_b, mask)
        mem_c, _ = model.encode(img, src_b, None)
    np.testing.assert_allclose(mem_a[:, :-2].numpy(), mem_b[:, :-2].numpy(), atol=ATOL)
    assert key_mask.shape == (2, 1, 1, 12) and bool(key_mask[:, 0, 0, :6].all())
    assert float((mem_c[:, :-2] - mem_b[:, :-2]).abs().max()) > 1e-3  # unmasked, they matter


def test_image_grid_to_tokens():
    grid = torch.arange(2 * 3 * 2 * 2).reshape(2, 3, 2, 2)
    tokens = image_grid_to_tokens(grid)
    assert tokens.shape == (2, 4, 3)
    np.testing.assert_array_equal(tokens[0, 0].numpy(), grid[0, :, 0, 0].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_valid_first_matches_jax(seed):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 50, (4, 3, 11)).astype(np.int32)
    valid = rng.rand(4, 3, 11) < 0.5
    ref_tokens, ref_valid = jax_chain.compact_valid_first(jnp.asarray(tokens), jnp.asarray(valid))
    got_tokens, got_valid = compact_valid_first(_t(tokens), _t(valid))
    np.testing.assert_array_equal(got_tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(ref_valid))


def identity_chains(annotated, max_steps):
    """The chains ``infer-chain`` builds: joint-vocab records whose function
    ids map to id + SPECIALS_OFFSET."""
    vocab = {}
    for q in annotated:
        for step in q["annotated_program"]:
            fn = step["function"]
            vocab.setdefault(fn, int(fn) + jds.SPECIALS_OFFSET if fn.isdigit() else 0)
    return jds.chain_arrays(annotated, vocab, max_steps=max_steps)


@pytest.fixture(scope="module")
def chains():
    """Synthetic CLEVR questions annotated in the "full" style, in the joint
    vocabulary, as chains (some deeper than MAX_STEPS), with random image
    tokens per chain."""
    from explainable_spatial_vqa_tpu.clevr import annotate as ann
    from explainable_spatial_vqa_tpu.clevr import synthetic as syn
    from explainable_spatial_vqa_tpu.clevr.scenes import Scene
    from explainable_spatial_vqa_tpu.core import vocab as voc

    scenes_raw, questions = syn.synthesize_dataset(6, 4, seed=5, hop_prob=0.5, chain_prob=0.5)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = [ann.annotate_question_full(q, scenes[q["image_index"]]) for q in questions]
    vocab = voc.build_joint_vocab(annotated)
    annotated = [voc.apply_joint_vocab(q, vocab) for q in annotated]
    arrays = identity_chains(annotated, MAX_STEPS)
    image = np.random.RandomState(6).rand(len(annotated), 6, 8).astype(np.float32)
    return arrays, image, len(vocab) + jds.SPECIALS_OFFSET


def test_chain_runners_match_jax(chains):
    arrays, image, vocab_size = chains
    assert arrays.truncated > 0 and (arrays.num_steps < MAX_STEPS).any()
    assert (arrays.deps >= 0).sum(-1).max() == 2  # steps with two dependencies
    jmodel, variables, model = _models(vocab_size, seed=7)
    jrunner = jax_chain.Seq2SeqChainRunner(jmodel, variables, jmodel.config, max_steps=MAX_STEPS)
    runner = Seq2SeqChainRunner(model, model.config, max_steps=MAX_STEPS, device="cpu")
    ref = jrunner.run(image, arrays)
    got = runner.run(image, arrays)
    bucketed = run_bucketed_seq2seq(runner, torch.from_numpy(image), arrays, BUCKETS)
    ref_bucketed = jax_chain.run_bucketed_seq2seq(jrunner, image, arrays, BUCKETS)
    for out in (got, bucketed):
        assert set(out) == {"step_outputs", "final_outputs"}
        np.testing.assert_array_equal(out["step_outputs"], ref["step_outputs"])
        np.testing.assert_array_equal(out["final_outputs"], ref["final_outputs"])
    np.testing.assert_array_equal(ref_bucketed["step_outputs"], ref["step_outputs"])
    assert (got["step_outputs"] != 0).any()
