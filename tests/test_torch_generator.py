"""The port's ProgramGenerator against the JAX generator on the CPU, in fp32:
encoder outputs and carries within 1e-5, greedy tokens equal, beam-search
tokens equal and scores within 1e-5 (exact ties included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core.config import GeneratorConfig as JaxGeneratorConfig
from explainable_spatial_vqa_tpu.models.generator import ProgramGenerator as JaxGenerator
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import GeneratorConfig
from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator

torch.set_num_threads(1)

CONFIGS = {
    # the thesis-final structure (bi-directional 3+3 stacks, Luong attention), narrow
    "thesis": dict(vocab_size=24, program_vocab_size=16, embed_dim=8, hidden_dim=12,
                   encoder_layers=3, decoder_layers=3, program_len=8),
    # decoder deeper than the encoder: the extra layers start from zero carries
    "deep_decoder": dict(vocab_size=24, program_vocab_size=16, embed_dim=8, hidden_dim=12,
                         encoder_layers=1, decoder_layers=2, program_len=8),
    "simple": dict(vocab_size=24, program_vocab_size=16, embed_dim=8, hidden_dim=12,
                   encoder_layers=1, decoder_layers=1, program_len=8, bidirectional=False,
                   attention=False, simple=True),
}


def _pair(name, seed=0):
    kw = CONFIGS[name]
    rng = np.random.RandomState(seed)
    questions = rng.randint(4, 24, (6, 9)).astype(np.int32)
    for row, pad in enumerate((0, 1, 3, 0, 5, 2)):  # ragged <NULL> padding
        if pad:
            questions[row, -pad:] = 0
    jmodel = JaxGenerator(JaxGeneratorConfig(**kw))
    variables = jmodel.init({"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)},
                            jnp.asarray(questions), jnp.zeros((6, kw["program_len"]), jnp.int32))
    model = ProgramGenerator(GeneratorConfig(**kw), device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    return jmodel, variables, model, questions


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_matches_jax(name):
    jmodel, variables, model, questions = _pair(name)
    jout, jcarry = jmodel.apply(variables, jnp.asarray(questions), method=jmodel.encode)
    with torch.no_grad():
        out, carry = model.encode(torch.from_numpy(questions))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    assert len(carry) == len(jcarry)
    for (c, h), (jc, jh) in zip(carry, jcarry):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_generate_matches_jax(name):
    """Tokens must be equal.  Each step's top-2 logit margin is asserted above
    1e-4, far above the ~1e-6 fp32 disagreement, so no near-tie can flip a
    token between the two packages."""
    jmodel, variables, model, questions = _pair(name)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(questions), method=jmodel.generate))
    step_logits = []
    hook = model.out_proj.register_forward_hook(lambda _m, _i, out: step_logits.append(out))
    try:
        tokens = model.generate(torch.from_numpy(questions)).numpy()
    finally:
        hook.remove()
    assert len(step_logits) == CONFIGS[name]["program_len"]
    for logits in step_logits:
        top2 = torch.topk(logits, 2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4
    np.testing.assert_array_equal(tokens, ref)


def _until_end(row, end=2):
    """A decoded row up to and including its first <END>."""
    hits = np.flatnonzero(row == end)
    return row[:hits[0] + 1] if len(hits) else row


@pytest.mark.parametrize("name", ["thesis", "simple"])
def test_beam_generate_matches_jax(name):
    """Beams of 3 equal to JAX's, scores within 1e-5; beam 1 is the greedy
    decode up to its first <END> (after it a finished beam adds padding)."""
    jmodel, variables, model, questions = _pair(name)
    ref_tokens, ref_scores = jmodel.apply(variables, jnp.asarray(questions), beam_size=3,
                                          method=jmodel.beam_generate)
    tokens, scores = model.beam_generate(torch.from_numpy(questions), beam_size=3)
    assert tokens.shape == (6, 3, CONFIGS[name]["program_len"]) and scores.shape == (6, 3)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), rtol=0, atol=1e-5)
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()  # best first
    single, _ = model.beam_generate(torch.from_numpy(questions), beam_size=1)
    greedy = model.generate(torch.from_numpy(questions)).numpy()
    for row, ref in zip(single[:, 0].numpy(), greedy):
        np.testing.assert_array_equal(_until_end(row), _until_end(ref))


def test_beam_generate_ties_match_jax():
    """With a zero output layer every token has the same log-probability:
    each step's top-k is decided by ties alone, which both packages break
    by the lower flat (beam, token) index; finished beams tie at -1e30 for
    every token but padding."""
    jmodel, variables, model, questions = _pair("thesis")
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for leaf in ("kernel", "bias"):
        params["out_proj"][leaf][...] = 0.0
    model.load_state_dict(flax_to_state_dict(params))
    ref_tokens, ref_scores = jmodel.apply({"params": params}, jnp.asarray(questions),
                                          beam_size=5, method=jmodel.beam_generate)
    tokens, scores = model.beam_generate(torch.from_numpy(questions), beam_size=5)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(ref_scores))
    assert (tokens.numpy() == 2).any()  # <END> is among the tied picks


def test_beam_search_is_not_monotone_in_beam_size():
    """A wider beam can end below the greedy decode: a prefix the wider beam
    pruned can finish higher.  JAX's ``beam_generate`` does so on the same
    questions as the port's, with equal scores."""
    kw = dict(vocab_size=24, program_vocab_size=16, embed_dim=8, hidden_dim=12,
              encoder_layers=2, decoder_layers=2, program_len=12)
    questions = np.random.RandomState(0).randint(4, 24, (64, 9)).astype(np.int32)
    jmodel = JaxGenerator(JaxGeneratorConfig(**kw))
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                            jnp.asarray(questions), jnp.zeros((64, 12), jnp.int32))
    model = ProgramGenerator(GeneratorConfig(**kw), device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    below = []
    for package in ("jax", "port"):
        best = {}
        for k in (1, 4):
            if package == "jax":
                scores = np.asarray(jmodel.apply(variables, jnp.asarray(questions), beam_size=k,
                                                 method=jmodel.beam_generate)[1])
            else:
                scores = model.beam_generate(torch.from_numpy(questions), beam_size=k)[1].numpy()
            best[k] = scores[:, 0]
        below.append(np.flatnonzero(best[4] < best[1] - 1e-4))
    np.testing.assert_array_equal(below[1], below[0])
    assert len(below[0]) > 0
