"""The port's decoder foundation and cached decoding against the JAX package
on the CPU, in fp32, with the JAX modules' random weights carried over by the
weight bridge: the causal and combined masks, the positional encoding, the
teacher-forced ``TransformerDecoder``, a chain of cached ``decode_step``s,
``greedy_decode``, ``greedy_decode_logits`` and ``beam_search_decode``
(tokens exactly equal, logits and scores within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core.config import StepSeq2SeqConfig as JaxSeq2SeqConfig
from explainable_spatial_vqa_tpu.models import layers as jax_layers
from explainable_spatial_vqa_tpu.models.step_executor import StepExecutorSeq2Seq as JaxSeq2Seq
from explainable_spatial_vqa_tpu.ops import attention as jax_attention
from explainable_spatial_vqa_tpu.ops import decoding as jax_decoding
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import StepSeq2SeqConfig
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.step_executor import StepExecutorSeq2Seq
from explainable_spatial_vqa_tpu_torch.ops import attention, decoding

torch.set_num_threads(1)

SMALL = dict(vocab_size=24, d_model=32, num_heads=4, encoder_layers=2, decoder_layers=2,
             ffn_dim=64, dropout=0.0, max_src_len=6, max_tgt_len=7, num_image_tokens=5,
             image_feature_dim=8)
ATOL = 1e-5


def _np_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def seq2seq():
    """The JAX step seq2seq with random weights, the port's with the same
    weights, and one encoded batch (a ragged src padding mask)."""
    rng = np.random.RandomState(0)
    img = rng.rand(3, 5, 8).astype(np.float32)
    src = rng.randint(3, 24, (3, 6)).astype(np.int32)
    valid = np.ones((3, 6), bool)
    valid[1, 4:] = False
    valid[2, 2:] = False
    src[~valid] = 0
    jmodel = JaxSeq2Seq(JaxSeq2SeqConfig(**SMALL))
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(img), jnp.asarray(src),
                            jnp.zeros((3, 4), jnp.int32))
    memory, key_mask = jmodel.apply(variables, jnp.asarray(img), jnp.asarray(src),
                                    jnp.asarray(valid), method=jmodel.encode)
    model = StepExecutorSeq2Seq(StepSeq2SeqConfig(**SMALL), device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(_np_params(variables)))
    with torch.no_grad():
        tmem, tmask = model.encode(_t(img), _t(src), _t(valid))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(memory), atol=ATOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(key_mask))
    return jmodel, variables, memory, key_mask, model, tmem, tmask


@pytest.mark.parametrize("length", [1, 4, 9])
def test_causal_and_combined_masks(length):
    causal = attention.make_causal_mask(length)
    np.testing.assert_array_equal(causal.numpy(),
                                  np.asarray(jax_attention.make_causal_mask(length)))
    keys = np.random.RandomState(length).rand(2, 1, 1, length) < 0.5
    got = attention.combine_masks(None, causal, _t(keys), None)
    ref = jax_attention.combine_masks(None, jax_attention.make_causal_mask(length),
                                      jnp.asarray(keys), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert attention.combine_masks(None, None) is None
    assert attention.combine_masks(causal) is causal


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_positional_encoding_rounds_its_table_to_x(dtype):
    """The table is rounded to x's type before the add (a bf16 forward adds a
    bf16 table); an offset reads from there, clamped as dynamic_slice."""
    x = np.random.RandomState(1).randn(2, 3, 16).astype(np.float32)
    jpe = jax_layers.PositionalEncoding(16, max_len=9, dropout=0.0)
    pe = layers.PositionalEncoding(16, max_len=9, dropout=0.0, device="cpu").eval()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for offset in (0, 2, 8):
        ref = jpe.apply({}, jnp.asarray(x, jdt), offset=jnp.asarray(offset))
        got = pe(_t(x).to(tdt), offset=offset)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_teacher_forced_decoder_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 7, 32).astype(np.float32)
    memory = rng.randn(3, 9, 32).astype(np.float32)
    mask = np.ones((3, 1, 1, 9), bool)
    mask[0, ..., 5:] = False
    jdec = jax_layers.TransformerDecoder(2, 32, 4, 64, dropout=0.0)
    variables = jdec.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(memory),
                          jnp.asarray(mask))
    ref = jdec.apply(variables, jnp.asarray(x), jnp.asarray(memory), jnp.asarray(mask))
    dec = layers.TransformerDecoder(2, 32, 4, 64, dropout=0.0, device="cpu").eval()
    dec.load_state_dict(flax_to_state_dict(_np_params(variables)))
    with torch.no_grad():
        got = dec(_t(x), _t(memory), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_cached_decode_steps_match_jax_and_full_redecode(seq2seq):
    """A chain of cached decode steps fed fixed tokens gives JAX's logits;
    the port's greedy decode equals its own re-run-the-whole-decoder loop."""
    jmodel, variables, memory, key_mask, model, tmem, tmask = seq2seq
    tokens = np.random.RandomState(4).randint(0, 24, (3, 7)).astype(np.int32)
    jcache = jmodel.apply(variables, memory, 7, method=jmodel.init_cache)
    with torch.no_grad():
        cache = model.init_cache(tmem, 7)
        for index in range(7):
            ref, jcache = jmodel.apply(variables, jnp.asarray(tokens[:, index]), jcache,
                                       jnp.asarray(index), key_mask, method=jmodel.decode_step)
            got, cache = model.decode_step(_t(tokens[:, index]).long(), cache, index, tmask)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        for block, jblock in zip(cache, jcache):
            np.testing.assert_allclose(block["self"]["k"].numpy().reshape(3, 7, -1),
                                       np.asarray(jblock["self"]["k"]).reshape(3, 7, -1),
                                       atol=ATOL)
        ys = torch.ones(3, 1, dtype=torch.long)
        for _ in range(7):
            logits = model.decode(ys, tmem, tmask)
            ys = torch.cat([ys, torch.argmax(logits[:, -1], -1)[:, None]], dim=1)
        cached = decoding.greedy_decode(model, tmem, tmask, 1, 7)
    np.testing.assert_array_equal(cached.numpy(), ys[:, 1:].numpy())


@pytest.mark.parametrize("end_token", [None, 2, 5])
def test_greedy_decode_matches_jax(seq2seq, end_token):
    jmodel, variables, memory, key_mask, model, tmem, tmask = seq2seq
    ref = jax_decoding.greedy_decode(jmodel, variables, memory, key_mask, 1, 7,
                                     end_token=end_token, pad_token=0)
    with torch.no_grad():
        got = decoding.greedy_decode(model, tmem, tmask, 1, 7, end_token=end_token)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_greedy_decode_logits_matches_jax(seq2seq):
    jmodel, variables, memory, key_mask, model, tmem, tmask = seq2seq
    ref_tokens, ref_logits = jax_decoding.greedy_decode_logits(jmodel, variables, memory,
                                                               key_mask, 1, 7)
    with torch.no_grad():
        tokens, logits = decoding.greedy_decode_logits(model, tmem, tmask, 1, 7)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL)


@pytest.mark.parametrize("beam_size,end_token,length_penalty",
                         [(1, None, 0.0), (3, None, 0.0), (4, 2, 0.0), (3, 5, 0.6)])
def test_beam_search_matches_jax(seq2seq, beam_size, end_token, length_penalty):
    jmodel, variables, memory, key_mask, model, tmem, tmask = seq2seq
    ref_tokens, ref_scores = jax_decoding.beam_search_decode(
        jmodel, variables, memory, key_mask, 1, 7, beam_size=beam_size, end_token=end_token,
        length_penalty=length_penalty)
    with torch.no_grad():
        tokens, scores = decoding.beam_search_decode(
            model, tmem, tmask, 1, 7, beam_size=beam_size, end_token=end_token,
            length_penalty=length_penalty)
        greedy = decoding.greedy_decode(model, tmem, tmask, 1, 7)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_scores), atol=ATOL)
    if beam_size == 1:
        np.testing.assert_array_equal(tokens[:, 0].numpy(), greedy.numpy())
    assert (np.diff(scores.numpy(), axis=-1) <= 0).all()


def test_cache_write_keeps_the_gradient_of_earlier_steps(seq2seq):
    """A later step's output depends on an earlier step's input only through
    the K/V it wrote into the cache: the write is out of place, so the
    gradient reaches that input (an in-place write into a preallocated cache
    would break or drop that path)."""
    *_, model, tmem, tmask = seq2seq
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn(3, 1, 32, generator=gen, requires_grad=True)
    x1 = torch.randn(3, 1, 32, generator=gen)
    probe = torch.randn(3, 1, 32, generator=gen)  # a LayerNorm output's plain sum is 0
    cache = model.decoder.init_cache(3, 4, tmem)
    _, cache = model.decoder.decode_step(x0, cache, 0, tmask)
    out, _ = model.decoder.decode_step(x1, cache, 1, tmask)
    grad, = torch.autograd.grad((out * probe).sum(), x0)
    assert float(grad.abs().sum(-1).min()) > 0  # every row reaches its first step
