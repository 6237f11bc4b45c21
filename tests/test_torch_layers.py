"""The port's layers and executor against the JAX package on the CPU, in fp32,
with the JAX modules' random weights carried over by the weight bridge."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig
from explainable_spatial_vqa_tpu.core.config import GeneratorConfig as JaxGeneratorConfig
from explainable_spatial_vqa_tpu.models import executor as jax_executor
from explainable_spatial_vqa_tpu.models import layers as jax_layers
from explainable_spatial_vqa_tpu.models.generator import ProgramGenerator as JaxGenerator
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.executor import (
    BoxDecoder,
    ProgramExecutor,
    roi_coverage_weights,
)
from explainable_spatial_vqa_tpu_torch.models.generator import LSTMCell, ProgramGenerator

torch.set_num_threads(1)

SMALL = dict(vocab_size=16, d_model=32, num_heads=4, encoder_layers=2, box_decoder_layers=2,
             num_queries=3, num_image_tokens=4, image_feature_dim=8, max_input_boxes=4,
             token_classes=8)


def _numpy_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_sincos_tables():
    for args in ((7, 16), (1, 2), (30, 64)):
        np.testing.assert_array_equal(layers.sinusoidal_positions(*args),
                                      jax_layers.sinusoidal_positions(*args))
    np.testing.assert_array_equal(layers.posemb_2d_sincos(3, 5, 32),
                                  jax_layers.posemb_2d_sincos(3, 5, 32))
    xy = np.random.RandomState(0).rand(2, 6, 2).astype(np.float32)
    np.testing.assert_allclose(layers.posemb_2d_sincos_at(_t(xy), 32).numpy(),
                               np.asarray(jax_layers.posemb_2d_sincos_at(jnp.asarray(xy), 32)),
                               atol=1e-6)


def test_roi_coverage_weights():
    rng = np.random.RandomState(1)
    lo = rng.rand(3, 5, 2) * 0.6
    boxes = np.concatenate([lo, lo + rng.rand(3, 5, 2) * 0.4], -1).astype(np.float32)
    boxes[0, 0] = 0.25  # zero-area box: all-zero weights
    ref = np.asarray(jax_executor.roi_coverage_weights(jnp.asarray(boxes), 4))
    out = roi_coverage_weights(_t(boxes), 4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert not out[0, 0].any()


def test_box_decoder_matches_jax():
    cfg = JaxExecutorConfig(**SMALL)
    rng = np.random.RandomState(2)
    memory = rng.randn(3, 9, 32).astype(np.float32)
    mask = np.ones((3, 1, 1, 9), bool)
    mask[1, ..., -4:] = False
    jdec = jax_executor.BoxDecoder(cfg)
    variables = jdec.init(jax.random.PRNGKey(0), jnp.asarray(memory), jnp.asarray(mask))
    ref = np.asarray(jdec.apply(variables, jnp.asarray(memory), jnp.asarray(mask)))
    dec = BoxDecoder(ExecutorConfig(**SMALL), device="cpu").eval()
    dec.load_state_dict(flax_to_state_dict(_numpy_params(variables)))
    out = dec(_t(memory), _t(mask)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


def _executor_pair(box_roi, seed=0, **options):
    """The JAX executor with random weights and the port's with the same
    weights, plus numpy inputs.  The roi_sim and count_embed channels, zero at
    init, get seeded random values first."""
    kw = dict(SMALL, box_roi=box_roi, **options)
    jmodel = jax_executor.ProgramExecutor(JaxExecutorConfig(**kw))
    rng = np.random.RandomState(seed)
    boxes_lo = rng.rand(3, 4, 2) * 0.5
    inputs = (
        rng.rand(3, 4, 8).astype(np.float32),
        np.concatenate([boxes_lo, boxes_lo + rng.rand(3, 4, 2) * 0.5], -1).astype(np.float32),
        rng.rand(3, 4) > 0.4,
        rng.randint(0, 16, (3, 3)).astype(np.int32),
        np.array([[1, 1, 0], [1, 0, 1], [1, 1, 1]], bool),
    )
    variables = jmodel.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for name, leaf in (("sim_embed", "kernel"), ("count_embed", "embedding")):
        if name in params:
            assert not params[name][leaf].any()  # zero at init
            params[name][leaf] = rng.randn(*params[name][leaf].shape).astype(np.float32)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    model = ProgramExecutor(ExecutorConfig(**kw), device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(params))
    return jmodel, variables, model, inputs


@pytest.mark.parametrize("box_roi", [False, True])
def test_executor_forward_matches_jax(box_roi):
    """fp32, atol 1e-4 on logits and boxes; raw and precomputed image paths."""
    jmodel, variables, model, inputs = _executor_pair(box_roi)
    ref = jmodel.apply(variables, *map(jnp.asarray, inputs))
    out = model(*map(_t, inputs))
    pre = model.precompute_image(_t(inputs[0]))
    jpre = jmodel.apply(variables, jnp.asarray(inputs[0]), method=jmodel.precompute_image)
    np.testing.assert_allclose(pre.detach().numpy(), np.asarray(jpre), atol=1e-5)
    out_pre = model(pre, *map(_t, inputs[1:]), image_precomputed=True)
    for key in ("routing_logits", "token_logits", "pred_boxes", "pred_conf"):
        for got in (out, out_pre):
            np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]),
                                       atol=1e-4, err_msg=key)


@pytest.mark.parametrize("heads", [1, 4])
def test_executor_roi_sim_count_matches_jax(heads):
    """roi_sim with ``heads`` match maps and count_embed, fp32, atol 2e-5 on
    logits and boxes; raw and precomputed image paths.  The precomputed
    cache carries [tokens | sim keys], width 2d, as the JAX one does."""
    jmodel, variables, model, inputs = _executor_pair(True, seed=heads, roi_sim=True,
                                                      roi_sim_heads=heads, count_embed=True)
    ref = jmodel.apply(variables, *map(jnp.asarray, inputs))
    pre = model.precompute_image(_t(inputs[0]))
    jpre = jmodel.apply(variables, jnp.asarray(inputs[0]), method=jmodel.precompute_image)
    assert pre.shape == jpre.shape == (3, 4, 64)
    np.testing.assert_allclose(pre.detach().numpy(), np.asarray(jpre), atol=1e-5)
    for got in (model(*map(_t, inputs)), model(pre, *map(_t, inputs[1:]), image_precomputed=True)):
        for key in ("routing_logits", "token_logits", "pred_boxes", "pred_conf"):
            np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]),
                                       atol=2e-5, err_msg=key)
    # the channels are live: zeroing them moves the outputs
    with torch.no_grad():
        model.sim_embed.weight.zero_()
        model.count_embed.weight.zero_()
    off = model(*map(_t, inputs))
    assert not np.allclose(off["token_logits"].detach().numpy(), np.asarray(ref["token_logits"]),
                           atol=1e-3)


def test_roi_sim_scale_in_compute_type():
    """The similarity is divided by sqrt(dh) taken in the compute type: in
    bf16, sqrt(128) rounds to 11.3125, as jnp.sqrt in bf16 gives."""
    ref = float(jnp.sqrt(jnp.asarray(128, jnp.bfloat16)))
    assert ref == 11.3125
    assert float(torch.tensor(128.0, dtype=torch.bfloat16).sqrt()) == ref


def test_executor_rejects_unported_options():
    """Option sets the JAX executor refuses (roi_sim without box_roi, match
    maps that do not divide d_model) raise in the port too."""
    for options in (dict(box_roi=False, roi_sim=True), dict(box_roi=True, roi_sim=True,
                                                            roi_sim_heads=3)):
        kw = dict(SMALL, **options)
        jmodel = jax_executor.ProgramExecutor(JaxExecutorConfig(**kw))
        with pytest.raises(ValueError, match="roi_sim"):
            jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)), jnp.zeros((1, 4, 4)),
                        jnp.ones((1, 4), bool), jnp.zeros((1, 3), jnp.int32),
                        jnp.ones((1, 3), bool))
        with pytest.raises(ValueError, match="roi_sim"):
            ProgramExecutor(ExecutorConfig(**kw), device="cpu")


def _generator_pair():
    kw = dict(vocab_size=24, program_vocab_size=16, embed_dim=8, hidden_dim=12,
              encoder_layers=2, decoder_layers=2, program_len=6)
    jmodel = JaxGenerator(JaxGeneratorConfig(**kw))
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                            jnp.ones((2, 7), jnp.int32), jnp.zeros((2, 6), jnp.int32))
    return variables, ProgramGenerator(GeneratorConfig(**kw), device="cpu")


@pytest.mark.parametrize("which", ["executor", "executor_roi", "executor_roi_sim_count",
                                   "generator"])
def test_convert_round_trip(which):
    """Converted keys are exactly the module's own (strict load), every tensor
    has the module's shape, and the loaded values are the converted ones."""
    if which == "generator":
        variables, model = _generator_pair()
    elif which == "executor_roi_sim_count":
        _, variables, model, _ = _executor_pair(True, roi_sim=True, roi_sim_heads=4,
                                                count_embed=True)
        assert {"sim_roi_proj.weight", "sim_img_proj.weight", "sim_embed.weight",
                "count_embed.weight"} <= set(model.state_dict())
    else:
        _, variables, model, _ = _executor_pair(which == "executor_roi")
    converted = flax_to_state_dict(_numpy_params(variables))
    own = model.state_dict()
    assert set(converted) == set(own)
    for name, tensor in converted.items():
        assert tensor.shape == own[name].shape, name
        assert tensor.dtype == torch.float32
    model.load_state_dict(converted, strict=True)
    for name, tensor in model.state_dict().items():
        torch.testing.assert_close(tensor, converted[name], rtol=0, atol=0)
    if which == "executor_roi":
        # spot-check the head-major (d, H, Dh) -> (d, d) reshape of a query kernel
        q = np.asarray(variables["params"]["fusion"]["block_0"]["attn"]["q"]["kernel"])
        w = converted["fusion.blocks.0.attn.q.weight"].numpy()
        np.testing.assert_array_equal(w[1 * 8 + 3], q[:, 1, 3])


def test_configs_match_jax_fields():
    for port, ref in ((ExecutorConfig, JaxExecutorConfig), (GeneratorConfig, JaxGeneratorConfig)):
        assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


def _cached_module(which, seed):
    """A bf16 module whose inference keeps cast or fused weights between
    calls, its parameters drawn from ``seed``, and a call on a fixed input."""
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 16).astype(np.float32))
    if which == "encoder_block":  # eval, no mask: K2's weights
        module = layers.EncoderBlock(16, 2, 64, dropout=0.0, dtype=torch.bfloat16, device="cpu")
        call = lambda m: m(x)  # noqa: E731
    elif which == "dense":
        module = layers.Dense(16, 8, torch.bfloat16, device="cpu")
        call = lambda m: m(x)  # noqa: E731
    else:
        module = LSTMCell(16, 8, torch.bfloat16, device="cpu")
        carry = (torch.zeros(2, 8), torch.ones(2, 8))
        call = lambda m: m(carry, x[:, 0])[1]  # noqa: E731
    return layers.init_parameters(module, seed).eval(), call


@pytest.mark.parametrize("which", ["encoder_block", "dense", "lstm_cell"])
def test_kept_weights_follow_parameter_writes(which):
    """The weights kept between inference calls are rebuilt after
    load_state_dict and after an in-place write, and never serve stale
    values: each call equals a fresh copy's."""
    module, call = _cached_module(which, seed=0)
    other, _ = _cached_module(which, seed=1)
    with torch.no_grad():
        first = call(module)
        assert torch.equal(call(module), first)
        module.load_state_dict(other.state_dict())
        assert torch.equal(call(module), call(other))
        assert not torch.equal(call(module), first)
        for p in module.parameters():
            p.mul_(1.5)
        assert torch.equal(call(module), call(copy.deepcopy(module)))
        assert not torch.equal(call(module), call(other))
