"""K1 at every head dim, on the CPU against the JAX package.

The TPU kernel (``explainable_spatial_vqa_tpu/ops/pallas_attention.py``) takes
any head dim; the port's K1 takes every head dim from 1 to 512
(``HEAD_DIMS``): every multiple of 8 from 8 to 128 has kernels of its own
(``EXACT_HEAD_DIMS``; the C library's ``ESV_K1_HEAD_DIMS``, compiled in the
units of ``ops._build.K1_DIM_GROUPS``), every other head dim the padded
kernels at its padded depth (``PADDED_DEPTHS``; ``ESV_K1_PAD_DEPTHS``, the
units of ``ops._build.K1_PAD_GROUPS``).  Here, on the same numpy inputs:

- the gates: ``head_dim_built`` and the wrapper's contract follow that set,
  and the source, the build's groups and the Python sets name the same dims
  and depths;
- K1's plain version (the wrapper's path for a CPU tensor) against JAX's
  Pallas kernel in interpret mode and JAX's XLA attention at head dims 8,
  16, 24, 32, 48, 64 and 96 and the models' lengths (8: the protocol's box
  decoder; 208: its fusion encoder; 243: the Transformer IQAP's encoder), in
  float32 within 1e-5, the tolerance of ``tests/test_pallas_attention.py``;
- the CoGenT protocol's executor at d_model 32, 64, 96, 128, 192 and 384
  (head dims 8, 16, 24, 32, 48 and 96), JAX's Flax weights carried over by
  ``convert.py``: an eval forward in both packages agrees, and in the port
  it calls K1 once per fusion layer and once per box-decoder layer, and K2
  never (on the CPU JAX's dispatch takes its XLA path,
  ``ops/attention.py:57``); a training forward, or an eval forward that
  records a graph, calls neither;
- where the d 256 models route: the Transformer IQAP's and the step
  seq2seq's encoders call K1, their decoders' causal self-attention and
  cross-attention do not, and neither does a training forward or an eval
  forward that records an autograd graph (the kernel has no backward).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
from explainable_spatial_vqa_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu.train import synthetic_protocol as jax_protocol
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import IQAPConfig, StepSeq2SeqConfig
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.iqap import TransformerIQAP, generate_programs
from explainable_spatial_vqa_tpu_torch.models.layers import eval_mode, init_parameters
from explainable_spatial_vqa_tpu_torch.models.prototypes import HierarchicalGenerator
from explainable_spatial_vqa_tpu_torch.models.step_executor import StepExecutorSeq2Seq
from explainable_spatial_vqa_tpu_torch.ops.decoding import greedy_decode
from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    EXACT_HEAD_DIMS,
    HEAD_DIMS,
    PADDED_DEPTHS,
    check_attention,
    fused_attention,
    head_dim_built,
    padded_depth,
)
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    BLOCK_HEAD_DIMS,
    block_head_dim_built,
)
from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol

torch.set_num_threads(1)

VOCABS = {"function": {f"f{i}": i for i in range(6)}, "other": {f"o{i}": i for i in range(5)}}


def _key_mask(batch, length, seed):
    """Ragged key-padding mask: row b keeps its first length - r_b keys."""
    rng = np.random.RandomState(seed)
    keep = np.ones((batch, length), bool)
    for b in range(batch):
        keep[b, length - rng.randint(1, length // 2 + 1):] = False
    return keep


def test_head_dim_built_is_every_multiple_of_8_to_128():
    """K1's gate: 4 heads of every head dim from 1 to 512 (d_model 4 to
    2048), among them every multiple of 8 from 8 to 128 and 4, 25, 136 and
    257; none past 512; K2's at 128, 256, 384 and 512."""
    assert HEAD_DIMS == tuple(range(1, 513))
    assert EXACT_HEAD_DIMS == tuple(range(8, 129, 8))
    for head_dim in range(1, 513):
        assert head_dim_built(4 * head_dim, 4), head_dim
        assert head_dim_built(2 * head_dim, 2), head_dim
    for head_dim in (4, 25, 136, 257):
        assert head_dim_built(4 * head_dim, 4), head_dim
    assert not head_dim_built(4 * 513, 4)
    assert not head_dim_built(100, 3)  # no whole head dim
    assert BLOCK_HEAD_DIMS == (128, 256, 384, 512)
    assert ([d for d in range(8, 641, 8) if block_head_dim_built(4 * d, 4)]
            == [128, 256, 384, 512])


@pytest.mark.parametrize("head_dim,ok", [(8, True), (72, True), (128, True), (4, True),
                                          (25, True), (136, True), (257, True), (512, True),
                                          (513, False)])
def test_wrapper_contract_follows_head_dims(head_dim, ok):
    """The wrapper's contract (checked before any launch on a CUDA tensor)
    takes exactly the head dims of ``HEAD_DIMS``, 1 to 512."""
    q, k, v = (torch.zeros(2, 5, 2, head_dim) for _ in range(3))
    if ok:
        check_attention(q, k, v)
    else:
        with pytest.raises(ValueError, match="head dim"):
            check_attention(q, k, v)


def test_source_and_build_name_the_same_head_dims(monkeypatch):
    """``csrc/fused_attention.cu``'s dispatch lists (ESV_K1_HEAD_DIMS,
    ESV_K1_PAD_DEPTHS), the build's units (each dim and depth in exactly one
    group) and ``EXACT_HEAD_DIMS`` and ``PADDED_DEPTHS`` agree, and every
    other head dim up to 512 has its padded depth among them; the library's
    hash covers the units' flags, so regrouping rebuilds."""
    source = (_build.CSRC_DIR / "fused_attention.cu").read_text()
    listed = re.search(r"#define ESV_K1_HEAD_DIMS ([0-9, ]+)\n", source).group(1)
    assert tuple(int(d) for d in listed.split(",")) == EXACT_HEAD_DIMS
    depths = re.search(r"#define ESV_K1_PAD_DEPTHS ([0-9, ]+)\n", source).group(1)
    assert tuple(int(d) for d in depths.split(",")) == PADDED_DEPTHS
    assert {padded_depth(d) for d in HEAD_DIMS if d not in EXACT_HEAD_DIMS} == set(PADDED_DEPTHS)
    grouped = [d for group in _build.K1_DIM_GROUPS for d in group]
    assert sorted(grouped) == list(EXACT_HEAD_DIMS)
    assert sorted(d for group in _build.K1_PAD_GROUPS for d in group) == list(PADDED_DEPTHS)
    units = _build.units("fused_attention")
    assert units[0] == ("fused_attention.cu", ())
    assert [flags for _, flags in units[1:]] == [
        tuple(f"-DESV_HEAD_DIM_{ab}={d}" for ab, d in zip("AB", group))
        for group in _build.K1_DIM_GROUPS] + [
        tuple(f"-DESV_PAD_DEPTH_{ab}={d}" for ab, d in zip("AB", group))
        for group in _build.K1_PAD_GROUPS]
    assert all(1 <= len(group) <= 2 for group in _build.K1_DIM_GROUPS + _build.K1_PAD_GROUPS)
    assert _build.units("hungarian") == (("hungarian.cu", ()),)
    before = _build._library_path("fused_attention")
    monkeypatch.setattr(_build, "K1_DIM_GROUPS", ((8,),) + _build.K1_DIM_GROUPS[1:])
    assert _build._library_path("fused_attention") != before


def test_block_attention_compiles_a_unit_per_head_dim():
    """K2's and K3's attention compiles in a unit of ``fused_block.cu`` per
    head dim (``_build.BLOCK_ATTENTION_DIMS``, ``BLOCK_HEAD_DIMS``), each
    instantiating ``block_attention_at`` for the blocks' three type pairs,
    and the library's ``block_attention`` picks among exactly those; the
    main unit holds the rest."""
    assert _build.BLOCK_ATTENTION_DIMS == BLOCK_HEAD_DIMS
    assert _build.units("fused_block") == (("fused_block.cu", ()),) + tuple(
        ("fused_block.cu", (f"-DESV_BLOCK_HEAD_DIM={d}",)) for d in BLOCK_HEAD_DIMS)
    source = (_build.CSRC_DIR / "fused_block.cu").read_text()
    unit = source.split("#ifdef ESV_BLOCK_HEAD_DIM", 1)[1].split("\n#else\n", 1)[0]
    assert re.findall(r"^ESV_AT\((\w+), (\w+)\)$", unit, re.M) == [
        ("float", "float"), ("float", "bf16"), ("bf16", "bf16")]
    picked = re.search(r"static cudaError_t block_attention\(.*?\n\}", source, re.S).group(0)
    cases = re.findall(r"case (\d+):\s*return block_attention_at<(\d+), T, TO>", picked)
    assert all(a == b for a, b in cases) and tuple(int(a) for a, _ in cases) == BLOCK_HEAD_DIMS


@pytest.mark.parametrize("head_dim", [8, 16, 24, 32, 48, 64, 96])
@pytest.mark.parametrize("length", [8, 208, 243])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_plain_matches_jax_at_head_dim(head_dim, length, masked):
    """B = 2, H = 2, float32, atol 1e-5; the scale is 1/sqrt(head dim)."""
    assert head_dim in EXACT_HEAD_DIMS
    rng = np.random.RandomState(head_dim + length)
    q, k, v = (rng.randn(2, length, 2, head_dim).astype(np.float32) for _ in range(3))
    mask = _key_mask(2, length, head_dim)[:, None, None, :] if masked else None
    jargs = [jnp.asarray(a) for a in (q, k, v)] + [None if mask is None else jnp.asarray(mask)]
    targs = [torch.from_numpy(a) for a in (q, k, v)] + [
        None if mask is None else torch.from_numpy(mask)]
    out = fused_attention(*targs).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_fused_attention(*jargs, interpret=True)),
                               atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jax_dot_product_attention(*jargs)), atol=1e-5)


@pytest.fixture
def spies(monkeypatch):
    """The (B, L, H, D) of each call of K1 and the (B, L, d) of each call of
    K2 from ``models/layers.py``, each passed on to the wrapper."""
    calls = {"block": [], "attention": []}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append(tuple(args[0].shape))
            return fn(*args, **kwargs)

        return wrapped

    monkeypatch.setattr(layers, "fused_encoder_block", spy("block", layers.fused_encoder_block))
    monkeypatch.setattr(layers, "fused_attention", spy("attention", layers.fused_attention))
    return calls


def _numpy_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("d_model", [32, 64, 96, 128, 192, 384])
def test_protocol_executor_matches_jax_through_k1(spies, d_model):
    """The protocol's executor (2 fusion layers, 1 box-decoder layer, 8
    queries, 4 image tokens of 8 features), float32 eval forward: the
    routing, token and box-confidence argmaxes equal JAX's, every output
    within 1e-4 (``tests/test_torch_layers.py``'s executor tolerance); K1
    once per fusion layer (L = CLS + 4 image + 8 box + 3 text) and once per
    box-decoder layer (the 8 queries), K2 never."""
    narrow = dict(num_image_tokens=4, image_feature_dim=8)
    jcfg = dataclasses.replace(jax_protocol.make_protocol_executor_config(
        VOCABS, d_model=d_model, encoder_layers=2, box_roi=True), **narrow)
    cfg = dataclasses.replace(synthetic_protocol.make_protocol_executor_config(
        VOCABS, d_model=d_model, encoder_layers=2, box_roi=True), **narrow)
    rng = np.random.RandomState(d_model)
    b, s = 3, cfg.max_input_boxes
    corner = rng.uniform(0, 0.5, (b, s, 2)).astype(np.float32)
    inputs = (rng.randn(b, 4, 8).astype(np.float32),
              np.concatenate([corner, corner + 0.4], -1).astype(np.float32),
              rng.rand(b, s) < 0.6, rng.randint(1, 6, (b, 3)).astype(np.int32),
              np.ones((b, 3), bool))
    jmodel = JaxExecutor(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(d_model), *map(jnp.asarray, inputs))
    ref = jmodel.apply(variables, *map(jnp.asarray, inputs))
    model = ProgramExecutor(cfg, device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(_numpy_params(variables)))
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in inputs))
    for key in ("routing_logits", "token_logits", "pred_boxes", "pred_conf"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4,
                                   err_msg=key)
    for key in ("routing_logits", "token_logits", "pred_conf"):
        np.testing.assert_array_equal(out[key].numpy().argmax(-1),
                                      np.asarray(ref[key]).argmax(-1), err_msg=key)
    head_dim = d_model // cfg.num_heads
    assert spies["block"] == []
    assert spies["attention"] == ([(b, 16, 4, head_dim)] * cfg.encoder_layers
                                  + [(b, cfg.num_queries, 4, head_dim)] * cfg.box_decoder_layers)


@pytest.mark.parametrize("d_model", [32, 64, 128, 384])
def test_protocol_executor_no_k1_where_autograd_records(spies, d_model):
    """The protocol's executor at the new head dims (8, 16, 32, 96): a
    training forward and an eval forward that records a graph call neither
    kernel (K1 has no backward); the same eval forward under no_grad calls
    K1 once per fusion and box-decoder layer."""
    cfg = dataclasses.replace(synthetic_protocol.make_protocol_executor_config(
        VOCABS, d_model=d_model, encoder_layers=2, box_roi=True),
        num_image_tokens=4, image_feature_dim=8)
    model = init_parameters(ProgramExecutor(cfg, device="cpu"), d_model)
    rng = np.random.RandomState(d_model + 1)
    b, s = 2, cfg.max_input_boxes
    corner = rng.uniform(0, 0.5, (b, s, 2)).astype(np.float32)
    inputs = [torch.from_numpy(a) for a in (
        rng.randn(b, 4, 8).astype(np.float32),
        np.concatenate([corner, corner + 0.4], -1).astype(np.float32),
        rng.rand(b, s) < 0.6, rng.randint(1, 6, (b, 3)), np.ones((b, 3), bool))]
    model.train()
    model(*inputs)["token_logits"].sum().backward()
    model.eval()
    model(*inputs)["token_logits"].sum().backward()
    assert spies == {"block": [], "attention": []}, d_model
    with torch.no_grad():
        model(*inputs)
    head_dim = d_model // cfg.num_heads
    assert spies["block"] == []
    assert spies["attention"] == ([(b, 16, 4, head_dim)] * cfg.encoder_layers
                                  + [(b, cfg.num_queries, 4, head_dim)] * cfg.box_decoder_layers)


def _iqap(embed_dim: int = 256):
    cfg = IQAPConfig(vocab_size=20, program_vocab_size=12, num_answer_classes=6,
                     num_image_tokens=4, image_feature_dim=8, program_len=5,
                     max_question_len=7, embed_dim=embed_dim)
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(2, 4, 8).astype(np.float32))
    questions = torch.from_numpy(rng.randint(1, 20, (2, 7)))
    return init_parameters(TransformerIQAP(cfg, device="cpu"), 3), images, questions


def test_iqap_encoder_routes_to_k1(spies):
    """The Transformer IQAP at hidden 256 (4 heads, head dim 64): its encoder
    over [CLS | 4 image | 7 question] calls K1 once a layer; its greedy
    decode over KV caches and its teacher-forced decode under the causal
    mask do not, and neither do its cross-attentions."""
    model, images, questions = _iqap()
    cfg = model.config
    assert cfg.embed_dim // cfg.num_heads == 64
    with torch.no_grad(), eval_mode(model):
        out = model(images, questions)
        generate_programs(model, out["memory"])
        model.decode_programs_tf(questions[:, :cfg.program_len] % cfg.program_vocab_size,
                                 out["memory"])
    assert spies["block"] == []
    assert spies["attention"] == [(2, 1 + 4 + 7, 4, 64)] * cfg.encoder_layers


def test_step_seq2seq_encoder_routes_to_k1(spies):
    """The step seq2seq at d 256 (4 heads, head dim 64): its encoder over [4
    image | 6 source] tokens with the source padding mask calls K1 once a
    layer; the teacher-forced decode (causal mask, cross-attention) and the
    greedy decode over KV caches do not."""
    cfg = StepSeq2SeqConfig(vocab_size=20, num_image_tokens=4, image_feature_dim=8,
                            max_src_len=6, max_tgt_len=5)
    model = init_parameters(StepExecutorSeq2Seq(cfg, device="cpu"), 4)
    rng = np.random.RandomState(2)
    images = torch.from_numpy(rng.randn(2, 4, 8).astype(np.float32))
    src = torch.from_numpy(np.array([[3, 4, 5, 0, 0, 0], [6, 7, 8, 9, 10, 0]]))
    tgt = torch.from_numpy(rng.randint(1, 20, (2, 5)))
    with torch.no_grad(), eval_mode(model):
        logits = model(images, src, tgt, src != 0)
        memory, key_mask = model.encode(images, src, src != 0)
        greedy_decode(model, memory, key_mask, 1, cfg.max_tgt_len)
    assert torch.isfinite(logits).all()
    assert spies["block"] == []
    assert spies["attention"] == [(2, 4 + 6, 4, 64)] * (2 * cfg.encoder_layers)


def test_hierarchical_generator_routes_to_k1(spies):
    """``HierarchicalGenerator`` at its preset's width (d 256, 4 heads, 2+2
    layers): K1 once per encoder layer, and once per decoder layer for the
    self-attention on the one-token start query (a (1, 1, 1, 1) causal mask,
    which JAX's rule takes); the decoder's pass over the start and the boxes
    under its causal mask does not."""
    model = init_parameters(HierarchicalGenerator(num_image_tokens=4, image_feature_dim=8,
                                                  max_inner_steps=5, device="cpu"), 5)
    image = torch.from_numpy(np.random.RandomState(3).randn(2, 4, 8).astype(np.float32))
    with torch.no_grad(), eval_mode(model):
        model(image)
    assert spies["block"] == []
    assert spies["attention"] == [(2, 4, 4, 64)] * 2 + [(2, 1, 4, 64)] * 2


def test_no_k1_where_autograd_records(spies):
    """A training forward, and an eval forward that records a graph (the
    kernels have no backward: the plain path, which has one, takes it), call
    neither kernel; the same eval forward under no_grad calls K1 at hidden
    256 (head dim 64) and K2 at hidden 512 (head dim 128)."""
    for embed_dim in (256, 512):
        model, images, questions = _iqap(embed_dim)
        model.train()
        model(images, questions)["answer_logits"].sum().backward()
        model.eval()
        model(images, questions)["answer_logits"].sum().backward()
        assert spies == {"block": [], "attention": []}, embed_dim
    model, images, questions = _iqap(256)
    with torch.no_grad(), eval_mode(model):
        model(images, questions)
    assert spies == {"block": [], "attention": [(2, 1 + 4 + 7, 4, 64)] * model.config.encoder_layers}
    spies["attention"].clear()
    model, images, questions = _iqap(512)
    with torch.no_grad(), eval_mode(model):
        model(images, questions)
    assert spies == {"block": [(2, 1 + 4 + 7, 512)] * model.config.encoder_layers, "attention": []}
