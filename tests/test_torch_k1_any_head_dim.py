"""K1 at every head dim up to 256 and rows past 1024 keys, on the CPU against
the JAX package.

JAX's dispatch sends self-attention to its kernel at any head dim and any
length (``explainable_spatial_vqa_tpu/ops/attention.py:51-59``).  The port's
K1 takes every head dim from 1 to 256: the multiples of 8 up to 128 on
kernels of their own, every other one on the padded kernels
(``csrc/attention_padded.cuh``) with the head dim a run-time argument inside
the instantiation of its padded depth; and rows of 1 to ``MAX_LEN`` keys, the
cap stated once in ``csrc/attention.cuh`` (``kAttnMaxLen``).  Here, on the
same numpy inputs:

- K1's plain version (the wrapper's path for a CPU tensor) against JAX's
  Pallas kernel in interpret mode at head dims 1, 4, 12, 25, 36, 100, 127,
  136, 192 and 256 and lengths 8 (the box decoders), 208 (the protocol's
  fusion encoder) and 1100 (past the old 1024-key cap), masked and not: in
  float32 within 1e-5 of JAX's kernel and of its XLA attention, the
  tolerance of ``test_k1_plain_matches_jax_at_head_dim``; in bf16 both
  within ``chip_smoke.attention_agreement`` of the float64 reference (the
  check ``chip_smoke.py`` phase 3 holds the kernels to on the card), as
  ``tests/test_torch_k1_long_rows.py`` holds JAX's bf16 kernel;
- routing and the wrapper agree on length: at 1025 keys (which the old cap,
  1024, refused in ``check_attention`` while ``MultiHeadAttention`` routed
  it there, so a model raised on the card where JAX runs) and at ``MAX_LEN``
  both take the call, one key more both refuse it; ``MAX_LEN`` is the C
  source's ``kAttnMaxLen``;
- the CoGenT protocol's executor at d_model 100 (4 heads, head dim 25) and
  512 with 2 heads (head dim 256), JAX's Flax weights carried over by
  ``convert.flax_to_state_dict``: a float32 eval forward's outputs within
  1e-4 of JAX's and its decisions (argmaxes) equal; the routing spy shows K1
  on every self-attention JAX's rule sends to its kernel, and K2 on every
  fusion layer where JAX's block rule holds (d_model and the head dim
  multiples of 128).
"""

import dataclasses
import os
import re
import sys

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
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.layers import MultiHeadAttention
from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    EXACT_HEAD_DIMS,
    MAX_LEN,
    check_attention,
    fused_attention,
    head_dim_built,
    padded_depth,
    shape_built,
)
from explainable_spatial_vqa_tpu_torch.ops.fused_block import block_head_dim_built
from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its bf16 attention check; the script imports nothing at the top)

torch.set_num_threads(1)

VOCABS = {"function": {f"f{i}": i for i in range(6)}, "other": {f"o{i}": i for i in range(5)}}
# the head dims no multiple-of-8 kernel takes below 128, and past it
HEAD_DIMS_NEW = (1, 4, 12, 25, 36, 100, 127, 136, 192, 256)


def _key_mask(batch, length, seed):
    """Ragged key-padding mask: row b keeps its first length - r_b keys."""
    rng = np.random.RandomState(seed)
    keep = np.ones((batch, length), bool)
    for b in range(batch):
        keep[b, length - rng.randint(1, length // 2 + 1):] = False
    return keep


def test_padded_depths_cover_the_new_head_dims():
    """Every head dim above takes the padded kernels, at a depth that holds
    it within 16 columns, or past 128 two halves each within 16 of half of
    it."""
    for d in HEAD_DIMS_NEW:
        assert d not in EXACT_HEAD_DIMS, d
        depth = padded_depth(d)
        assert depth % 16 == 0 and depth <= 256, d
        if d <= 128:
            assert depth - 16 < d <= depth, d
        else:
            assert depth % 32 == 0 and depth // 2 - 16 < (d + 1) // 2 <= depth // 2, d


@pytest.mark.parametrize("head_dim", HEAD_DIMS_NEW)
@pytest.mark.parametrize("length", [8, 208, 1100])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k1_plain_matches_jax_at_any_head_dim(head_dim, length, masked, dtype):
    """B = 2, H = 2; the scale is 1/sqrt(head dim).  float32: atol 1e-5
    against JAX's kernel (interpret mode) and its XLA attention.  bf16: the
    port's plain version and JAX's kernel each within
    ``chip_smoke.attention_agreement`` (no element outside its limit, a mean
    error within ``MEAN_ULPS``)."""
    assert head_dim_built(2 * head_dim, 2)
    rng = np.random.RandomState(head_dim * 7 + length)
    q, k, v = (rng.randn(2, length, 2, head_dim).astype(np.float32) for _ in range(3))
    mask = _key_mask(2, length, head_dim)[:, None, None, :] if masked else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [
        None if mask is None else jnp.asarray(mask)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [
        None if mask is None else torch.from_numpy(mask)]
    out = fused_attention(*targs)
    ref_kernel = jax_fused_attention(*jargs, interpret=True)
    if dtype == "fp32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_kernel), atol=1e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_dot_product_attention(*jargs)),
                                   atol=1e-5)
        return
    jax_out = torch.from_numpy(np.array(ref_kernel.astype(jnp.float32))).bfloat16()
    for name, got in (("port", out), ("jax", jax_out)):
        stats = chip_smoke.attention_agreement(torch, got, *targs)
        assert chip_smoke.bf16_ok(stats), (name, stats)


def test_max_len_is_the_kernels_own():
    """``MAX_LEN`` is the C source's ``kAttnMaxLen``, the one statement of the
    cap that the launchers, the wrappers and the routers read."""
    source = (_build.CSRC_DIR / "attention.cuh").read_text()
    assert int(re.search(r"constexpr int kAttnMaxLen = (\d+);", source).group(1)) == MAX_LEN
    assert MAX_LEN >= 4096


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


@pytest.mark.parametrize("length", [1025, MAX_LEN, MAX_LEN + 1])
def test_routing_and_wrapper_agree_on_length(spies, length):
    """``MultiHeadAttention``'s self-attention in eval mode under no_grad
    (d_model 8, 2 heads of 4) routes to K1 exactly where the wrapper's
    contract takes the (B, L, H, D) call: 1025 and MAX_LEN keys both, one key
    more neither (the plain path runs it, as it does any call K1 does not
    take)."""
    attn = MultiHeadAttention(8, 2, device="cpu").eval()
    x = torch.from_numpy(np.random.RandomState(length).randn(1, length, 8).astype(np.float32))
    with torch.no_grad():
        out = attn(x, x)
    assert out.shape == (1, length, 8) and torch.isfinite(out).all()
    q = torch.zeros(1, length, 2, 4)
    try:
        check_attention(q, q, q)
        takes = True
    except ValueError as err:
        assert "length" in str(err)
        takes = False
    assert takes == shape_built(1, length, 2) == (length <= MAX_LEN)
    assert spies["attention"] == ([(1, length, 2, 4)] if takes else [])
    # the router's old rule looked at the head dim alone: past the wrapper's
    # cap it sent K1 a call the wrapper refuses (a raise on the card)
    old_rule_routes = head_dim_built(8, 2)
    assert old_rule_routes and (old_rule_routes != takes) == (length > MAX_LEN)


def _numpy_params(variables):
    return jax.tree_util.tree_map(np.asarray, variables["params"])


@pytest.mark.parametrize("d_model,heads", [(100, 4), (512, 2)])
def test_protocol_executor_matches_jax_at_new_head_dims(spies, d_model, heads):
    """The protocol's executor (2 fusion layers, 1 box-decoder layer, 8
    queries, 4 image tokens of 8 features) at head dim 25 (d_model 100) and
    256 (512 / 2), float32 eval forward: every output within 1e-4 of JAX's
    (``tests/test_torch_layers.py``'s executor tolerance), the routing, token
    and box-confidence argmaxes equal.  K2 runs every fusion layer where
    JAX's block rule holds (d_model and head dim multiples of 128: 512 / 2),
    K1 the self-attention of every other fusion layer (L = CLS + 4 image + 8
    box + 3 text) and of the box decoder's 8 queries."""
    narrow = dict(num_image_tokens=4, image_feature_dim=8, num_heads=heads)
    jcfg = dataclasses.replace(jax_protocol.make_protocol_executor_config(
        VOCABS, d_model=d_model, encoder_layers=2, box_roi=True), **narrow)
    cfg = dataclasses.replace(synthetic_protocol.make_protocol_executor_config(
        VOCABS, d_model=d_model, encoder_layers=2, box_roi=True), **narrow)
    rng = np.random.RandomState(d_model + heads)
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
    head_dim = d_model // heads
    jax_block_rule = d_model % 128 == 0 and head_dim % 128 == 0
    assert block_head_dim_built(d_model, heads) == jax_block_rule
    fusion = (1 + 4 + 8 + 3)
    assert spies["block"] == ([(b, fusion, d_model)] * cfg.encoder_layers if jax_block_rule
                              else [])
    assert spies["attention"] == (
        ([] if jax_block_rule else [(b, fusion, heads, head_dim)] * cfg.encoder_layers)
        + [(b, cfg.num_queries, heads, head_dim)] * cfg.box_decoder_layers)
