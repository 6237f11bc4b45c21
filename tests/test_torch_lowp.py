"""The port's bf16-IO serving opt-in (``ops/lowp.py``) against the JAX
package's, at tests/test_lowp.py's configuration (the default executor
widths, bf16, batch 8, the same weights).

Tolerances are tests/test_lowp.py's: logits within ``ATOL`` = 2.5e-2, boxes
and confidences within 1e-2, and every decision equal where the float32-IO
run is decisive (top-2 gap above 2 * ATOL; a confidence farther than 2e-2
from 0.5).  lowp off must be bit-equal to the default."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.core.config import ExecutorConfig as JaxExecutorConfig
from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
from explainable_spatial_vqa_tpu.ops import attention as jattention
from explainable_spatial_vqa_tpu.ops import lowp as jlowp
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.layers import LayerNorm
from explainable_spatial_vqa_tpu_torch.ops import lowp
from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention

torch.set_num_threads(1)

ATOL = 2.5e-2  # tests/test_lowp.py's
KEYS = ("routing_logits", "token_logits", "pred_boxes", "pred_conf")


def _inputs(cfg):
    rng = np.random.RandomState(0)
    b = 8
    return (rng.rand(b, cfg.num_image_tokens, cfg.image_feature_dim).astype(np.float32),
            rng.rand(b, cfg.max_input_boxes, 4).astype(np.float32),
            rng.rand(b, cfg.max_input_boxes) < 0.6,
            rng.randint(1, 32, (b, 3)).astype(np.int32), np.ones((b, 3), bool))


def _margin(logits):
    part = np.sort(logits, axis=-1)
    return part[..., -1] - part[..., -2]


@pytest.fixture(scope="module")
def runs():
    """Both packages' executor outputs with lowp off, on, and each segment
    alone; the port's also off again after a toggle."""
    cfg_kw = dict(vocab_size=32, token_classes=16)
    jcfg = JaxExecutorConfig(**cfg_kw)
    args = _inputs(jcfg)
    jmodel = JaxExecutor(jcfg, dtype=jnp.bfloat16)
    variables = jmodel.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))
    model = ProgramExecutor(ExecutorConfig(**cfg_kw), torch.bfloat16, device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    targs = [torch.from_numpy(a) for a in args]

    def port():
        with torch.no_grad():
            return {k: v.float().numpy() for k, v in model(*targs).items()}

    def jax_run():
        jax.clear_caches()
        out = jmodel.apply(variables, *(jnp.asarray(a) for a in args))
        return {k: np.asarray(v, np.float32) for k, v in out.items()}

    settings = {"off": (False, False), "on": (True, True), "norms": (True, False),
                "softmax": (False, True)}
    out = {}
    try:
        for name, (norms, softmax) in settings.items():
            for mod in (lowp, jlowp):
                mod.use_lowp_norms(norms)
                mod.use_lowp_softmax(softmax)
            out[name] = port()
            out["jax_" + name] = jax_run()
        lowp.use_lowp_serving(True)
        lowp.use_lowp_serving(False)
        out["off_again"] = port()
    finally:
        lowp.use_lowp_serving(False)
        jlowp.use_lowp_serving(False)
        jax.clear_caches()
    return out


def _decisions_equal(low, base):
    decisive = _margin(base["routing_logits"]) > 2 * ATOL
    assert decisive.any()
    np.testing.assert_array_equal(np.argmax(low["routing_logits"], -1)[decisive],
                                  np.argmax(base["routing_logits"], -1)[decisive])
    decisive = _margin(base["token_logits"]) > 2 * ATOL
    np.testing.assert_array_equal(np.argmax(low["token_logits"], -1)[decisive],
                                  np.argmax(base["token_logits"], -1)[decisive])
    decisive = np.abs(base["pred_conf"] - 0.5) > 2e-2
    np.testing.assert_array_equal((low["pred_conf"] >= 0.5)[decisive],
                                  (base["pred_conf"] >= 0.5)[decisive])


def _close(low, base):
    for key in ("routing_logits", "token_logits"):
        np.testing.assert_allclose(low[key], base[key], atol=ATOL, err_msg=key)
    for key in ("pred_boxes", "pred_conf"):
        np.testing.assert_allclose(low[key], base[key], atol=1e-2, err_msg=key)


@pytest.mark.parametrize("reference", ["port_fp32_io", "jax_lowp"])
def test_lowp_serving_within_tolerance(runs, reference):
    """lowp against the port's float32-IO run (tests/test_lowp.py's gate) and
    against JAX's lowp run."""
    base = runs["off"] if reference == "port_fp32_io" else runs["jax_on"]
    _close(runs["on"], base)
    _decisions_equal(runs["on"], base)


@pytest.mark.parametrize("segment", ["norms", "softmax"])
def test_lowp_segments_individually_small(runs, segment):
    np.testing.assert_allclose(runs[segment]["token_logits"], runs["off"]["token_logits"],
                               atol=ATOL)
    np.testing.assert_allclose(runs[segment]["token_logits"],
                               runs["jax_" + segment]["token_logits"], atol=ATOL)


def test_lowp_off_is_bitwise_default(runs):
    for key in KEYS:
        np.testing.assert_array_equal(runs["off_again"][key], runs["off"][key])


def test_norm_dtype_resolution():
    try:
        assert lowp.norm_dtype(torch.bfloat16) == torch.float32
        assert lowp.norm_dtype(torch.float32) == torch.float32
        lowp.use_lowp_norms(True)
        assert lowp.norm_dtype(torch.bfloat16) == torch.bfloat16
        assert lowp.norm_dtype(torch.float32) == torch.float32  # fp32 compute keeps fp32
        assert lowp.lowp_norms_enabled() and not lowp.lowp_softmax_enabled()
    finally:
        lowp.use_lowp_serving(False)


def test_bf16_layernorm_rounds_float32_once():
    """The bf16-output LayerNorm computes flax's _normalize in float32 (its
    statistics and affine) and rounds once: equal to the float32 output
    rounded to bf16 up to the statistics' float32 order (one bf16 ulp)."""
    torch.manual_seed(0)
    norm = LayerNorm(64, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(64))
        norm.bias.copy_(0.1 * torch.randn(64))
    x = (3 * torch.randn(16, 64)).bfloat16()
    low = norm(x, torch.bfloat16)
    assert low.dtype == torch.bfloat16 and norm(x).dtype == torch.float32
    ref = norm(x).bfloat16().float()
    ulp = torch.finfo(torch.bfloat16).eps * ref.abs().clamp(min=1e-3)
    assert bool(((low.float() - ref).abs() <= ulp).all())
    assert norm.weight.dtype == torch.float32


def test_softmax_segment_rounds_the_plain_scores_only():
    """lowp's softmax changes the plain attention on bf16 inputs as JAX's does
    (its scores rounded to bf16) and leaves K1 (its plain version on the
    CPU) and float32 inputs alone."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 10, 4, 128).astype(np.float32) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    base = dot_product_attention(tq, tk, tv)
    f32 = dot_product_attention(*(t.float() for t in (tq, tk, tv)))
    try:
        lowp.use_lowp_softmax(True)
        jlowp.use_lowp_softmax(True)
        jax.clear_caches()
        low = dot_product_attention(tq, tk, tv)
        want = np.asarray(jattention.dot_product_attention(jq, jk, jv), np.float32)
        assert torch.equal(fused_attention(tq, tk, tv), base)
        assert torch.equal(dot_product_attention(*(t.float() for t in (tq, tk, tv))), f32)
    finally:
        lowp.use_lowp_serving(False)
        jlowp.use_lowp_serving(False)
        jax.clear_caches()
    assert not torch.equal(low, base)
    np.testing.assert_allclose(low.float().numpy(), want, atol=2e-2)
