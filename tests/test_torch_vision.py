"""The port's feature extractor (``vision/resnet.py``, ``vision/extract.py``)
against the JAX package's on the CPU, on seeded numpy inputs:

- a ``Bottleneck`` and ``ResNetFeatures`` with ``stage_sizes=(1, 1, 1)``,
  JAX's initial weights carried over by ``resnet_state_from_jax``: within
  atol 2e-5 (tests/test_vision.py's block tolerance); the same net in bf16
  within 2 bf16 ulps of the largest output;
- the full-depth (3, 4, 23) net at 64x64 on 2 images, the port's weights
  carried to JAX by the JAX package's own ``params_from_torch_state_dict``:
  within 1e-4 * max(|ref|, 1), JAX's rule for the whole network;
- ``load_torchvision_state_dict`` on a full torchvision-layout dict
  (``layer4.*``, ``fc.*``, ``num_batches_tracked`` ignored) and raising on a
  missing key or a wrong shape;
- ``cubic_resize`` against ``jax.image.resize(method="cubic")`` downsampling,
  upsampling and mixed, within atol 1e-3 on 0-255 values, and its weights
  against JAX's jitted ``compute_weight_mat`` within a few float32 ulps;
- ``make_extract_fn`` against JAX's on uint8 images, resized and not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.vision import extract as jextract
from explainable_spatial_vqa_tpu.vision import resnet as jresnet
from explainable_spatial_vqa_tpu_torch.convert import resnet_state_from_jax
from explainable_spatial_vqa_tpu_torch.vision import extract as textract
from explainable_spatial_vqa_tpu_torch.vision import resnet as tresnet

torch.set_num_threads(1)

SMALL = (1, 1, 1)


def _randomized(variables, seed):
    """JAX's initial variables with the batch-norm statistics and affine
    drawn near their identity, so each one matters."""
    rng = np.random.RandomState(seed)

    def visit(node):
        out = {}
        for name, child in node.items():
            if isinstance(child, dict) or hasattr(child, "items"):
                out[name] = visit(child)
            elif name == "kernel":
                out[name] = np.asarray(child)
            else:
                shape = np.shape(child)
                out[name] = {"scale": rng.normal(1.0, 0.05, shape),
                             "bias": rng.normal(0.0, 0.05, shape),
                             "mean": rng.normal(0.0, 0.05, shape),
                             "var": rng.uniform(0.8, 1.2, shape)}[name].astype(np.float32)
        return out

    return {"params": visit(variables["params"])}


@pytest.fixture(scope="module")
def small_pair():
    """JAX's ``ResNetFeatures(stage_sizes=(1, 1, 1))`` with randomized
    statistics, and the port's with the same weights."""
    model = jresnet.ResNetFeatures(stage_sizes=SMALL)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 0)
    port = tresnet.ResNetFeatures(stage_sizes=SMALL, device="cpu")
    tresnet.load_torchvision_state_dict(port, resnet_state_from_jax(variables))
    return model, variables, port


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def test_bottleneck_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(2, 16, 16, 64).astype(np.float32)
    block = jresnet.Bottleneck(mid=32, out=128, stride=2, downsample=True)
    variables = _randomized(block.init(jax.random.PRNGKey(1), jnp.asarray(x)), 1)
    ref = _nchw(block.apply(variables, jnp.asarray(x)))
    port = tresnet.Bottleneck(64, 32, 128, stride=2, downsample=True, device="cpu")
    port.load_state_dict(resnet_state_from_jax(variables), strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(_nchw(x).copy())).numpy()
    assert out.shape == ref.shape == (2, 128, 8, 8)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_resnet_small_matches_jax(small_pair):
    model, variables, port = small_pair
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    ref = _nchw(jax.jit(model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = port(torch.from_numpy(_nchw(x).copy())).numpy()
    assert out.shape == ref.shape == (2, 1024, 4, 4)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_resnet_small_bf16_matches_jax(small_pair):
    """Both compute in bf16 from float32 weights (the BN fold rounded to
    bf16 the same way); their convolutions sum in other orders and round
    each output to bf16, so they agree to a few bf16 ulps of the scale."""
    _, variables, _ = small_pair
    model = jresnet.ResNetFeatures(stage_sizes=SMALL, dtype=jnp.bfloat16)
    port = tresnet.ResNetFeatures(stage_sizes=SMALL, dtype=torch.bfloat16, device="cpu")
    tresnet.load_torchvision_state_dict(port, resnet_state_from_jax(variables))
    x = np.random.RandomState(3).rand(2, 64, 64, 3).astype(np.float32)
    ref = _nchw(jax.jit(model.apply)(variables, jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        out = port(torch.from_numpy(_nchw(x).copy()))
    assert out.dtype == torch.bfloat16
    scale = np.abs(ref).max()
    assert np.abs(out.float().numpy() - ref).max() <= 2 * 2.0 ** -7 * scale


def scaled_random_state(num_stages: int, seed: int):
    """A torchvision-layout state dict of seeded random weights scaled as
    tests/test_vision.py scales them (convolutions x 0.5, batch-norm
    statistics and affine near the identity), so that activations stay tame
    over 30 blocks and a float32 comparison means something."""
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters

    port = init_parameters(tresnet.ResNetFeatures(num_stages=num_stages, device="cpu"), seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.mul_(0.5)
            elif isinstance(m, tresnet.FrozenBatchNorm):
                n = m.weight.shape
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.05)
                m.running_var.copy_(0.8 + 0.4 * torch.rand(n, generator=gen))
                m.weight.copy_(1.0 + 0.05 * torch.randn(n, generator=gen))
                m.bias.copy_(0.05 * torch.randn(n, generator=gen))
    return port.state_dict()


def test_resnet101_full_depth_matches_jax():
    port = tresnet.ResNetFeatures(device="cpu")
    port.load_state_dict(scaled_random_state(3, seed=4))
    variables = jresnet.params_from_torch_state_dict(port.state_dict())
    x = np.random.RandomState(4).rand(2, 64, 64, 3).astype(np.float32)
    ref = _nchw(jax.jit(jresnet.ResNetFeatures().apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        out = port(torch.from_numpy(_nchw(x).copy())).numpy()
    assert out.shape == ref.shape == (2, 1024, 4, 4)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-4 * max(scale, 1.0), (np.abs(out - ref).max(), scale)


def test_loader_takes_torchvision_layout_and_raises_on_missing():
    source = tresnet.ResNetFeatures(device="cpu")
    state = {k: v.clone() + 0.25 for k, v in source.state_dict().items()}
    torchvision_extra = {
        "layer4.0.conv1.weight": torch.zeros(512, 1024, 1, 1),
        "layer4.2.bn3.running_var": torch.ones(2048),
        "fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000),
        "bn1.num_batches_tracked": torch.tensor(0),
        "layer3.22.bn2.num_batches_tracked": torch.tensor(0),
    }
    full = {**state, **torchvision_extra}
    port = tresnet.ResNetFeatures(device="cpu")
    tresnet.load_torchvision_state_dict(port, {k: v.numpy() for k, v in full.items()})
    loaded = port.state_dict()
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    # a shorter truncation ignores the later stages
    stage1 = tresnet.ResNetFeatures(num_stages=1, device="cpu")
    tresnet.load_torchvision_state_dict(stage1, full)
    assert torch.equal(stage1.state_dict()["layer1.2.conv3.weight"],
                       state["layer1.2.conv3.weight"])
    for drop in ("layer3.22.conv2.weight", "layer2.0.downsample.1.running_var", "bn1.bias"):
        with pytest.raises(KeyError, match="lacks 1 keys"):
            tresnet.load_torchvision_state_dict(
                tresnet.ResNetFeatures(device="cpu"), {k: v for k, v in full.items() if k != drop})
    with pytest.raises(RuntimeError, match="size mismatch"):
        tresnet.load_torchvision_state_dict(tresnet.ResNetFeatures(device="cpu"),
                                            {**full, "conv1.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        tresnet.load_torchvision_state_dict(
            tresnet.ResNetFeatures(device="cpu"), {**full, "layer1.0.conv4.weight": torch.zeros(1)})


@pytest.mark.parametrize("shape,size", [
    ((2, 320, 480, 3), (224, 224)),  # CLEVR's images to the extractor's input
    ((2, 20, 30, 3), (32, 32)),  # upsampling both axes
    ((2, 20, 300, 3), (32, 224)),  # up in H, down in W
    ((1, 224, 300, 3), (224, 224)),  # W alone changes
])
def test_cubic_resize_matches_jax(shape, size):
    x = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, 3), method="cubic"))
    out = textract.cubic_resize(torch.from_numpy(x), size).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3)
    assert not np.allclose(out, torch.nn.functional.interpolate(  # not PyTorch's bicubic
        torch.from_numpy(x).permute(0, 3, 1, 2), size=size, mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy(), atol=1.0)


@pytest.mark.parametrize("n_in,n_out", [(320, 224), (480, 224), (300, 224), (20, 32), (7, 5)])
def test_resize_weights_match_jax(n_in, n_out):
    """The weights as the jitted resize computes them (``_resize`` calls
    ``compute_weight_mat`` with Python-float scales), within 6 float32 ulps
    of 1 (the weights lie in (-0.1, 0.72)): at CLEVR's sizes they agree to
    one ulp, and at 7 -> 5 XLA contracts the weights of the normalizing sum
    otherwise than the weights themselves, 5 ulps apart."""
    from jax._src.image.scale import _fill_keys_cubic_kernel, compute_weight_mat

    ref = np.asarray(jax.jit(lambda: compute_weight_mat(
        n_in, n_out, n_out / n_in, 0.0, _fill_keys_cubic_kernel, True))())
    ours = textract._weight_mat(n_in, n_out)
    assert ours.dtype == np.float32 and ours.shape == (n_in, n_out)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=6 * 2.0 ** -24)


@pytest.mark.parametrize("image", [(40, 60), (32, 32)])
def test_make_extract_fn_matches_jax(small_pair, image):
    model, variables, port = small_pair
    images = np.random.RandomState(5).randint(0, 256, (2, *image, 3)).astype(np.uint8)
    ref = np.asarray(jextract.make_extract_fn(model, variables, (32, 32))(jnp.asarray(images)))
    out = textract.make_extract_fn(port, (32, 32))(torch.from_numpy(images))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (2, 1024, 2, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tresnet.ResNetFeatures()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        textract.extract_features([], "unused.h5")
