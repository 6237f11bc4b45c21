"""K1's and K2's float32 attention past padded depth 128 but 256
(``attention_kernel_wide_f32``, ``csrc/attention_f32_wide.cuh``) on the CPU.

The kernel runs on the card only.  Here:

* its shared memory at every depth the C sources instantiate it at (Q's raw
  rows, the ring's stages of two planes, the exchange of partial scores and
  the mbarriers, by ``f32w_smem_at``'s expression and ``f32w_stages``' rule,
  parsed from the source) is held under the H100's 232,448 bytes a block,
  and the bytes and stages the launcher's comment states are held to it;
* its order of arithmetic is emulated in numpy and held against JAX's
  Pallas kernel (``_fused_attention_bhld`` through ``fused_attention``,
  interpret mode) at D = 136, 192, 320, 384 and 512, B = 1, H = 2, L = 17,
  210 and 257 with a ragged key mask, within ``chip_smoke.k1_f32_tol``, the
  tolerance ``chip_smoke.py`` phase 3 holds the kernel to: each operand
  split into TF32 hi and lo parts (``ops.fused_block.split_tf32``, the rule
  of ``split_tf32`` in ``csrc/attention.cuh``; the tensor cores read lo's top
  bits), Q and K zero-padded to the padded depth, each warp of a 16-row
  group summing the scores over its slice of DP / G columns, three products
  per 8-deep slice into a fresh accumulator added in float32, the slices'
  partial sums added in their order; the softmax online over tiles of
  ``kF32WideKeys`` keys, each lane of a row's quad keeping its share of the
  sum (keys 8 n + 2 t + e of each tile, rescaled when the max grows), the
  quad's shares added as its shuffles add them; P V in 3xTF32 per 8-key
  slice.  One TF32 pass instead of three misses the tolerance (the negative
  control).  The same emulation, put in the place of the plain attention
  of K2's plain version (``ops.fused_block.fused_encoder_block`` on a CPU
  tensor), holds K2 against JAX's ``_block_kernel`` (``fused_encoder_block``,
  interpret mode) at head dims 384 and 512 (one head at d_model 384 and
  512) within 2e-5, ``tests/test_torch_head_dims_past_256.py``'s float32
  limit;
* the route: ``chip_smoke``'s mirror (``k1_kernel``,
  ``block_attention_kernel``) names the kernel exactly where
  ``launch_attention_padded`` sends a call (float32, past 16 keys, a padded
  depth past 128 but 256, rows of whole 16-byte chunks: the head dims that
  are multiples of 4), checked against the route and the count parsed from
  the C sources.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.models.layers import EncoderBlock as JaxEncoderBlock
from explainable_spatial_vqa_tpu.ops import pallas_block as jax_block
from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.models.layers import EncoderBlock
from explainable_spatial_vqa_tpu_torch.ops import _build, fused_block
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import PADDED_DEPTHS, padded_depth
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    fuse_encoder_params,
    fused_encoder_block,
    split_tf32,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its tolerance and routing mirrors; it imports nothing at the top)

torch.set_num_threads(1)

F32WIDE = (_build.CSRC_DIR / "attention_f32_wide.cuh").read_text()
WIDE = (_build.CSRC_DIR / "attention_wide.cuh").read_text()
PADDED = (_build.CSRC_DIR / "attention_padded.cuh").read_text()
f32 = np.float32


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))


KEYS = _constant(F32WIDE, "kF32WideKeys")  # the online softmax's tile


def _returned(name: str) -> str:
    """The expression ``name`` returns in attention_f32_wide.cuh, on one line."""
    body = re.search(rf"constexpr \w+ {name}\((?:int S)?\) \{{\s*return (.*?);\n\}}", F32WIDE,
                     re.S).group(1)
    return " ".join(body.split())


def _py(expr: str, **names) -> int:
    """A C++ integer expression of the source (at most one ?: at its top)
    evaluated in Python with the given names."""
    expr = expr.replace("(size_t)", "").replace("/", "//")
    for call, name in (("f32w_group<DP>()", "G"), ("f32w_slice<DP>()", "DG"),
                       ("f32w_rows<DP>()", "R"), ("f32w_plane<DP>()", "PLANE"),
                       ("f32w_warps<DP>()", "W")):
        expr = expr.replace(call, name)
    if "?" in expr:
        cond, rest = expr.split("?")
        a, b = rest.split(":")
        expr = f"({a}) if ({cond}) else ({b})"
    return int(eval(expr, {}, names))


def _layout(depth: int):
    """{G, DG, R, PLANE, S, bytes} at ``depth``, each by the source's own
    expression; the stages by ``f32w_stages``' rule (kF32WideMaxStages where
    they fit, else as many as fit)."""
    assert re.search(r"int s = kF32WideMaxStages;\s*while \(s > 2 && f32w_smem_at<DP>\(s\) > "
                     r"kPaddedSmemMax\) --s;", F32WIDE)
    names = dict(DP=depth, kF32WideKeys=KEYS)
    names["G"] = _py(_returned("f32w_group"), **names)
    names["W"] = _py(_returned("f32w_warps"), **names)
    names["DG"] = _py(_returned("f32w_slice"), **names)
    names["R"] = _py(_returned("f32w_rows"), **names)
    names["PLANE"] = _py(_returned("f32w_plane"), **names)
    limit = _constant(WIDE, "kPaddedSmemMax")

    def smem(s):
        return _py(_returned("f32w_smem_at"), S=s, **names)

    s = _constant(F32WIDE, "kF32WideMaxStages")
    while s > 2 and smem(s) > limit:
        s -= 1
    names.update(S=s, bytes=smem(s), producers=_py(_returned("f32w_producers"), **names))
    return names


def _depths():
    """Every depth the sources instantiate the kernel at: the padded depths
    of K1's units (``ESV_K1_PAD_DEPTHS``) past 128 but 256, where
    ``launch_attention_padded``'s route compiles it, and the block library's
    384 and 512 (``launch_block_attention``)."""
    src = (_build.CSRC_DIR / "fused_attention.cu").read_text()
    padded = [int(d) for d in re.search(r"#define ESV_K1_PAD_DEPTHS ([\d, ]+)", src).group(1)
              .split(",")]
    assert padded == list(PADDED_DEPTHS)
    assert "if constexpr (DP > 128 && DP != 256 && std::is_same<T, float>::value) {" in PADDED
    return sorted({d for d in padded if d > 128 and d != 256} | {384, 512})


def test_f32_wide_shared_memory_fits_every_depth():
    """Each depth's shared memory under 232,448 bytes, more stages than a
    tile's K pieces and the copies in flight; 112 query rows a block at two
    warps a group, 48 at three and four, 16 warps in all but 12 at three
    warps a group; the bytes and stages the launcher's comment states."""
    limit = _constant(WIDE, "kPaddedSmemMax")
    assert limit == 232448
    depths = _depths()
    assert depths == [160, 192, 224, 288, 336, 384, 448, 512] == list(chip_smoke.WIDE_F32_DEPTHS)
    layouts = {d: _layout(d) for d in depths}
    for d, lay in layouts.items():
        assert lay["bytes"] <= limit, (d, lay)
        assert lay["S"] > lay["G"] + _constant(F32WIDE, "kF32WideAhead"), (d, lay)
        assert lay["DG"] % 16 == 0 and lay["DG"] <= 128 and lay["G"] * lay["DG"] == d
        assert lay["R"] * lay["G"] + lay["producers"] == lay["W"] == (12 if lay["G"] == 3 else 16)
        assert lay["producers"] >= 2
        assert 16 * lay["R"] == {2: 112, 3: 48, 4: 48}[lay["G"]]
    stated = re.search(r"// bytes: (.*?)\n\s*constexpr size_t smem", F32WIDE, re.S).group(1)
    stated = re.sub(r"\s*//\s*", " ", stated)
    found = re.findall(r"([\d,]+) at (\d+) \((\d+)", stated)
    assert sorted(int(d) for _, d, _ in found) == depths
    for text, d, s in found:
        lay = layouts[int(d)]
        assert (lay["bytes"], lay["S"]) == (int(text.replace(",", "")), int(s)), (d, lay)


def _split(x: np.ndarray):
    """x's TF32 split as the kernel reads it: hi (exact in TF32) and lo with
    its low 13 bits dropped, both float64."""
    flat = np.ascontiguousarray(x, dtype=f32).reshape(-1, x.shape[-1])
    hi, lo = (p.numpy() for p in split_tf32(torch.from_numpy(flat)).split(flat.shape[0]))
    lo = (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(f32)
    return hi.astype(np.float64).reshape(x.shape), lo.astype(np.float64).reshape(x.shape)


def _three(a_hi, a_lo, b_hi, b_lo, one_pass: bool):
    """a b^T in 3xTF32 (lo hi + hi lo + hi hi), or one TF32 pass (hi hi)."""
    if one_pass:
        return a_hi @ b_hi.T
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def _emulated_head(q, k, v, keep, one_pass=False):
    """One (batch, head) of attention_kernel_wide_f32 in the kernel's order:
    q, k, v (L, D) float32, keep (L,) bool; the (L, D) output."""
    length, d = q.shape
    depth = padded_depth(d)
    lay = _layout(depth)
    g, dg = lay["G"], lay["DG"]
    pad = ((0, 0), (0, depth - d))
    (qh, ql), (kh, kl) = _split(np.pad(q, pad)), _split(np.pad(k, pad))
    s = None
    for part in range(g):  # each warp of the group: its slice, a fresh accumulator per 8 deep
        ps = np.zeros((length, length), f32)
        for kk in range(part * dg // 8, (part + 1) * dg // 8):
            sl = slice(8 * kk, 8 * kk + 8)
            ps = (ps + _three(qh[:, sl], ql[:, sl], kh[:, sl], kl[:, sl], one_pass).astype(f32))
        s = ps if s is None else (s + ps).astype(f32)  # the slices in their order
    scale = f32(1.0) / np.sqrt(f32(d))
    s = np.where(keep[None, :], (s * scale).astype(f32), f32(-1e30)).astype(f32)
    tiles = (length + KEYS - 1) // KEYS
    s = np.pad(s, ((0, 0), (0, tiles * KEYS - length)), constant_values=-np.inf)
    vp = np.pad(v, ((0, tiles * KEYS - length), (0, 0)))
    m = np.full(length, -np.inf, f32)
    quad = np.zeros((length, 4), f32)  # lane t's share of each row's sum
    o = np.zeros((length, d), f32)
    for key0 in range(0, tiles * KEYS, KEYS):  # the online softmax, a tile at a time
        st = s[:, key0:key0 + KEYS]
        mn = np.maximum(m, st.max(1))
        alpha = np.exp(m - mn).astype(f32)
        m = mn
        p = np.exp(st - m[:, None]).astype(f32)
        quad = (quad * alpha[:, None]).astype(f32)
        for n in range(KEYS // 8):
            for e in range(2):  # keys 8 n + 2 t + e of lane t
                quad = (quad + p[:, 8 * n + e:8 * n + 8:2]).astype(f32)
        o = (o * alpha[:, None]).astype(f32)
        (ph, pl), (vth, vtl) = _split(p), _split(np.ascontiguousarray(vp[key0:key0 + KEYS].T))
        for n in range(0, KEYS, 8):  # P V, 8 keys at a time, into the running sum
            sl = slice(n, n + 8)
            o = (o + _three(ph[:, sl], pl[:, sl], vth[:, sl], vtl[:, sl], one_pass)).astype(f32)
    total = ((quad[:, 0] + quad[:, 1]).astype(f32) + (quad[:, 2] + quad[:, 3]).astype(f32))
    return (o / (total.astype(f32) + f32(1e-30))[:, None]).astype(f32)


def _emulated(q, k, v, keep, one_pass=False):
    """(B, L, H, D) q, k, v and a (B, L) keep: every head emulated."""
    out = np.zeros_like(q)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            out[b, :, h] = _emulated_head(q[b, :, h], k[b, :, h], v[b, :, h], keep[b], one_pass)
    return out


def _inputs(d: int, length: int):
    """q, k, v (1, L, 2, D) float32 and a ragged key mask (1, L), as
    chip_smoke.py masks: a tail of up to 13 keys, each kept at 0.6."""
    rng = np.random.RandomState(23000 + d + length)
    q, k, v = (rng.randn(1, length, 2, d).astype(f32) for _ in range(3))
    keep = np.ones((1, length), bool)
    tail = min(length, 13)
    keep[:, length - tail:] = rng.rand(1, tail) < 0.6
    keep[:, 0] = True
    return q, k, v, keep


@pytest.mark.parametrize("d", [136, 192, 320, 384, 512])
@pytest.mark.parametrize("length", [17, 210, 257])
def test_emulated_f32_wide_matches_jax(d, length):
    """The kernel's arithmetic, emulated, within k1_f32_tol of JAX's K1 in
    interpret mode; at 210 keys one TF32 pass instead of three misses it."""
    assert padded_depth(d) in chip_smoke.WIDE_F32_DEPTHS
    assert chip_smoke.k1_kernel(d, length, "fp32") == chip_smoke.WIDE_F32
    q, k, v, keep = _inputs(d, length)
    ref = np.asarray(jax_fused_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         jnp.asarray(keep[:, None, None, :]), interpret=True))
    err = float(np.abs(_emulated(q, k, v, keep) - ref).max())
    assert err <= chip_smoke.k1_f32_tol(length), err
    if length == 210:
        control = float(np.abs(_emulated(q, k, v, keep, one_pass=True) - ref).max())
        assert control > chip_smoke.k1_f32_tol(length), control


@pytest.mark.parametrize("d_model", [384, 512])
def test_emulated_f32_wide_in_k2_matches_jax_block(d_model, monkeypatch):
    """K2's plain version with the kernel's emulated attention in place of
    its plain attention, against JAX's ``_block_kernel`` in interpret mode
    at one head of d_model (head dim 384 and 512), B = 2, L = 40 (three
    16-key tiles, the last ragged), a ragged key mask: within 2e-5."""
    assert chip_smoke.block_attention_kernel(d_model, 40, "fp32") == chip_smoke.WIDE_F32
    batch, length = 2, 40
    jblock = JaxEncoderBlock(d_model, 1, d_model * 4, dropout=0.0)
    x = np.random.RandomState(d_model).randn(batch, length, d_model).astype(f32)
    variables = jblock.init(jax.random.PRNGKey(d_model), jnp.asarray(x))
    block = EncoderBlock(d_model, 1, d_model * 4, dropout=0.0, device="cpu")
    block.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    keep = np.ones((batch, length), bool)
    keep[0, length - 7:] = False
    keep[1, length - 3:] = [True, False, True]
    calls = []

    def emulated(q, k, v, mask, bf16_scores=False):
        assert not bf16_scores and q.dtype == torch.float32
        kept = np.ones((q.shape[0], q.shape[1]), bool) if mask is None else \
            mask[:, 0, 0, :].numpy()
        calls.append(tuple(q.shape))
        return torch.from_numpy(_emulated(q.numpy(), k.numpy(), v.numpy(), kept))

    monkeypatch.setattr(fused_block, "scaled_attention", emulated)
    jweights = jax_block.fuse_encoder_params(variables["params"], dtype=jnp.float32)
    ref = jax_block.fused_encoder_block(jnp.asarray(x), jnp.asarray(keep), jweights, 1,
                                        interpret=True)
    out = fused_encoder_block(torch.from_numpy(x), torch.from_numpy(keep),
                              fuse_encoder_params(block.eval(), dtype=torch.float32), 1)
    assert calls == [(batch, length, 1, d_model)]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_route_takes_float32_whole_chunks_past_depth_128():
    """launch_attention_padded sends float32 calls past 16 keys at the
    padded depths past 128 but 256 to launch_attention_wide_f32 where
    wide_takes (whole 16-byte rows: wide_takes' float32 test), after the
    short kernels' route and before the padded ones; that launcher counts
    kAttnKernelWideF32, named attention_kernel_wide_f32; and for every head
    dim 1-512, every length around the splits, K1's mirror names it exactly
    there (the padded and deep float32 kernels keep the head dims that are
    not multiples of 4, the short kernels L <= 16, split_f32 depth 256), K2's
    attention at 384 and 512 the same."""
    body = re.search(r"static cudaError_t launch_attention_padded\(.*?\n\}", PADDED,
                     re.S).group(0)
    route = re.search(r"if constexpr \(DP > 128 && DP != 256 && std::is_same<T, float>::value\) "
                      r"\{\s*if \(wide_takes<T, TO>\(q, k, v, out, L, D, in_bs, in_rs, out_bs, "
                      r"out_rs\)\)\s*return launch_attention_wide_f32<DP, TO>\(", body)
    assert route
    assert body.index("launch_attention_short") < route.start() < body.index("launch_padded_r")
    takes = re.search(r"static bool wide_takes\(.*?\{(.*?)\n\}", WIDE, re.S).group(1)
    assert "return L > 16 && (D * sizeof(T)) % 16 == 0 && aligned16(q)" in takes
    launcher = re.search(r"static cudaError_t launch_attention_wide_f32\(.*?\n\}", F32WIDE,
                         re.S).group(0)
    assert re.findall(r"counted_launch\((\w+)\)", launcher) == ["kAttnKernelWideF32"]
    src = (_build.CSRC_DIR / "attention.cuh").read_text()
    enum = re.search(r"enum AttnKernel \{(.*?)\};", src, re.S).group(1)
    kinds = [e.strip() for e in enum.split(",") if e.strip() and e.strip() != "kAttnKernels"]
    names = re.findall(r'"(\w+)"', re.search(r"kAttnKernelNames\[kAttnKernels\] = \{(.*?)\};",
                                             src, re.S).group(1))
    assert names[kinds.index("kAttnKernelWideF32")] == chip_smoke.WIDE_F32
    taken = set()
    for d in range(1, 513):
        depth = padded_depth(d)
        for length in (1, 16, 17, 64, 208, 210, 256, 257, 1025, 4096):
            got = chip_smoke.k1_kernel(d, length, "fp32")
            want = depth > 128 and depth != 256 and length > 16 and d % 4 == 0
            assert (got == chip_smoke.WIDE_F32) == want, (d, length, got)
            if want:
                taken.add(depth)
            elif depth > 128 and length > 16 and depth != 256:
                assert got == (chip_smoke.DEEP_F32 if d > 256 else chip_smoke.PADDED_F32)
            assert chip_smoke.k1_kernel(d, length, "bf16") != chip_smoke.WIDE_F32
    assert sorted(taken) == list(chip_smoke.WIDE_F32_DEPTHS)
    for d in (384, 512):
        for length in (17, 208, 210, 257, 4096):
            assert chip_smoke.block_attention_kernel(d, length, "fp32") == chip_smoke.WIDE_F32
        assert chip_smoke.block_attention_kernel(d, 16, "fp32") == chip_smoke.SHORT_F32
    assert chip_smoke.block_attention_kernel(256, 208, "fp32") == chip_smoke.SPLIT_F32
