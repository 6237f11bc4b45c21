"""K1 in bf16 at the lengths where its kernels split, on the CPU against the
JAX package.

On the card K1's bf16 calls take one warp up to 16 keys, the one-pass kernel
(K and V whole in shared memory) from 17 to 256 keys at head dims up to 64,
and the cp.async ring past that, in two passes past 224 keys
(``launch_attention_dim`` in ``csrc/attention.cuh``).  Each must keep the TPU kernel's
arithmetic: float32 scores, -1e30 on masked keys, a float32 softmax with
``sum + 1e-30``, the weights normalised and then rounded to bf16, P V summed
in float32.  Here, on the same numpy inputs at B = 2, H = 2, D = 64 and the
lengths around each split, K1's plain version (the wrapper's path for a CPU
tensor) and JAX's Pallas kernel in interpret mode, both in bf16, are held
against the float64 reference of ``chip_smoke.attention_agreement``: no
element outside its limit and a mean error within ``MEAN_ULPS``, the check
``chip_smoke.py`` phase 3 holds the kernels to on the card.  Also: the
C library's launch counts by kernel as the wrapper module reads them, the
ctypes entry bound once per library, and the one-pass kernel's timing
variants (``measure/attention_variants.py``), which patch the
shipped source and run on the card only.
"""

import ctypes
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu_torch.measure import attention_variants, variants
from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops import fused_attention as k1

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its bf16 attention check; the script imports nothing at the top)

torch.set_num_threads(1)

# around 16 (one warp), 224 (the ring's one-chunk rows), 256 (the one-pass
# kernel's longest row) and 257 (the ring's two passes); 243 and 246 are the
# Transformer IQAP's and the step seq2seq's encoders
LENGTHS = (17, 224, 225, 243, 246, 256, 257)


def _key_mask(batch, length, seed):
    """Ragged key-padding mask: row b keeps its first length - r_b keys."""
    rng = np.random.RandomState(seed)
    keep = np.ones((batch, length), bool)
    for b in range(batch):
        keep[b, length - rng.randint(1, length // 2 + 1):] = False
    return keep


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("masked", [False, True])
def test_k1_bf16_long_rows_match_jax(length, masked):
    """B = 2, H = 2, D = 64, bf16: both within chip_smoke.py's bf16 attention
    check (0 elements outside, mean within MEAN_ULPS)."""
    rng = np.random.RandomState(1000 + length)
    q, k, v = (rng.randn(2, length, 2, 64).astype(np.float32) for _ in range(3))
    mask = _key_mask(2, length, length)[:, None, None, :] if masked else None
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    jargs = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv)]
    jax_out = jax_fused_attention(*jargs, None if mask is None else jnp.asarray(mask),
                                  interpret=True)
    outs = {"K1's plain version": k1.fused_attention(tq, tk, tv, tmask),
            "JAX's Pallas kernel": torch.from_numpy(
                np.array(jax_out.astype(jnp.float32))).bfloat16()}
    for name, out in outs.items():
        assert out.dtype == torch.bfloat16 and out.shape == tq.shape
        stats = chip_smoke.attention_agreement(torch, out, tq, tk, tv, tmask)
        assert stats["outside"] == 0 and chip_smoke.bf16_ok(stats), (name, stats)


def test_kernel_launches_reads_the_c_counts(monkeypatch):
    """kernel_launches names K1's kernel functions as the C library does, up
    to its first null name, and reads each one's count from it."""
    names = [b"attention_kernel_f32", b"attention_kernel", b"attention_kernel_onepass"]
    counts = [3, 0, 7]

    class Library:
        def __init__(self):
            self.esv_attention_kernel = lambda i: names[i] if i < len(names) else None
            self.esv_attention_launches = lambda i: counts[i]

    monkeypatch.setattr(_build, "load", lambda name: Library())
    k1._launch_counters.cache_clear()
    try:
        assert k1.kernel_launches() == {"attention_kernel_f32": 3, "attention_kernel": 0,
                                        "attention_kernel_onepass": 7}
        counts[2] += 1
        assert k1.kernel_launches()["attention_kernel_onepass"] == 8
    finally:
        k1._launch_counters.cache_clear()


def test_esv_attention_binds_each_entry_once(monkeypatch):
    """The ctypes entry gets its argument and result types once, after the
    library is loaded, not on every call."""
    class Entry:
        def __init__(self):
            self.bound = 0

        def __setattr__(self, key, value):
            if key == "argtypes":
                self.__dict__["bound"] = self.__dict__.get("bound", 0) + 1
            self.__dict__[key] = value

    class Library:
        def __init__(self):
            self.esv_attention = Entry()

    lib = Library()
    loads = []
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or lib)
    k1._esv_attention.cache_clear()
    try:
        first = k1._esv_attention()
        assert k1._esv_attention() is first is lib.esv_attention
        assert first.bound == 1 and loads == ["fused_attention"]
        assert first.argtypes[0] is ctypes.c_void_p and first.restype is ctypes.c_int
    finally:
        k1._esv_attention.cache_clear()


@pytest.mark.parametrize("name", sorted(attention_variants.VARIANTS))
def test_attention_variants_patch_the_shipped_source(name):
    """Each variant of the attention kernels is the shipped ``csrc/`` (the
    one-pass kernel's in ``attention.cuh``, the head-dim-256 kernels' in
    ``attention_wide.cuh`` and their routing in ``attention_padded.cuh``)
    with its replacements, each matching exactly once: a source edit that
    moves a patched line fails here, not on the card."""
    patched = variants.variant_sources(attention_variants.VARIANTS, name)
    for file, text in patched.items():
        assert text != (_build.CSRC_DIR / file).read_text()
    for file, _, new in attention_variants.VARIANTS[name]:
        assert new in patched[file] or not new


def test_attention_variants_need_a_card(monkeypatch):
    """Without a card ``main`` raises before building; an unknown name is
    refused first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        attention_variants.main(["--variants", "warps8"])
    with pytest.raises(ValueError, match="unknown variants"):
        attention_variants.main(["--variants", "warps9"])
