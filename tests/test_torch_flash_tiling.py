"""The flash kernels' own rounding order and their TMA plan, on the CPU.

``ops.flash_attention.flash_fwd_tiled_plain`` is the forward kernel's
order: an online softmax over key tiles of the kernel's width, the
un-normalised exp(S - m) rounded to bf16 before P.V. It is held against
``triad_tpu.models.layers.flash_dot_product_attention`` (JAX's library
Pallas kernel in interpret mode, behind the adapter that pads N to a
multiple of 128), which walks 512-key blocks and rounds the normalised P:
the two orders agree within the card tests' tolerance, 2 bf16 ulps of the
largest output, so that tolerance covers the kernel's order. l and m, fp32
on both sides, agree to 1e-5.

``tma_plan`` is the tensor map through which the kernels load a (B, H, N,
64) view; it is checked on CPU tensors laid out as the encoders and the
fused-qkv projections give them.

Inputs come from numpy with a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

BF16_ULP = 2.0 ** -7
_REFERENCE = {}


def _inputs(n, mask_kind, seed, b=2, h=2):
    """q, k, v as (B, N, H, 64) fp32 rounded to bf16 and a (B, N) bool key
    mask: "all" masks the back half of row 0's keys and every key of row -1."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, n, h, 64)).astype(np.float32) for _ in range(3))
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    valid = np.ones((b, n), bool)
    if mask_kind == "all":
        valid[0, n // 2:] = False
        valid[-1] = False
    return q, k, v, valid


def _library(n, mask_kind):
    """(out, the inputs) of the JAX library kernel in bf16, once per case."""
    key = (n, mask_kind)
    if key not in _REFERENCE:
        from triad_tpu.models.layers import flash_dot_product_attention

        q, k, v, valid = _inputs(n, mask_kind, seed=n + 7)
        mask = jnp.asarray(valid)[:, None, None, :] if mask_kind != "none" else None
        with pltpu.force_tpu_interpret_mode():
            out = flash_dot_product_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                              mask, jnp.bfloat16)
        _REFERENCE[key] = (np.asarray(jnp.asarray(out, jnp.float32)), q, k, v, valid)
    return _REFERENCE[key]


def _heads(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("mask_kind", ["none", "all"])
@pytest.mark.parametrize("n", [1, 37, 261, 1000])
def test_tiled_order_matches_library(n, mask_kind, tile):
    """The kernel's order against the library kernel: 2 bf16 ulps of the
    largest output, at one key, ragged N, N = 261 (the ViT) and N = 1000
    (two library blocks, 8 or 16 kernel tiles), with masked keys and a row
    whose keys are all masked."""
    from triad_tpu_torch.ops.flash_attention import flash_fwd_tiled_plain

    ref, q, k, v, valid = _library(n, mask_kind)
    mask = torch.from_numpy(valid) if mask_kind != "none" else None
    out, l, m = flash_fwd_tiled_plain(*(_heads(x) for x in (q, k, v)), mask, 0.125, tile)
    got = out.transpose(1, 2).float().numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * BF16_ULP * float(np.abs(ref).max()))


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("n", [37, 1000])
def test_tiled_stats_match_twin(n, tile):
    """l and m of the kernel's order equal the library twin's (fp32 both,
    the padded keys counted in l alone; an all-masked row has m =
    MASK_VALUE and l = the padded N): 1e-5."""
    from triad_tpu_torch.ops.flash_attention import flash_fwd_plain, flash_fwd_tiled_plain

    q, k, v, valid = _inputs(n, "all", seed=n + 11)
    args = (*(_heads(x) for x in (q, k, v)), torch.from_numpy(valid), 0.125)
    _, l, m = flash_fwd_tiled_plain(*args, tile)
    _, l_ref, m_ref = flash_fwd_plain(*args)
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd", "qkv"])
def test_tma_plan(layout):
    """dims (64, N, H, B), byte strides of rows, heads and batches, box (64,
    64, 1, 1): for (B, H, N, 64) views of (B, N, H, 64) memory (the
    encoders'), of contiguous (B, H, N, 64) memory, and of q, k, v sliced
    out of one fused (B, N, 3, H, 64) qkv tensor (row stride 3 H 64)."""
    from triad_tpu_torch.ops.flash_attention import tma_plan

    b, n, h = 2, 37, 3
    if layout == "bnhd":
        views = [torch.zeros((b, n, h, 64), dtype=torch.bfloat16).transpose(1, 2)]
        strides = (h * 128, 128, n * h * 128)
    elif layout == "bhnd":
        views = [torch.zeros((b, h, n, 64), dtype=torch.bfloat16)]
        strides = (128, n * 128, h * n * 128)
    else:
        qkv = torch.zeros((b, n, 3, h, 64), dtype=torch.bfloat16)
        views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        strides = (3 * h * 128, 128, n * 3 * h * 128)
    for x in views:
        assert tma_plan(x) == ((64, n, h, b), strides, (64, 64, 1, 1))


def test_tma_plan_single_rows_and_refusals():
    """A dim of size 1 is never stepped and takes the packed stride; a view
    TMA cannot address raises (columns not unit-strided, a base off 16
    bytes, a row stride off 16 bytes), and _addressable's copy of it plans."""
    from triad_tpu_torch.ops.attention import _addressable
    from triad_tpu_torch.ops.flash_attention import tma_plan

    one = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)
    assert tma_plan(one) == ((64, 1, 1, 1), (128, 128, 128), (64, 64, 1, 1))
    flat = torch.zeros(2 * 5 * 3 * 64 + 8, dtype=torch.bfloat16)
    bad = [
        torch.zeros((2, 3, 5, 128), dtype=torch.bfloat16)[..., ::2],  # column stride 2
        flat[1:1 + 2 * 5 * 3 * 64].view(2, 5, 3, 64).transpose(1, 2),  # base 2 bytes off
        torch.zeros((2, 5, 3, 68), dtype=torch.bfloat16)[..., :64].transpose(1, 2),  # rows 408 B
    ]
    for x in bad:
        with pytest.raises(ValueError, match="tma_plan"):
            tma_plan(x)
        assert tma_plan(_addressable(x))[0] == (64, 5, 3, 2)
