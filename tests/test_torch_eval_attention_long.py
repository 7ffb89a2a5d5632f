"""The port's eval attention past 512 keys (the kernel has no key cap)
against the JAX package, on the CPU, at N = 600 and N = 1000: the plain
twins of ``attention_eval``, ``attention_eval_merged``,
``attention_eval_pair`` and ``attention_eval_merged_pair`` against
``fused_attention_eval``, ``fused_attention_eval_merged``,
``fused_attention_eval_pair`` and ``fused_attention_eval_merged_pair``
(Pallas in interpret mode) behind the JAX adapters
``packed_dot_product_attention`` and ``merged_packed_dot_product_attention``.

B = 2, H = 3 (the pair modes' odd last head takes ``_head_eval``): batch
row 0 has one masked key, batch row 1 every key masked, so its softmax is
uniform over the keys the adapter counts (the 128-padded ones too, except
in the single-head merged mode, whose port takes the adapter's unpadded
``pad="none"`` form: its callers pass no key mask).

Inputs come from numpy with a seed; the port's wrappers run their plain
twins (the tensors lie on the CPU). fp32 with TF32 off. Tolerances: fp32
1e-5 absolute on outputs of magnitude below 1 (summation order only);
bf16 one bf16 ulp of the output's largest magnitude (both sides round the
same fp32 probabilities to bf16 before e.V, and the pair modes sum the
rounded values; the sums differ in order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, H = 2, 3
BF16_ULP = 2.0 ** -7  # relative spacing of bf16 values in [1, 2)
MODES = ("packed", "merged", "pair", "merged_pair")


def _inputs(n):
    rng = np.random.default_rng(n)
    q, k, v = (rng.normal(size=(B, n, H, 64)).astype(np.float32) * 0.5 for _ in range(3))
    valid = np.ones((B, n), np.float32)
    valid[0, n // 3] = 0.0  # one masked key
    valid[1] = 0.0  # every key masked
    return q, k, v, valid


def _reference(mode, q, k, v, valid, dtype=jnp.float32):
    from triad_tpu.models.layers import (
        merged_packed_dot_product_attention,
        packed_dot_product_attention,
    )

    n = q.shape[1]
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    pair = mode.endswith("pair")
    with pltpu.force_tpu_interpret_mode():
        if mode.startswith("merged"):
            qkv = jnp.concatenate([x.reshape(B, n, H * 64) for x in (jq, jk, jv)], axis=-1)
            out = merged_packed_dot_product_attention(
                qkv, jnp.asarray(valid), dtype, 64, pair=pair, pad="hbm" if pair else "none")
        else:
            mask = jnp.asarray(valid)[:, None, None, :].astype(bool)
            out = packed_dot_product_attention(jq, jk, jv, mask, dtype, pair=pair)
    return np.asarray(jnp.asarray(out, jnp.float32)).reshape(B, n, H * 64)


def _port(mode, q, k, v, valid, dtype=torch.float32):
    from triad_tpu_torch.ops import attention as A

    n = q.shape[1]
    tq, tk, tv = (torch.from_numpy(x.reshape(B, n, H * 64)).to(dtype) for x in (q, k, v))
    mask = torch.from_numpy(valid)
    if mode == "merged":
        out = A.attention_eval_merged(torch.cat([tq, tk, tv], dim=-1), mask)
    elif mode == "merged_pair":
        out = A.attention_eval_merged_pair(torch.cat([tq, tk, tv], dim=-1), mask)
    else:
        out = (A.attention_eval_pair if mode == "pair" else A.attention_eval)(tq, tk, tv, mask)
    return out.float().numpy()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [600, 1000])
def test_twins_match_pallas_past_512_keys(n, mode):
    q, k, v, valid = _inputs(n)
    ref = _reference(mode, q, k, v, valid)
    got = _port(mode, q, k, v, valid)
    assert got.shape == ref.shape == (B, n, H * 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the all-masked row: the mean of v over the keys the softmax counts
    counted = n if mode == "merged" else -(-n // 128) * 128
    want = v[1].reshape(n, H * 64).sum(axis=0) / counted
    np.testing.assert_allclose(got[1], np.broadcast_to(want, (n, H * 64)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [600, 1000])
def test_twins_match_pallas_bf16(n, mode):
    """bf16 operands, as the card runs them: within one bf16 ulp of the
    Pallas kernel's largest output."""
    q, k, v, valid = _inputs(n)
    ref = _reference(mode, q, k, v, valid, jnp.bfloat16)
    got = _port(mode, q, k, v, valid, torch.bfloat16)
    assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()
