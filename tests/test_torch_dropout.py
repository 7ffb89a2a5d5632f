"""The port's dropout keep mask (ops/dropout.py) and its host seeds, on
the CPU: the torch Philox4x32-10 against an independent pure-Python-int
Philox (itself checked against the Random123 known-answer vectors), the
keep rule and rate, distinct streams and seeds, and the replay of the
forward's mask by each kernel twin's backward.

The CUDA kernels draw the same bits (csrc/common.cuh:keep4);
tests/test_torch_kernels_cuda.py and chip_smoke.py hold them to these
twins on the card.
"""

import numpy as np
import pytest
import torch

M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK = 0xFFFFFFFF


def philox_ref(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., Random123)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
        p0, p1 = M0 * c0, M1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & MASK, (p0 >> 32) ^ c3 ^ k1, p0 & MASK)
    return c0, c1, c2, c3


def bits_ref(seed, stream, row, col):
    return philox_ref((col // 4, row, 0, 0), (seed, stream))[col % 4]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((MASK,) * 4, (MASK, MASK), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_reference_philox_known_answers(ctr, key, want):
    assert philox_ref(ctr, key) == want


@pytest.mark.parametrize("seed,streams", [(0, [0]), (123456789, [0, 5, 11]),
                                          (0x7FFFFFFE, [767])])
def test_keep_bits_match_reference(seed, streams):
    from triad_tpu_torch.ops.dropout import keep_bits

    rows, cols = 7, 13  # a ragged last quad
    got = keep_bits(seed, streams, rows, cols)
    assert got.shape == (len(streams), rows, cols)
    rng = np.random.default_rng(seed % 1000)
    for s_i, stream in enumerate(streams):
        for r, c in zip(rng.integers(0, rows, 30), rng.integers(0, cols, 30)):
            assert int(got[s_i, r, c]) == bits_ref(seed, stream, int(r), int(c))
    # one stream given as an int drops the stream axis
    torch.testing.assert_close(keep_bits(seed, streams[0], rows, cols), got[0])


def test_keep_bits_large_coordinates():
    """Rows and columns past 2^16 exercise every limb of the multiply."""
    from triad_tpu_torch.ops.dropout import philox4x32_10

    c0 = torch.tensor([70001, 0xFFFFFFFF, 123], dtype=torch.int64)
    c1 = torch.tensor([99999, 5, 0xFFFFFFFF], dtype=torch.int64)
    words = philox4x32_10(c0, c1, 0xDEADBEEF, 0xCAFEF00D)
    for i in range(3):
        want = philox_ref((int(c0[i]), int(c1[i]), 0, 0), (0xDEADBEEF, 0xCAFEF00D))
        assert tuple(int(w[i]) for w in words) == want


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_rate_within_4_sigma(p):
    from triad_tpu_torch.ops.dropout import keep_mask

    keep = keep_mask(17, [0, 1, 2, 3], 250, 500, p)
    n = keep.numel()
    rate = float(keep.float().mean())
    assert abs(rate - (1 - p)) < 4 * (p * (1 - p) / n) ** 0.5, rate


def test_keep_rule_and_scale():
    from triad_tpu_torch.ops.dropout import apply_keep, keep_bits, keep_mask, keep_scale, threshold

    assert threshold(0.1) == int(0.1 * 2 ** 32)
    assert threshold(1.0) == 2 ** 32 - 1
    bits = keep_bits(3, 0, 8, 16)
    torch.testing.assert_close(keep_mask(3, 0, 8, 16, 0.1), bits >= threshold(0.1))
    assert bool(keep_mask(3, 0, 8, 16, 0.0).all())
    x = torch.ones(8, 16)
    keep = keep_mask(3, 0, 8, 16, 0.1)
    y = apply_keep(x, keep, 0.1)
    assert torch.equal(y == 0, ~keep)
    torch.testing.assert_close(y[keep], torch.full_like(y[keep], keep_scale(0.1)))
    assert keep_scale(0.1) == float(np.float32(1 / 0.9))
    assert apply_keep(x, keep, 0.0) is x


def test_streams_and_seeds_differ():
    from triad_tpu_torch.ops.dropout import keep_mask

    a = keep_mask(1, [0, 1], 32, 64, 0.5)
    b = keep_mask(2, [0, 1], 32, 64, 0.5)
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], b[0])
    # the mask is a function of coordinates: a sub-block is the block's slice
    torch.testing.assert_close(keep_mask(1, 1, 8, 12, 0.5), a[1, :8, :12])


def test_host_seeds():
    from triad_tpu_torch.ops.dropout import HostSeeds

    a, b, c = HostSeeds(1, 7), HostSeeds(1, 7), HostSeeds(1, 8)
    sa = [a.seed() for _ in range(5)]
    assert sa == [b.seed() for _ in range(5)]
    assert sa != [c.seed() for _ in range(5)]
    assert len(set(sa)) == 5 and all(0 <= s < 2 ** 31 - 1 for s in sa)
    u = np.array([HostSeeds(0, i).uniform() for i in range(4000)])
    assert u.min() >= 0.0 and u.max() < 1.0
    # layerdrop draws: keep rate within 4 sigma of 1 - p at p = 0.1
    assert abs(float((u >= 0.1).mean()) - 0.9) < 4 * (0.09 / u.size) ** 0.5


class TestReplay:
    """Each twin's backward replays its forward's mask: the gradient of the
    forward (autograd through the plain ops) equals the backward twin."""

    def test_attention(self):
        from triad_tpu_torch.ops.attention import attention_train_bwd_plain, attention_train_plain

        rng = np.random.default_rng(0)
        q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 19, 128))).double() for _ in range(4))
        mask = torch.ones(2, 19)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        attention_train_plain(*leaves, mask, 0.125, 5, 0.3).backward(do)
        for got, leaf in zip(attention_train_bwd_plain(q, k, v, mask, do, 0.125, 5, 0.3), leaves):
            ref = leaf.grad.float()
            torch.testing.assert_close(got.float(), ref, rtol=0, atol=1e-5 * float(ref.abs().max()))

    def test_mlp(self):
        from triad_tpu_torch.ops.mlp import fused_mlp_bwd_plain, fused_mlp_plain

        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.normal(size=(2, 7, 32))).double().requires_grad_()
        w1 = torch.from_numpy(rng.normal(size=(64, 32)) / 6).double()
        b1 = torch.from_numpy(rng.normal(size=64) * 0.1).double()
        w2 = torch.from_numpy(rng.normal(size=(32, 64)) / 8).double()
        b2 = torch.zeros(32, dtype=torch.float64)
        dy = torch.from_numpy(rng.normal(size=(2, 7, 32))).double()
        fused_mlp_plain(x, w1, b1, w2, b2, "tanh", 9, 0.4).backward(dy)
        dx, _, _ = fused_mlp_bwd_plain(x.detach(), w1, b1, w2, dy, "tanh", 9, 0.4)
        torch.testing.assert_close(dx.float(), x.grad.float(), rtol=0,
                                   atol=1e-5 * float(x.grad.abs().max()))

    def test_layernorm(self):
        from triad_tpu_torch.ops.layernorm import dropout_add_ln_bwd_plain, dropout_add_ln_plain

        rng = np.random.default_rng(2)
        x, h, dy = (torch.from_numpy(rng.normal(size=(2, 5, 128))).double() for _ in range(3))
        scale = torch.from_numpy(rng.normal(size=128) + 1).double()
        bias = torch.from_numpy(rng.normal(size=128) * 0.1).double()
        leaves = [t.clone().requires_grad_() for t in (x, h, scale, bias)]
        dropout_add_ln_plain(*leaves, 1e-5, 4, 0.25).backward(dy)
        got = dropout_add_ln_bwd_plain(x, h, scale, dy, 1e-5, 4, 0.25)
        for g, leaf in zip(got, leaves):
            ref = leaf.grad.float()
            torch.testing.assert_close(g.float(), ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
