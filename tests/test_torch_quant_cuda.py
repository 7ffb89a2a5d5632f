"""The int8 product of the serving mode on the card
(triad_tpu_torch/ops/quant.py): ``torch._int_mm`` against the plain int32
product at rows 1, 15, 17, 261 and 4000 and the (K, N) of the three
encoders' Dense products (HuBERT's feature projection, attention and
FFN; DistilBERT's; the ViT's fused qkv; the projection heads), and at K
and N that need padding: exact. ``int8_dense`` on the card equals its CPU
run bit for bit (the same roundings in fp32, exact int32 sums), and never
falls back to the plain product on a CUDA tensor. An int8 product traced
by ``torch.export`` with a symbolic batch holds at batches 1 and 3.

Needs an NVIDIA GPU; skips elsewhere. On a machine with the card and no
JAX (tests/conftest.py imports JAX, hence --noconftest):
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_quant_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

ROWS = [1, 15, 17, 261, 4000]
# (K, N): HuBERT feature projection, attention (and DistilBERT's), FFN in
# and out, the ViT's fused qkv, the projection heads; then shapes _int_mm
# takes only padded
SHAPES = [(512, 768), (768, 768), (768, 3072), (3072, 768), (768, 2304), (768, 512),
          (512, 512), (100, 36), (771, 13)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(m, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    return a, b


@pytest.mark.parametrize("k,n", SHAPES, ids=[f"K{k}-N{n}" for k, n in SHAPES])
@pytest.mark.parametrize("m", ROWS)
def test_int_mm_exact(dev, m, k, n, monkeypatch):
    from triad_tpu_torch.ops import quant

    a, b = _operands(m, k, n, m * 7 + k + n)
    want = quant.int8_matmul_plain(a, b)

    def no_fallback(*args):
        raise AssertionError("the plain product ran on a CUDA tensor")

    monkeypatch.setattr(quant, "int8_matmul_plain", no_fallback)
    got = quant.int8_matmul(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m", ROWS)
def test_int8_dense_card_equals_cpu(dev, m):
    from triad_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(m)
    x = torch.randn(m, 768, generator=g).to(torch.bfloat16)
    w = torch.randn(3072, 768, generator=g) * 0.02
    b = torch.randn(3072, generator=g)
    want = quant.int8_dense(x, w, b)
    got = quant.int8_dense(x.to(dev), w.to(dev), b.to(dev))
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("seq,k,n", [(16, 64, 64), (9, 100, 36), (128, 768, 768)])
def test_exported_int8_matmul_holds_at_every_batch(dev, seq, k, n):
    """An int8 product traced by torch.export with a symbolic batch (as
    serve/export.py traces it, at 2) runs at batches 1 and 3, where M =
    batch x seq may be 16 or fewer rows, and equals the plain product."""
    from torch.export import Dim, export

    from triad_tpu_torch.ops import quant

    class Product(torch.nn.Module):
        def __init__(self, w):
            super().__init__()
            self.register_buffer("w", w)

        def forward(self, x):
            return quant.int8_matmul(x.reshape(-1, x.shape[-1]), self.w).reshape(
                x.shape[0], seq, -1)

    _, w = _operands(1, k, n, seq + k)
    prog = export(Product(w.to(dev)), (_operands(2 * seq, k, n, 1)[0].reshape(2, seq, k).to(dev),),
                  dynamic_shapes=({0: Dim("b", min=1)},)).module()
    for b in (1, 3):
        a = _operands(b * seq, k, n, b)[0]
        got = prog(a.reshape(b, seq, k).to(dev))
        assert torch.equal(got.cpu().reshape(b * seq, n), quant.int8_matmul_plain(a, w))
