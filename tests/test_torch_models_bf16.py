"""The port's encoders and TriadModel against the JAX package at
compute_dtype="bfloat16" on the CPU (same narrow perf config and checks
as tests/test_torch_models.py, which states the tolerances)."""

import pytest

from tests.test_torch_models import build_pair, check_backbone, check_inference_forward


@pytest.fixture(scope="module")
def pair_bf16():
    return build_pair("bfloat16")


@pytest.mark.parametrize("enc", ["visual", "audio", "text"])
def test_backbone(pair_bf16, enc):
    check_backbone(pair_bf16, enc, "bfloat16")


def test_inference_forward(pair_bf16):
    check_inference_forward(pair_bf16, "bfloat16")
