"""The cost arithmetic: one attention and one MLP call against a hand
count, and the step's count against torch's FlopCounterMode over the
port's plain route (every product plain, nothing recomputed) at a small
size."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import costs
import harness
from conftest import tiny_cell


def test_attention_hand_count():
    b, n, h = 3, 100, 12
    # QK^T and PV: two products of n x n x 64 a head, 2 operations a MAC
    flops = 2 * (2 * n * n * 64) * h * b
    act = b * n * h * 64 * 2
    (fwd_ms, by), (bwd_ms, _) = costs.attention_costs(b, n, h)
    assert math.isclose(fwd_ms, max(flops / 989e12, (4 * act + b * n * 4) / 3.35e12) * 1e3)
    assert math.isclose(bwd_ms, max(2.5 * flops / 989e12,
                                     (7 * act + b * n * 4) / 3.35e12) * 1e3)


def test_mlp_hand_count():
    m = 64 * 499
    flops = 2 * m * 768 * 3072 * 2  # fc1 and fc2
    nbytes = 2 * (m * 768 * 2 + 768 * 3072 * 2 + 3072 + 768)
    ms, by = costs.mlp_fwd_cost(m)
    assert by == "operations" and math.isclose(ms, flops / 989e12 * 1e3)
    assert nbytes / 3.35e12 * 1e3 < ms
    assert math.isclose(costs.mlp_bwd_cost(m)[0], 1.5 * ms)


@pytest.mark.parametrize("name", ["perf-joint-b64", "default-joint-b22"])
def test_step_count_matches_flop_counter(name):
    """The count of what the step needs against the products the plain
    route runs, less what the route runs besides: the folded LoRA's
    W + s B A, its full dW' and the factors' gradients from it (the count
    takes the factors' own rank-r products), and the positional conv's
    extra output row (computed, then trimmed). One positional conv group:
    the counter over-counts a grouped convolution's backward."""
    cell = tiny_cell(name, "float32")
    m = cell.config["model"]
    m["vit"].update(attention_impl="xla", mlp_impl="xla")
    m["hubert"].update(attention_impl="xla", mlp_impl="xla", ln_impl="xla", posconv_impl="conv",
                       frontend_impl="conv", remat="none", layerdrop=0.0,
                       num_conv_pos_embedding_groups=1)
    m["text"].update(attention_impl="xla")
    cell.config["loss"].update(implementation="dense")
    cell.config["optim"].update(gradient_accumulation_steps=1)
    dev = torch.device("cpu")
    tr = cell.traffic
    ring = harness.T.make_ring(tr, m["text"]["vocab_size"], 11, dev)
    state, step = harness.build_program(cell, 11, dev)
    with FlopCounterMode(display=False) as fc:
        step(state, *ring[0], tr["w_av"], tr["w_tv"])
    v, h = m["vit"], m["hubert"]
    d, r = v["hidden_size"], v["lora_rank"]
    n = 1 + v["num_register_tokens"] + (v["image_size"] // v["patch_size"]) ** 2
    folded = sum(2 * fo * r * d + 2 * b * n * d * fo + 4 * fo * d * r - 2 * b * n * r * (d + fo)
                 for b in (tr["batch_av"], tr["batch_tv"]) for fo in (3 * d, d))
    na = costs.frontend_tokens(h, tr["audio_samples"])[-1]
    posconv = 3 * 2 * tr["batch_av"] * na * h["hidden_size"] ** 2 * h["num_conv_pos_embeddings"]
    want = (costs.step_flops(m, tr, h["num_layers"]) + v["num_layers"] * folded
            + posconv // na)
    assert fc.get_total_flops() == want
