"""The plain reference against the port's plain CPU route at a tiny size:
every draw of the step (the kernels' keep masks, the generator's dropouts,
SpecAugment, layerdrop), the encoders, the losses, accumulation, gating,
clipping and the Adam updates. In fp32 the two agree to rounding; in the
configured bf16 they stay within what bf16 gives, and the control (the
reference in float8 products) reads far from both."""

import pytest
import torch

import check
import harness
from conftest import tiny_cell

DEV = torch.device("cpu")


def _program(cell, seed):
    return harness.prepare(cell, seed, DEV)[3]


def _numbers(prog, ref):
    return {k: v for k, (v, _) in check.numbers(prog, ref).items()}


def test_fp32_agrees(cell_name):
    cell = tiny_cell(cell_name, "float32")
    seed = 2 ** 31 + 5
    prog, ref = _program(cell, seed), harness.reference_readings(cell, seed, DEV)
    assert ref["updates"] == 2
    nums = _numbers(prog, ref)
    # fp32 on both sides: rounding only (Adam's first steps amplify it in
    # leaves whose gradient is near nought)
    assert nums["loss_gap"] < 1e-5, nums
    assert nums["grad_gap"] < 1e-4, nums
    assert nums["grad_err"] < 1e-4, nums
    assert nums["change_gap"] < 1e-3, nums


def test_layerdrop_and_draws_matter(cell_name):
    """Another step's draws (the wrong global step) read far off: the
    agreement above rests on re-deriving the step's own draws."""
    cell = tiny_cell(cell_name, "float32")
    seed = 2 ** 31 + 6
    prog = _program(cell, seed)
    cell.traffic = dict(cell.traffic, start_step=cell.traffic["start_step"] + 1)
    ref = harness.reference_readings(cell, seed, DEV)
    assert _numbers(prog, ref)["loss_gap"] > 1e-3


def test_bf16_and_the_control(cell_name):
    cell = tiny_cell(cell_name, "bfloat16")
    seed = 2 ** 31 + 7
    prog, ref = _program(cell, seed), harness.reference_readings(cell, seed, DEV)
    ctl = harness.reference_readings(cell, seed, DEV, "fp8")
    sound, control = _numbers(prog, ref), _numbers(ctl, ref)
    assert sound["loss_gap"] < 2e-2 and sound["grad_gap"] < 0.1, sound
    assert control["loss_gap"] > 3 * sound["loss_gap"], (sound, control)
    assert control["grad_err"] > 3 * sound["grad_err"], (sound, control)


def test_layout_is_the_programs():
    """The reference's parameter layout is the program's, name for name."""
    from reference import layout
    from triad_tpu_torch.config import Config
    from triad_tpu_torch.models.multimodal import TriadModel

    for name in ("perf-joint-b64", "default-joint-b22"):
        cell = harness.load_cell(name)
        cfg = Config.from_dict({"model": cell.config["model"]}).model
        model = TriadModel(cfg, device="meta")
        have = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert have == dict(layout.param_shapes(cell.config["model"]))


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
def test_keep_rule_is_the_programs(p):
    from reference import draws
    from triad_tpu_torch.ops import dropout

    got = draws.keep_mask(1234567, [0, 3, 7], 5, 11, p, DEV, row0=40)
    want = dropout.keep_mask(1234567, [0, 3, 7], 5, 11, p, DEV, row0=40)
    assert torch.equal(got, want)
    hs, ph = draws.HostSeeds(2 ** 31 + 3, 6001), dropout.HostSeeds(2 ** 31 + 3, 6001)
    assert [hs.uniform(), hs.seed()] == [ph.uniform(), ph.seed()]
