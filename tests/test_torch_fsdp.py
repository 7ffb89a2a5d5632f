"""The port's FSDP (``triad_tpu_torch/parallel/fsdp.py``: parameters stored
sharded over 'data', gathered at use) on the CPU, against the JAX package:

(a) ``fsdp_param_specs`` equals JAX's leaf for leaf after
    ``models/convert.py``'s name and layout map: on a flat mesh of 8, on
    dp 4 x tp 2 extending the Megatron specs, and with ``min_size``.
(b) One joint step of tests/test_torch_tp.py's narrow model under FSDP
    (with ZeRO-1, as the Trainer runs it) against JAX's jitted
    single-device step: FSDP at world 2 (tp 1), at dp 2 x tp 2, FSDP x
    multi-slice (replica 2 x data 2), and two micro steps with
    accumulation 2; loss rtol 2e-5, parameters rtol 5e-5, atol 1e-5.
(c) The FSDP worlds with every dropout live against the port's
    one-process step (tests/test_torch_tp.py's bounds).

The worlds are tests/test_torch_tp.py's, computed once a session.
"""

import pytest

from tests.test_torch_tp import (  # noqa: F401 — layout_worlds is a fixture
    BLOCKS,
    _jax_params,
    _port_model,
    fake_world,
    held_loss_to_jax,
    held_params_to_jax,
    held_to_one_process,
    jax_specs_by_name,
    layout_worlds,
    port_specs_in_flax_layout,
)

FSDP_LAYOUTS = (("exact", "fsdp"), ("exact", "fsdp_tp2"), ("exact", "fsdp_slices"),
                ("accum2", "fsdp"))


@pytest.mark.parametrize("min_size", [1024, 64, 10 ** 9])
def test_fsdp_specs_match_jax(monkeypatch, min_size):
    """A flat mesh of 8: each leaf of at least ``min_size`` elements on its
    largest divisible Flax dim (the first of equal ones)."""
    from triad_tpu.parallel.dp import make_mesh as jax_mesh
    from triad_tpu.parallel.fsdp import fsdp_param_specs as jax_fsdp
    from triad_tpu_torch.parallel.dp import make_mesh
    from triad_tpu_torch.parallel.fsdp import fsdp_param_specs

    want = jax_specs_by_name(jax_fsdp(_jax_params(), jax_mesh(8), min_size=min_size))
    fake_world(monkeypatch, 8)
    got = port_specs_in_flax_layout(fsdp_param_specs(_port_model(), make_mesh(8),
                                                     min_size=min_size))
    assert got == want
    sharded = sum(1 for s in got.values() if s)
    assert (sharded == 0) == (min_size == 10 ** 9)


def test_fsdp_extends_tp_specs_match_jax(monkeypatch):
    from triad_tpu.parallel.fsdp import fsdp_param_specs as jax_fsdp
    from triad_tpu.parallel.tp import make_dp_tp_mesh as jax_mesh
    from triad_tpu.parallel.tp import tp_param_specs as jax_tp
    from triad_tpu_torch.parallel.fsdp import fsdp_param_specs
    from triad_tpu_torch.parallel.tp import make_dp_tp_mesh, tp_param_specs

    params = _jax_params()
    want = jax_specs_by_name(jax_fsdp(params, jax_mesh(8, 2), base_specs=jax_tp(params, 2)))
    fake_world(monkeypatch, 8)
    model = _port_model()
    got = fsdp_param_specs(model, make_dp_tp_mesh(8, 2), base_specs=tp_param_specs(model, 2))
    got = port_specs_in_flax_layout(got)
    assert got == want
    assert got["audio_backbone.layers.0.attention.q_proj.weight"] == ("data", "model")
    assert got["audio_backbone.layers.0.output_dense.weight"] == ("model", "data")


@pytest.mark.parametrize("key,layout", FSDP_LAYOUTS)
def test_fsdp_step_loss_matches_jax(layout_worlds, key, layout):
    held_loss_to_jax(layout_worlds, key, layout)


@pytest.mark.parametrize("key,layout", FSDP_LAYOUTS)
def test_fsdp_step_params_match_jax(layout_worlds, key, layout):
    held_params_to_jax(layout_worlds, key, layout)


@pytest.mark.parametrize("layout", ["fsdp", "fsdp_tp2", "fsdp_slices"])
def test_fsdp_live_dropout_step_matches_one_process(layout_worlds, layout):
    held_to_one_process(layout_worlds, layout)


def test_fsdp_storage(layout_worlds):
    """Each rank stores its slices of the large leaves: world 2 holds less
    than 0.6 of one process's parameters, dp 2 x tp 2 less than 0.45."""
    got = layout_worlds["got"]
    params_1, _ = layout_worlds["one_process_bytes"]
    assert max(got["exact/fsdp/param_bytes"]) < 0.6 * params_1
    assert max(got["exact/fsdp_tp2/param_bytes"]) < 0.45 * params_1


def test_fsdp_chunked_frontend_reads_gathered_weights(monkeypatch, layout_worlds):
    """FSDP shards conv_1's weight of HuBERT's frontend, and the FSDP runs
    still ran the chunked frontend (5 blocks, each again in the backward's
    recompute, which reads the weight the forward gathered: the runs above
    hold to JAX and to one process)."""
    from triad_tpu_torch.parallel.dp import make_mesh
    from triad_tpu_torch.parallel.fsdp import fsdp_param_specs

    fake_world(monkeypatch, 2)
    specs = fsdp_param_specs(_port_model(), make_mesh(2))
    assert "data" in specs["audio_backbone.feature_extractor.convs.1.weight"]
    for key, layout in FSDP_LAYOUTS:
        steps = 2 if key == "accum2" else 1
        assert float(layout_worlds["got"][f"{key}/{layout}/metric/frontend_blocks"]) == \
            2 * BLOCKS * steps, (key, layout)
