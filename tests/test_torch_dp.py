"""The port's data-parallel losses (``triad_tpu_torch/parallel/dp.py``)
against the JAX package's on ``make_mesh(n)``, and the dropout draws of a
data-parallel rank against one process's.

The port's ranks are gloo worlds of CPU processes
(``tests/torch_dp_worker.py``): a world of 2 and one of 4, started once
for the file, side by side, each rendezvousing through a FileStore under
the test's temporary directory. Each rank holds its rows of the batch;
rank 0 writes the replicated values, the gathered feature gradients and
the temperature gradient summed over the ranks (each rank runs its
backward with the cotangent 1 / world).

Shapes and tolerances are tests/test_parallel.py's (B 16, Na 23, Nt 12,
Nv 9, D 16, every other caption padded): values rtol 1e-5, statistics
and gradients rtol 1e-4 (atol 1e-6 and 1e-7). The multi-slice 2 x 2 mesh
and the ring are held to the flat all-gather run of the same world at
the same tolerances.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_dp_worker import computed_once, spawn_world
from triad_tpu.core.config import LossConfig
from triad_tpu.parallel.dp import distributed_av_loss, distributed_tv_loss, make_mesh

B, NA, NT, NV, D = 16, 23, 12, 9, 16
IMPLS = ("chunked", "chunked_vjp")
STATS = ("pos_sim_mean", "pos_sim_std", "neg_sim_mean", "neg_sim_std", "separation",
         "hardest_negative")


def _inputs():
    rng = np.random.default_rng(0)
    mask = np.ones((B, NT), np.float32)
    mask[1::2, 8:] = 0.0
    return {
        "audio": (rng.normal(size=(B, NA, D)) * 0.3).astype(np.float32),
        "text": (rng.normal(size=(B, NT, D)) * 0.3).astype(np.float32),
        "visual": (rng.normal(size=(B, NV, D)) * 0.3).astype(np.float32),
        "mask": mask,
        "temperature": np.float32(1.3),
    }


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _inputs(), computed_once(tmp_path_factory, "torch_dp_worlds", _run_worlds)


def _run_worlds(workdir):
    """The port's results at world 2 and 4 (both worlds run at once)."""
    inp = _inputs()
    np.savez(workdir / "inputs.npz", **inp)
    errors = []

    def run(n):
        try:
            spawn_world("losses", n, workdir)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n,)) for n in (2, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return {n: dict(np.load(workdir / f"losses-{n}.npz")) for n in (2, 4)}


def _jax_loss(leg, inp, impl, n):
    """JAX's distributed loss on make_mesh(n): (values, grads of the
    queries, the visual features and the temperature)."""
    cfg = LossConfig(implementation=impl, chunk_size=2)
    mesh = make_mesh(n)
    q = jnp.asarray(inp["audio" if leg == "av" else "text"])
    v, t = jnp.asarray(inp["visual"]), jnp.asarray(inp["temperature"])
    mask = jnp.asarray(inp["mask"])

    def total(q, v, t):
        out = (distributed_av_loss(q, v, t, cfg, mesh) if leg == "av"
               else distributed_tv_loss(q, v, mask, t, cfg, mesh))
        return out.total, out

    (_, out), grads = jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2), has_aux=True))(
        q, v, t)
    vals = {"total": out.total, "contrastive": out.contrastive, "reg": out.reg,
            **{k.split("_", 1)[1]: x for k, x in out.stats.items()}}
    if leg == "av":
        vals["smooth"] = out.smooth
    return vals, dict(zip(("dq", "dv", "dt"), grads))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("leg", ["av", "tv"])
def test_losses_match_jax(worlds, n, impl, leg):
    inp, res = worlds
    got = res[n]
    vals, grads = _jax_loss(leg, inp, impl, n)
    key = f"{impl}/flat/all_gather/{leg}"
    for name, ref in vals.items():
        mine = got[f"{key}/{leg}_{name}" if name in STATS else f"{key}/{name}"]
        if name in STATS or name == "smooth":
            np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(mine, ref, rtol=1e-5, err_msg=name)
    for name, ref in grads.items():
        np.testing.assert_allclose(got[f"{key}/{name}"], np.asarray(ref), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("other", ["slices/all_gather", "flat/ring"])
@pytest.mark.parametrize("impl", IMPLS)
def test_multislice_and_ring_match_flat_gather(worlds, impl, other):
    """World 4: the 2 x 2 multi-slice mesh (negatives gathered over both
    axes) and the ring give the flat all-gather's values and gradients."""
    got = worlds[1][4]
    keys = [k for k in got if k.startswith(f"{impl}/flat/all_gather/")]
    assert len(keys) == 25  # 13 AV values and gradients, 12 TV
    for k in keys:
        tol = (dict(rtol=1e-5, atol=0) if k.rsplit("/", 1)[1] in ("total", "contrastive", "reg")
               else dict(rtol=1e-4, atol=1e-7))
        np.testing.assert_allclose(got[k.replace("flat/all_gather", other)], got[k], err_msg=k,
                                   **tol)


def test_ring_rejects_multislice_mesh(worlds):
    """The JAX ValueError, word for word, on a tuple axis."""
    with pytest.raises(ValueError) as jax_err:
        from triad_tpu.parallel.dp import _ring_aggregate

        _ring_aggregate(None, None, None, LossConfig(negatives="ring"), -1.0, None,
                        ("replica", "data"))
    assert str(worlds[1][4]["ring_tuple_error"]) == str(jax_err.value)


# ---------------------------------------------------------------------------
# (e) the dropout draws at b0: a rank's rows draw what one process draws
# ---------------------------------------------------------------------------

WORLD, GLOBAL_B = 2, 4


def _shards():
    per = GLOBAL_B // WORLD
    return [(r, r * per, slice(r * per, (r + 1) * per)) for r in range(WORLD)]


def test_attention_mask_at_b0():
    from triad_tpu_torch.ops.attention import (
        attention_keep,
        attention_train_bwd_plain,
        attention_train_plain,
    )

    h, n, p = 2, 37, 0.3
    full = attention_keep(GLOBAL_B, h, n, n, 91, p, "cpu")
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(GLOBAL_B, n, h * 64, generator=gen) for _ in range(4))
    mask = torch.ones(GLOBAL_B, n)
    out = attention_train_plain(q, k, v, mask, 0.125, 91, p)
    grads = attention_train_bwd_plain(q, k, v, mask, do, 0.125, 91, p)
    for _, b0, rows in _shards():
        assert torch.equal(attention_keep(GLOBAL_B // WORLD, h, n, n, 91, p, "cpu", b0),
                           full[rows])
        assert torch.equal(attention_train_plain(q[rows], k[rows], v[rows], mask[rows], 0.125,
                                                 91, p, b0), out[rows])
        for g, ref in zip(attention_train_bwd_plain(q[rows], k[rows], v[rows], mask[rows],
                                                    do[rows], 0.125, 91, p, b0), grads):
            assert torch.equal(g, ref[rows])


def test_mlp_mask_at_b0():
    """The keep mask bit for bit; the outputs within 1e-6 of their
    magnitude (a product of fewer rows may sum in another order)."""
    from triad_tpu_torch.ops.mlp import fused_mlp_bwd_plain, fused_mlp_plain, mlp_keep

    n, din, dh, p = 5, 16, 24, 0.3
    full = mlp_keep(GLOBAL_B * n, dh, 17, p, "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(GLOBAL_B, n, din, generator=gen)
    w1, b1 = torch.randn(dh, din, generator=gen), torch.randn(dh, generator=gen)
    w2, b2 = torch.randn(din, dh, generator=gen), torch.randn(din, generator=gen)
    dy = torch.randn(GLOBAL_B, n, din, generator=gen)
    out = fused_mlp_plain(x, w1, b1, w2, b2, "tanh", 17, p)
    grads = fused_mlp_bwd_plain(x, w1, b1, w2, dy, "tanh", 17, p)
    for _, b0, rows in _shards():
        per = GLOBAL_B // WORLD
        assert torch.equal(mlp_keep(per * n, dh, 17, p, "cpu", b0 * n),
                           full[b0 * n:(b0 + per) * n])
        mine = (fused_mlp_plain(x[rows], w1, b1, w2, b2, "tanh", 17, p, b0),
                *fused_mlp_bwd_plain(x[rows], w1, b1, w2, dy[rows], "tanh", 17, p, b0))
        for got, ref in zip(mine, (out, *grads)):
            torch.testing.assert_close(got, ref[rows], rtol=0,
                                       atol=1e-6 * float(ref.abs().max()))
        assert torch.equal(mine[3] == 0, grads[2][rows] == 0)  # the dropped g


def test_layernorm_mask_at_b0():
    from triad_tpu_torch.ops.layernorm import dropout_add_ln_bwd_plain, dropout_add_ln_plain

    n, c, p = 7, 32, 0.3
    gen = torch.Generator().manual_seed(2)
    x, h, dy = (torch.randn(GLOBAL_B, n, c, generator=gen) for _ in range(3))
    scale, bias = torch.randn(c, generator=gen), torch.randn(c, generator=gen)
    out = dropout_add_ln_plain(x, h, scale, bias, 1e-5, 23, p)
    dx, dh, _, _ = dropout_add_ln_bwd_plain(x, h, scale, dy, 1e-5, 23, p)
    for _, b0, rows in _shards():
        assert torch.equal(dropout_add_ln_plain(x[rows], h[rows], scale, bias, 1e-5, 23, p, b0),
                           out[rows])
        gx, gh, _, _ = dropout_add_ln_bwd_plain(x[rows], h[rows], scale, dy[rows], 1e-5, 23, p,
                                                b0)
        assert torch.equal(gx, dx[rows]) and torch.equal(gh, dh[rows])


def test_plain_draws_at_b0():
    """dropout, patch dropout and SpecAugment draw, on each rank's
    generator, the one-process draws of its rows, and leave every rank's
    generator where one process leaves it."""
    from triad_tpu_torch.models.hubert import spec_augment_time_mask
    from triad_tpu_torch.models.layers import dropout, patch_dropout_mask
    from triad_tpu_torch.train.step import step_generator

    x = torch.randn(GLOBAL_B, 40, 8)
    embed = torch.full((8,), 9.0)

    def draws(gen, rows):
        return (dropout(x[rows], 0.3, gen), patch_dropout_mask(gen, (x[rows].shape[0], 40), 0.25),
                spec_augment_time_mask(x[rows], embed, gen, 0.3, 4, 2), torch.rand(3, generator=gen))

    one = draws(step_generator(5, 3, "cpu"), slice(None))
    for r, _, rows in _shards():
        mine = draws(step_generator(5, 3, "cpu", (r, WORLD)), rows)
        for got, ref in zip(mine[:3], one[:3]):
            assert torch.equal(got, ref[rows])
        assert torch.equal(mine[3], one[3])  # the generators stay in step


def test_kernel_offsets():
    """The C kernels' offset argument: b0 * H (attention), b0 * N (MLP,
    LayerNorm); 0 without dropout."""
    from triad_tpu_torch import kernels
    from triad_tpu_torch.ops.dropout import row_offset

    assert kernels.dropout_args(7, 0.1, 64)[4] == 64
    assert kernels.dropout_args(7, 0.0, 64) == (0, 0, 1.0, 0, 0)
    assert row_offset(torch.empty(2, 499, 768), 32) == 32 * 499
    with pytest.raises(ValueError):
        kernels.dropout_args(7, 0.1, 2 ** 32)

