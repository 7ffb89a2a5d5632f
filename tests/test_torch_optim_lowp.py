"""The port's optimizer bank with low-precision Adam moments against the
JAX package's, on the CPU.

tests/test_optim.py's bf16-moment check replayed through both banks: the
same 5 updates of the same gradients (seed 3, x 0.1) on the same tree
(``tiny_params``), every group unfrozen, on the default route
(``scale_by_cycled_adam``) and on ``cycle_momentum=False``
(``optax.adamw(mu_dtype=...)``), with fp32 and with bf16 moments. After
each update the port's moments have the configured dtypes (on the plain
route nu stays fp32, as optax keeps it), and its moments and parameters
are held to JAX's:

  fp32 moments   moments within 1e-5 of the leaf's largest plus 1e-9
                 (a moment near 0 is a difference of larger terms),
                 parameters within 1e-5 relative plus 1e-7, as tests/test_torch_train_step.py holds the
                 bank (the same arithmetic; the schedules' lr and beta1
                 are formed in double in the port and in fp32 in JAX, and
                 1 - beta1 carries beta1's rounding at 20x)
  bf16 moments   each moment within one bf16 ulp of its magnitude (a
                 value that lands next to a rounding boundary may round
                 the other way), the parameters within 2e-3 lr plus 1e-7
                 (an ulp of the moment moves an update by about 2^-8 of
                 lr)

Then a checkpoint round trip through ``train/checkpoint.py`` keeps bf16
moments bf16 and bit-equal; moments saved in another dtype come back in
the running config's. ZeRO-1 with bf16 moments runs in the gloo world of
tests/test_torch_zero1.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from triad_tpu.core.config import OptimConfig

LR = 1e-4  # OptimConfig's learning_rate, the peak of "others"


def tiny_params():
    """tests/test_optim.py:tiny_params, flat: {path: value}."""
    k = lambda s: np.full((3,), s, np.float32)  # noqa: E731
    return {
        "audio_backbone/layer_0/kernel": k(0.1),
        "audio_projection/projection1/kernel": k(0.2),
        "temperature": np.asarray(1.5, np.float32),
        "text_backbone/layer_0/kernel": k(0.3),
        "text_projection/projection1/kernel": k(0.4),
        "visual_backbone/block_0/attn/qkv/kernel": k(0.5),
        "visual_backbone/block_0/attn/qkv/lora_a": k(0.6),
        "visual_backbone/block_0/attn/qkv/lora_b": k(0.7),
        "visual_projection/projection1/kernel": k(0.8),
    }


def _tree(flat):
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


class _Model(nn.Module):
    """The flat tree as a module whose state-dict names are the paths with
    dots (the bank groups them by those names)."""

    def __init__(self, flat):
        super().__init__()
        for path, v in flat.items():
            *parents, leaf = path.split("/")
            node = self
            for p in parents:
                if not hasattr(node, p):
                    node.add_module(p, nn.Module())
                node = getattr(node, p)
            node.register_parameter(leaf, nn.Parameter(torch.from_numpy(v.copy())))


def _grads(flat, n=5):
    rng = np.random.default_rng(3)
    return [{k: np.asarray(rng.normal(size=v.shape) * 0.1, np.float32)
             for k, v in flat.items()} for _ in range(n)]


def _cfg(dtype, cycled):
    return OptimConfig(unfreeze_audio_step=0, unfreeze_text_step=0, mu_dtype=dtype,
                       nu_dtype=dtype, cycle_momentum=cycled)


def _port_cfg(cfg):
    from triad_tpu_torch.config import OptimConfig as PortOptim

    return PortOptim(**dataclasses.asdict(cfg))


def _port_bank(cfg, flat):
    from triad_tpu_torch.train.optim import OptimizerBank

    model = _Model(flat)
    return model, OptimizerBank(_port_cfg(cfg), model, total_updates=100)


def _port_update(model, bank, grads, i):
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(np.array(grads[name.replace(".", "/")]))
    bank.update(i)
    bank.zero_grad()


def _moments(bank):
    """{(path, "mu" | "nu"): the stored moment}."""
    out = {}
    for g, opt in bank.opts.items():
        for name, p in zip(bank.names[g], bank.groups[g]):
            st = opt.state[p]
            out[name.replace(".", "/"), "mu"] = st["exp_avg"]
            out[name.replace(".", "/"), "nu"] = st["exp_avg_sq"]
    return out


def _jax_moments(jbank, state, part):
    out = {}
    labels = dict(zip(part.path_strings(), part.labels))
    for g, adam in state.adam.items():
        paths = [p for p in part.path_strings() if labels[p] == g]
        for path, mu, nu in zip(paths, adam[0].mu, adam[0].nu):
            out[path, "mu"], out[path, "nu"] = mu, nu
    return out


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (at least at 2^-126)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cycled", [True, False], ids=["cycled", "plain"])
def test_bank_moments_match_jax(dtype, cycled):
    from triad_tpu.train.optim import OptimizerBank, ParamPartition

    flat = tiny_params()
    cfg = _cfg(dtype, cycled)
    params = _tree(flat)
    part = ParamPartition(params)
    jbank = OptimizerBank(cfg, part, total_updates=100)
    jstate = jbank.init(params)
    model, bank = _port_bank(cfg, flat)
    for i, g in enumerate(_grads(flat)):
        upd, jstate, _ = jbank.update(_tree(g), jstate, params, jnp.asarray(i, jnp.int32))
        params = jax.tree.map(jnp.add, params, upd)
        _port_update(model, bank, g, i)
        want = _jax_moments(jbank, jstate, part)
        got = _moments(bank)
        assert set(got) == set(want)
        for key, ref in want.items():
            stored = got[key]
            wdt = torch.bfloat16 if dtype == "bfloat16" and (cycled or key[1] == "mu") \
                else torch.float32
            assert stored.dtype == wdt, (key, stored.dtype)
            assert ref.dtype == jnp.dtype(str(wdt).split(".")[1]), (key, ref.dtype)
            mine, ref = stored.to(torch.float32).numpy(), np.asarray(ref, np.float32)
            tol = 1e-5 * np.abs(ref).max() + 1e-9 if wdt == torch.float32 else _bf16_ulp(ref)
            assert (np.abs(mine - ref) <= tol).all(), (i, key, mine, ref)
        jflat = dict(zip(part.path_strings(), jax.tree.leaves(params)))
        for name, p in model.named_parameters():
            ref = np.asarray(jflat[name.replace(".", "/")], np.float32)
            tol = 1e-5 * np.abs(ref) + 1e-7 if dtype == "float32" else 2e-3 * LR + 1e-7
            mine = p.detach().numpy()
            assert (np.abs(mine - ref) <= tol).all(), (i, name, mine - ref)


@pytest.mark.parametrize("cycled", [True, False], ids=["cycled", "plain"])
def test_bf16_moments_halve_state_and_track_fp32(cycled):
    """tests/test_optim.py's own claim through the port's bank: bf16 moments
    hold half of fp32's bytes on the cycled route (on the plain route only
    mu is bf16: 3/4) and the parameters stay within 5e-4 of the fp32 run."""
    flat = tiny_params()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        model, bank = _port_bank(_cfg(dtype, cycled), flat)
        for i, g in enumerate(_grads(flat)):
            _port_update(model, bank, g, i)
        runs[dtype] = model, bank
    ratio = runs["bfloat16"][1].moment_bytes() / runs["float32"][1].moment_bytes()
    assert ratio == (0.5 if cycled else 0.75)
    for (n, a), (_, b) in zip(runs["float32"][0].named_parameters(),
                              runs["bfloat16"][0].named_parameters()):
        assert float((a - b).abs().max()) < 5e-4, n


def _trained(cfg, flat, n=2):
    from triad_tpu_torch.train.step import TrainState

    model, bank = _port_bank(cfg, flat)
    for i, g in enumerate(_grads(flat, n)):
        _port_update(model, bank, g, i)
    return TrainState(model, bank, n, 0)


@pytest.mark.parametrize("saved,running", [("bfloat16", "bfloat16"), ("float32", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_checkpoint_round_trip(saved, running, tmp_path):
    """A bank saved through CheckpointManager and restored into a new bank:
    the moments come back in the running config's dtypes (torch's
    Optimizer.load_state_dict alone would cast them to the parameters'
    fp32); in the saved dtype they are bit-equal, else the saved values
    cast."""
    from triad_tpu_torch.train.checkpoint import CheckpointManager, HostProgress

    flat = tiny_params()
    state = _trained(_cfg(saved, True), flat)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, HostProgress(), {})
    fresh = _trained(_cfg(running, True), flat, n=0)
    mgr.restore(fresh)
    want_dt = getattr(torch, running)
    before, after = _moments(state.bank), _moments(fresh.bank)
    assert set(before) == set(after)
    for key, m in before.items():
        assert after[key].dtype == want_dt, key
        assert torch.equal(after[key], m.to(want_dt)), key
    for g, opt in fresh.bank.opts.items():
        assert all(float(st["step"]) == 2.0 for st in opt.state.values()), g
    assert fresh.bank.moment_bytes() == sum(m.numel() * m.element_size() for m in after.values())
