"""The port's CheckpointManager (torch files in place of Orbax): the six
cases of tests/test_checkpoint.py on a port TrainState, an exact resume
inside a gradient-accumulation window, and the commit by rename.

The TrainState is the narrow model of tests/test_multimodal.py
(small_model_config: hidden 32, 2 layers per encoder, 28 px images) on
the CPU with its optimizer bank. Restored tensors are held bit-equal."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from tests.test_multimodal import small_model_config
from triad_tpu_torch.config import Config, OptimConfig
from triad_tpu_torch.train.checkpoint import (
    CheckpointManager,
    HostProgress,
    read_run_meta,
    warn_on_config_mismatch,
)


def _port_model_config():
    """tests/test_multimodal.py's small_model_config as the port's config."""
    return Config.from_dict({"model": dataclasses.asdict(small_model_config())}).model


def _state(seed=0, ocfg=None):
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import TrainState

    model = init_triad_model(_port_model_config(), torch.Generator().manual_seed(seed))
    ocfg = ocfg or OptimConfig(unfreeze_audio_step=0, unfreeze_text_step=0)
    return TrainState(model, OptimizerBank(ocfg, model, total_updates=10), 3, 7)


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _assert_params_equal(state, want):
    for n, p in state.model.named_parameters():
        assert torch.equal(p, want[n]), n


@pytest.fixture
def state():
    return _state()


def test_save_restore_latest(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path))
    prog = HostProgress(epoch=1, global_step=10, current_batch_idx=2,
                        dataset_segment=5, best_loss=3.5)
    want = _params(state)
    mgr.save(10, state, prog, {"a": 1}, extra={"note": "x"})
    assert mgr.latest_step() == 10
    fresh = _state(seed=1)
    restored, p2, cfg, extra = mgr.restore(fresh)
    assert restored is fresh
    _assert_params_equal(restored, want)
    assert (restored.global_step, restored.seed) == (3, 7)
    assert p2.epoch == 1 and p2.current_batch_idx == 2 and p2.dataset_segment == 5
    assert p2.best_loss == 3.5
    assert cfg == {"a": 1} and extra == {"note": "x"}


def test_best_kept_separately(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    prog = HostProgress(global_step=1, best_loss=5.0)
    want = _params(state)
    mgr.save(1, state, prog, {}, is_best=True)
    # later (worse) checkpoints must not clobber best
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    mgr.save(2, state, HostProgress(global_step=2), {})
    mgr.save(3, state, HostProgress(global_step=3), {})
    assert mgr.all_steps() == [2, 3]  # step 1 collected, best/ kept
    best, bp, _ = mgr.restore_best(_state(seed=1))
    _assert_params_equal(best, want)
    assert bp.best_loss == 5.0


def test_max_to_keep_gc(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state, HostProgress(global_step=s), {})
    assert mgr.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        mgr.restore(state, step=1)  # garbage-collected


def test_config_mismatch_warning():
    msgs = []
    warn_on_config_mismatch({"a": 1, "b": 2}, {"a": 1, "b": 3, "c": 4},
                            logger=msgs.append)
    joined = " ".join(msgs)
    assert "'b'" in joined and "'c'" in joined and "'a'" not in joined


def test_async_save_then_restore(tmp_path, state):
    """async_save: save returns after the host copy; restore drains the
    in-flight write and gets the same state + meta (one commit)."""
    mgr = CheckpointManager(str(tmp_path / "async"), async_save=True)
    prog = HostProgress(epoch=1, global_step=7, current_batch_idx=3)
    want = _params(state)
    mgr.save(7, state, prog, {"train": {"seed": 1}}, extra={"k": "v"})
    # the host copy is taken before save returns: later updates miss it
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(2.0)
    restored, p2, cfg, extra = mgr.restore(_state(seed=1))
    assert p2.global_step == 7 and p2.current_batch_idx == 3
    assert cfg == {"train": {"seed": 1}} and extra == {"k": "v"}
    _assert_params_equal(restored, want)
    assert mgr.timings[0]["step"] == 7 and mgr.timings[0]["write_s"] > 0
    mgr.close()


def test_read_run_meta(tmp_path, state):
    run = tmp_path / "run"
    mgr = CheckpointManager(str(run / "checkpoints"))
    mgr.save(3, state, HostProgress(global_step=3), {"train": {"seed": 9}})
    mgr.close()
    meta = read_run_meta(str(run))
    assert meta["config"]["train"]["seed"] == 9
    assert meta["progress"]["global_step"] == 3


def test_uncommitted_save_is_not_picked(tmp_path, state):
    """A save killed before its rename leaves a hidden temporary
    directory: latest_step and restore skip it, even at a later step."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, HostProgress(global_step=4), {})
    committed = tmp_path / "ckpts" / "4"
    half = tmp_path / "ckpts" / ".tmp-8-12345"
    shutil.copytree(committed, half)
    (half / "meta.json").write_text(json.dumps({"progress": {"global_step": 8}}))
    assert mgr.latest_step() == 4
    _, prog, _, _ = mgr.restore(_state(seed=1))
    assert prog.global_step == 4
    # a later save of the same step replaces it whole
    mgr.save(4, state, HostProgress(global_step=4, epoch=2), {})
    assert mgr.restore(_state(seed=1))[1].epoch == 2


def _batches(step):
    rng = np.random.default_rng(100 + step)
    mask = np.ones((2, 8), np.float32)
    mask[1, 5:] = 0.0
    av = {"images": torch.from_numpy(rng.normal(size=(2, 28, 28, 3)).astype(np.float32)),
          "audio": torch.from_numpy((rng.normal(size=(2, 1600)) * 0.1).astype(np.float32))}
    tv = {"images": torch.from_numpy(rng.normal(size=(2, 28, 28, 3)).astype(np.float32)),
          "token_ids": torch.from_numpy(rng.integers(1, 100, size=(2, 8))),
          "text_mask": torch.from_numpy(mask)}
    return av, tv


def _snapshot(state):
    """Parameters, .grads, every AdamW state tensor, counts, step."""
    bank = state.bank
    return {
        "params": _params(state),
        "grads": {n: None if p.grad is None else p.grad.clone()
                  for n, p in state.model.named_parameters()},
        "opts": {g: {i: {k: v.clone() for k, v in s.items()}
                     for i, s in o.state_dict()["state"].items()}
                 for g, o in bank.opts.items()},
        "counts": dict(bank.counts),
        "global_step": state.global_step,
    }


def _assert_same(a, b):
    assert a["counts"] == b["counts"] and a["global_step"] == b["global_step"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
        ga, gb = a["grads"][n], b["grads"][n]
        assert (ga is None) == (gb is None), n
        if ga is not None:
            assert torch.equal(ga, gb), n
    assert a["opts"].keys() == b["opts"].keys()
    for g in a["opts"]:
        assert a["opts"][g].keys() == b["opts"][g].keys(), g
        for i in a["opts"][g]:
            for k in a["opts"][g][i]:
                assert torch.equal(a["opts"][g][i][k], b["opts"][g][i][k]), (g, i, k)


def test_resume_inside_accumulation_window_is_exact(tmp_path):
    """A narrow joint step with accumulation 2 and every dropout live,
    saved after one micro step (mid-window: the .grads hold a half-summed
    gradient) and restored into a state built from another seed, goes on
    bit-equal to the uninterrupted run: parameters, .grads, AdamW
    moments and step counts, the bank's counts, after each of 3 more
    micro steps (two updates)."""
    from triad_tpu_torch.config import perf_train_loss_config
    from triad_tpu_torch.train.step import StepFactory

    ocfg = OptimConfig(gradient_accumulation_steps=2, unfreeze_audio_step=0,
                       unfreeze_text_step=0, unfreeze_vit_step=0)
    loss_cfg = dataclasses.replace(perf_train_loss_config(), volume_dtype="float32")
    step = StepFactory(loss_cfg, ocfg).make_step("joint")
    state = _state(seed=0, ocfg=ocfg)
    state.global_step = 0
    state, _ = step(state, *_batches(0), 0.7, 0.3)
    assert all(p.grad is not None for p in state.model.audio_backbone.parameters())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, HostProgress(global_step=1), {})
    want = []
    for s in range(1, 4):
        state, m = step(state, *_batches(s), 0.7, 0.3)
        want.append((float(m["train_loss"]), _snapshot(state)))
    assert state.bank.counts["audio"] == 2

    resumed, prog, _, _ = mgr.restore(_state(seed=5, ocfg=ocfg))
    assert resumed.global_step == 1 and prog.global_step == 1
    for s in range(1, 4):
        resumed, m = step(resumed, *_batches(s), 0.7, 0.3)
        assert float(m["train_loss"]) == want[s - 1][0]
        _assert_same(_snapshot(resumed), want[s - 1][1])
