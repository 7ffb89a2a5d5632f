"""The port's Trainer on the CPU, at tests/test_trainer.py:tiny_config's
size (hidden 32, 2 layers per encoder, 28 px images, 1600 audio samples,
B = 2): the curriculum against the JAX Trainer's, a short run's
artifacts, an exact mid-epoch resume, the routes that raise, and one
full_joint epoch against the JAX Trainer on the same weights and data;
the pretrained start: from per-backbone files, and from one reference
checkpoint beside the JAX Trainer (bit-equal start, first epoch's losses
at the tolerance below).

Tolerances of the JAX comparison (fp32 on both sides, every dropout rate
0, the JAX Pallas kernels as the JAX Trainer runs them on the CPU, the
port's wrappers on their plain versions), as
tests/test_torch_train_step.py states them: the logged train_loss and
the validation loss 1e-4 of their magnitude plus 1e-5; the final
parameters 2 updates x 2 lr_max + 1e-6 absolute (each Adam update moves
a leaf by about lr (1 + weight decay), and a gradient that is zero up to
rounding may take either sign in the two packages); the retrieval
recalls equal, after a check that no two competing scores lie within
1e-4 of the largest score of each other (else the recalls would not be
decidable at fp32 and the test says so).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_multimodal import small_model_config
from tests.test_trainer import tiny_config
from triad_tpu_torch.config import Config

LR_MAX = 1e-4  # OptimConfig.learning_rate: every group's peak lr is at most this


def port_config(jax_cfg, **train):
    """The port's Config of a JAX Config (field-equal copies), with train
    fields replaced."""
    d = dataclasses.asdict(jax_cfg)
    d["train"].update(train)
    return Config.from_dict(d)


def _metrics(run_dir):
    return [json.loads(line) for line in
            (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _train_losses(run_dir):
    return {int(m["global_step"]): m["train_loss"] for m in _metrics(run_dir)
            if "train_loss" in m}


def test_phase_for_epoch_matches_jax():
    from triad_tpu.train.trainer import Trainer as JaxTrainer
    from triad_tpu_torch.train.trainer import Trainer

    base = tiny_config(Path("/nonexistent"))
    grid = [(1, 1, 2, 0.8, 0.5), (0, 0, 0, 0.8, 0.5), (2, 0, 3, 0.9, 0.1),
            (0, 3, 1, 0.7, 0.7), (1, 2, 4, 1.0, 0.0)]
    for av, tv, wj, start, end in grid:
        jcfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, av_focus_epochs=av, tv_warmup_epochs=tv, weighted_joint_epochs=wj,
            av_weight_start=start, av_weight_end=end, num_epochs=12))

        class JStub:
            config = jcfg

        class Stub:
            config = port_config(jcfg)

        for epoch in range(12):
            assert Trainer.phase_for_epoch(Stub, epoch) == \
                JaxTrainer.phase_for_epoch(JStub, epoch), (av, tv, wj, epoch)


def test_short_run_writes_metrics_checkpoint_and_viz(tmp_path):
    from triad_tpu_torch.train.trainer import Trainer

    cfg = port_config(tiny_config(tmp_path), vis_every=2)
    trainer = Trainer(cfg, force_new_training=True, device="cpu")
    trainer.train()
    out = Path(cfg.train.output_dir)
    lines = _metrics(out)
    assert any("train_loss" in m and "step_time_ms" in m for m in lines)
    assert any(k.startswith("retrieval_") for m in lines for k in m)
    assert any(k.startswith("val_") for m in lines for k in m)
    assert all(np.isfinite(v) for v in _train_losses(out).values())
    assert trainer.ckpt.latest_step() == 3
    assert (out / "checkpoints" / "best" / "state.pt").exists()
    for name in ("av_0.png", "av_1.png", "tv_0.png", "tv_1.png", "av_0_attention.mp4"):
        assert (out / "viz" / "epoch_0" / name).stat().st_size > 0, name
    assert trainer.video_writer is not None
    # the viz hook after step 2 restarts the timer: steps 1 and 2 timed
    assert [label for label, _ in trainer.timer.history] == ["full_joint"] * 2
    assert len(trainer.timings["viz"]) == 1


def _payload(run_dir):
    from triad_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(Path(run_dir) / "checkpoints"))
    step = mgr.latest_step()
    d = mgr._steps_dir / str(step)
    return (torch.load(d / "state.pt", weights_only=True),
            json.loads((d / "meta.json").read_text())["progress"])


def _assert_tree_equal(a, b, path=""):
    assert type(a) is type(b), path
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def test_mid_epoch_resume_is_bit_equal(tmp_path):
    """Two epochs of 3 steps, accumulation 2, dropouts live, a save at
    step 5 (cursor: epoch 1, batch 2; inside an accumulation window).
    A second run directory holding only that checkpoint resumes from it
    and ends bit-equal to the uninterrupted run: every tensor of the
    final checkpoint (model, AdamW states, counts, .grads), the progress,
    and the train_loss logged after the resume."""
    import shutil

    from triad_tpu_torch.config import OptimConfig
    from triad_tpu_torch.train.trainer import Trainer

    base = tiny_config(tmp_path)
    optim = dataclasses.asdict(OptimConfig(gradient_accumulation_steps=2, unfreeze_audio_step=1,
                                           unfreeze_text_step=1, unfreeze_vit_step=1))
    cfg_a = port_config(base, num_epochs=2, save_every_steps=4, optim=optim,
                        output_dir=str(tmp_path / "a"))
    cfg_b = dataclasses.replace(cfg_a, train=dataclasses.replace(
        cfg_a.train, output_dir=str(tmp_path / "b")))
    Trainer(cfg_a, force_new_training=True, device="cpu").train()
    saved = tmp_path / "a" / "checkpoints" / "ckpts" / "5"
    meta = json.loads((saved / "meta.json").read_text())["progress"]
    assert (meta["epoch"], meta["current_batch_idx"]) == (1, 2)
    assert torch.load(saved / "state.pt", weights_only=True)["grads"]  # mid-window
    shutil.copytree(saved, tmp_path / "b" / "checkpoints" / "ckpts" / "5")
    for leg in ("av", "tv"):
        shutil.copy(tmp_path / "a" / f"retrieval_subset_{leg}.json", tmp_path / "b")
    resumed = Trainer(cfg_b, force_new_training=False, device="cpu")
    assert resumed.progress.global_step == 5
    resumed.train()
    (pa, prog_a), (pb, prog_b) = _payload(tmp_path / "a"), _payload(tmp_path / "b")
    assert pa["global_step"] == 6
    _assert_tree_equal(pa, pb)
    assert prog_a == prog_b
    after = {s: v for s, v in _train_losses(tmp_path / "b").items()}
    assert after and all(_train_losses(tmp_path / "a")[s] == v for s, v in after.items())


@pytest.mark.parametrize("route", ["tp", "fsdp"])
def test_not_ported_routes_raise(tmp_path, monkeypatch, route):
    """Tensor parallelism and FSDP are ported; what they still refuse is
    refused before anything is written: at tp 2, a split inside a head
    (3 heads; GSPMD would re-gather) raises not_ported; under FSDP an
    explicit kernel knob raises JAX's resolve_xla_impls error."""
    from triad_tpu_torch.parallel import collectives as C
    from triad_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(C, "world", lambda group=None: 2)
    cfg = port_config(tiny_config(tmp_path))
    if route == "tp":
        mesh = dataclasses.replace(cfg.mesh, num_devices=2, tp=2)
        model = dataclasses.replace(cfg.model, text=dataclasses.replace(
            cfg.model.text, hidden_size=30, num_heads=3))
        err, text = NotImplementedError, "GSPMD"
    else:
        mesh = dataclasses.replace(cfg.mesh, num_devices=2, fsdp=True)
        model = dataclasses.replace(cfg.model, hubert=dataclasses.replace(
            cfg.model.hubert, mlp_impl="fused"))
        err, text = ValueError, "mesh.tp > 1 requires XLA impls; hubert.mlp_impl='fused'"
    cfg = dataclasses.replace(cfg, mesh=mesh, model=model)
    with pytest.raises(err) as info:
        Trainer(cfg, force_new_training=True, device="cpu")
    assert text in str(info.value)
    assert not Path(cfg.train.output_dir).exists()  # raised before writing


def test_default_device_without_card_raises(tmp_path):
    from triad_tpu_torch.train.trainer import Trainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(port_config(tiny_config(tmp_path)), force_new_training=True)


def _parity_model_config():
    m = small_model_config(visual_dropout_prob=0.0)
    return dataclasses.replace(
        m,
        hubert=dataclasses.replace(m.hubert, hidden_dropout=0.0, activation_dropout=0.0,
                                   attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
                                   apply_spec_augment=False),
        text=dataclasses.replace(m.text, dropout=0.0, attention_dropout=0.0))


def _min_score_gap(trainer):
    """The smallest |s_ii - s_ij| over the rows of each retrieval
    direction's score matrix (the port's final model), over the largest
    |s|."""
    from triad_tpu_torch.eval.retrieval import embed_av_subset, embed_tv_subset, score_matrix

    cfg = trainer.config
    temp = float(trainer.model.temperature.detach())
    out = trainer.output_dir
    idx = json.loads((out / "retrieval_subset_av.json").read_text())
    a, am, v = embed_av_subset(trainer._enc_av, trainer.val_av_dataset, idx,
                               cfg.data.audio_num_samples,
                               num_tokens_fn=cfg.model.hubert.num_audio_tokens)
    idx = json.loads((out / "retrieval_subset_tv.json").read_text())
    t, tm, vt = embed_tv_subset(trainer._enc_tv, trainer.val_tv_dataset, idx, trainer.tokenizer,
                                cfg.data.max_text_tokens)
    ones = np.ones(v.shape[:2], np.float32)
    gaps = []
    for q, qm, k, km in ((a, am, v, ones), (v, ones, a, am), (t, tm, vt, ones),
                         (vt, ones, t, tm)):
        s = score_matrix(q, qm, k, km, temp, device="cpu")
        diag = np.diag(s)[:, None]
        off = ~np.eye(len(s), dtype=bool)
        gaps.append(float(np.abs(diag - s)[off].min() / np.abs(s).max()))
    return min(gaps)


def test_matches_jax_trainer(tmp_path):
    """One full_joint epoch of 2 steps, every dropout rate 0, the port's
    initial weights carried into the JAX Trainer, the same synthetic
    data and retrieval subsets: the logged train_loss, the validation
    loss, the final parameters and the retrieval recalls."""
    import jax
    import jax.numpy as jnp

    from triad_tpu.train.trainer import Trainer as JaxTrainer
    from triad_tpu_torch.models.convert import _flatten, torch_to_flax
    from triad_tpu_torch.train.trainer import Trainer

    jcfg = tiny_config(tmp_path)
    jcfg = dataclasses.replace(jcfg, model=_parity_model_config(), train=dataclasses.replace(
        jcfg.train, steps_per_epoch=2, output_dir=str(tmp_path / "jax")))
    pcfg = port_config(jcfg, output_dir=str(tmp_path / "port"))
    for run in ("jax", "port"):
        (tmp_path / run).mkdir()
        for leg in ("av", "tv"):
            (tmp_path / run / f"retrieval_subset_{leg}.json").write_text(json.dumps([5, 2, 7, 0]))
    port = Trainer(pcfg, force_new_training=True, device="cpu")
    ref = JaxTrainer(jcfg, force_new_training=True)
    ref.state = ref.state.replace(params=jax.tree.map(
        jnp.asarray, torch_to_flax(port.model.state_dict())))
    port.train()
    ref.train()

    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for key in ("train_loss", "val_train_loss"):
        g = [m[key] for m in got if key in m]
        w = [m[key] for m in want if key in m]
        assert len(g) == len(w) > 0, key
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=key)

    gap = _min_score_gap(port)
    assert gap > 1e-4, (f"two retrieval scores lie within {gap:.3g} of the scale of each other: "
                        "the recalls are not decidable at fp32")
    rec_g = {k: v for m in got for k, v in m.items() if k.startswith("retrieval_")}
    rec_w = {k: v for m in want for k, v in m.items() if k.startswith("retrieval_")}
    assert rec_g and rec_g == rec_w

    final = dict(_flatten(torch_to_flax(port.model.state_dict())))
    ref_final = dict(_flatten(jax.tree.map(np.asarray, ref.state.params)))
    assert final.keys() == ref_final.keys()
    for k, v in ref_final.items():
        np.testing.assert_allclose(final[k], v, rtol=0, atol=2 * 2 * LR_MAX + 1e-6,
                                   err_msg=str(k))


def _pretrained_files(tmp_path, cfg):
    """Per-backbone files written from seeds in their published layouts:
    HuBERT as a 2-shard safetensors snapshot with the legacy weight-norm
    names, DistilBERT as a task model's pytorch_model.bin, DINOv2 as a
    torch.hub file under teacher / backbone."""
    from triad_tpu_torch.tools import hf_layout

    paths = {"hubert": str(tmp_path / "hubert"), "text": str(tmp_path / "distilbert"),
             "vit": str(tmp_path / "dinov2_vitb14_reg4_pretrain.pth")}
    hf_layout.write_snapshot(paths["hubert"], "hubert", cfg.hubert, 11, fmt="sharded",
                             legacy_weight_norm=True)
    hf_layout.write_snapshot(paths["text"], "distilbert", cfg.text, 12, fmt="bin", task=True)
    hf_layout.write_hub_dinov2(paths["vit"], cfg.vit, 13, wrap="teacher")
    return paths


def test_trainer_from_snapshots_carries_the_backbones(tmp_path, capsys):
    """A Trainer whose config names the three files starts from the
    importer's state_dict exactly: the backbones as imported, the heads
    and temperature the seeded fresh init; it logs what it loaded."""
    from triad_tpu_torch.models.hf_import import init_params_from_pretrained
    from triad_tpu_torch.train.trainer import Trainer

    cfg = port_config(tiny_config(tmp_path))
    paths = _pretrained_files(tmp_path, cfg.model)
    cfg = dataclasses.replace(cfg, pretrained=dataclasses.replace(cfg.pretrained, **paths))
    trainer = Trainer(cfg, force_new_training=True, device="cpu")
    assert "Loaded pretrained weights: hubert=" in capsys.readouterr().out
    want = init_params_from_pretrained(cfg.model, torch.Generator().manual_seed(cfg.train.seed),
                                       hubert_path=paths["hubert"], text_path=paths["text"],
                                       vit_path=paths["vit"])
    got = trainer.model.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not trainer.model.visual_backbone.blocks[0].attn.qkv.weight.requires_grad
    trainer.train()
    assert all(np.isfinite(v) for v in _train_losses(cfg.train.output_dir).values())


def test_reference_checkpoint_start_matches_jax_trainer(tmp_path):
    """The port's and the JAX Trainer built from one reference checkpoint
    (every parameter in it) start bit-equal, and their first epoch's
    logged losses agree at rtol 1e-4, atol 1e-5 (as test_matches_jax_trainer)."""
    import jax

    from triad_tpu.train.trainer import Trainer as JaxTrainer
    from triad_tpu_torch.models.convert import _flatten, torch_to_flax
    from triad_tpu_torch.tools.hf_layout import write_reference_checkpoint
    from triad_tpu_torch.train.trainer import Trainer

    jcfg = tiny_config(tmp_path)
    jcfg = dataclasses.replace(jcfg, model=_parity_model_config(), train=dataclasses.replace(
        jcfg.train, steps_per_epoch=2, output_dir=str(tmp_path / "jax")))
    ckpt = str(tmp_path / "checkpoint_epoch3_step1200.pt")
    write_reference_checkpoint(ckpt, port_config(jcfg).model, seed=21)
    jcfg = dataclasses.replace(jcfg, pretrained=dataclasses.replace(
        jcfg.pretrained, reference_checkpoint=ckpt))
    pcfg = port_config(jcfg, output_dir=str(tmp_path / "port"))
    port = Trainer(pcfg, force_new_training=True, device="cpu")
    ref = JaxTrainer(jcfg, force_new_training=True)
    start = dict(_flatten(torch_to_flax(port.model.state_dict())))
    ref_start = dict(_flatten(jax.tree.map(np.asarray, ref.state.params)))
    assert start.keys() == ref_start.keys()
    for k, v in ref_start.items():
        assert np.array_equal(start[k], v), k
    port.train()
    ref.train()
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for key in ("train_loss", "val_train_loss"):
        g = [m[key] for m in got if key in m]
        w = [m[key] for m in want if key in m]
        assert len(g) == len(w) > 0, key
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=key)
