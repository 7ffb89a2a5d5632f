"""The learning proofs of tests/test_learning.py run through the port on
the CPU: a tiny TriadModel trained from scratch on the grounded synthetic
correspondences (square position <-> tone frequency <-> word) through the
port's StepFactory and datasets, at the JAX test's own config, must

1. drop its loss by 0.5,
2. retrieve held-out items by class far above chance (A->V, T->V, and the
   transitive A->T, each >= 0.75 against 1/4),
3. localize the class square with the audio tokens' attention on at
   least 10 of 16 held-out clips;

and the port's Trainer must route config.data.synthetic_grounded to the
grounded datasets and train. Both are slow, as the JAX tests are: run
them apart from tier-1 with ``-m slow``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from triad_tpu_torch.config import (
    DistilBertConfig,
    HubertConfig,
    LossConfig,
    ModelConfig,
    OptimConfig,
    ViTConfig,
)
from triad_tpu_torch.data.datasets import (
    GroundedSyntheticAVDataset,
    GroundedSyntheticSpec,
    GroundedSyntheticTVDataset,
)

K = 4  # classes
AUDIO_SECONDS = 0.25


def grounded_model_config():
    return ModelConfig(
        embedding_dim=32,
        compute_dtype="float32",
        visual_dropout_prob=0.0,
        vit=ViTConfig(
            image_size=56, patch_size=14, hidden_size=32, num_layers=2,
            num_heads=4,
        ),
        hubert=HubertConfig(
            hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
            conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        ),
        text=DistilBertConfig(
            vocab_size=16, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=8,
        ),
    )


def token_id(k: int) -> int:
    return k + 2  # 0 = pad, 1 = unused


def av_batch_at(ds, idxs):
    items = [ds[int(i)] for i in idxs]
    return {
        "images": torch.from_numpy(np.stack([it["video_frames"] for it in items])),
        "audio": torch.from_numpy(np.stack([it["audio"] for it in items])),
    }


def tv_batch_at(ds, idxs):
    imgs, ids = [], []
    for i in idxs:
        img, _ = ds[int(i)]
        imgs.append(img)
        ids.append([token_id(ds.label(int(i))), 0])
    mask = np.zeros((len(idxs), 2), np.float32)
    mask[:, 0] = 1.0
    return {
        "images": torch.from_numpy(np.stack(imgs)),
        "token_ids": torch.from_numpy(np.array(ids, np.int64)),
        "text_mask": torch.from_numpy(mask),
    }


def maxmean_clip_sims(q: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(Nq, Tq, D) x (Nc, Tc, D) -> (Nq, Nc) max-over-candidate-tokens,
    mean-over-query-tokens of normalized token sims."""
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    c = c / (np.linalg.norm(c, axis=-1, keepdims=True) + 1e-12)
    tok = np.einsum("qtd,csd->qcts", q, c)
    return tok.max(axis=-1).mean(axis=-1)


@pytest.mark.slow
def test_learns_grounded_correspondence():
    from triad_tpu_torch.models.convert import init_triad_model
    from triad_tpu_torch.train.optim import OptimizerBank
    from triad_tpu_torch.train.step import StepFactory, TrainState

    cfg = grounded_model_config()
    spec = GroundedSyntheticSpec(num_classes=K)
    train_av = GroundedSyntheticAVDataset(size=64, audio_seconds=AUDIO_SECONDS, spec=spec, seed=0)
    train_tv = GroundedSyntheticTVDataset(size=64, spec=spec, seed=0)
    eval_av = GroundedSyntheticAVDataset(size=16, audio_seconds=AUDIO_SECONDS, spec=spec,
                                         seed=777)
    eval_tv = GroundedSyntheticTVDataset(size=16, spec=spec, seed=778)

    optim_cfg = OptimConfig(learning_rate=2e-3, gradient_accumulation_steps=1,
                            unfreeze_audio_step=0, unfreeze_text_step=0, unfreeze_vit_step=0)
    model = init_triad_model(cfg, torch.Generator().manual_seed(0))
    # 120 steps, as the JAX test (its measured sharpest localization)
    n_steps = 120
    state = TrainState(model, OptimizerBank(optim_cfg, model, total_updates=n_steps), 0, 1)
    step = StepFactory(LossConfig(), optim_cfg).make_step("joint")
    losses = []
    for s in range(n_steps):
        # one sample per class per batch: no same-class false negatives
        idxs = [(s * K + j) % len(train_av) for j in range(K)]
        state, metrics = step(state, av_batch_at(train_av, idxs), tv_batch_at(train_tv, idxs),
                              1.0, 1.0)
        losses.append(float(metrics["train_loss"]))
    assert np.isfinite(losses).all()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    assert last < first - 0.5, f"barely learned: {first:.3f} -> {last:.3f}"

    # --- held-out embeddings (fresh noise draws: seed disjoint) ---
    eav = av_batch_at(eval_av, range(16))
    etv = tv_batch_at(eval_tv, range(16))
    with torch.no_grad():
        a = model.encode_audio(eav["audio"]).numpy()
        v_of_av = model.encode_visual(eav["images"]).numpy()
        t = model.encode_text(etv["token_ids"], etv["text_mask"]).numpy()
        v_of_tv = model.encode_visual(etv["images"]).numpy()
    labels_av = np.array([eval_av.label(i) for i in range(16)])
    labels_tv = np.array([eval_tv.label(i) for i in range(16)])

    acc_av = float((labels_av[maxmean_clip_sims(a, v_of_av).argmax(1)] == labels_av).mean())
    assert acc_av >= 0.75, f"A->V class acc {acc_av} (chance {1 / K})"
    acc_tv = float((labels_tv[maxmean_clip_sims(t[:, :1], v_of_tv).argmax(1)]
                    == labels_tv).mean())
    assert acc_tv >= 0.75, f"T->V class acc {acc_tv}"
    # A->T: never trained against each other, only through the visual space
    acc_at = float((labels_tv[maxmean_clip_sims(a, t[:, :1]).argmax(1)] == labels_av).mean())
    assert acc_at >= 0.75, f"transitive A->T class acc {acc_at}"

    # --- DENSE grounding: audio attention localizes the class square ---
    an = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-12)
    vn = v_of_av / (np.linalg.norm(v_of_av, axis=-1, keepdims=True) + 1e-12)
    hits = 0
    for i in range(16):
        patch_score = np.einsum("td,pd->tp", an[i], vn[i]).mean(axis=0)
        r, c = spec.cell(labels_av[i])
        hits += int(patch_score.argmax() == r * spec.grid + c)
    print(f"loss {first:.4f} -> {last:.4f}; class acc A->V {acc_av}, T->V {acc_tv}, "
          f"A->T {acc_at}; square localized on {hits}/16")
    # chance = 1/16 per sample; 10+/16 is p < 1e-8 under no grounding
    assert hits >= 10, f"attention localized the square on {hits}/16"


@pytest.mark.slow
def test_trainer_grounded_synthetic_wiring(tmp_path):
    """config.data.synthetic_grounded routes the port's Trainer (train AND
    val datasets) to the grounded datasets and a short run trains."""
    from tests.test_torch_trainer import port_config
    from tests.test_trainer import tiny_config
    from triad_tpu_torch.train.trainer import Trainer

    cfg = port_config(tiny_config(tmp_path))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, synthetic_grounded=True, synthetic_grounded_classes=2))
    tr = Trainer(cfg, device="cpu")
    assert isinstance(tr.av_dataset, GroundedSyntheticAVDataset)
    assert isinstance(tr.tv_dataset, GroundedSyntheticTVDataset)
    assert isinstance(tr.val_av_dataset, GroundedSyntheticAVDataset)
    assert isinstance(tr.val_tv_dataset, GroundedSyntheticTVDataset)
    assert tr.av_dataset.spec.num_classes == 2
    # grounded captions flow through the corpus-built tokenizer
    assert tr.tv_dataset[0][1] in ("circle", "square")
    tr.train()
    assert (tmp_path / "run" / "metrics.jsonl").exists()
