"""1000-way cross-modal retrieval (R@1/5/10/20, four directions): the
port of ``triad_tpu/eval/retrieval.py`` and of the trainer's
``eval_1000_way_retrieval`` (``triad_tpu/train/trainer.py:908-960``).

Reference protocol (kept for parity, as in the JAX package):
  * a persisted random subset of 1000 items;
  * no-augmentation re-embedding: AV features L2-normalized, TV features
    NOT normalized and the text mask-truncated (asymmetric on purpose);
  * per-pair aggregator: token_sims = Q.K^T / temperature (divided here,
    multiplied in training), max over candidate tokens, mean over query
    tokens;
  * R@K from the rank of the diagonal.

``score_matrix`` is ``_score_all``'s blocked running masked max-mean: query
blocks of ``block`` items against key blocks of ``key_block`` items, N
padded to a multiple of both with fully-masked items. Its products are
``torch.matmul`` in fp32 (the JAX package leaves them to XLA), with TF32
off at ``precision="highest"``, the default.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from triad_tpu_torch.data.audio import pad_or_trim
from triad_tpu_torch.parallel import collectives as C


def select_subset_indices(dataset_size: int, subset_file: str,
                          subset_size: int = 1000) -> List[int]:
    """Load-or-create the persisted subset (reference retrieval.py:9-30).

    Multi-process: rank 0 loads or creates it and broadcasts it to every
    rank (each must embed the same subset; the ranks need not share a
    file system, and a concurrent create and read of the JSON would
    race)."""
    if C.world() > 1:
        # Fixed-size wire format: slot 0 the true length, then the subset
        # zero-padded.
        buf = torch.zeros(subset_size + 1, dtype=torch.int64, device=C.collective_device())
        if C.rank() == 0:
            subset = _load_or_create_subset(dataset_size, subset_file, subset_size)[:subset_size]
            buf[0] = len(subset)
            buf[1:1 + len(subset)] = torch.tensor(subset, dtype=torch.int64)
        buf = C.broadcast_(buf, 0).cpu()
        return [int(i) for i in buf[1:1 + int(buf[0])]]
    return _load_or_create_subset(dataset_size, subset_file, subset_size)


def _load_or_create_subset(dataset_size: int, subset_file: str,
                           subset_size: int) -> List[int]:
    if os.path.exists(subset_file):
        with open(subset_file) as f:
            indices = json.load(f)
        print(f"Loaded {len(indices)} subset indices from {subset_file}")
        return indices
    indices = list(range(dataset_size))
    random.shuffle(indices)
    subset = indices[:subset_size]
    tmp = subset_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(subset, f)
    os.replace(tmp, subset_file)
    print(f"Created new subset of size {len(subset)} -> {subset_file}")
    return subset


# ---------------------------------------------------------------------------
# Vectorized scoring
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """"highest": fp32 products with TF32 off; "default": TF32 allowed."""
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown precision {precision!r} (expected highest or default)")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "default"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _score_all(q_tokens, q_mask, k_tokens, k_mask, inv_temp, qb: int, kb: int) -> torch.Tensor:
    """Full (N, N) aggregated scores: for each block of qb queries and kb
    candidates, the (qb*Nq, D) x (D, kb*Nk) product times 1/T, masked
    candidate tokens at finfo.min, max over candidate tokens, mean over
    the query's real tokens (at least one)."""
    n, nq, d = q_tokens.shape
    nk = k_tokens.shape[1]
    neg = torch.finfo(torch.float32).min
    out = torch.empty((n, n), dtype=torch.float32, device=q_tokens.device)
    for i in range(0, n, qb):
        q2 = q_tokens[i:i + qb].reshape(qb * nq, d)
        qm = q_mask[i:i + qb]
        counts = torch.clamp(qm.sum(dim=1), min=1.0)
        for j in range(0, n, kb):
            sims = (q2 @ k_tokens[j:j + kb].reshape(kb * nk, d).T) * inv_temp
            sims = sims.reshape(qb, nq, kb, nk)
            sims = torch.where(k_mask[j:j + kb][None, None] > 0, sims, neg)
            mx = sims.amax(dim=3)  # (qb, Nq, kb)
            out[i:i + qb, j:j + kb] = (mx * qm[:, :, None]).sum(dim=1) / counts[:, None]
    return out


def score_matrix(q_tokens: np.ndarray, q_mask: np.ndarray, k_tokens: np.ndarray,
                 k_mask: np.ndarray, temperature: float, block: int = 8, key_block: int = 16,
                 precision: str = "highest", device="cuda") -> np.ndarray:
    """Full (N, N) aggregated similarity matrix, computed on ``device``.

    N is padded up to a block multiple with fully-masked items: padded
    *candidates* score finfo.min against everything (ranked last);
    padded *query* rows are sliced off before returning."""
    n = q_tokens.shape[0]
    lcm = block * key_block // np.gcd(block, key_block)
    n_pad = int(np.ceil(n / lcm)) * lcm

    def on_device(x):
        x = np.asarray(x, np.float32)
        if n_pad != n:
            x = np.pad(x, [(0, n_pad - n)] + [(0, 0)] * (x.ndim - 1))
        return torch.from_numpy(x).to(device)

    inv_temp = torch.tensor(np.float32(1.0 / temperature), device=device)
    with _matmul_precision(precision), torch.no_grad():
        out = _score_all(*map(on_device, (q_tokens, q_mask, k_tokens, k_mask)), inv_temp, block,
                         key_block)
    return out.cpu().numpy()[:n, :n]


def compute_recall_at_k(sim_matrix: np.ndarray) -> Dict[str, float]:
    """R@{1,5,10,20} of the diagonal (reference retrieval.py:117-144)."""
    n = sim_matrix.shape[0]
    order = np.argsort(-sim_matrix, axis=1)
    ranks = np.argmax(order == np.arange(n)[:, None], axis=1)
    return {
        "r1": float(np.mean(ranks < 1)),
        "r5": float(np.mean(ranks < 5)),
        "r10": float(np.mean(ranks < 10)),
        "r20": float(np.mean(ranks < 20)),
    }


# ---------------------------------------------------------------------------
# Embedding and the metrics
# ---------------------------------------------------------------------------


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


def embed_av_subset(encode_fn, dataset, indices: List[int], audio_num_samples: int,
                    batch_size: int = 8,
                    num_tokens_fn=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """No-augmentation embedding of the AV subset, L2-normalized
    (reference retrieval.py:32-104).

    encode_fn(images (B,H,W,3), audio (B,T)) -> (audio_feats, visual_feats),
    fed CPU fp32 tensors. Returns (audio_tokens (N,Na,D), audio_mask (N,Na),
    visual_tokens (N,Nv,D)); the audio mask flags frames produced by real
    (non-padding) audio. ``num_tokens_fn(num_samples) -> num_tokens`` gives
    the exact conv-stack length map (HubertConfig.num_audio_tokens);
    without it a proportional approximation is used."""
    a_list, am_list, v_list = [], [], []
    for lo in range(0, len(indices), batch_size):
        chunk = indices[lo:lo + batch_size]
        items = [dataset.__getitem__(int(i), apply_augmentation=False) for i in chunk]
        images = np.stack([it["video_frames"] for it in items]).astype(np.float32)
        raw_lens = [min(len(it["audio"]), audio_num_samples) for it in items]
        audio = np.stack([pad_or_trim(it["audio"], audio_num_samples) for it in items])
        a_feats, v_feats = encode_fn(torch.from_numpy(images), torch.from_numpy(audio))
        a_feats, v_feats = _host(a_feats), _host(v_feats)
        na = a_feats.shape[1]
        for b, raw_len in enumerate(raw_lens):
            if num_tokens_fn is not None:
                valid = max(1, min(na, num_tokens_fn(raw_len)))
            else:
                valid = max(1, int(na * raw_len / audio_num_samples))
            mask = np.zeros(na, np.float32)
            mask[:valid] = 1.0
            a_list.append(a_feats[b])
            am_list.append(mask)
            v_list.append(v_feats[b])
    return _l2(np.stack(a_list)), np.stack(am_list), _l2(np.stack(v_list))


def embed_tv_subset(encode_fn, dataset, indices: List[int], tokenizer, max_text_tokens: int,
                    batch_size: int = 8) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TV subset embedding: text mask-truncated, NOT normalized (reference
    retrieval.py:200-248 asymmetry, kept). encode_fn(images, ids, mask)
    -> (text_feats, visual_feats), fed CPU tensors."""
    t_list, tm_list, v_list = [], [], []
    for lo in range(0, len(indices), batch_size):
        chunk = indices[lo:lo + batch_size]
        items = [dataset.__getitem__(int(i), apply_augmentation=False) for i in chunk]
        images = np.stack([img for img, _ in items]).astype(np.float32)
        captions = [cap for _, cap in items]
        ids, mask = tokenizer.encode_batch(captions, max_length=max_text_tokens,
                                           pad_to=max_text_tokens)
        t_feats, v_feats = encode_fn(torch.from_numpy(images), torch.from_numpy(ids),
                                     torch.from_numpy(mask))
        t_list.append(_host(t_feats))
        tm_list.append(mask.astype(np.float32))
        v_list.append(_host(v_feats))
    return np.concatenate(t_list), np.concatenate(tm_list), np.concatenate(v_list)


def _l2(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    norm = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norm, eps)


def _two_way(name_a: str, name_b: str, a_tokens, a_mask, b_tokens, b_mask, temperature,
             device) -> Dict[str, float]:
    """A->B and B->A recall under the keys '<A>-><B>_r<K>'."""
    out = {}
    for (qn, qt, qm), (kn, kt, km) in (((name_a, a_tokens, a_mask), (name_b, b_tokens, b_mask)),
                                       ((name_b, b_tokens, b_mask), (name_a, a_tokens, a_mask))):
        sims = score_matrix(qt, qm, kt, km, temperature, device=device)
        out.update({f"{qn}->{kn}_r{k[1:]}": v for k, v in compute_recall_at_k(sims).items()})
    return out


def av_retrieval_metrics(audio_tokens, audio_mask, visual_tokens, temperature: float,
                         device="cuda") -> Dict[str, float]:
    """A->V and V->A recall (reference retrieval.py:146-188)."""
    v_mask = np.ones(visual_tokens.shape[:2], np.float32)
    return _two_way("A", "V", audio_tokens, audio_mask, visual_tokens, v_mask, temperature,
                    device)


def tv_retrieval_metrics(text_tokens, text_mask, visual_tokens, temperature: float,
                         device="cuda") -> Dict[str, float]:
    """T->V and V->T recall (reference retrieval.py:250-292)."""
    v_mask = np.ones(visual_tokens.shape[:2], np.float32)
    return _two_way("T", "V", text_tokens, text_mask, visual_tokens, v_mask, temperature,
                    device)


def at_retrieval_metrics(audio_tokens, audio_mask, text_tokens, text_mask, temperature: float,
                         device="cuda") -> Dict[str, float]:
    """A->T and T->A recall, the transitive tri-modal direction the
    reference never measures (for datasets that carry all three
    modalities per item); both sides masked."""
    return _two_way("A", "T", audio_tokens, audio_mask, text_tokens, text_mask, temperature,
                    device)


def eval_1000_way_retrieval(model, av_dataset, tv_dataset, tokenizer, cfg, output_dir,
                            device="cuda") -> Dict[str, float]:
    """Trainer.eval_1000_way_retrieval without the Trainer: the AV and TV
    subsets (either dataset may be None) embedded by ``model`` (a
    TriadModel on ``device``) at eval, scored in four directions at the
    model's temperature. ``cfg``: the run's Config (retrieval_subset_size,
    audio_num_samples, max_text_tokens, HubertConfig.num_audio_tokens).
    The subset files go to ``output_dir``. Runs on the card unless the
    caller passes device="cpu"; raises when the card is asked for and
    absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eval_1000_way_retrieval: no CUDA device (pass device='cpu' to run "
                           "on the CPU)")
    if any(p.device.type != device.type for p in model.parameters()):
        raise ValueError(f"eval_1000_way_retrieval: the model is not on {device}")
    model.eval()
    output_dir = Path(output_dir)
    temp = float(model.temperature.detach())
    subset_size = min(cfg.train.retrieval_subset_size,
                      len(av_dataset or []) or 10 ** 9,
                      len(tv_dataset or []) or 10 ** 9)
    out: Dict[str, float] = {}
    if av_dataset is not None:
        indices = select_subset_indices(len(av_dataset),
                                        str(output_dir / "retrieval_subset_av.json"),
                                        subset_size)

        @torch.inference_mode()
        def enc_av(images, audio):
            return (model.encode_audio(audio.to(device)),
                    model.encode_visual(images.to(device)))

        a, am, v = embed_av_subset(enc_av, av_dataset, indices, cfg.data.audio_num_samples,
                                   num_tokens_fn=cfg.model.hubert.num_audio_tokens)
        out.update(av_retrieval_metrics(a, am, v, temp, device))
    if tv_dataset is not None:
        indices = select_subset_indices(len(tv_dataset),
                                        str(output_dir / "retrieval_subset_tv.json"),
                                        subset_size)

        @torch.inference_mode()
        def enc_tv(images, ids, mask):
            return (model.encode_text(ids.to(device), mask.to(device)),
                    model.encode_visual(images.to(device)))

        t, tm, v = embed_tv_subset(enc_tv, tv_dataset, indices, tokenizer,
                                   cfg.data.max_text_tokens)
        out.update(tv_retrieval_metrics(t, tm, v, temp, device))
    return out

