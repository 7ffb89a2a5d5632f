"""The port's 1000-way retrieval eval against the JAX package, on the CPU,
at small sizes: ``score_matrix`` (N not a multiple of the blocks, masks on
both sides), ``compute_recall_at_k``, the persisted subset file, the
synthetic datasets (bit-equal items for the same seed and index), and
the slice as a whole: a narrow model on the head-pair attention and the
"pallas" frontend, its weights handed to the JAX model, 16 synthetic
items embedded by both packages' ``embed_*_subset`` and scored in the AV,
TV and AT directions.

fp32 with TF32 off. Tolerances: scores 1e-4 of the largest |score| (fp32
sums in another order); embeddings 1e-4 of the largest value; the metric
dicts equal.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_pair_attention import build_models, pair_model_config

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _tokens(rng, n, t, d, masked):
    x = rng.normal(size=(n, t, d)).astype(np.float32)
    m = np.ones((n, t), np.float32)
    if masked:
        m[:, t // 2:] = (rng.uniform(size=(n, t - t // 2)) > 0.5).astype(np.float32)
    return x, m


def test_score_matrix_matches_jax():
    """N = 21 (padded to 32 by the 8 x 16 blocks), both sides masked."""
    from triad_tpu.eval.retrieval import score_matrix as jax_score
    from triad_tpu_torch.eval.retrieval import score_matrix

    rng = np.random.default_rng(0)
    q, qm = _tokens(rng, 21, 7, 16, True)
    k, km = _tokens(rng, 21, 5, 16, True)
    ref = jax_score(q, qm, k, km, 0.7)
    got = score_matrix(q, qm, k, km, 0.7, device="cpu")
    assert got.shape == (21, 21)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_recall_at_k_matches_jax():
    from triad_tpu.eval.retrieval import compute_recall_at_k as jax_recall
    from triad_tpu_torch.eval.retrieval import compute_recall_at_k

    rng = np.random.default_rng(1)
    sims = rng.normal(size=(40, 40)).astype(np.float32)
    sims[np.arange(40), np.arange(40)] += np.linspace(0, 3, 40, dtype=np.float32)
    assert compute_recall_at_k(sims) == jax_recall(sims)


def test_subset_file_round_trip(tmp_path):
    """Created once, loaded after; the JAX package reads the same file to
    the same subset."""
    from triad_tpu.eval.retrieval import select_subset_indices as jax_select
    from triad_tpu_torch.eval.retrieval import select_subset_indices

    path = str(tmp_path / "subset.json")
    first = select_subset_indices(50, path, 20)
    assert len(first) == 20 == len(set(first)) and all(0 <= i < 50 for i in first)
    assert json.load(open(path)) == first
    assert select_subset_indices(50, path, 20) == first
    assert jax_select(50, path, 20) == first


def _datasets(pkg):
    import importlib

    d = importlib.import_module(f"{pkg}.data.datasets")
    spec = d.GroundedSyntheticSpec(num_classes=4, image_size=28)
    return {
        "tv": d.SyntheticTVDataset(size=8, image_size=28, seed=3),
        "av": d.SyntheticAVDataset(size=8, image_size=28, audio_seconds=0.125, seed=3),
        "grounded_av": d.GroundedSyntheticAVDataset(size=8, audio_seconds=0.125, spec=spec,
                                                    seed=2),
        "grounded_tv": d.GroundedSyntheticTVDataset(size=8, spec=spec, seed=2),
    }


@pytest.mark.parametrize("name", ["tv", "av", "grounded_av", "grounded_tv"])
def test_synthetic_datasets_bit_equal(name):
    port, ref = _datasets("triad_tpu_torch")[name], _datasets("triad_tpu")[name]
    assert len(port) == len(ref)
    for idx in (0, 5):
        a, b = port.__getitem__(idx, apply_augmentation=False), ref.__getitem__(
            idx, apply_augmentation=False)
        if isinstance(b, dict):
            assert sorted(a) == sorted(b)
            pairs = [(a[k], b[k]) for k in b]
        else:
            pairs = list(zip(a, b))
        for x, y in pairs:
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


def test_retrieval_slice_matches_jax():
    """16 AV and TV items through both packages' embed_*_subset on the same
    weights (head-pair attention in all three encoders, the "pallas"
    frontend; 2000-sample clips padded to 2400, so the audio masks cut),
    then the AV, TV and AT metrics."""
    from triad_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
    from triad_tpu.eval import retrieval as jr
    from triad_tpu.models import TriadModel as JaxTriad
    from triad_tpu_torch.data.datasets import SyntheticAVDataset, SyntheticTVDataset
    from triad_tpu_torch.data.tokenizer import WordPieceTokenizer
    from triad_tpu_torch.eval import retrieval as pr

    cfg = pair_model_config()
    jm, params, model = build_models(cfg, seed=4)
    av = SyntheticAVDataset(size=16, image_size=28, audio_seconds=0.125, seed=1)
    tv = SyntheticTVDataset(size=16, image_size=28, seed=1)
    captions = [tv[i][1] for i in range(16)]
    tok, jtok = WordPieceTokenizer.build_from_corpus(captions), JaxTokenizer.build_from_corpus(
        captions)
    idx, samples, n_text = list(range(16)), 2400, 12
    num_tokens = cfg.hubert.num_audio_tokens

    def jax_enc(*methods):
        @jax.jit
        def enc(*args):
            return tuple(jm.apply({"params": params}, *a, method=m)
                         for m, a in zip(methods, args))

        def run(*args):
            with pltpu.force_tpu_interpret_mode():
                return enc(*args)
        return run

    jax_av = jax_enc(JaxTriad.encode_audio, JaxTriad.encode_visual)
    jax_tv = jax_enc(JaxTriad.encode_text, JaxTriad.encode_visual)
    a_ref, am_ref, v_ref = jr.embed_av_subset(lambda im, au: jax_av((au,), (im,)), av, idx,
                                              samples, batch_size=8, num_tokens_fn=num_tokens)
    t_ref, tm_ref, vt_ref = jr.embed_tv_subset(lambda im, ids, m: jax_tv((ids, m), (im,)), tv,
                                               idx, jtok, n_text, batch_size=8)

    @torch.inference_mode()
    def enc_av(images, audio):
        return model.encode_audio(audio), model.encode_visual(images)

    @torch.inference_mode()
    def enc_tv(images, ids, mask):
        return model.encode_text(ids, mask), model.encode_visual(images)

    a, am, v = pr.embed_av_subset(enc_av, av, idx, samples, num_tokens_fn=num_tokens)
    t, tm, vt = pr.embed_tv_subset(enc_tv, tv, idx, tok, n_text)
    assert 0 < am.sum() < am.size  # the audio masks cut
    np.testing.assert_array_equal(am, am_ref)
    np.testing.assert_array_equal(tm, tm_ref)
    for got, ref in ((a, a_ref), (v, v_ref), (t, t_ref), (vt, vt_ref)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())

    temp = float(model.temperature.detach())
    for q, qm, k, km in ((a, am, v, None), (v, None, a, am), (t, tm, vt, None),
                         (a, am, t, tm)):
        qm = np.ones(q.shape[:2], np.float32) if qm is None else qm
        km = np.ones(k.shape[:2], np.float32) if km is None else km
        ref = jr.score_matrix(q, qm, k, km, temp)
        got = pr.score_matrix(q, qm, k, km, temp, device="cpu")
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    got = {**pr.av_retrieval_metrics(a, am, v, temp, "cpu"),
           **pr.tv_retrieval_metrics(t, tm, vt, temp, "cpu"),
           **pr.at_retrieval_metrics(a, am, t, tm, temp, "cpu")}
    want = {**jr.av_retrieval_metrics(a_ref, am_ref, v_ref, temp),
            **jr.tv_retrieval_metrics(t_ref, tm_ref, vt_ref, temp),
            **jr.at_retrieval_metrics(a_ref, am_ref, t_ref, tm_ref, temp)}
    assert got == want


def test_eval_1000_way_retrieval_on_cpu(tmp_path):
    """The entry point with device="cpu" on the same narrow model: the
    subset files written, the eight metric keys of the AV and TV
    directions, each a recall in [0, 1]; without a card the default
    device raises."""
    from triad_tpu_torch.config import Config
    from triad_tpu_torch.data.datasets import SyntheticAVDataset, SyntheticTVDataset
    from triad_tpu_torch.data.tokenizer import WordPieceTokenizer
    from triad_tpu_torch.eval.retrieval import eval_1000_way_retrieval

    mcfg = pair_model_config()
    _, _, model = build_models(mcfg, seed=4)
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=mcfg,
                              data=dataclasses.replace(cfg.data, audio_num_samples=2400,
                                                       max_text_tokens=12))
    av = SyntheticAVDataset(size=12, image_size=28, audio_seconds=0.125, seed=1)
    tv = SyntheticTVDataset(size=12, image_size=28, seed=1)
    tok = WordPieceTokenizer.build_from_corpus(tv[i][1] for i in range(12))
    out = eval_1000_way_retrieval(model, av, tv, tok, cfg, tmp_path, device="cpu")
    assert sorted(out) == sorted(f"{d}_r{k}" for d in ("A->V", "V->A", "T->V", "V->T")
                                 for k in (1, 5, 10, 20))
    assert all(0.0 <= x <= 1.0 for x in out.values())
    assert (tmp_path / "retrieval_subset_av.json").exists()
    assert (tmp_path / "retrieval_subset_tv.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_1000_way_retrieval(model, av, tv, tok, cfg, tmp_path)
