"""The port's serving surface (triad_tpu_torch/serve) against the JAX live
model: ServingModel's embeddings and scores on the small test config,
and an HTTP round trip of all five routes through the shared handler."""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tests.test_multimodal import small_model_config

AUDIO = 1600
NT = 12


@pytest.fixture(scope="module")
def served():
    from triad_tpu.data.tokenizer import WordPieceTokenizer
    from triad_tpu.models import init_triad_model
    from triad_tpu_torch.models.convert import flax_to_torch
    from triad_tpu_torch.serve.model import ServingModel

    cfg = small_model_config()
    params = init_triad_model(cfg, jax.random.key(0))
    tok = WordPieceTokenizer.build_from_corpus(
        ["a dog barking in the park", "street music and a crowd"]
    )
    sm = ServingModel(cfg, flax_to_torch(params, cfg), "cpu", AUDIO, NT, tok)
    return sm, cfg, params, tok


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (
        (rng.normal(size=(b, AUDIO)) * 0.1).astype(np.float32),
        rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
        rng.integers(1, 90, size=(b, NT)).astype(np.int32),
        np.ones((b, NT), np.float32),
    )


class TestServingModel:
    def test_embeddings_match_jax_live_model(self, served):
        """fp32 config: the port matches the JAX model to fp32 rounding
        (rtol 2e-5, atol 1e-5)."""
        from triad_tpu.models import TriadModel

        sm, cfg, params, _ = served
        audio, images, ids, mask = _inputs(2, 2)
        model = TriadModel(cfg)
        for got, method, args in (
            (sm.embed_audio(audio), TriadModel.encode_audio, (audio,)),
            (sm.embed_visual(images), TriadModel.encode_visual, (images,)),
            (sm.embed_text_ids(ids, mask), TriadModel.encode_text, (ids, mask)),
        ):
            ref = np.asarray(
                model.apply({"params": params}, *args, train=False, method=method)
            )
            np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-5)

    def test_pair_scores_match_export_fn(self, served):
        from triad_tpu.serve.export import _pair_scores_fn

        sm, _, params, _ = served
        rng = np.random.default_rng(7)
        q = rng.normal(size=(3, 5, 32)).astype(np.float32)
        qm = (rng.random((3, 5)) > 0.3).astype(np.float32)
        k = rng.normal(size=(4, 6, 32)).astype(np.float32)
        km = (rng.random((4, 6)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0
        temp = float(np.asarray(params["temperature"]))
        want = np.asarray(_pair_scores_fn(q, qm, k, km, np.float32(1.0 / temp)))
        np.testing.assert_allclose(sm.pair_scores(q, qm, k, km), want, rtol=1e-5, atol=1e-5)

    def test_embed_texts_and_meta(self, served):
        sm, cfg, params, tok = served
        out = sm.embed_texts(["a dog barking", "street music"])
        ids, mask = tok.encode_batch(["a dog barking", "street music"], max_length=NT, pad_to=NT)
        np.testing.assert_array_equal(out["mask"], mask)
        np.testing.assert_allclose(out["tokens"], sm.embed_text_ids(ids, mask))
        assert sm.meta["temperature"] == pytest.approx(float(np.asarray(params["temperature"])))
        assert sm.meta["embedding_dim"] == cfg.embedding_dim

    def test_wrong_audio_length_raises(self, served):
        sm = served[0]
        with pytest.raises(ValueError):
            sm.embed_audio(np.zeros((1, AUDIO + 1), np.float32))


class TestHttp:
    def test_all_routes_round_trip(self, served):
        from triad_tpu_torch.serve.server import make_server

        sm, cfg, _, _ = served
        srv = make_server(sm, "127.0.0.1", 0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def post(path, obj):
            req = urllib.request.Request(
                base + path, data=json.dumps(obj).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
                return json.loads(r.read())

        try:
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                assert json.loads(r.read())["status"] == "ok"
            audio, images, ids, mask = _inputs(2, 11)
            a = np.asarray(post("/v1/embed/audio", {"audio": audio.tolist()})["tokens"])
            np.testing.assert_allclose(a, sm.embed_audio(audio), rtol=1e-6, atol=1e-6)
            v = np.asarray(post("/v1/embed/image", {"images": images.tolist()})["tokens"])
            np.testing.assert_allclose(v, sm.embed_visual(images), rtol=1e-6, atol=1e-6)
            t = post("/v1/embed/text", {"texts": ["a dog", "music"]})
            assert np.asarray(t["tokens"]).shape == (2, NT, cfg.embedding_dim)
            s = post("/v1/score", {
                "query": {"tokens": a.tolist(), "mask": np.ones(a.shape[:2]).tolist()},
                "key": {"tokens": v.tolist(), "mask": np.ones(v.shape[:2]).tolist()},
                "direction": "av",
            })
            assert np.asarray(s["scores"]).shape == (2, 2)
            assert np.isfinite(s["scores"]).all()
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
