"""The port's serving export (triad_tpu_torch/serve/export.py, cli/export.py,
``cli.serve --bundle``) against the JAX package's StableHLO bundle
(tests/test_serve.py), on the CPU at small_model_config()'s size.

The same parameters (the port's, drawn from a seed, carried to the JAX
tree by models/convert.py) go through JAX's
``export_bundle(platforms=("cpu",))`` and the port's. From
one export each, at B = 1 and 3: the port's bundle against the port's
live model at rtol 2e-5 / atol 1e-6 (tests/test_serve.py's bound; it is
bit-equal in practice), and against the JAX bundle at rtol 2e-5 / atol
1e-5, the tolerance of the port's fp32 encoder parity tests
(tests/test_torch_serve.py). ``pair_scores`` at shapes unlike the trace's
(q = 1 and Nk = 1 among them) against the numpy oracle and JAX's. The
int8 bundles: the port's against its live int8 model at the fp32 bound,
and against JAX's at tests/test_torch_quant.py's audio tolerance for
every modality (token cosine > 0.999, mean > 0.9999; and 9 tokens in 10
within 1e-5): the float inputs of the int8 products agree to ~1e-6, so
an activation now and then lands on the other side of an int8 rounding
boundary and moves its token by up to one quantum a product (with these
weights one text token of the 36 moves by 0.023). The bundle
is served by ``cli.serve --bundle`` in a subprocess whose import system
refuses ``triad_tpu_torch.models`` and ``triad_tpu_torch.kernels``.
"""

import dataclasses
import json
import operator
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_multimodal import small_model_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = 1600
NT = 12
CORPUS = ["a dog barking in the park", "street music and a crowd"]
# A fresh interpreter whose import system refuses the port's model code
# and kernels: what it serves comes from the bundle's programs alone.
REFUSE = (
    "import sys\n"
    "BLOCKED = ('triad_tpu_torch.models', 'triad_tpu_torch.kernels')\n"
    "class Refuse:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.startswith(BLOCKED):\n"
    "            raise ImportError('refused: ' + name)\n"
    "sys.meta_path.insert(0, Refuse())\n"
)


def _port_cfg(cfg):
    from triad_tpu_torch.config import Config

    return Config.from_dict({"model": dataclasses.asdict(cfg)}).model


@pytest.fixture(scope="module")
def source():
    """The port's parameters drawn from seed 0, the same as the JAX
    package's tree (models/convert.py), and a vocab."""
    from triad_tpu.data.tokenizer import WordPieceTokenizer
    from triad_tpu_torch.models.convert import init_triad_model, torch_to_flax

    model = init_triad_model(_port_cfg(small_model_config()), torch.Generator().manual_seed(0))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, torch_to_flax(state))
    return params, state, WordPieceTokenizer.build_from_corpus(CORPUS).vocab


def _export_both(source, root, int8):
    """(the port's bundle, JAX's bundle) of the same parameters, exported
    for the CPU under ``root``."""
    from triad_tpu.serve.export import ServingBundle as JaxBundle
    from triad_tpu.serve.export import export_bundle as jax_export
    from triad_tpu_torch.serve.export import ServingBundle, export_bundle

    params, state, vocab = source
    cfg = small_model_config()
    kw = dict(audio_num_samples=AUDIO, max_text_tokens=NT, vocab=vocab, int8=int8,
              platforms=("cpu",))
    jax_export(params, cfg, str(root / "jax"), **kw)
    export_bundle(state, _port_cfg(cfg), str(root / "port"), **kw)
    return ServingBundle(str(root / "port"), "cpu"), JaxBundle(str(root / "jax"))


@pytest.fixture(scope="module")
def fp32(source, tmp_path_factory):
    return _export_both(source, tmp_path_factory.mktemp("fp32"), False)


@pytest.fixture(scope="module")
def int8(source, tmp_path_factory):
    return _export_both(source, tmp_path_factory.mktemp("int8"), True)


@pytest.fixture(scope="module")
def live(source):
    from triad_tpu_torch.serve.model import ServingModel

    return ServingModel(_port_cfg(small_model_config()), source[1], "cpu", AUDIO, NT)


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, NT), np.float32)
    mask[0, NT // 2:] = 0.0
    return (
        (rng.normal(size=(b, AUDIO)) * 0.1).astype(np.float32),
        rng.normal(size=(b, 28, 28, 3)).astype(np.float32),
        rng.integers(1, 90, size=(b, NT)).astype(np.int32),
        mask,
    )


def _embeds(serving, audio, images, ids, mask):
    return {"audio": serving.embed_audio(audio), "visual": serving.embed_visual(images),
            "text": serving.embed_text_ids(ids, mask)}


def _cos_rows(a, b):
    a, b = (np.asarray(x, np.float64).reshape(-1, x.shape[-1]) for x in (a, b))
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("B", [1, 3])
def test_bundle_matches_live_model_and_jax_bundle(fp32, live, B):
    port, jax_bundle = fp32
    args = _inputs(B, B)
    got = _embeds(port, *args)
    for name, want in _embeds(live, *args).items():
        assert got[name].shape[0] == B
        np.testing.assert_allclose(got[name], want, rtol=2e-5, atol=1e-6, err_msg=name)
    for name, want in _embeds(jax_bundle, *args).items():
        np.testing.assert_allclose(got[name], want, rtol=2e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("q,nq,k,nk", [(3, 5, 4, 6), (1, 7, 5, 1), (4, 1, 1, 9)])
def test_pair_scores_on_free_dims(fp32, source, q, nq, k, nk):
    """Shapes unlike the trace's (2, 4) x (3, 5): the numpy oracle of
    tests/test_serve.py and JAX's pair_scores program."""
    port, jax_bundle = fp32
    rng = np.random.default_rng(q * 100 + nk)
    qt = rng.normal(size=(q, nq, 32)).astype(np.float32)
    qm = (rng.random((q, nq)) > 0.3).astype(np.float32)
    qm[:, 0] = 1.0
    kt = rng.normal(size=(k, nk, 32)).astype(np.float32)
    km = (rng.random((k, nk)) > 0.3).astype(np.float32)
    km[:, 0] = 1.0
    temp = float(np.asarray(source[0]["temperature"]))
    got = port.pair_scores(qt, qm, kt, km)

    sims = np.einsum("qnd,kmd->qnkm", qt, kt) / temp
    sims = np.where(km[None, None] > 0, sims, np.finfo(np.float32).min)
    want = (sims.max(axis=3) * qm[:, :, None]).sum(1) / np.maximum(qm.sum(1), 1)[:, None]
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_bundle.pair_scores(qt, qm, kt, km), rtol=2e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.pair_scores(qt, qm, kt, km, 0.5),
                               jax_bundle.pair_scores(qt, qm, kt, km, 0.5), rtol=2e-5, atol=1e-5)


def test_vocab_and_meta(fp32):
    root = fp32[0].path.parent
    assert (root / "port" / "vocab.txt").read_bytes() == (root / "jax" / "vocab.txt").read_bytes()
    port = json.loads((root / "port" / "meta.json").read_text())
    jax_meta = json.loads((root / "jax" / "meta.json").read_text())
    assert set(jax_meta) <= set(port)
    assert port["format"] == "triad_tpu_torch.serve/1"
    assert port["torch_version"] == torch.__version__
    for key in ("platforms", "int8", "embedding_dim", "audio_num_samples", "image_size",
                "max_text_tokens", "model_config"):
        assert port[key] == jax_meta[key], key
    assert port["temperature"] == pytest.approx(jax_meta["temperature"], rel=1e-7)
    out = fp32[0].embed_texts(["a dog barking", "street music"])
    assert out["tokens"].shape == (2, NT, 32) and out["mask"][0].sum() > 0


@pytest.mark.parametrize("tag", ["fp32", "int8"])
def test_programs_hold_only_aten_ops(request, tag):
    """No call into the port's kernels or any other Python code: every
    call of each loaded program is an aten operator (or a getitem of a
    tuple output, or the batch dim's size arithmetic)."""
    bundle = request.getfixturevalue(tag)[0]
    assert sorted(f.name for f in bundle.path.glob("*.pt2")) == \
        sorted(f"{name}.cpu.pt2" for name in bundle._fns)
    for name, module in bundle._fns.items():
        targets = [n.target for n in module.graph.nodes if n.op == "call_function"]
        assert targets, name
        bad = [t for t in targets if t is not operator.getitem
               and getattr(t, "__module__", None) != "_operator"
               and not (isinstance(t, torch._ops.OpOverload) and t.namespace == "aten")]
        assert not bad, (name, bad)
    # the int8 bundle's CPU programs take the plain int8 product, in float64
    mm = [str(n.target) for n in bundle._fns["embed_text"].graph.nodes if n.op == "call_function"]
    assert "aten._int_mm.default" not in mm


def test_int8_bundle_matches_live_int8_and_jax_int8(int8, fp32, live):
    from triad_tpu_torch.models.quantize import int8_interception

    port, jax_bundle = int8
    args = _inputs(3, 5)
    got = _embeds(port, *args)
    with int8_interception():
        want = _embeds(live, *args)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=2e-5, atol=1e-6, err_msg=name)
    want = _embeds(jax_bundle, *args)
    for name in got:
        cos = _cos_rows(got[name], want[name])
        assert cos.min() > 0.999 and cos.mean() > 0.9999, (name, cos.min(), cos.mean())
        close = np.isclose(got[name], want[name], rtol=0, atol=1e-5).all(axis=-1)
        assert close.mean() > 0.9, (name, close.mean())
    fp = _embeds(fp32[0], *args)
    for name in got:
        assert _cos_rows(got[name], fp[name]).mean() > 0.995, name


def test_bundle_loads_without_model_code(fp32, tmp_path):
    """A fresh interpreter that refuses the model and kernel modules loads
    the bundle and answers as this process does."""
    root = tmp_path
    audio = _inputs(2, 9)[0]
    np.save(root / "audio.npy", audio)
    code = REFUSE + (
        "import numpy as np\n"
        "from triad_tpu_torch.serve.export import ServingBundle\n"
        f"b = ServingBundle({str(fp32[0].path)!r}, 'cpu')\n"
        f"np.save({str(root / 'tokens.npy')!r}, b.embed_audio(np.load({str(root / 'audio.npy')!r})))\n"
        "print(sorted(m for m in sys.modules if m.startswith('triad_tpu_torch')))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "triad_tpu_torch.models" not in r.stdout and "triad_tpu_torch.ops" not in r.stdout
    np.testing.assert_array_equal(np.load(root / "tokens.npy"), fp32[0].embed_audio(audio))


def test_refusals(fp32, live, tmp_path, monkeypatch):
    """A bundle lacking the asked platform raises; so do serving and
    exporting for "cuda" without a card."""
    from triad_tpu_torch.serve.export import ServingBundle, export_bundle

    src = fp32[0].path
    with pytest.raises(ValueError, match="not 'cuda'"):
        ServingBundle(str(src), "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = json.loads((src / "meta.json").read_text())
    meta["platforms"] = ["cpu", "cuda"]
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingBundle(str(tmp_path), "cuda")
    state = live.model.state_dict()
    cfg = _port_cfg(small_model_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_bundle(state, cfg, str(tmp_path / "x"), audio_num_samples=AUDIO,
                      max_text_tokens=NT, platforms=("cuda",))
    with pytest.raises(ValueError, match="platforms"):
        export_bundle(state, cfg, str(tmp_path / "x"), audio_num_samples=AUDIO,
                      max_text_tokens=NT, platforms=("tpu",))


class TestServer:
    """tests/test_serve.py's TestServer, served by ``cli.serve --bundle``."""

    @pytest.fixture(scope="class")
    def url(self, fp32):
        code = REFUSE + (
            "from triad_tpu_torch.cli.serve import main\n"
            f"main(['--bundle', {str(fp32[0].path)!r}, '--device', 'cpu', "
            "'--port', '0'])\n"
        )
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            port = re.search(r"serving on 127\.0\.0\.1:(\d+) \(cpu\)", line)
            assert port, (line, proc.stderr.read() if proc.poll() is not None else "")
            yield f"http://127.0.0.1:{port.group(1)}"
        finally:
            proc.kill()
            proc.wait()

    def _post(self, url, path, obj):
        req = urllib.request.Request(
            url + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    def test_healthz(self, url):
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            meta = json.loads(r.read())
        assert meta["status"] == "ok"
        assert meta["format"].startswith("triad_tpu_torch.serve/")

    def test_embed_and_score_roundtrip(self, fp32, url):
        b = fp32[0]
        rng = np.random.default_rng(3)
        audio = (rng.normal(size=(2, AUDIO)) * 0.1).tolist()
        images = rng.normal(size=(2, 28, 28, 3)).tolist()
        a = self._post(url, "/v1/embed/audio", {"audio": audio})["tokens"]
        v = self._post(url, "/v1/embed/image", {"images": images})["tokens"]
        np.testing.assert_allclose(np.asarray(a), b.embed_audio(np.asarray(audio)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np.asarray(v), b.embed_visual(np.asarray(images)),
                                   rtol=1e-6, atol=1e-6)
        ones = lambda x: np.ones((2, len(x[0]))).tolist()  # noqa: E731
        s = self._post(url, "/v1/score", {"query": {"tokens": a, "mask": ones(a)},
                                          "key": {"tokens": v, "mask": ones(v)},
                                          "direction": "av"})["scores"]
        assert np.asarray(s).shape == (2, 2)
        s_self = self._post(url, "/v1/score", {"query": {"tokens": a, "mask": ones(a)},
                                               "key": {"tokens": a, "mask": ones(a)},
                                               "direction": "av"})["scores"]
        assert (np.argmax(np.asarray(s_self), axis=1) == np.arange(2)).all()

    def test_text_endpoint_and_errors(self, url):
        out = self._post(url, "/v1/embed/text", {"texts": ["a dog"]})
        assert np.asarray(out["tokens"]).shape == (1, NT, 32)
        req = urllib.request.Request(
            url + "/v1/score", data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400


def _tiny_config_file(tmp_path, model_cfg=None):
    from tests.test_trainer import tiny_config

    d = dataclasses.asdict(tiny_config(tmp_path))
    if model_cfg is not None:
        d["model"] = dataclasses.asdict(model_cfg)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(d))
    return str(path)


def _model_from(cfg, state_file):
    from triad_tpu_torch.models.multimodal import TriadModel

    model = TriadModel(_port_cfg(cfg))
    model.load_state_dict(torch.load(state_file, map_location="cpu", weights_only=True)["model"])
    return model.eval()


def _held_to(bundle_dir, model):
    from triad_tpu_torch.serve.export import ServingBundle

    b = ServingBundle(str(bundle_dir), "cpu")
    audio, images, ids, mask = _inputs(2, 21)
    with torch.inference_mode():
        want = {"audio": model.encode_audio(torch.from_numpy(audio)),
                "visual": model.encode_visual(torch.from_numpy(images)),
                "text": model.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))}
    for name, got in _embeds(b, audio, images, ids, mask).items():
        np.testing.assert_allclose(got, want[name].numpy(), rtol=2e-5, atol=1e-6, err_msg=name)
    return b


def test_cli_export_random_init(tmp_path):
    """cli.export --random-init with the tiny config from a file: the
    bundle equals the weights drawn from a generator seeded 0, with the
    placeholder vocab."""
    from triad_tpu_torch.cli import export as export_cli
    from triad_tpu_torch.models.convert import init_triad_model

    out = export_cli.main(["--random-init", "--config", _tiny_config_file(tmp_path), "--out",
                           str(tmp_path / "random"), "--platforms", "cpu", "--device", "cpu"])
    model = init_triad_model(_port_cfg(small_model_config()), torch.Generator().manual_seed(0))
    b = _held_to(out, model.eval())
    assert b.meta["platforms"] == ["cpu"] and "placeholder" in b.tokenizer.vocab


def test_cli_export_run_dir_and_best(tmp_path):
    """A tiny cli.train run exported from its latest checkpoint and from
    best/: each bundle equals the weights it names, and carries the run's
    vocab."""
    from triad_tpu_torch.cli import export as export_cli
    from triad_tpu_torch.cli import train as train_cli

    run = tmp_path / "run"
    trainer = train_cli.main(["--device", "cpu", "--synthetic", "--steps", "2", "--config",
                              _tiny_config_file(tmp_path), "--output-dir", str(run),
                              "--force-new"])
    step = trainer.ckpt.latest_step()
    vocab = trainer.tokenizer.vocab
    for name, extra, state_file in (
            ("latest", [], run / "checkpoints" / "ckpts" / str(step) / "state.pt"),
            ("best", ["--best"], run / "checkpoints" / "best" / "state.pt")):
        out = export_cli.main(["--run-dir", str(run), "--out", str(tmp_path / name),
                               "--platforms", "cpu", "--device", "cpu", *extra])
        b = _held_to(out, _model_from(small_model_config(), state_file))
        assert b.tokenizer.vocab == vocab, name


def test_cli_export_refuses_kernel_knobs(tmp_path):
    """A config with an explicit kernel knob is refused before anything is
    built, with resolve_xla_impls's message."""
    from triad_tpu_torch.cli import export as export_cli
    from triad_tpu_torch.config import perf_train_model_config

    cfg_file = _tiny_config_file(tmp_path, perf_train_model_config())
    with pytest.raises(ValueError, match=r"vit\.attention_impl='fused_packed' is a pallas path"):
        export_cli.main(["--random-init", "--config", cfg_file, "--out", str(tmp_path / "b"),
                         "--platforms", "cpu", "--device", "cpu"])
    assert not (tmp_path / "b").exists()
