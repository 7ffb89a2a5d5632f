"""The port stands alone: no module of triad_tpu_torch, and nothing that
chip_smoke.py imports, names the JAX package or JAX; and the port's own
copy of the config tree equals the JAX package's field for field."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "triad_tpu_torch")
BLOCKED = ("triad_tpu", "jax", "jaxlib", "flax", "optax", "orbax")


def _port_files():
    """The port's modules: .py files of its packages (directories with an
    __init__.py; build outputs and kernel sources are not packages)."""
    out = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if os.path.exists(os.path.join(root, d, "__init__.py")))
        out += [os.path.relpath(os.path.join(root, f), REPO) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    """Every module an import statement of the file names, at any depth."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", _port_files() + ["chip_smoke.py"])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [n for n in _imported(path) if n.split(".")[0] in BLOCKED]
    assert not bad, (path, bad)


def test_every_module_imports_with_jax_and_triad_tpu_refused():
    """In a fresh interpreter whose import system refuses triad_tpu and
    JAX, every module of the port and chip_smoke.py import."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import triad_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(triad_tpu_torch.__path__,\n"
        "                                              'triad_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 25


_CLASSES = ("ViTConfig", "HubertConfig", "DistilBertConfig", "ModelConfig", "LossConfig",
            "DataConfig", "OptimConfig", "TrainConfig", "MeshConfig", "PretrainedConfig",
            "Config")
_PRESETS = ("perf_eval_model_config", "perf_train_model_config", "perf_train_loss_config",
            "perf_eval_loss_config")


@pytest.mark.parametrize("name", _CLASSES)
def test_config_class_equals_jax(name):
    from triad_tpu.core import config as J
    from triad_tpu_torch import config as P

    jc, pc = getattr(J, name), getattr(P, name)
    assert [f.name for f in dataclasses.fields(pc)] == [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(pc()) == dataclasses.asdict(jc())


@pytest.mark.parametrize("name", _PRESETS)
def test_config_preset_equals_jax(name):
    from triad_tpu.core import config as J
    from triad_tpu_torch import config as P

    assert dataclasses.asdict(getattr(P, name)()) == dataclasses.asdict(getattr(J, name)())


def test_config_loads_across_packages():
    """A Config written by the JAX package loads in the port, and back."""
    from triad_tpu.core import config as J
    from triad_tpu_torch import config as P

    jcfg = dataclasses.replace(J.Config(), model=J.perf_train_model_config())
    pcfg = P.Config.from_json(jcfg.to_json())
    assert pcfg.to_dict() == jcfg.to_dict()
    assert J.Config.from_dict(pcfg.to_dict()) == jcfg
    assert P.HubertConfig().num_audio_tokens(160_000) == 499


@pytest.mark.parametrize("text", ["A dog runs, hello!", "Héllo DOGS\tand  cats", "xyz 中文",
                                  ""])
def test_tokenizer_equals_jax(text):
    """The port's WordPiece copy gives the JAX package's ids and masks."""
    import numpy as np

    from triad_tpu.data.tokenizer import WordPieceTokenizer as J
    from triad_tpu_torch.data.tokenizer import WordPieceTokenizer as P

    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "a", "dog", "run", "##s", ",", "!", "hello", "and", "cat", "中"])}
    assert P(vocab).tokenize(text) == J(vocab).tokenize(text)
    for got, want in zip(P(vocab).encode_batch([text, "a dog"], 6), J(vocab).encode_batch(
            [text, "a dog"], 6)):
        np.testing.assert_array_equal(got, want)
