"""The port's train / eval commands: config building (the six cases of
tests/test_cli.py:17-56 against the port's build_config), and
``cli.train`` then ``cli.eval`` end to end on the CPU at
tests/test_trainer.py:tiny_config's size."""

import argparse
import dataclasses
import json

import pytest
import torch

from triad_tpu_torch.cli.train import apply_overrides, build_config


def _ns(**kw):
    base = dict(config=None, set=None, output_dir=None, steps=None)
    base.update(kw)
    return argparse.Namespace(**base)


def test_defaults():
    cfg = build_config(_ns())
    assert cfg.data.batch_size_av == 22
    assert cfg.loss.matmul_precision == "highest"


def test_dotted_overrides():
    cfg = build_config(_ns(set=[
        "train.num_epochs=3",
        "data.batch_size_av=16",
        "loss.matmul_precision=\"default\"",
        "model.hubert.conv_dim=[16,16]",
    ]))
    assert cfg.train.num_epochs == 3
    assert cfg.data.batch_size_av == 16
    assert cfg.loss.matmul_precision == "default"
    assert cfg.model.hubert.conv_dim == (16, 16)


def test_yaml_config(tmp_path):
    f = tmp_path / "c.yaml"
    f.write_text("train:\n  num_epochs: 7\nmesh:\n  num_devices: 4\n")
    cfg = build_config(_ns(config=str(f)))
    assert cfg.train.num_epochs == 7
    assert cfg.mesh.num_devices == 4


def test_override_beats_file(tmp_path):
    f = tmp_path / "c.yaml"
    f.write_text("train:\n  num_epochs: 7\n")
    cfg = build_config(_ns(config=str(f), set=["train.num_epochs=2"]))
    assert cfg.train.num_epochs == 2


def test_bad_override_rejected():
    with pytest.raises(ValueError):
        apply_overrides({}, ["no_equals_sign"])


def test_unknown_key_rejected():
    with pytest.raises(KeyError):
        build_config(_ns(set=["train.not_a_field=1"]))


def test_build_config_equals_jax(tmp_path):
    """The same file, overrides and flags give the JAX package's config,
    field for field; --synthetic also clears the data paths."""
    from triad_tpu.cli.train import build_config as jax_build_config

    f = tmp_path / "c.json"
    f.write_text(json.dumps({"train": {"num_epochs": 7}, "data": {"text_dataset_path": "/x"}}))
    args = _ns(config=str(f), set=["model.vit.num_layers=3"], output_dir="/out", steps=5)
    assert dataclasses.asdict(build_config(args)) == dataclasses.asdict(jax_build_config(args))
    assert build_config(_ns(config=str(f), synthetic=True)).data.text_dataset_path is None


def _tiny_config_file(tmp_path):
    from tests.test_trainer import tiny_config

    d = dataclasses.asdict(tiny_config(tmp_path))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(d))
    return str(path)


def test_train_then_eval_on_the_cpu(tmp_path, capsys):
    """cli.train on synthetic data for 2 steps, then cli.eval of the run
    directory: the metrics it prints are those of the run's last
    retrieval (the same weights, subsets and kernels' twins), and
    --best evaluates best/."""
    from triad_tpu_torch.cli import eval as eval_cli
    from triad_tpu_torch.cli import train as train_cli

    run = tmp_path / "cli_run"
    trainer = train_cli.main(["--device", "cpu", "--synthetic", "--steps", "2",
                              "--config", _tiny_config_file(tmp_path),
                              "--output-dir", str(run), "--force-new"])
    assert trainer.ckpt.latest_step() == 2 and trainer.device.type == "cpu"
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    last = {k[len("retrieval_"):]: v for m in lines for k, v in m.items()
            if k.startswith("retrieval_")}
    capsys.readouterr()
    out = tmp_path / "eval.json"
    metrics = eval_cli.main(["--run-dir", str(run), "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == metrics == last
    assert json.loads(out.read_text()) == metrics
    assert eval_cli.main(["--run-dir", str(run), "--device", "cpu", "--best"]) == last


def test_default_device_without_card_exits(tmp_path):
    from triad_tpu_torch.cli import eval as eval_cli
    from triad_tpu_torch.cli import train as train_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(SystemExit, match="--device cpu"):
        train_cli.main(["--synthetic", "--steps", "1", "--output-dir", str(tmp_path / "r")])
    with pytest.raises(SystemExit, match="--device cpu"):
        eval_cli.main(["--run-dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()
