"""Serve the port's TriadModel over HTTP (endpoint contract:
``triad_tpu/serve/server.py``).

  python -m triad_tpu_torch.cli.serve --random-init --port 8080
  python -m triad_tpu_torch.cli.serve --params-npz params.npz --config cfg.json

``--params-npz`` takes a flat npz of a JAX param tree whose keys are the
tree paths joined with "/" (e.g. ``audio_backbone/layer_0/.../kernel``);
it is converted by ``models/convert.py``. ``--config`` is ``perf_eval``
(the tuned eval config, default), ``default`` (``ModelConfig()``) or a
JSON file holding a ModelConfig dict or a whole Config. The device is
``cuda`` unless ``--device cpu`` is given; without a GPU the default
fails rather than serving from the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

from triad_tpu_torch.cli.common import add_device_arg, resolve_device
from triad_tpu_torch.config import Config, ModelConfig, perf_eval_model_config


def load_config(spec: str) -> ModelConfig:
    if spec == "perf_eval":
        return perf_eval_model_config()
    if spec == "default":
        return ModelConfig()
    with open(spec) as f:
        d = json.load(f)
    return Config.from_dict(d if "model" in d else {"model": d}).model


def load_params_npz(path: str, cfg: ModelConfig):
    from triad_tpu_torch.models.convert import flax_to_torch

    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return flax_to_torch(tree, cfg)


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="serve the PyTorch port's TriadModel")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--random-init", action="store_true", help="random weights (seed 0)")
    src.add_argument("--params-npz", help="flat '/'-keyed npz of a JAX param tree")
    p.add_argument("--config", default="perf_eval", help="perf_eval | default | JSON file")
    p.add_argument("--audio-num-samples", type=int, default=160_000)
    p.add_argument("--max-text-tokens", type=int, default=128)
    p.add_argument("--vocab", help="WordPiece vocab.txt for /v1/embed/text with texts")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    add_device_arg(p)
    args = p.parse_args(argv)

    device = resolve_device(args)
    cfg = load_config(args.config)
    state_dict = None if args.random_init else load_params_npz(args.params_npz, cfg)
    tokenizer = None
    if args.vocab:
        from triad_tpu_torch.data.tokenizer import WordPieceTokenizer

        tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab)

    from triad_tpu_torch.serve.model import ServingModel
    from triad_tpu_torch.serve.server import make_server

    model = ServingModel(cfg, state_dict, device, args.audio_num_samples,
                         args.max_text_tokens, tokenizer)
    srv = make_server(model, args.host, args.port)
    print(f"serving on {args.host}:{srv.server_address[1]} ({model.meta['device_name']})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
