"""The one generator of training traffic: a ring of batch pairs made on the
device from the run's seed, from a traffic file's parameters.

A traffic file (``traffic/<name>.json``) gives the batch of each side
(``batch_av`` clips of ``audio_samples`` samples with one
``image_size``-square frame each; ``batch_tv`` image-caption pairs, each
caption padded to ``text_tokens``), the caption lengths
(``caption_lengths``: a fixed set of WordPiece counts, [CLS] and [SEP]
included, cycled to the batch and shuffled by the seed, so every seed
sends the same sizes in another order), the phase weights, the ring's
length, the micro step the window starts from and the schedule's length,
and how many micro steps the correctness check follows.

Frames and clips are standard normal (what the loaders' normalisation
gives), waveforms normal(0.1) (normalised per clip by the model), token
ids uniform over the vocabulary's word pieces between [CLS] and [SEP].
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from reference.layout import BATCHES, derived_seed

CLS, SEP, FIRST_PIECE = 101, 102, 1000
HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@torch.no_grad()
def make_ring(traffic: dict, vocab_size: int, seed: int, device) -> List[Tuple[Dict, Dict]]:
    """``traffic["ring"]`` (av, tv) batch pairs, every row drawn anew."""
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, BATCHES))
    ba, bt = traffic["batch_av"], traffic["batch_tv"]
    side, samples, nt = traffic["image_size"], traffic["audio_samples"], traffic["text_tokens"]
    lengths = torch.tensor(traffic["caption_lengths"], dtype=torch.int64, device=device)
    lengths = lengths.repeat(-(-bt // lengths.numel()))[:bt]
    pos = torch.arange(nt, device=device)
    ring = []
    for _ in range(traffic["ring"]):
        av = {"images": torch.randn((ba, side, side, 3), generator=gen, device=device),
              "audio": torch.randn((ba, samples), generator=gen, device=device) * 0.1}
        n = lengths[torch.randperm(bt, generator=gen, device=device)]
        ids = torch.randint(FIRST_PIECE, vocab_size, (bt, nt), generator=gen, device=device)
        ids = torch.where(pos[None] == 0, CLS, torch.where(pos[None] == n[:, None] - 1, SEP, ids))
        mask = pos[None] < n[:, None]
        tv = {"images": torch.randn((bt, side, side, 3), generator=gen, device=device),
              "token_ids": torch.where(mask, ids, 0), "text_mask": mask.to(torch.float32)}
        ring.append((av, tv))
    return ring
