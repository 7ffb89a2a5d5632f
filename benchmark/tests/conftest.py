"""Shared helpers of the benchmark's CPU tests: the harness's modules on
the path, and each cell cut to a tiny size that runs on the CPU."""

import copy
import sys
from pathlib import Path

import pytest
import torch

# tiny shapes: several test processes with a thread each beat one process
# fighting over every core
torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(name: str, compute_dtype: str = "float32"):
    """The cell ``name`` at a tiny size: every width cut (the frontend keeps
    its 512 channels, which the kernels' twins take), 2 layers, the
    batches of 4, HuBERT's kernel routes explicit (their plain twins and
    keep masks run on the CPU, as the kernels do on the card)."""
    import harness

    cell = harness.load_cell(name)
    cell = copy.copy(cell)
    cfg = copy.deepcopy(cell.config)
    m = cfg["model"]
    m.update(embedding_dim=64, compute_dtype=compute_dtype)
    m["vit"].update(image_size=28, hidden_size=128, num_layers=2, num_heads=2)
    m["hubert"].update(hidden_size=128, num_layers=3, num_heads=2, intermediate_size=256,
                       num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                       frontend_chunk_tokens=8, layerdrop=0.3, mask_time_length=4)
    h = m["hubert"]
    h["mlp_impl"] = "fused"
    h["ln_impl"] = "fused"
    if h["attention_impl"] == "auto":
        h["attention_impl"] = "fused"
    m["text"].update(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                     vocab_size=2000, max_position_embeddings=64)
    if compute_dtype == "float32":
        # the monolithic frontend's twin rounds to bf16 inside, as its kernels do
        cfg["loss"].update(volume_dtype="float32")
        if h["frontend_impl"] == "monolithic":
            h.update(frontend_impl="conv", remat="none")
    cell.config = cfg
    acc = cfg["optim"]["gradient_accumulation_steps"]
    cell.traffic = dict(cell.traffic, batch_av=4, batch_tv=4, audio_samples=8000,
                        image_size=28, text_tokens=16, ring=2 * acc + 2,
                        check_micro_steps=2 * acc, warmup_steps=1, reference_block=3,
                        caption_lengths=[3, 5, 9, 16])
    return cell


@pytest.fixture(params=["perf-joint-b64", "default-joint-b22"])
def cell_name(request):
    return request.param
