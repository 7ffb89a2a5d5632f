"""TriadPack shards, the loaders, the worker pools, the Prefetcher and the
device augmentation of the port against the JAX package's, on the CPU, at
small sizes (32^2 images, 1,600 audio samples, a handful of clips).

- A shard packed by either package from the same seeded dataset is the
  same bytes, and each package reads the other's (flat and segmented).
- AVLoader / TVLoader batches equal the JAX loaders' for the same (seed,
  epoch, start_batch): bit for bit in the raw (device-augment) form, the
  text and the audio; the host-augmented AV images within the JAX float32
  mean's drift (``images.image_mean``; 1e-5 at 32^2).
- The device augmentation on CPU tensors against JAX's jitted version on
  the CPU within 2e-6 abs (8 float32 ulps of the largest normalized value,
  2.64: the two sum the per-image means in different orders), and against
  the port's host path: AV bit for bit, TV within 2e-6.
"""

import os
import time

import numpy as np
import pytest
import torch

from triad_tpu.data import datasets as JD
from triad_tpu.data import packed as JP
from triad_tpu.data import pipeline as JL
from triad_tpu_torch.data import datasets as PD
from triad_tpu_torch.data import packed as PP
from triad_tpu_torch.data import pipeline as PL

SIZE, SAMPLES = 32, 1600


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The same 10 synthetic clips packed by each package, split 6 + 4
    into two shards of a directory each."""
    root = tmp_path_factory.mktemp("tpack")
    out = {}
    for name, pack, ds in (("port", PP.pack_dataset, PD.SyntheticAVDataset),
                           ("jax", JP.pack_dataset, JD.SyntheticAVDataset)):
        src = ds(size=10, image_size=SIZE, audio_seconds=0.12, seed=4)
        os.makedirs(root / name)
        for i, idx in enumerate((range(6), range(6, 10))):
            assert pack(src, str(root / name / f"s{i}.tpack"), SIZE, SAMPLES, idx) == len(idx)
        out[name] = str(root / name)
    return out


def test_shards_are_byte_identical(shards):
    for f in ("s0.tpack", "s1.tpack"):
        a = open(os.path.join(shards["port"], f), "rb").read()
        b = open(os.path.join(shards["jax"], f), "rb").read()
        assert a == b
        assert len(a) > 16 + 6 * (SIZE * SIZE * 3 + 2 * SAMPLES) * (f == "s0.tpack")


@pytest.mark.parametrize("segmented", [False, True])
def test_each_package_reads_the_others_shards(shards, segmented):
    p = PP.PackedAVDataset(shards["jax"], segmented=segmented)
    j = JP.PackedAVDataset(shards["port"], segmented=segmented)
    for seg in (0, 1) if segmented else (0,):
        p.set_segment(seg)
        j.set_segment(seg)
        assert len(p) == len(j) == (10 if not segmented else (6, 4)[seg])
        assert p.video_files == j.video_files
        for i in range(len(p)):
            a, b = p.raw_item(i), j.raw_item(i)
            assert a["video_path"] == b["video_path"]
            np.testing.assert_array_equal(a["frame_u8"], b["frame_u8"])
            np.testing.assert_array_equal(a["audio_i16"], b["audio_i16"])
            a, b = p.__getitem__(i, False), j.__getitem__(i, False)
            np.testing.assert_array_equal(a["video_frames"], b["video_frames"])
            np.testing.assert_array_equal(a["audio"], b["audio"])
            a = p.__getitem__(i, True, np.random.default_rng(i))
            b = j.__getitem__(i, True, np.random.default_rng(i))
            assert np.abs(a["video_frames"] - b["video_frames"]).max() <= 1e-5
    with pytest.raises(IndexError):
        p.raw_item(len(p))


def test_packed_cli(shards, tmp_path):
    """python -m triad_tpu_torch.data.packed packs a flat MP4-folder root;
    an empty root fails."""
    import subprocess
    import sys

    os.makedirs(tmp_path / "empty")
    r = subprocess.run([sys.executable, "-m", "triad_tpu_torch.data.packed", "--root",
                        str(tmp_path / "empty"), "--out", str(tmp_path / "x.tpack"), "--flat"],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode != 0 and "No MP4 files" in r.stderr


def _loaders(shards, kind, **kw):
    if kind == "av":
        return (PL.AVLoader(PP.PackedAVDataset(shards["port"]), 4, SAMPLES, **kw),
                JL.AVLoader(JP.PackedAVDataset(shards["jax"]), 4, SAMPLES, **kw))
    return (PL.AVLoader(PD.SyntheticAVDataset(10, SIZE, 0.12, seed=5), 4, SAMPLES, **kw),
            JL.AVLoader(JD.SyntheticAVDataset(10, SIZE, 0.12, seed=5), 4, SAMPLES, **kw))


def _assert_av_batch_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "images":
            assert np.abs(a[k] - b[k]).max() <= 1e-5  # the mean's drift
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("device_augment", [False, True])
@pytest.mark.parametrize("start", [(0, 0), (1, 1), (2, 2)])
def test_av_loader_equals_jax(shards, device_augment, start):
    p, j = _loaders(shards, "av", seed=9, num_workers=2, device_augment=device_augment)
    assert len(p) == len(j) == 2 and p.device_augment == device_augment
    got = list(p.epoch(*start))
    want = list(j.epoch(*start))
    assert len(got) == len(want) == max(0, 2 - start[1])
    for a, b in zip(got, want):
        _assert_av_batch_equal(a, b)
    if device_augment and got:
        assert got[0]["frames_u8"].dtype == np.uint8 and got[0]["audio_i16"].dtype == np.int16


def test_av_loader_item_path_and_unique_videos_equal_jax(shards):
    """Datasets without raw_item take the per-item path; unique_videos
    draws batches through UniqueVideoSampler."""
    p, j = _loaders(shards, "synthetic", seed=2, num_workers=2)
    for a, b in zip(p.epoch(1), j.epoch(1)):
        _assert_av_batch_equal(a, b)
    ids = ["a", "a", "b", "c", "c", "d", "e", "f", "f", "g"]
    p, j = _loaders(shards, "av", seed=3, unique_video_ids=ids, num_workers=1)
    sampler = PL.UniqueVideoSampler(ids, 4, 3, 0)
    for b in range(sampler.num_batches):
        got = [ids[i] for i in sampler.batch_indices(b)]
        assert len(set(got)) == len(got) == 4
        np.testing.assert_array_equal(sampler.batch_indices(b),
                                      JL.UniqueVideoSampler(ids, 4, 3, 0).batch_indices(b))
    for a, b in zip(p.epoch(0), j.epoch(0)):
        _assert_av_batch_equal(a, b)
    assert PL.video_id_from_path("/x/ytid_30_40.mp4") == JL.video_id_from_path(
        "/x/ytid_30_40.mp4") == "ytid"


@pytest.mark.parametrize("shard", [(0, 2), (1, 2)])
def test_process_shard_rows_equal_jax(shards, shard):
    p, j = _loaders(shards, "av", seed=6, process_shard=shard, device_augment=True)
    full, _ = _loaders(shards, "av", seed=6, device_augment=True)
    for a, b, whole in zip(p.epoch(0), j.epoch(0), full.epoch(0)):
        _assert_av_batch_equal(a, b)
        rows = slice(2 * shard[0], 2 * shard[0] + 2)
        np.testing.assert_array_equal(a["frames_u8"], whole["frames_u8"][rows])
    with pytest.raises(ValueError):
        PL.AVLoader(PD.SyntheticAVDataset(8, SIZE, 0.1), 3, SAMPLES, process_shard=(0, 2))


def test_cycling_crosses_epochs_and_resumes(shards):
    """cycling over a 2-batch epoch: the stream started at (1, 1) is the
    uninterrupted stream from its fourth batch on, as the JAX one is."""
    p, j = _loaders(shards, "av", seed=1, device_augment=True)
    whole = PL.cycling(p.epoch)
    seq = [next(whole) for _ in range(6)]
    jseq = JL.cycling(j.epoch)
    for a in seq:
        _assert_av_batch_equal(a, next(jseq))
    resumed = PL.cycling(p.epoch, 1, 1)
    for a in seq[3:]:
        _assert_av_batch_equal(next(resumed), a)
    with pytest.raises(RuntimeError, match="empty dataset"):
        next(PL.cycling(lambda e, b: iter(())))


@pytest.fixture(scope="module")
def tokenizer():
    from triad_tpu_torch.data.tokenizer import WordPieceTokenizer

    return WordPieceTokenizer.build_from_corpus(
        PD.SyntheticTVDataset(12, SIZE, seed=1).captions())


@pytest.fixture(scope="module")
def caption_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("captions")
    rng = np.random.default_rng(11)
    for d in range(2):
        os.makedirs(root / f"d{d}")
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8)).save(
                root / f"d{d}" / f"{i}.jpg")
            (root / f"d{d}" / f"{i}.txt").write_text(f"a dog runs {d} {i}")
    return str(root)


@pytest.mark.parametrize("device_augment", [False, True])
def test_tv_loader_equals_jax(caption_root, tokenizer, device_augment):
    from triad_tpu.data.tokenizer import WordPieceTokenizer as JT

    jtok = JT(tokenizer.vocab)
    for ds in ("captions", "synthetic"):
        make = (lambda m: m.LocalCaptionDataset(caption_root, SIZE)) if ds == "captions" else (
            lambda m: m.SyntheticTVDataset(10, SIZE, seed=2))
        p = PL.TVLoader(make(PD), tokenizer, 4, 16, seed=8, device_augment=device_augment)
        j = JL.TVLoader(make(JD), jtok, 4, 16, seed=8, device_augment=device_augment)
        for a, b in zip(p.epoch(1, 1), j.epoch(1, 1)):
            assert set(a) == set(b) and a["captions"] == b["captions"]
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k])


def test_worker_pools_equal_jax():
    """Thread mode, and one small spawn-process case."""
    from triad_tpu.data.workers import WorkerPool as JW
    from triad_tpu_torch.data.workers import WorkerPool as PW

    ds = PD.SyntheticAVDataset(6, SIZE, 0.05, seed=3)
    jds = JD.SyntheticAVDataset(6, SIZE, 0.05, seed=3)
    seeds = [(1, 0, 0, i) for i in range(4)]
    want = JW(jds, 2).map([5, 1, 3, 0], True, seeds)
    for mode in ("thread", "process"):
        pool = PW(ds, 1 if mode == "process" else 2, mode)
        got = pool.map([5, 1, 3, 0], True, seeds)
        pool.close()
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["video_frames"], b["video_frames"])
            np.testing.assert_array_equal(a["audio"], b["audio"])
    with pytest.raises(ValueError):
        PW(ds, 1, "fiber")


# --------------------------------------------------------------------------- device augmentation


def _av_raw(b, seed):
    from triad_tpu_torch.data.device_aug import av_param_arrays
    from triad_tpu_torch.data.images import draw_av_params

    frames = np.random.default_rng(seed).integers(0, 256, (b, SIZE, SIZE, 3), np.uint8)
    params = [draw_av_params(np.random.default_rng((seed, 0, 0, i))) for i in range(b)]
    audio = np.random.default_rng(seed + 1).integers(-32768, 32767, (b, SAMPLES), np.int16)
    return {"frames_u8": frames, "audio_i16": audio, **av_param_arrays(params)}, params


def _tv_raw(b, seed):
    from triad_tpu_torch.data.device_aug import tv_param_arrays
    from triad_tpu_torch.data.images import draw_tv_params

    frames = np.random.default_rng(seed).integers(0, 256, (b, SIZE, SIZE, 3), np.uint8)
    params = [draw_tv_params(np.random.default_rng((seed, 0, 0, i)), SIZE, SIZE)
              for i in range(b)]
    return {"frames_u8": frames, **tv_param_arrays(params),
            "token_ids": np.ones((b, 8), np.int32), "text_mask": np.ones((b, 8), np.float32),
            "captions": ["x"] * b}, params


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_augment_av_equals_jax_and_host(seed):
    from triad_tpu.data import device_aug as JA
    from triad_tpu_torch.data.device_aug import device_ingest_av
    from triad_tpu_torch.data.images import apply_av_batch

    batch, params = _av_raw(8, seed)
    got = device_ingest_av(batch, device="cpu")
    want = JA.device_ingest_av(batch)
    assert np.abs(got["images"].numpy() - np.asarray(want["images"])).max() <= 2e-6
    # XLA multiplies by 1/32767; the port divides, as the host path does
    assert np.abs(got["audio"].numpy() - np.asarray(want["audio"])).max() <= 2.0 ** -24
    np.testing.assert_array_equal(got["audio"].numpy(),
                                  batch["audio_i16"].astype(np.float32) / 32767.0)
    np.testing.assert_array_equal(got["images"].numpy(), apply_av_batch(
        batch["frames_u8"].astype(np.float32) / 255.0, params))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_augment_tv_equals_jax_and_host(seed):
    from triad_tpu.data import device_aug as JA
    from triad_tpu_torch.data.device_aug import device_ingest_tv
    from triad_tpu_torch.data.images import apply_tv_image

    batch, params = _tv_raw(8, seed)
    got = device_ingest_tv(batch, device="cpu")
    want = JA.device_ingest_tv(batch)
    assert np.abs(got["images"].numpy() - np.asarray(want["images"])).max() <= 2e-6
    host = np.stack([apply_tv_image(f.astype(np.float32) / 255.0, p)
                     for f, p in zip(batch["frames_u8"], params)])
    assert np.abs(got["images"].numpy() - host).max() <= 2e-6
    assert got["captions"] == batch["captions"]
    np.testing.assert_array_equal(got["token_ids"].numpy(), batch["token_ids"])


def test_device_augment_tv_clamps_shifts_as_jax():
    """A shift past the padding reads the clamped window, as
    jax.lax.dynamic_slice clamps its start."""
    from triad_tpu.data import device_aug as JA
    from triad_tpu_torch.data import device_aug as PA

    batch, _ = _tv_raw(2, 3)
    batch["aug_dx"] = np.array([40, -3], np.int32)
    batch["aug_dy"] = np.array([-45, 0], np.int32)
    args = [batch[k] for k in ("frames_u8", "aug_flip", "aug_dx", "aug_dy", "aug_perm",
                               "aug_factors")]
    got = PA.device_augment_tv(*(torch.from_numpy(a) for a in args)).numpy()
    assert np.abs(got - np.asarray(JA.device_augment_tv(*args))).max() <= 2e-6


def test_host_batches_pass_through_ingest():
    from triad_tpu_torch.data.device_aug import device_ingest_av, device_ingest_tv

    av = device_ingest_av({"images": np.ones((2, 4, 4, 3), np.float32),
                           "audio": np.zeros((2, 5), np.float32)}, device="cpu")
    assert isinstance(av["images"], torch.Tensor) and av["audio"].shape == (2, 5)
    tv = device_ingest_tv({"images": np.ones((2, 4, 4, 3), np.float32), "captions": ["a", "b"]},
                          device="cpu")
    assert tv["captions"] == ["a", "b"]


# --------------------------------------------------------------------------- Prefetcher


def test_prefetcher_keeps_order_and_runs_the_ingest_on_cpu():
    from triad_tpu_torch.data.device_aug import device_ingest_av

    raws = [_av_raw(2, s)[0] for s in range(5)]
    pf = PL.Prefetcher(iter(raws), prefetch=2, device_put=device_ingest_av, device="cpu")
    got = list(pf)
    assert len(got) == 5
    for g, raw in zip(got, raws):
        want = device_ingest_av(raw, device="cpu")
        assert torch.equal(g["images"], want["images"]) and torch.equal(g["audio"], want["audio"])
    with pytest.raises(StopIteration):
        next(pf)
    plain = list(PL.Prefetcher(iter([{"x": np.arange(3) + i, "tag": i} for i in range(4)]),
                               device="cpu"))
    assert [int(b["x"][0]) for b in plain] == [0, 1, 2, 3] and plain[2]["tag"] == 2


def test_prefetcher_reraises_iterator_errors():
    def broken():
        yield {"x": np.zeros(2)}
        raise KeyError("bad record")

    pf = PL.Prefetcher(broken(), device="cpu")
    next(pf)
    with pytest.raises(KeyError, match="bad record"):
        next(pf)


def test_prefetcher_close_stops_the_thread():
    made = []

    def endless():
        n = 0
        while True:
            made.append(n)
            yield {"n": np.array([n])}
            n += 1

    pf = PL.Prefetcher(endless(), prefetch=2, device="cpu")
    assert int(next(pf)["n"][0]) == 0
    time.sleep(0.1)
    pf.close()
    assert not pf._thread.is_alive()
    count = len(made)
    time.sleep(0.1)
    assert len(made) == count


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_prefetcher_asked_for_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.Prefetcher(iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.Prefetcher(iter([]), device="cuda:0")
