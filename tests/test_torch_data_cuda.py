"""The port's data layer on the card: the device augmentation against the
host path (``images.apply_av_batch`` / ``apply_tv_image``) on the same
draws, B from 1 to 64 at 224^2, the ``Prefetcher``'s pinned ring under a
slow consumer, and the native library's build on the card's host.

Needs an NVIDIA GPU; skips elsewhere. On a machine with the card and no
JAX (tests/conftest.py imports JAX, hence --noconftest):
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_data_cuda.py

Tolerance: the device and the host compute the same float32 math; they
may differ in the order of the per-image mean's sum, so each output is
held within 1e-4 absolute (the normalized pixels lie within about 2.7).
"""

import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frames(b, size, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(b, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("b", [1, 2, 17, 64])
def test_device_augment_av_matches_host(dev, b):
    from triad_tpu_torch.data.device_aug import av_param_arrays, device_ingest_av
    from triad_tpu_torch.data.images import apply_av_batch, draw_av_params

    frames = _frames(b, 224, b)
    audio = np.random.default_rng(b + 1).integers(-32768, 32767, size=(b, 1600), dtype=np.int16)
    params = [draw_av_params(np.random.default_rng((3, 0, 1, i))) for i in range(b)]
    got = device_ingest_av({"frames_u8": frames, "audio_i16": audio, **av_param_arrays(params)},
                           device=dev)
    assert got["images"].is_cuda and got["images"].dtype == torch.float32
    want = apply_av_batch(frames.astype(np.float32) / 255.0, params)
    err = float(np.abs(got["images"].cpu().numpy() - want).max())
    assert err <= TOL, err
    np.testing.assert_array_equal(got["audio"].cpu().numpy(),
                                  audio.astype(np.float32) / 32767.0)


@pytest.mark.parametrize("b", [1, 2, 17, 64])
def test_device_augment_tv_matches_host(dev, b):
    from triad_tpu_torch.data.device_aug import device_ingest_tv, tv_param_arrays
    from triad_tpu_torch.data.images import apply_tv_image, draw_tv_params

    frames = _frames(b, 224, 100 + b)
    params = [draw_tv_params(np.random.default_rng((5, 1, 2, i)), 224, 224) for i in range(b)]
    ids = np.ones((b, 32), np.int32)
    batch = {"frames_u8": frames, **tv_param_arrays(params), "token_ids": ids,
             "text_mask": np.ones((b, 32), np.float32)}
    got = device_ingest_tv(batch, device=dev)["images"].cpu().numpy()
    want = np.stack([apply_tv_image(f.astype(np.float32) / 255.0, p)
                     for f, p in zip(frames, params)])
    err = float(np.abs(got - want).max())
    assert err <= TOL, err


def _pattern(n, shape, dtype):
    """Batch n's content: every element (n * 7 + position) mod 251."""
    return ((np.arange(int(np.prod(shape)), dtype=np.int64) + n * 7) % 251).astype(
        dtype).reshape(shape)


def test_prefetcher_ring_under_a_slow_consumer(dev):
    """The producer runs ahead of a consumer that sleeps on the host and
    queues its reads behind a long kernel: every batch arrives as it was
    made (no pinned slot refilled before its copy ended, no device block
    reused before the consumer's queued reads ran)."""
    from triad_tpu_torch.data.pipeline import Prefetcher

    shape = (64, 224, 224, 3)
    n_batches = 10

    def batches():
        for n in range(n_batches):
            yield {"frames_u8": _pattern(n, shape, np.uint8),
                   "audio_i16": _pattern(n, (64, 16000), np.int16), "n": n}

    pf = Prefetcher(batches(), prefetch=2, device=dev)
    sums = []
    for n, batch in enumerate(pf):
        assert batch["n"] == n
        torch.cuda._sleep(20_000_000)  # queue the reads behind ~10 ms of spinning
        sums.append((batch["frames_u8"].to(torch.int64).sum(),
                     batch["audio_i16"].to(torch.int64).sum()))
        del batch
        time.sleep(0.03)
    pf.close()
    assert len(sums) == n_batches
    for n, (fs, aus) in enumerate(sums):
        assert int(fs) == int(_pattern(n, shape, np.uint8).astype(np.int64).sum()), n
        assert int(aus) == int(_pattern(n, (64, 16000), np.int16).astype(np.int64).sum()), n


def test_prefetcher_runs_the_ingest_on_the_card(dev):
    from triad_tpu_torch.data.device_aug import av_param_arrays, device_ingest_av
    from triad_tpu_torch.data.images import draw_av_params
    from triad_tpu_torch.data.pipeline import Prefetcher

    def batches():
        for n in range(4):
            params = [draw_av_params(np.random.default_rng((0, 0, n, i))) for i in range(8)]
            yield {"frames_u8": _frames(8, 64, n), "audio_i16": _pattern(n, (8, 800), np.int16),
                   **av_param_arrays(params)}

    want = [device_ingest_av(b, device=dev) for b in batches()]
    pf = Prefetcher(batches(), prefetch=2, device_put=device_ingest_av, device=dev)
    got = list(pf)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g["images"], w["images"]) and torch.equal(g["audio"], w["audio"])


def test_prefetcher_reraises_on_the_card(dev):
    from triad_tpu_torch.data.pipeline import Prefetcher

    def batches():
        yield {"x": np.zeros(4, np.float32)}
        raise ValueError("broken shard")

    pf = Prefetcher(batches(), device=dev)
    assert torch.equal(next(pf)["x"], torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="broken shard"):
        next(pf)


def test_native_library_builds_and_loads(dev):
    from triad_tpu_torch.data import native

    assert native.available(), native.load_error
    assert native.library_path().exists()
    x = np.sin(np.arange(4800, dtype=np.float32) / 7.0)
    out = native.resample(x, 48_000, 16_000)
    assert out.shape == (1600,) and np.isfinite(out).all()
