"""TriadPack: packed pre-decoded dataset shards for accelerator-rate
ingest. The port's copy of ``triad_tpu/data/packed.py``: the TPK1 layout
byte for byte, so a shard written by either package reads in the other.

The reference decodes H.264+AAC per sample in DataLoader workers
(dataset.py:91-135, 80-89). TriadPack decodes ONCE offline into an
mmap-able shard of fixed-layout records; the training loaders then
stream records at disk bandwidth and spend worker CPU only on the
augmentations (or ship raw records to the device, data/device_aug.py).

Record layout (little-endian, per sample):
  frame: uint8 (image_size, image_size, 3) RGB — decoded, resized,
         NOT normalized (augmentation wants [0,1] floats; the reader
         converts and the standard augment/normalize path applies).
  audio: int16 mono at 16 kHz, ``audio_samples`` samples, clipped
         [-1, 1] scaled by 32767 (storage halved vs float32).

File layout:
  [16-byte header: magic 'TPK1', u32 n_samples, u32 image_size,
   u32 audio_samples]
  [n_samples x record]                       (fixed stride -> O(1) seek)
  [JSON trailer: {"paths": [...]} + u64 trailer_size]

A 224x224 frame (150,528 bytes) + 10 s of audio (320,000 bytes) is a
470,528-byte record.

``pack_dataset`` builds shards from any AV dataset (decode happens
there, once); ``PackedAVDataset`` is a drop-in AudioVisualDataset
replacement (same __getitem__ contract incl. deterministic-rng
augmentation and zero-tensor fault tolerance) backed by one or more
shards.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from triad_tpu_torch.data.audio import pad_or_trim
from triad_tpu_torch.data.images import (
    IMAGENET_MEAN as _MEAN,
    IMAGENET_STD as _STD,
    augment_av_frame,
    imagenet_normalize,
)

_MAGIC = b"TPK1"
_HEADER = struct.Struct("<4sIII")


def _record_size(image_size: int, audio_samples: int) -> int:
    return image_size * image_size * 3 + 2 * audio_samples


def pack_dataset(
    dataset,
    out_path: str,
    image_size: int = 224,
    audio_samples: int = 160_000,
    indices: Optional[Sequence[int]] = None,
) -> int:
    """Decode every sample of an AV dataset once into a TriadPack shard.

    ``dataset``: anything with the AudioVisualDataset __getitem__
    contract. Samples are fetched WITHOUT augmentation (raw pixels are
    stored; augmentation happens at read time so epochs still differ).
    Returns the number of samples written.
    """
    idx = list(indices) if indices is not None else list(range(len(dataset)))
    paths: List[str] = []
    with open(out_path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, len(idx), image_size, audio_samples))
        for i in idx:
            item = dataset.__getitem__(i, apply_augmentation=False)
            frame = np.asarray(item["video_frames"], np.float32)
            if frame.shape[:2] != (image_size, image_size):
                raise ValueError(
                    f"sample {i}: frame {frame.shape} != {image_size}"
                )
            # Datasets return normalized floats for the un-augmented
            # path; invert ImageNet normalization back to [0,1] pixels
            # so the stored record is augmentation-ready raw RGB (the
            # constants are the read-time imagenet_normalize's —
            # data/images.py — so pack and read cannot diverge).
            pixels = np.clip(frame * _STD + _MEAN, 0.0, 1.0)
            f.write(np.round(pixels * 255.0).astype(np.uint8).tobytes())
            audio = pad_or_trim(
                np.asarray(item["audio"], np.float32), audio_samples
            )
            a16 = np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
            f.write(a16.tobytes())
            paths.append(str(item.get("video_path", f"packed://{i}")))
        trailer = json.dumps({"paths": paths}).encode()
        f.write(trailer)
        f.write(struct.pack("<Q", len(trailer)))
    return len(idx)


class _Shard:
    def __init__(self, path: str):
        self.path = path
        self.mm = np.memmap(path, np.uint8, mode="r")
        magic, n, image_size, audio_samples = _HEADER.unpack(
            self.mm[: _HEADER.size].tobytes()
        )
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a TriadPack file")
        self.n = n
        self.image_size = image_size
        self.audio_samples = audio_samples
        self.stride = _record_size(image_size, audio_samples)
        (tsize,) = struct.unpack("<Q", self.mm[-8:].tobytes())
        trailer = json.loads(self.mm[-8 - tsize : -8].tobytes())
        self.paths = trailer["paths"]
        expect = _HEADER.size + n * self.stride + tsize + 8
        if len(self.mm) != expect:
            raise ValueError(
                f"{path}: size {len(self.mm)} != expected {expect}"
            )

    def record(self, i: int):
        off = _HEADER.size + i * self.stride
        img_n = self.image_size * self.image_size * 3
        frame_u8 = self.mm[off : off + img_n].reshape(
            self.image_size, self.image_size, 3
        )
        a16 = self.mm[off + img_n : off + self.stride].view("<i2")
        return frame_u8, a16


class PackedAVDataset:
    """AudioVisualDataset-compatible reader over TriadPack shard(s).

    ``root``: one .tpack file, or a directory of ``*.tpack`` shards
    (sorted; shard boundaries are transparent). ``switch_segment`` hops
    between shards like the reference's segment folders
    (dataset.py:179-186) when ``segmented=True``; default is the flat
    view over all shards (validation semantics).
    """

    def __init__(self, root: str, segmented: bool = False):
        p = Path(root)
        files = [p] if p.is_file() else sorted(p.glob("*.tpack"))
        if not files:
            raise ValueError(f"no .tpack shards under {root}")
        self.shards = [_Shard(str(f)) for f in files]
        self.image_size = self.shards[0].image_size
        self.audio_samples = self.shards[0].audio_samples
        for f, s in zip(files, self.shards):
            if (s.image_size, s.audio_samples) != (
                self.image_size, self.audio_samples
            ):
                raise ValueError(
                    f"shard {f}: geometry ({s.image_size}px, "
                    f"{s.audio_samples} samples) != first shard "
                    f"({self.image_size}px, {self.audio_samples})"
                )
        self.segmented = segmented
        self.current_segment = 0
        self._offsets = np.cumsum([0] + [s.n for s in self.shards])

    # -- segment interface (reference dataset.py:179-186) ---------------

    def switch_segment(self, rng=None) -> None:
        if not self.segmented or len(self.shards) < 2:
            return
        import random as _random

        others = [
            i for i in range(len(self.shards)) if i != self.current_segment
        ]
        self.current_segment = (rng or _random).choice(others)
        print(f"Switching segment to {self.current_segment}")

    def set_segment(self, segment: int) -> None:
        if 0 <= segment < len(self.shards):
            self.current_segment = segment

    @property
    def video_files(self) -> List[str]:
        if self.segmented:
            return self.shards[self.current_segment].paths
        return [p for s in self.shards for p in s.paths]

    def __len__(self) -> int:
        if self.segmented:
            return self.shards[self.current_segment].n
        return int(self._offsets[-1])

    def _locate(self, idx: int):
        n = len(self)
        if idx < 0:
            idx += n  # python negative-index semantics (reference
            # dataset.py: video_files[idx])
        if not 0 <= idx < n:
            # OUTSIDE the fault-tolerance net on purpose: a bad index is
            # a sampler/segment logic error, not a corrupt record —
            # zero-tensor fallbacks would mask it (and Python's
            # __getitem__ iteration protocol needs the IndexError).
            raise IndexError(f"index {idx} out of range for {n} samples")
        if self.segmented:
            return self.shards[self.current_segment], idx
        s = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.shards[s], idx - int(self._offsets[s])

    def raw_item(self, idx: int) -> Dict:
        """Un-augmented record at STORAGE dtypes (uint8 pixels, int16
        audio). The loaders use this for the batched-augmentation fast
        path — per-item numpy augmentation (and per-item fp32
        conversion: ~0.7 ms/clip of the 1-core ingest budget, measured
        in scripts/data_throughput.py) is GIL-bound at chip-rate
        ingest, so all dtype conversion happens batched downstream
        (data/pipeline.py) or on the device (data/device_aug.py)."""
        shard, local = self._locate(idx)
        try:
            frame_u8, a16 = shard.record(local)
            return {
                "video_path": shard.paths[local],
                "frame_u8": np.asarray(frame_u8),
                "audio_i16": np.asarray(a16),
            }
        except Exception as e:  # noqa: BLE001 — reference fault tolerance
            print(f"Error reading packed sample {idx}: {e}")
            return {
                "video_path": f"packed://{idx}",
                "frame_u8": np.zeros(
                    (self.image_size, self.image_size, 3), np.uint8
                ),
                "audio_i16": np.zeros(self.audio_samples, np.int16),
            }

    def __getitem__(
        self, idx: int, apply_augmentation: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict:
        # _locate raises IndexError for out-of-range indices (logic
        # errors propagate); only record decode is fault-tolerant.
        shard, local = self._locate(idx)
        try:
            frame_u8, a16 = shard.record(local)
            frame = frame_u8.astype(np.float32) / 255.0
            if apply_augmentation:
                frame = augment_av_frame(
                    frame, rng or np.random.default_rng()
                )
            else:
                frame = imagenet_normalize(frame)
            audio = a16.astype(np.float32) / 32767.0
            return {
                "video_path": shard.paths[local],
                "video_frames": frame,
                "audio": audio,
            }
        except Exception as e:  # noqa: BLE001 — reference fault tolerance
            print(f"Error reading packed sample {idx}: {e}")
            return {
                "video_path": f"packed://{idx}",
                "video_frames": np.zeros(
                    (self.image_size, self.image_size, 3), np.float32
                ),
                "audio": np.zeros(self.audio_samples, np.float32),
            }


def _main(argv=None) -> int:
    """CLI: decode a reference-layout AV root once into a .tpack shard.

    python -m triad_tpu_torch.data.packed --root /data/audioset --out /data/p.tpack
    """
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True, help="AV dataset root")
    parser.add_argument("--out", required=True, help="output .tpack path")
    parser.add_argument(
        "--flat", action="store_true",
        help="flat layout (FlatAudioVisualDataset) instead of segments",
    )
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--audio-samples", type=int, default=160_000)
    args = parser.parse_args(argv)

    from triad_tpu_torch.data.datasets import (
        AudioVisualDataset,
        FlatAudioVisualDataset,
    )

    cls = FlatAudioVisualDataset if args.flat else AudioVisualDataset
    ds = cls(args.root, image_size=args.image_size)
    n = pack_dataset(
        ds, args.out, image_size=args.image_size,
        audio_samples=args.audio_samples,
    )
    print(f"packed {n} samples -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
