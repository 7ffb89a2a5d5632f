"""Datasets of the port: copies of ``triad_tpu/data/datasets.py``, which
give bit-equal items for the same files, seed, index and draws.

Disk layouts mirror the reference:

* ``LocalCaptionDataset`` (reference dataset.py:29-78): root/*/ *.jpg
  with a sibling .txt caption; augmented train transform vs clean
  transform; decode failure -> zero image + "" (dataset.py:74-78).
* ``AudioVisualDataset`` (reference dataset.py:166-214): root/segment_N/
  shards of .mp4; ``switch_segment()`` hops to a random other shard
  (per-epoch, checkpointed); failures -> zero tensors.
* ``FlatAudioVisualDataset`` (reference dataset.py:217-262): flat dir of
  .mp4 (validation); switch_segment is a no-op.

``SyntheticAVDataset`` / ``SyntheticTVDataset`` and the grounded
``GroundedSynthetic{Spec,AV,TV}`` produce deterministic random media for
tests and benches. TriadPack shards (``data/packed.py``) hold pre-decoded
AV records.

All datasets return numpy; batching, padding and tokenization happen in
``triad_tpu_torch.data.pipeline``, and device placement in its
``Prefetcher``.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from triad_tpu_torch.data.audio import FALLBACK_NUM_SAMPLES, extract_audio
from triad_tpu_torch.data.images import (
    augment_tv_image,
    clean_image,
    load_image,
)
from triad_tpu_torch.data.video import load_video_frame


class LocalCaptionDataset:
    """Image-caption pairs from root/*/ *.jpg + .txt."""

    def __init__(self, root_dir: str, image_size: int = 224, augment: bool = True):
        self.root = Path(root_dir)
        self.image_size = image_size
        self.augment = augment
        self.image_files: List[Path] = []
        for subdir in sorted(self.root.iterdir()):
            if subdir.is_dir():
                self.image_files.extend(sorted(subdir.glob("*.jpg")))
        print(f"Found {len(self.image_files)} images in {self.root}")

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(
        self, idx: int, apply_augmentation: Optional[bool] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, str]:
        """``rng``: augmentation RNG. The loaders pass one keyed on
        (seed, epoch, batch, idx) so a resumed run replays the exact
        augmentations of an uninterrupted one (the reference restores
        all four RNG states instead, train.py:500-514)."""
        aug = self.augment if apply_augmentation is None else apply_augmentation
        img_path = self.image_files[idx]
        try:
            img = load_image(str(img_path), self.image_size)
            if rng is None:
                rng = np.random.default_rng(random.getrandbits(32))
            img = augment_tv_image(img, rng) if aug else clean_image(img)
            caption = img_path.with_suffix(".txt").read_text().strip()
            return img, caption
        except Exception as e:  # noqa: BLE001 — reference swallows (dataset.py:74-78)
            print(f"Error loading {img_path}: {e}")
            return np.zeros((self.image_size, self.image_size, 3), np.float32), ""

    def raw_item(self, idx: int) -> dict:
        """Wire-dtype access for on-device TV augmentation: the decoded
        uint8 pixels + caption, augmentation deferred to the device
        (data/device_aug.device_augment_tv). Exact vs the host path when
        images are pre-sized on disk (the reference's contract — its
        transform has NO resize, dataset.py:32-44); off-spec sizes are
        bilinear-resized then rounded back to uint8 (<=1/255 wire
        quantization). Same zero-fallback semantics as __getitem__."""
        from PIL import Image

        from triad_tpu_torch.data.images import resize_bilinear

        img_path = self.image_files[idx]
        try:
            with Image.open(img_path) as im:
                arr = np.asarray(im.convert("RGB"), np.uint8)
            if arr.shape[:2] != (self.image_size, self.image_size):
                arr = np.clip(
                    np.round(
                        resize_bilinear(
                            arr.astype(np.float32) / 255.0, self.image_size
                        ) * 255.0
                    ), 0, 255,
                ).astype(np.uint8)
            caption = img_path.with_suffix(".txt").read_text().strip()
            return {"image_u8": arr, "caption": caption}
        except Exception as e:  # noqa: BLE001
            print(f"Error loading {img_path}: {e}")
            return {
                "image_u8": np.zeros(
                    (self.image_size, self.image_size, 3), np.uint8
                ),
                "caption": "",
            }


class AudioVisualDataset:
    """Segmented video shards: root/segment_N/*.mp4."""

    def __init__(self, data_root: str, image_size: int = 224):
        self.root = Path(data_root)
        self.image_size = image_size
        folders = sorted(
            (d for d in self.root.iterdir() if d.is_dir()),
            key=lambda x: int(x.name.split("_")[1]),
        )
        self.segment_to_videos: Dict[int, List[Path]] = {
            int(f.name.split("_")[1]): sorted(f.glob("*.mp4")) for f in folders
        }
        self.current_segment = min(self.segment_to_videos)
        self.video_files = self.segment_to_videos[self.current_segment]

    def switch_segment(self, rng: Optional[random.Random] = None) -> None:
        """Hop to a random different shard (reference dataset.py:179-186);
        the current segment id is checkpointed by the trainer."""
        others = [s for s in self.segment_to_videos if s != self.current_segment]
        if others:
            self.current_segment = (rng or random).choice(others)
            self.video_files = self.segment_to_videos[self.current_segment]
            print(f"Switching segment to {self.current_segment}")

    def set_segment(self, segment: int) -> None:
        if segment in self.segment_to_videos:
            self.current_segment = segment
            self.video_files = self.segment_to_videos[segment]

    def __len__(self) -> int:
        return len(self.video_files)

    def __getitem__(
        self, idx: int, apply_augmentation: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict:
        """``rng`` seeds both the random-frame pick and the augmentation
        draws (keyed per (seed, epoch, batch, idx) by the loaders for
        exact mid-epoch resume)."""
        path = self.video_files[idx]
        try:
            audio = extract_audio(str(path))
        except Exception as e:  # noqa: BLE001
            print(f"Error processing {path} audio: {e}")
            audio = np.zeros(FALLBACK_NUM_SAMPLES, np.float32)
        try:
            frame = load_video_frame(
                str(path), rng=rng, size=self.image_size,
                apply_augmentation=apply_augmentation,
            )
        except Exception as e:  # noqa: BLE001
            print(f"Error processing {path} video frame: {e}")
            frame = np.zeros((self.image_size, self.image_size, 3), np.float32)
        return {"video_path": str(path), "video_frames": frame, "audio": audio}


class FlatAudioVisualDataset(AudioVisualDataset):
    """Flat directory of .mp4 (validation layout, dataset.py:217-262)."""

    def __init__(self, data_root: str, image_size: int = 224):
        self.root = Path(data_root)
        self.image_size = image_size
        self.video_files = sorted(self.root.glob("*.mp4"))
        if not self.video_files:
            raise ValueError(f"No MP4 files found in {data_root}")
        self.segment_to_videos = {0: self.video_files}
        self.current_segment = 0
        print(f"Found {len(self.video_files)} videos in flat directory {data_root}")

    def switch_segment(self, rng=None) -> None:
        pass


# ---------------------------------------------------------------------------
# Synthetic datasets (deterministic; for tests and benches)
# ---------------------------------------------------------------------------

_WORDS = (
    "a the dog cat man woman child ball park beach tree car bike water sky "
    "red blue green small large playing running sitting jumping eating "
    "guitar drum bird plane train street house garden snow rain sun"
).split()


class SyntheticTVDataset:
    def __init__(self, size: int = 256, image_size: int = 224, seed: int = 0):
        self.size = size
        self.image_size = image_size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(
        self, idx: int, apply_augmentation: Optional[bool] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, str]:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        img = rng.uniform(0, 1, size=(self.image_size, self.image_size, 3))
        img = clean_image(img.astype(np.float32))
        n = int(rng.integers(3, 9))
        caption = " ".join(rng.choice(_WORDS, size=n))
        return img, caption

    def captions(self) -> List[str]:
        return [self[i][1] for i in range(len(self))]


class SyntheticAVDataset:
    def __init__(
        self,
        size: int = 256,
        image_size: int = 224,
        audio_seconds: float = 10.0,
        sample_rate: int = 16_000,
        seed: int = 0,
    ):
        self.size = size
        self.image_size = image_size
        self.num_samples = int(audio_seconds * sample_rate)
        self.seed = seed
        self.current_segment = 0

    def switch_segment(self, rng=None) -> None:
        pass

    def set_segment(self, segment: int) -> None:
        self.current_segment = segment

    def __len__(self) -> int:
        return self.size

    def __getitem__(
        self, idx: int, apply_augmentation: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict:
        rng = np.random.default_rng(self.seed * 7_000_003 + idx)
        img = rng.uniform(0, 1, size=(self.image_size, self.image_size, 3))
        frame = clean_image(img.astype(np.float32))
        t = np.arange(self.num_samples, dtype=np.float32) / 16000.0
        freq = float(rng.uniform(80, 2000))
        audio = (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        audio += rng.normal(0, 0.01, size=audio.shape).astype(np.float32)
        return {
            "video_path": f"synthetic://{idx}",
            "video_frames": frame,
            "audio": audio,
        }


_GROUNDED_WORDS = ("circle", "square", "triangle", "diamond",
                   "star", "cross", "ring", "wave")


class GroundedSyntheticSpec:
    """Shared class structure for the grounded synthetic datasets.

    Class ``k`` couples all three modalities: a bright square occupying
    one patch-aligned cell of the image grid (position keyed by k), a
    pure tone at a class-specific frequency, and a class word. Unlike
    the noise-pair ``Synthetic*`` datasets (instance-level only), this
    gives contrastive training a LEARNABLE dense correspondence: the
    grounding the reference trains for (README.md:9-15), testable
    end-to-end without real media (tests/test_learning.py asserts
    above-chance cross-modal retrieval AND that token-level attention
    localizes the square)."""

    def __init__(
        self,
        num_classes: int = 4,
        image_size: int = 56,
        patch_size: int = 14,
        sample_rate: int = 16_000,
    ):
        if num_classes > len(_GROUNDED_WORDS):
            raise ValueError(f"at most {len(_GROUNDED_WORDS)} classes")
        self.num_classes = num_classes
        self.image_size = image_size
        self.patch_size = patch_size
        self.sample_rate = sample_rate
        self.grid = image_size // patch_size

    def cell(self, k: int) -> Tuple[int, int]:
        """(row, col) of class k's square in the patch grid — spread
        over the grid diagonal-ish so classes never share a cell."""
        n = self.grid * self.grid
        idx = (k * (n // self.num_classes)) % n
        return idx // self.grid, idx % self.grid

    def frequency(self, k: int) -> float:
        return 220.0 * (2.0 ** k)  # octave spacing: 220, 440, 880, ...

    def word(self, k: int) -> str:
        return _GROUNDED_WORDS[k]

    def color(self, k: int) -> np.ndarray:
        """Saturated class color — a patch-CONTENT cue that survives a
        frozen randomly-initialized backbone (position-only cues were
        measured unlearnable through frozen-base+LoRA at tiny scale:
        visual same/diff-class cosine 0.997/0.995 after 240 steps)."""
        base = np.array([
            [1.0, 0.15, 0.15], [0.15, 1.0, 0.15], [0.15, 0.3, 1.0],
            [1.0, 1.0, 0.15], [1.0, 0.15, 1.0], [0.15, 1.0, 1.0],
            [1.0, 0.55, 0.15], [0.55, 0.15, 1.0],
        ])
        return base[k % len(base)]

    def image(self, k: int, rng: np.random.Generator) -> np.ndarray:
        """Dim noise background + class-colored square at the class
        cell, ImageNet-normalized float32 (H, W, 3)."""
        img = rng.uniform(0.0, 0.25, size=(self.image_size, self.image_size, 3))
        r, c = self.cell(k)
        p = self.patch_size
        img[r * p : (r + 1) * p, c * p : (c + 1) * p, :] = self.color(k) * (
            rng.uniform(0.8, 1.0, size=(p, p, 1))
        )
        return clean_image(img.astype(np.float32))

    def audio(
        self, k: int, num_samples: int, rng: np.random.Generator
    ) -> np.ndarray:
        t = np.arange(num_samples, dtype=np.float32) / self.sample_rate
        x = 0.3 * np.sin(2 * np.pi * self.frequency(k) * t)
        return (x + rng.normal(0, 0.02, size=num_samples)).astype(np.float32)


class GroundedSyntheticAVDataset:
    """Audio-visual pairs with class-keyed correspondence (see
    GroundedSyntheticSpec). Item ``idx`` has class ``idx % K``; use
    ``seed`` to draw disjoint train/eval noise."""

    def __init__(
        self,
        size: int = 256,
        audio_seconds: float = 1.0,
        spec: Optional[GroundedSyntheticSpec] = None,
        seed: int = 0,
    ):
        self.spec = spec or GroundedSyntheticSpec()
        self.size = size
        self.num_samples = int(audio_seconds * self.spec.sample_rate)
        self.seed = seed
        self.current_segment = 0

    def switch_segment(self, rng=None) -> None:
        pass

    def set_segment(self, segment: int) -> None:
        self.current_segment = segment

    def __len__(self) -> int:
        return self.size

    def label(self, idx: int) -> int:
        return idx % self.spec.num_classes

    def __getitem__(
        self, idx: int, apply_augmentation: bool = True,
        rng: Optional[np.random.Generator] = None,
    ) -> Dict:
        k = self.label(idx)
        rng = np.random.default_rng(self.seed * 9_000_011 + idx)
        return {
            "video_path": f"grounded://{k}/{idx}",
            "video_frames": self.spec.image(k, rng),
            "audio": self.spec.audio(k, self.num_samples, rng),
        }


class GroundedSyntheticTVDataset:
    """Text-visual pairs with class-keyed correspondence: the caption
    is the class word (see GroundedSyntheticSpec)."""

    def __init__(
        self,
        size: int = 256,
        spec: Optional[GroundedSyntheticSpec] = None,
        seed: int = 0,
    ):
        self.spec = spec or GroundedSyntheticSpec()
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def label(self, idx: int) -> int:
        return idx % self.spec.num_classes

    def __getitem__(
        self, idx: int, apply_augmentation: Optional[bool] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> Tuple[np.ndarray, str]:
        k = self.label(idx)
        rng = np.random.default_rng(self.seed * 11_000_017 + idx)
        return self.spec.image(k, rng), self.spec.word(k)

    def captions(self) -> List[str]:
        return [self.spec.word(self.label(i)) for i in range(len(self))]
