"""Host data layer of the port: decode, datasets, TriadPack shards,
loaders with an exact resume cursor, a pinned-memory prefetcher and
on-device augmentation. The exported names are the JAX package's
(``triad_tpu/data/__init__.py``). Importing the package builds nothing:
the native library builds at first use (``native.build``)."""

from triad_tpu_torch.data.audio import extract_audio, pad_or_trim, resample
from triad_tpu_torch.data.packed import PackedAVDataset, pack_dataset
from triad_tpu_torch.data.datasets import (
    AudioVisualDataset,
    FlatAudioVisualDataset,
    LocalCaptionDataset,
    SyntheticAVDataset,
    SyntheticTVDataset,
)
from triad_tpu_torch.data.images import (
    augment_av_frame,
    augment_tv_image,
    clean_image,
    imagenet_normalize,
    load_image,
    resize_bilinear,
)
from triad_tpu_torch.data.pipeline import AVLoader, Prefetcher, TVLoader, cycling
from triad_tpu_torch.data.tokenizer import WordPieceTokenizer
from triad_tpu_torch.data.video import load_video_frame

__all__ = [
    "AVLoader",
    "AudioVisualDataset",
    "PackedAVDataset",
    "pack_dataset",
    "FlatAudioVisualDataset",
    "LocalCaptionDataset",
    "Prefetcher",
    "SyntheticAVDataset",
    "SyntheticTVDataset",
    "TVLoader",
    "WordPieceTokenizer",
    "augment_av_frame",
    "augment_tv_image",
    "clean_image",
    "cycling",
    "extract_audio",
    "imagenet_normalize",
    "load_image",
    "load_video_frame",
    "pad_or_trim",
    "resample",
    "resize_bilinear",
]
