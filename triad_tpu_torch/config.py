"""The config tree of the port: frozen dataclasses and the tuned presets.

An own copy of ``triad_tpu/core/config.py`` with the same fields,
defaults and values, so a config written by either package loads in the
other (``tests/test_torch_isolation.py`` holds the two equal field for
field). Every module of the port takes its configs from here. Fields that
only choose a TPU tiling are kept so configs load the same; the port
ignores them (``IGNORED_TPU_KNOBS``), and ``apply_train_knobs`` refuses
the knobs that set them.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


# Config fields that only choose a TPU tiling or layout (VMEM block rows,
# token padding, waveform wire layout, frontend block size). They do not
# change what a model computes, and the CUDA kernels choose their own
# tiles, so the port reads none of them.
IGNORED_TPU_KNOBS = (
    "frontend_wave_layout",
    "frontend_tb",
    "mlp_block_rows",
    "ln_block_rows",
    "attention_pad",
)
_UNREAD_FIELDS = frozenset(IGNORED_TPU_KNOBS)


# ---------------------------------------------------------------------------
# Encoder configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViTConfig:
    """DINOv2 ViT-B/14 with register tokens and LoRA on qkv and proj."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    layerscale_init: float = 1.0
    ffn_bias: bool = True
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-6
    lora_rank: int = 8
    lora_alpha: float = 16.0
    # "folded": x (W + s B A)^T; "separate": x W^T + s (x A^T) B^T.
    lora_compute: str = "folded"
    # "float32" = torch-parity softmax scores; "bfloat16" = bf16 scores.
    attention_scores_dtype: str = "float32"
    # "xla" plain attention, "packed*" / "fused*" the attention kernels.
    attention_impl: str = "xla"
    # "xla" = Dense/GELU/Dense; "fused" = the fused MLP kernel.
    mlp_impl: str = "xla"
    # GELU form inside the fused MLP kernel: "erf" or "tanh".
    mlp_gelu: str = "erf"
    mlp_block_rows: int = 1  # TPU tiling knob
    attention_pad: str = "hbm"  # TPU tiling knob

    @property
    def num_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class HubertConfig:
    """HuBERT-base: 7-layer conv feature encoder with a group norm on
    layer 0, a grouped conv positional embedding, a 12-layer post-LN
    transformer."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_proj_layer_norm: bool = True
    layer_norm_eps: float = 1e-5
    # Zero-mean / unit-variance normalization per padded batch row before
    # the conv stack.
    normalize_waveform: bool = True
    attention_scores_dtype: str = "float32"
    # "auto": the fused MLP kernel on the accelerator, plain ops elsewhere;
    # "xla" / "fused" force one.
    mlp_impl: str = "auto"
    mlp_gelu: str = "erf"
    mlp_block_rows: int = 1  # TPU tiling knob
    attention_pad: str = "hbm"  # TPU tiling knob
    # "auto": the attention-dropout kernel while training with live
    # attention dropout on the accelerator, plain attention elsewhere.
    # "xla" / "fused" / "flash" / "packed" / "fused_packed" /
    # "packed_merged" / "fused_packed_merged" force one.
    attention_impl: str = "auto"
    # "auto": the fused dropout + residual + LayerNorm kernel while
    # training with live hidden dropout on the accelerator, plain ops
    # elsewhere. "xla" / "fused" force one.
    ln_impl: str = "auto"
    ln_block_rows: int = 1  # TPU tiling knob
    # Waveform frontend: "conv" plain convolutions, "monolithic" the
    # frontend kernels; "matmul", "block_matmul", "phase", "pallas" and
    # "conv_act" are other lowerings of the same function.
    frontend_impl: str = "conv"
    # GELU inside the "monolithic" frontend only: "tanh" or "erf".
    frontend_gelu: str = "tanh"
    frontend_wave_layout: str = "x10"  # TPU tiling knob
    frontend_tb: int = 64  # TPU tiling knob
    # Positional grouped conv: "conv" plain grouped convolution, "pallas"
    # the positional conv kernel (forward, dX and dW).
    posconv_impl: str = "conv"
    # Rematerialization for the backward: "none", "conv", "chunked_conv",
    # "full".
    remat: str = "chunked_conv"
    frontend_chunk_tokens: int = 128
    # Training dropouts (HF HubertConfig defaults).
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    layerdrop: float = 0.1
    # SpecAugment time masking (HF defaults): masked positions take the
    # learned masked_spec_embed vector, which exists iff mask_time_prob > 0.
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2

    def num_audio_tokens(self, num_samples: int) -> int:
        """Output sequence length of the conv feature encoder."""
        t = num_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t


@dataclass(frozen=True)
class DistilBertConfig:
    """DistilBERT-base-uncased."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12
    attention_scores_dtype: str = "float32"
    attention_impl: str = "xla"
    dropout: float = 0.1
    attention_dropout: float = 0.1
    max_text_tokens: int = 128


# ---------------------------------------------------------------------------
# Model / loss configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """The combined tri-modal model."""

    embedding_dim: int = 512
    temperature_init: float = 1.5
    visual_dropout_prob: float = 0.25
    vit: ViTConfig = field(default_factory=ViTConfig)
    hubert: HubertConfig = field(default_factory=HubertConfig)
    text: DistilBertConfig = field(default_factory=DistilBertConfig)
    # bf16 compute for the encoders, fp32 parameters and loss math.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class LossConfig:
    """Loss hyperparameters."""

    av_nonneg_clamp_min: float = -60.0
    av_nonneg_weight: float = 0.15
    temp_cal_weight: float = 20.0
    temp_cal_low: float = 1.0
    temp_cal_high: float = 2.0  # computed but unused, as in the reference
    smooth_weight: float = 0.01
    tv_nonneg_clamp_min: float = -20.0
    tv_nonneg_weight: float = 0.15
    patch_sparsity_threshold: float = 0.80
    patch_sparsity_weight: float = 0.01
    # Aggregation: "dense", "chunked", "chunked_vjp" (hand-written
    # backward), "chunked_unrolled", "pallas".
    implementation: str = "dense"
    negatives: str = "all_gather"
    chunk_size: int = 8
    # Matmul precision of the aggregation: "highest" (fp32) or "default"
    # (bf16 operands, fp32 accumulation).
    matmul_precision: str = "highest"
    # Storage dtype of the token-sim volume: "float32" or "bfloat16".
    volume_dtype: str = "float32"


# ---------------------------------------------------------------------------
# Data / train configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    audio_num_samples: int = 160_000  # 10 s @ 16 kHz
    sample_rate: int = 16_000
    image_size: int = 224
    max_text_tokens: int = 128
    batch_size_av: int = 22
    batch_size_tv: int = 22
    num_workers: int = 4
    worker_mode: str = "thread"
    prefetch: int = 2
    device_augment: bool = False
    audio_visual_data_root: Optional[str] = None
    text_dataset_path: Optional[str] = None
    audio_visual_val_data_root: Optional[str] = None
    text_dataset_val_path: Optional[str] = None
    tokenizer_vocab: Optional[str] = None
    synthetic_av_size: int = 256
    synthetic_tv_size: int = 256
    synthetic_grounded: bool = False
    synthetic_grounded_classes: int = 4
    unique_videos: bool = False


@dataclass(frozen=True)
class OptimConfig:
    """4-group optimizer setup."""

    learning_rate: float = 1e-4
    lr_scale_others: float = 1.0
    lr_scale_audio: float = 0.25
    lr_scale_text: float = 0.75
    lr_scale_vit_lora: float = 0.5
    pct_start: float = 0.1
    div_factor: float = 10.0
    final_div_factor: float = 1e4
    unfreeze_audio_step: int = 5000
    unfreeze_text_step: int = 5000
    unfreeze_vit_step: int = 5000
    # Global-norm clip of the audio and text subtrees.
    clip_norm: float = 10.0
    gradient_accumulation_steps: int = 4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # OneCycle cycles beta1 0.95 -> 0.85 -> 0.95 along each group's cycle.
    cycle_momentum: bool = True
    base_momentum: float = 0.85
    max_momentum: float = 0.95
    # Adam moment storage dtype (updates always compute in fp32).
    mu_dtype: str = "float32"
    nu_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 10
    steps_per_epoch: Optional[int] = None
    av_focus_epochs: int = 1
    tv_warmup_epochs: int = 1
    weighted_joint_epochs: int = 2
    av_weight_start: float = 0.8
    av_weight_end: float = 0.5
    vis_every: int = 20000
    save_every_steps: int = 10000
    async_checkpointing: bool = False
    validation_frequency: int = 20000
    retrieval_subset_size: int = 1000
    num_vis_samples_av: int = 24
    num_vis_samples_tv: int = 24
    profile_steps: int = 0
    output_dir: str = "./outputs_triad_tpu"
    use_wandb: bool = False
    project_name: str = "triad-tpu"
    seed: int = 0
    optim: OptimConfig = field(default_factory=OptimConfig)


@dataclass(frozen=True)
class MeshConfig:
    data_axis: str = "data"
    num_devices: Optional[int] = None
    num_slices: int = 1
    replica_axis: str = "replica"
    tp: int = 1
    model_axis: str = "model"
    fsdp: bool = False
    zero1: bool = True


@dataclass(frozen=True)
class PretrainedConfig:
    """Paths of pretrained weights (None = fresh initialization)."""

    hubert: Optional[str] = None
    text: Optional[str] = None
    vit: Optional[str] = None
    reference_checkpoint: Optional[str] = None

    def any(self) -> bool:
        return any((self.hubert, self.text, self.vit, self.reference_checkpoint))


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pretrained: PretrainedConfig = field(default_factory=PretrainedConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in d.items():
        if key not in fields:
            raise KeyError(f"Unknown config field {key!r} for {cls.__name__}")
        f = fields[key]
        # Nested dataclasses are found through the default factory.
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else None
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = _from_dict(type(default), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def perf_eval_model_config() -> ModelConfig:
    """The tuned eval configuration: bf16 softmax scores in all three
    encoders, fused MLP kernels with tanh GELU, the monolithic frontend
    kernels with tanh GELU, merged-qkv packed eval attention in the ViT
    and packed eval attention in HuBERT."""
    base = ModelConfig()
    return dataclasses.replace(
        base,
        vit=dataclasses.replace(
            base.vit, attention_scores_dtype="bfloat16", mlp_impl="fused",
            mlp_gelu="tanh", attention_impl="packed_merged",
            attention_pad="none",
        ),
        hubert=dataclasses.replace(
            base.hubert, attention_scores_dtype="bfloat16", mlp_impl="auto",
            mlp_gelu="tanh", frontend_impl="monolithic", frontend_gelu="tanh",
            frontend_wave_layout="xt", attention_pad="none",
            attention_impl="packed",
        ),
        text=dataclasses.replace(base.text, attention_scores_dtype="bfloat16"),
    )


def perf_train_model_config() -> ModelConfig:
    """The tuned training configuration: tanh GELU in the fused MLP
    kernels and the fused ViT MLP, packed training attention in HuBERT
    and the ViT, the monolithic frontend kernels (recompute backward), the
    positional conv kernel."""
    base = ModelConfig()
    return dataclasses.replace(
        base,
        vit=dataclasses.replace(
            base.vit, mlp_impl="fused", mlp_gelu="tanh",
            attention_impl="fused_packed", attention_pad="none",
        ),
        hubert=dataclasses.replace(
            base.hubert, mlp_gelu="tanh", attention_impl="fused_packed",
            frontend_impl="monolithic", frontend_gelu="tanh",
            posconv_impl="pallas", frontend_wave_layout="xt",
            attention_pad="none",
        ),
    )


def perf_train_loss_config() -> LossConfig:
    """The training loss path: the chunked aggregation with its
    hand-written backward, chunks of 32, bf16 operands with fp32
    accumulation, bf16 sim volumes."""
    return LossConfig(
        implementation="chunked_vjp", chunk_size=32,
        matmul_precision="default", volume_dtype="bfloat16",
    )


def perf_eval_loss_config() -> LossConfig:
    """The eval loss path: the unrolled chunked aggregation, chunks of 32,
    bf16 operands with fp32 accumulation, bf16 sim volumes."""
    return LossConfig(
        implementation="chunked_unrolled", chunk_size=32,
        matmul_precision="default", volume_dtype="bfloat16",
    )


# knob -> (HubertConfig fields, ViTConfig fields), in the order they apply.
_KNOBS: Dict[str, Tuple[Dict[str, Any], Dict[str, Any]]] = {
    "perf": ({}, {}),
    "tanh": ({"mlp_gelu": "tanh"}, {"mlp_impl": "fused", "mlp_gelu": "tanh"}),
    "pkattn": ({"attention_impl": "fused_packed"}, {}),
    "mqkv": ({"attention_impl": "fused_packed_merged"}, {}),
    "vitpk": ({}, {"attention_impl": "fused_packed"}),
    "vitmq": ({}, {"attention_impl": "fused_packed_merged"}),
    "monofe": ({"frontend_impl": "monolithic", "frontend_gelu": "tanh"}, {}),
    "posconv": ({"posconv_impl": "pallas"}, {}),
    "wave640": ({"frontend_wave_layout": "x640"}, {}),
    "wavext": ({"frontend_wave_layout": "xt"}, {}),
    "rematconv": ({"remat": "conv"}, {}),
    "noremat": ({"remat": "none"}, {}),
    "attnpad": ({"attention_pad": "none"}, {"attention_pad": "none"}),
    "pad128": ({"attention_pad": "hbm"}, {"attention_pad": "hbm"}),
    "lorasep": ({}, {"lora_compute": "separate"}),
    "mlprows2": ({"mlp_block_rows": 2}, {"mlp_block_rows": 2}),
    "mlprows4": ({"mlp_block_rows": 4}, {"mlp_block_rows": 4}),
    "vitrows2": ({}, {"mlp_block_rows": 2}),
}


def apply_train_knobs(model_cfg: ModelConfig, knobs) -> ModelConfig:
    """Apply a comma-separated set of training A/B knobs (the JAX package's
    ``apply_train_knobs``, shared there by its train bench and profiler).
    knobs: iterable of strings or a comma-separated string; an unknown
    knob raises ValueError, and a knob that only sets fields the port does
    not read (TPU tilings: wave640, wavext, attnpad, pad128, mlprows2,
    mlprows4, vitrows2) raises
    NotImplementedError, so an A/B run cannot measure a knob that changes
    nothing. "perf" starts from perf_train_model_config(); the others
    replace fields of the config in the order below, so "mqkv" supersedes
    "pkattn"."""
    if isinstance(knobs, str):
        knobs = [k for k in knobs.split(",") if k]
    knobs = set(knobs)
    unknown = knobs - set(_KNOBS)
    if unknown:
        raise ValueError(f"unknown train knobs {sorted(unknown)}")
    unread = sorted(k for k in knobs if _UNREAD_FIELDS & {*_KNOBS[k][0], *_KNOBS[k][1]})
    if unread:
        raise NotImplementedError(
            f"train knobs {unread} set only fields triad_tpu_torch does not read (TPU tilings "
            "and layouts in the JAX package)")
    if "perf" in knobs:
        model_cfg = perf_train_model_config()
    for knob, (hubert, vit) in _KNOBS.items():
        if knob in knobs:
            model_cfg = dataclasses.replace(
                model_cfg,
                hubert=dataclasses.replace(model_cfg.hubert, **hubert),
                vit=dataclasses.replace(model_cfg.vit, **vit),
            )
    return model_cfg


# configs/default.yaml as a dict (the port reads no YAML): the reference
# run envelope; every other field keeps its dataclass default.
DEFAULT_TRAIN_CONFIG: Dict[str, Any] = {
    "data": {
        "audio_visual_data_root": None,
        "text_dataset_path": None,
        "audio_visual_val_data_root": None,
        "text_dataset_val_path": None,
        "tokenizer_vocab": None,
        "batch_size_av": 22,
        "batch_size_tv": 22,
        "audio_num_samples": 160000,
        "max_text_tokens": 128,
        "num_workers": 10,
    },
    "train": {
        "num_epochs": 10,
        "av_focus_epochs": 1,
        "tv_warmup_epochs": 1,
        "weighted_joint_epochs": 2,
        "av_weight_start": 0.8,
        "av_weight_end": 0.5,
        "vis_every": 20000,
        "save_every_steps": 10000,
        "validation_frequency": 20000,
        "optim": {
            "learning_rate": 1.0e-4,
            "gradient_accumulation_steps": 4,
            "unfreeze_audio_step": 5000,
            "unfreeze_text_step": 5000,
            "unfreeze_vit_step": 5000,
        },
    },
    "loss": {
        "implementation": "chunked",
        "matmul_precision": "highest",
    },
}


def default_train_config() -> Config:
    """The Config of configs/default.yaml."""
    return Config.from_dict(DEFAULT_TRAIN_CONFIG)
