"""DINOv2 ViT-B/14 with register tokens and LoRA (mirrors
``triad_tpu/models/vit.py``):

  patch conv (14x14 s14) -> [cls | registers | patches + pos] -> pre-LN
  blocks with LayerScale -> final LayerNorm (eps 1e-6)

LoRA sits on the fused qkv projection and the output projection (folded
into the weight by default). ``attention_impl="packed_merged"`` feeds the
(B, N, 3C) qkv projection straight into the merged eval kernel, and
``"packed_merged_pair"`` into its head-pair variant (no gradient, as in
the JAX package); ``"fused_packed_merged"`` feeds it into
the differentiable merged training kernel; ``"fused"`` (strided) and
``"fused_packed"`` run the differentiable training kernels on the split
q, k, v. DINOv2 has no attention dropout, so the training kernels run at
p = 0, the same at eval and in training. Images are NHWC, as
in the JAX package. Under tensor parallelism only the MLP shards
(``parallel/tp.py``): the fused qkv stays whole.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from triad_tpu_torch.config import ViTConfig
from triad_tpu_torch.models.layers import (
    MERGED_IMPLS,
    LayerNorm,
    LoRALinear,
    Mlp,
    dot_product_attention,
    merged_attention,
)
from triad_tpu_torch.ops.attention import HEAD_DIM


class LayerScale(nn.Module):
    def __init__(self, dim, dtype, param_dtype, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device, dtype=param_dtype))
        self.compute_dtype = dtype

    def forward(self, x):
        return x * self.gamma.to(self.compute_dtype)


class ViTAttention(nn.Module):
    """Fused-qkv multi-head attention with LoRA on qkv and proj."""

    def __init__(self, cfg: ViTConfig, use_lora, dtype, param_dtype, device=None):
        super().__init__()
        c = cfg
        rank = c.lora_rank if use_lora else 0
        kw = dict(rank=rank, alpha=c.lora_alpha, dtype=dtype, param_dtype=param_dtype,
                  lora_compute=c.lora_compute, device=device)
        self.qkv = LoRALinear(c.hidden_size, 3 * c.hidden_size, bias=c.qkv_bias, **kw)
        self.proj = LoRALinear(c.hidden_size, c.hidden_size, **kw)
        impl = c.attention_impl
        if impl in MERGED_IMPLS and c.hidden_size // c.num_heads != HEAD_DIM:
            raise ValueError(f"merged attention kernels require head_dim {HEAD_DIM}")
        self.cfg, self.dtype = cfg, dtype

    def forward(self, x):
        c = self.cfg
        b, n, d = x.shape
        qkv = self.qkv(x)
        if c.attention_impl in MERGED_IMPLS:
            train = c.attention_impl == "fused_packed_merged"  # JAX's differentiable flag
            return self.proj(merged_attention(qkv, self.dtype, train,
                                              pair=c.attention_impl == "packed_merged_pair"))
        hd = d // c.num_heads
        q, k, v = (t.reshape(b, n, c.num_heads, hd) for t in qkv.split(d, dim=-1))
        out = dot_product_attention(
            q, k, v, None, self.dtype,
            scores_dtype=getattr(torch, c.attention_scores_dtype),
            impl=c.attention_impl,
        )
        return self.proj(out.reshape(b, n, d))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, use_lora, dtype, param_dtype, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm1 = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.attn = ViTAttention(c, use_lora, **kw)
        self.ls1 = LayerScale(c.hidden_size, **kw)
        self.norm2 = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.mlp = Mlp(c.hidden_size, int(c.hidden_size * c.mlp_ratio), c.hidden_size,
                       impl=c.mlp_impl, gelu_form=c.mlp_gelu, **kw)
        self.ls2 = LayerScale(c.hidden_size, **kw)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoViT(nn.Module):
    """(B, H, W, 3) images -> (B, 1 + R + P, D) normed tokens."""

    def __init__(self, cfg: ViTConfig, use_lora=True, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        c = cfg
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        pkw = dict(device=device, dtype=param_dtype)
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size, **pkw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size, **pkw))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, c.num_register_tokens, c.hidden_size, **pkw))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + c.num_patches, c.hidden_size, **pkw))
        self.blocks = nn.ModuleList(ViTBlock(c, use_lora, **kw) for _ in range(c.num_layers))
        self.norm = LayerNorm(c.hidden_size, c.layer_norm_eps, **kw)
        self.cfg, self.dtype = cfg, dtype

    def forward(self, images):
        c, d = self.cfg, self.dtype
        b = images.shape[0]
        x = F.conv2d(images.to(d).permute(0, 3, 1, 2), self.patch_embed.weight.to(d),
                     self.patch_embed.bias.to(d), stride=c.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (B, P, D), row-major patches
        cls = self.cls_token.to(d).expand(b, 1, c.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(d)
        regs = self.register_tokens.to(d).expand(b, c.num_register_tokens, c.hidden_size)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)

    def freeze_non_lora(self) -> None:
        """requires_grad False on every leaf but the LoRA factors: the
        counterpart of multimodal._freeze_non_lora (the ViT base is never
        optimized, and its weight gradients are never formed)."""
        for name, p in self.named_parameters():
            if "lora" not in name.rsplit(".", 1)[-1]:
                p.requires_grad_(False)

    def get_patch_tokens(self, images):
        """DINOv2 get_intermediate_layers(x, n=1)[0]: patch tokens only."""
        return self(images)[:, 1 + self.cfg.num_register_tokens:]
