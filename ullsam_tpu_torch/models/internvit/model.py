"""InternViT vision encoder (``ullsam_tpu/models/internvit/model.py``),
InternVL's own tower.

The reference carries only this model's config
(configuration_intern_vit.py): the deployed uLLSAM replaces the tower with
SAM's ViT. It is here so InternVL2.5 checkpoints can run their original
caption path: a pre-norm ViT with a class token, learned position
embeddings, RMSNorm over the whole flattened q and k (qk_normalization)
and LayerScale residual gains, the InternViT-300M family. The attention is
plain PyTorch (no TPU kernel stands behind it in the JAX package either).

Input [B, S, S, 3] NHWC -> tokens [B, 1 + (S / patch)^2, hidden].
"""

from __future__ import annotations

import torch
from torch import nn

from ullsam_tpu_torch.core.config import InternViTConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.ops import layers as L

Tensor = torch.Tensor


class Attention(nn.Module):
    def __init__(self, cfg: InternViTConfig, **kw):
        super().__init__()
        h = cfg.hidden_size
        self.qkv = L.Linear(h, 3 * h, bias=cfg.qkv_bias, **kw)
        self.proj = L.Linear(h, h, **kw)
        if cfg.qk_normalization:
            self.q_norm = L.RMSNorm(h, eps=cfg.layer_norm_eps, **kw)
            self.k_norm = L.RMSNorm(h, eps=cfg.layer_norm_eps, **kw)
        self.cfg = cfg

    def forward(self, x: Tensor) -> Tensor:
        B, N, H = x.shape
        nh = self.cfg.num_attention_heads
        hd = H // nh
        q, k, v = self.qkv(x).reshape(B, N, 3, H).unbind(2)
        if self.cfg.qk_normalization:
            q, k = self.q_norm(q), self.k_norm(k)
        q, k, v = (t.reshape(B, N, nh, hd) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * hd ** -0.5
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        return self.proj(out.reshape(B, N, H).to(x.dtype))


class Block(nn.Module):
    def __init__(self, cfg: InternViTConfig, **kw):
        super().__init__()
        h = cfg.hidden_size
        self.norm1 = L.LayerNorm(h, eps=cfg.layer_norm_eps, **kw)
        self.attn = Attention(cfg, **kw)
        self.ls1 = nn.Parameter(torch.full((h,), cfg.initializer_factor,
                                           **kw))
        self.norm2 = L.LayerNorm(h, eps=cfg.layer_norm_eps, **kw)
        self.mlp = L.MLPBlock(h, cfg.intermediate_size, **kw)
        self.ls2 = nn.Parameter(torch.full((h,), cfg.initializer_factor,
                                           **kw))

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x)) * self.ls1.to(x.dtype)
        return x + self.mlp(self.norm2(x)) * self.ls2.to(x.dtype)


class InternViT(nn.Module):
    """``patch_embed``, ``cls_token`` [1, 1, H], ``pos_embed``
    [1, 1 + n_patches, H], ``blocks``; on the GPU unless ``device`` says
    otherwise."""

    def __init__(self, cfg: InternViTConfig, *, device="cuda", dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        h, p = cfg.hidden_size, cfg.patch_size
        n_pos = 1 + (cfg.image_size // p) ** 2
        self.cfg = cfg
        self.patch_embed = L.Conv2d(cfg.num_channels, h, p, stride=p, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h, **kw))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_pos, h, **kw))
        self.blocks = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_hidden_layers))

    def init_(self, gen: torch.Generator) -> None:
        """The position embeddings ~ N(0, 0.02); the class token zero."""
        with torch.no_grad():
            self.pos_embed.copy_(torch.randn(
                self.pos_embed.shape, generator=gen,
                device=self.pos_embed.device) * 0.02)

    def forward(self, x: Tensor) -> Tensor:
        return internvit_apply(self, x)


def internvit_init(cfg: InternViTConfig, *, seed: int = 0, device="cuda",
                   dtype=None) -> InternViT:
    """A tower with random weights drawn from ``torch.Generator(seed)``."""
    model = InternViT(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=model.pos_embed.device)
    gen.manual_seed(seed)
    L.init_module_(model, gen)
    return model


def internvit_apply(model: InternViT, x: Tensor) -> Tensor:
    """x [B, image_size, image_size, 3] -> [B, 1 + n_patches, hidden]."""
    p = model.patch_embed(x)
    B, gh, gw, H = p.shape
    tokens = p.reshape(B, gh * gw, H)
    cls = model.cls_token.to(tokens.dtype).expand(B, 1, H)
    tokens = torch.cat([cls, tokens], dim=1)
    tokens = tokens + model.pos_embed.to(tokens.dtype)
    for blk in model.blocks:
        tokens = blk(tokens)
    return tokens
