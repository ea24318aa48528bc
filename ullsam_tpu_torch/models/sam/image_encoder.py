"""SAM ViTDet image encoder (``ullsam_tpu/models/sam/image_encoder.py``).

Input [B, img, img, 3] NHWC (normalized) -> [B, grid, grid, out_chans] NHWC.

* The patch embed is an im2col reshape plus one matmul (k == s conv).
* Consecutive windowed blocks run on the grid partitioned ONCE into
  [B*nw, ws, ws, C] windows (padded grids included); each block's
  attention half is B1 (``ops/kernels/vit_block.window_attn``), which
  zeroes the pad tokens' normed activations from the window geometry
  (nwx, nwy, Hv, Wv, masked).
* Global blocks keep the rel-pos bias factored (rel_h, rel_w) and run B2
  (``ops/kernels/flash_attention.vit_flash_attn``).
On CUDA tensors the two kernels launch; on CPU tensors their plain
versions run. Both go through ``torch.autograd.Function``s, so gradients
flow: B1's backward recomputes its chain with the attention core as B3
and differentiates that by B8; B2's backward is B9.

``forward(x, remat=True)`` checkpoints every block
(``torch.utils.checkpoint``) with the JAX package's routing under remat
(``image_encoder.py:376-403``): windowed blocks run B1's plain version
``window_attn_plain`` under autograd where the JAX package runs its XLA
block, global blocks still run B2 / B9. Where no gradient flows through
the tower, remat has nothing to save and the tower runs without it. The plain version keeps B1's
rounding points, so in bfloat16 it rounds where B1 does rather than where
the JAX XLA block does; in float32 the two are the same function.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ullsam_tpu_torch.core.config import ViTConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.ops import attention as A
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels.flash_attention import vit_flash_attention
from ullsam_tpu_torch.ops.kernels.vit_block import (window_attn_block,
                                                     window_attn_plain)

Tensor = torch.Tensor


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, input_size: Tuple[int, int], *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        C = cfg.embed_dim
        self.qkv = L.Linear(C, 3 * C, bias=cfg.qkv_bias, **kw)
        self.proj = L.Linear(C, C, **kw)
        self.use_rel_pos = cfg.use_rel_pos
        self.head_dim = cfg.head_dim
        if cfg.use_rel_pos:
            self.rel_pos_h = nn.Parameter(
                torch.zeros(2 * input_size[0] - 1, cfg.head_dim, **kw))
            self.rel_pos_w = nn.Parameter(
                torch.zeros(2 * input_size[1] - 1, cfg.head_dim, **kw))

    def init_(self, gen: torch.Generator) -> None:
        # the reference zero-inits these; small random values keep the
        # rel-pos path live in randomly initialised models
        if self.use_rel_pos:
            with torch.no_grad():
                self.rel_pos_h.normal_(0.0, 0.02, generator=gen)
                self.rel_pos_w.normal_(0.0, 0.02, generator=gen)

    def rel_tables(self, kh: int, kw: int, dtype) -> Tuple[Tensor, Tensor]:
        """Gathered tables Rh [kh, kh, hd], Rw [kw, kw, hd] at ``dtype``."""
        if not self.use_rel_pos:
            z, hd = self.qkv.weight.new_zeros, self.head_dim
            return z((kh, kh, hd), dtype=dtype), z((kw, kw, hd), dtype=dtype)
        return (A.get_rel_pos(kh, kh, self.rel_pos_h).to(dtype).contiguous(),
                A.get_rel_pos(kw, kw, self.rel_pos_w).to(dtype).contiguous())


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, window_size: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        C = cfg.embed_dim
        input_size = ((cfg.grid_size, cfg.grid_size) if window_size == 0
                      else (window_size, window_size))
        self.norm1 = L.LayerNorm(C, eps=cfg.ln_eps, **kw)
        self.attn = Attention(cfg, input_size, **kw)
        self.norm2 = L.LayerNorm(C, eps=cfg.ln_eps, **kw)
        self.mlp = L.MLPBlock(C, int(C * cfg.mlp_ratio), **kw)
        self.window_size = window_size
        self.num_heads = cfg.num_heads

    def _mlp_half(self, x: Tensor) -> Tensor:
        return x + self.mlp(self.norm2(x))

    def forward_global(self, x: Tensor) -> Tensor:
        """Global attention block on [B, H, W, C] via B2."""
        B, H, W, C = x.shape
        nh = self.num_heads
        hd = C // nh
        N = H * W
        h = self.norm1(x)
        qkv = self.attn.qkv(h).reshape(B, N, 3, nh, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, N, hd)
        q, k, v = (t.contiguous() for t in qkv)
        if self.attn.use_rel_pos:
            rel_h, rel_w = A.decomposed_rel_pos_terms(
                q, self.attn.rel_pos_h, self.attn.rel_pos_w, (H, W), (H, W))
        else:
            rel_h = q.new_zeros((B * nh, H, W, H), dtype=torch.float32)
            rel_w = q.new_zeros((B * nh, H, W, W), dtype=torch.float32)
        # f32 factors: the Function casts them to x.dtype inside, so
        # their gradients stay f32
        o = vit_flash_attention(q, k, v, rel_h.reshape(B * nh, N, H),
                                rel_w.reshape(B * nh, N, W))
        o = o.reshape(B, nh, H, W, hd).permute(0, 2, 3, 1, 4).reshape(
            B, H, W, C)
        return self._mlp_half(x + self.attn.proj(o))

    def forward_windows(self, xw: Tensor, geom, plain: bool = False
                        ) -> Tensor:
        """Windowed block on pre-partitioned windows [Bw, ws, ws, C] via B1
        (``plain``: via B1's plain version, differentiated by autograd);
        geom = (nwx, nwy, Hv, Wv, masked)."""
        Bw, ws, _, C = xw.shape
        nwx, nwy, Hv, Wv, masked = geom
        rh, rw = self.attn.rel_tables(ws, ws, xw.dtype)
        a = self.attn
        attn = window_attn_plain if plain else window_attn_block
        h = attn(
            xw.reshape(Bw, ws * ws, C), self.norm1.weight, self.norm1.bias,
            a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias, rh, rw,
            num_heads=self.num_heads, eps=self.norm1.eps, nwx=nwx, nwy=nwy,
            Hv=Hv, Wv=Wv, masked=masked)
        return self._mlp_half(h).reshape(Bw, ws, ws, C)


def window_partition(x: Tensor, ws: int) -> Tuple[Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> [B*nw, ws, ws, C], zero-padded to a window multiple."""
    B, H, W, C = x.shape
    pad_h = (ws - H % ws) % ws
    pad_w = (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows: Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> Tensor:
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :].contiguous()


class ImageEncoder(nn.Module):
    """Parameter names follow the reference (``patch_embed.proj``,
    ``pos_embed``, ``blocks.{i}``, ``neck.{0..3}``); on the GPU unless
    ``device`` says otherwise."""

    def __init__(self, cfg: ViTConfig, *, device="cuda", dtype=None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        C, p = cfg.embed_dim, cfg.patch_size
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = L.Conv2d(cfg.in_chans, C, p, **kw)
        if cfg.use_abs_pos:
            self.pos_embed = nn.Parameter(
                torch.zeros(1, cfg.grid_size, cfg.grid_size, C, **kw))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size,
                  **kw)
            for i in range(cfg.depth))
        oc = cfg.out_chans
        self.neck = nn.ModuleList([
            L.Conv2d(C, oc, 1, bias=False, **kw),
            L.LayerNorm(oc, eps=1e-6, **kw),
            L.Conv2d(oc, oc, 3, bias=False, padding=1, **kw),
            L.LayerNorm(oc, eps=1e-6, **kw),
        ])

    def init_(self, gen: torch.Generator) -> None:
        if self.cfg.use_abs_pos:
            with torch.no_grad():
                self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def patch_embed_apply(self, x: Tensor) -> Tensor:
        """k == s patch conv as im2col + matmul: [B, S, S, 3] -> [B, g, g, C]."""
        p = self.cfg.patch_size
        B, H, W, Cin = x.shape
        gh, gw = H // p, W // p
        conv = self.patch_embed.proj
        cols = x.reshape(B, gh, p, gw, p, Cin).permute(0, 1, 3, 2, 4, 5)
        cols = cols.reshape(B, gh, gw, p * p * Cin)
        w = conv.weight.permute(0, 2, 3, 1).reshape(conv.weight.shape[0], -1)
        return L.linear(cols, w, conv.bias)

    def forward(self, x: Tensor, remat: bool = False) -> Tensor:
        cfg = self.cfg
        # remat trades a recompute for the activations a backward would
        # keep; a tower that carries no gradient (frozen, as in the
        # language-only training modes, or under no_grad) keeps none, so it
        # runs as without remat, through B1 and B2
        remat = remat and torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        x = self.patch_embed_apply(x)
        if cfg.use_abs_pos:
            x = x + self.pos_embed.to(x.dtype)
        ws = cfg.window_size

        def run(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        i = 0
        while i < cfg.depth:
            if self.blocks[i].window_size == 0:
                x = run(self.blocks[i].forward_global, x)
                i += 1
                continue
            # a run of windowed blocks: partition once
            j = i
            while j < cfg.depth and self.blocks[j].window_size != 0:
                j += 1
            H, W = x.shape[1:3]
            xw, pad_hw = window_partition(x, ws)
            geom = (pad_hw[1] // ws, pad_hw[0] // ws, H, W, pad_hw != (H, W))
            for blk in self.blocks[i:j]:
                xw = run(blk.forward_windows, xw, geom, remat)
            x = window_unpartition(xw, ws, pad_hw, (H, W))
            i = j
        n = self.neck
        return n[3](n[2](n[1](n[0](x))))
