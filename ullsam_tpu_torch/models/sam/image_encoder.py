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
On CUDA tensors the kernels launch; on CPU tensors their plain versions
run. All go through ``torch.autograd.Function``s, so gradients flow: B1's
backward recomputes its chain with the attention core as B3 and
differentiates that by B8; B2's backward is B9.

The JAX package's switches (``ops/kernels/flags.py``, read at each call)
pick the other routes of ``image_encoder.py:145-283``:
* ``ULLSAM_FUSED_VIT_ATTN=0``: a windowed block's attention half runs LN1
  and the pad mask, qkv, the attention core through B3's Function (B15
  under ``ULLSAM_WINDOW_TWOPHASE=1``), proj, and the residual, with that
  route's own rounding points (``_qkv_packed``, ``_proj_packed``): qkv and
  proj each rounded once after their bias, the residual summed in the
  dtype.
* ``ULLSAM_PACKED_GLOBAL=1``: a global block's attention runs B14 straight
  from the qkv projection when N >= 1024, N % 1024 == 0 and 1024 % W == 0.
* ``ULLSAM_FUSED_VIT_MLP=1``: every block's LN2 + MLP half runs B13 where
  ``ln_mlp_supported`` holds.

``forward(x, remat=True)`` checkpoints every block
(``torch.utils.checkpoint``) with the JAX package's routing under remat
(``image_encoder.py:376-403``): windowed blocks run B1's plain version
``window_attn_plain`` under autograd where the JAX package runs its XLA
block, global blocks still run B2 / B9, and no switch applies (the JAX
package passes ``allow_window_kernel=False``). Where no gradient flows
through the tower, remat has nothing to save and the tower runs without
it. The plain version keeps B1's rounding points, so in bfloat16 it
rounds where B1 does rather than where the JAX XLA block does; in float32
the two are the same function.

Under tensor parallelism (``parallel/partitioning.py``) a block's qkv,
proj, lin1 and lin2 are stored sharded and gathered whole when the block
runs (``distributed.gathered``, inside the checkpointed function, so a
remat recompute gathers again): B1, B2, B13 and B14 take whole weights, and
every rank computes the whole block. ``shard_params`` marks such a block
``tp_gathered``; an unmarked block (one process) skips the gather.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ullsam_tpu_torch.core.config import ViTConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.ops import attention as A
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import flags
from ullsam_tpu_torch.ops.kernels import vit_block as VB
from ullsam_tpu_torch.ops.kernels.flash_attention import (
    vit_flash_attention, vit_flash_attention_packed)
from ullsam_tpu_torch.ops.kernels.window_attention import window_attention
from ullsam_tpu_torch.parallel.distributed import gathered

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
    tp_gathered = False     # set by ``shard_params``: weights stored sharded

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

    def _whole(self):
        """The block's weights whole for its duration (a no-op unless
        sharded)."""
        return gathered(self) if self.tp_gathered else contextlib.nullcontext()

    def _mlp_half(self, x: Tensor, plain: bool = False) -> Tensor:
        """x + mlp(LN2(x)); B13 under ``ULLSAM_FUSED_VIT_MLP`` where it takes
        the shape, never under remat (``plain``)."""
        C = x.shape[-1]
        mlp = self.mlp
        if not plain and VB.ln_mlp_supported(x.numel() // C, C,
                                             mlp.lin1.weight.shape[0]):
            return VB.fused_ln_mlp(x, self.norm2.weight, self.norm2.bias,
                                   mlp.lin1.weight, mlp.lin1.bias,
                                   mlp.lin2.weight, mlp.lin2.bias,
                                   eps=self.norm2.eps)
        return x + mlp(self.norm2(x))

    def _rel_factors(self, q: Tensor, H: int, W: int):
        """f32 rel-pos factors rel_h [B*nh, N, H], rel_w [B*nh, N, W] of q
        [B*nh, N, hd] (unscaled); the flash Functions cast them to the
        dtype inside, so their gradients stay f32."""
        BH = q.shape[0]
        if self.attn.use_rel_pos:
            rel_h, rel_w = A.decomposed_rel_pos_terms(
                q, self.attn.rel_pos_h, self.attn.rel_pos_w, (H, W), (H, W))
        else:
            rel_h = q.new_zeros((BH, H, W, H), dtype=torch.float32)
            rel_w = q.new_zeros((BH, H, W, W), dtype=torch.float32)
        return rel_h.reshape(BH, H * W, H), rel_w.reshape(BH, H * W, W)

    def global_attention(self, h: Tensor, plain: bool = False) -> Tensor:
        """proj(attention(h)) of a global block on h = LN1(x) [B, H, W, C]:
        B2 on the head-split q, k, v, or B14 straight from the qkv
        projection under ``ULLSAM_PACKED_GLOBAL=1`` where it applies
        (``image_encoder.py:240-249``; ``plain``: remat, no switch
        applies)."""
        B, H, W, C = h.shape
        nh = self.num_heads
        hd = C // nh
        N = H * W
        if (not plain and flags.packed_global() and self.attn.use_rel_pos
                and hd <= 128 and N >= 1024 and N % 1024 == 0
                and 1024 % W == 0):
            qkv = self.attn.qkv(h).reshape(B, N, 3 * C)
            q = qkv[..., :C].reshape(B, N, nh, hd).permute(0, 2, 1, 3)
            rel_h, rel_w = self._rel_factors(q.reshape(B * nh, N, hd), H, W)
            o = vit_flash_attention_packed(qkv, rel_h, rel_w, nh)
            return self.attn.proj(o).reshape(B, H, W, C)
        qkv = self.attn.qkv(h).reshape(B, N, 3, nh, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, B * nh, N, hd)
        q, k, v = (t.contiguous() for t in qkv)
        o = vit_flash_attention(q, k, v, *self._rel_factors(q, H, W))
        o = o.reshape(B, nh, H, W, hd).permute(0, 2, 3, 1, 4).reshape(
            B, H, W, C)
        return self.attn.proj(o)

    def forward_global(self, x: Tensor, plain: bool = False) -> Tensor:
        """Global attention block on [B, H, W, C] (``plain``: remat)."""
        with self._whole():
            h = self.global_attention(self.norm1(x), plain)
            return self._mlp_half(x + h, plain)

    def _window_attn_unfused(self, x: Tensor, rh: Tensor, rw: Tensor,
                             geom) -> Tensor:
        """The attention half of a windowed block on windows x [Bw, n, C]
        under ``ULLSAM_FUSED_VIT_ATTN=0`` (``image_encoder.py:145-164``,
        ``:225-239``): LN1 and the pad mask as B1's chain computes them,
        qkv = LN1 W^T + b summed in f32 and rounded once (``_qkv_packed``),
        the core through B3's Function (B15 by its switch; backward B8),
        proj likewise rounded once after its bias (``_proj_packed``), and
        the residual summed in the dtype."""
        nwx, nwy, Hv, Wv, masked = geom
        Bw, n, C = x.shape
        a = self.attn
        y = VB.window_ln_mask(x, self.norm1.weight, self.norm1.bias,
                              rh.shape[0], rw.shape[0], eps=self.norm1.eps,
                              nwx=nwx, nwy=nwy, Hv=Hv, Wv=Wv, masked=masked)
        qkv = a.qkv(y).reshape(Bw * n, 3 * C)
        o = window_attention(qkv, rh, rw)
        return x + a.proj(o).reshape(Bw, n, C)

    def forward_windows(self, xw: Tensor, geom, plain: bool = False
                        ) -> Tensor:
        """Windowed block on pre-partitioned windows [Bw, ws, ws, C] via B1
        (or the ``ULLSAM_FUSED_VIT_ATTN=0`` route; ``plain``: via B1's plain
        version, differentiated by autograd, no switch applies);
        geom = (nwx, nwy, Hv, Wv, masked)."""
        with self._whole():
            return self._forward_windows(xw, geom, plain)

    def _forward_windows(self, xw: Tensor, geom, plain: bool) -> Tensor:
        Bw, ws, _, C = xw.shape
        nwx, nwy, Hv, Wv, masked = geom
        rh, rw = self.attn.rel_tables(ws, ws, xw.dtype)
        x = xw.reshape(Bw, ws * ws, C)
        if not plain and not flags.fused_vit_attn():
            h = self._window_attn_unfused(x, rh, rw, geom)
        else:
            a = self.attn
            attn = VB.window_attn_plain if plain else VB.window_attn_block
            h = attn(
                x, self.norm1.weight, self.norm1.bias, a.qkv.weight,
                a.qkv.bias, a.proj.weight, a.proj.bias, rh, rw,
                num_heads=self.num_heads, eps=self.norm1.eps, nwx=nwx,
                nwy=nwy, Hv=Hv, Wv=Wv, masked=masked)
        return self._mlp_half(h, plain).reshape(Bw, ws, ws, C)


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
                x = run(self.blocks[i].forward_global, x, remat)
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
