"""B2: ViT global flash attention with the factored decomposed rel-pos bias.

``vit_flash_attn(q, k, v, rel_h, rel_w) -> (o, lse)`` computes

    o   = softmax(cast(q * D^-1/2) k^T + bias) v
    lse = row logsumexp (f32)

with bias[i, key] = rel_h[i, key // KW] + rel_w[i, key % KW], KH*KW = N.

It replaces the TPU kernel ``ullsam_tpu/ops/pallas/flash_attention.py``
``_vit_kernel`` (entry ``vit_flash_attention``). On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/vit_flash_attn.cu`` (see the note
there: operation-bound; bf16 on the tensor cores, float32 by FMA); on a
CPU tensor it runs ``vit_flash_attn_plain``. There is no fallback from the
kernel.

B14, ``vit_flash_attn_packed(qkv, rel_h, rel_w, nh)``, is B2's function
read straight from the qkv projection [B, N, 3C] (head h of q, k, v at
columns h*hd, C + h*hd, 2C + h*hd) and written into o [B, N, C] at column
h*hd, the layout proj consumes: no head-split copy, no merge transpose. It
replaces ``_vit_kernel_packed`` (entry ``vit_flash_attention_packed``),
which the JAX package runs under ``ULLSAM_PACKED_GLOBAL=1``; its kernel is
B2's body with other strides (``csrc/vit_flash_attn.cu``). Its gradient
(``VitFlashPacked``) splits into heads and runs B9, as
``_vit_flash_packed_bwd`` does. B2 and B14 take head dims 64 and 80, B9 64.

B9, ``vit_flash_attn_bwd``, is its gradient (``_vit_bwd_dq_kernel`` and
``_vit_bwd_dkv_kernel``, through ``_vit_flash_bwd_impl``), launched from
``csrc/vit_flash_bwd.cu`` on a CUDA tensor. ``vit_flash_attention`` is the
differentiable entry: a ``torch.autograd.Function`` whose forward is B2 and
whose backward is B9 on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ullsam_tpu_torch.ops.kernels import build

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80)  # B2, B14: SAM ViT-B / L and ViT-H


def vit_flash_attn_plain(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                         rel_w: Tensor) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (bias materialized).

    Same rounding points as the kernel: q pre-scaled and cast to q.dtype,
    rel factors taken at q.dtype, unnormalized p cast to v.dtype before
    p.v, output acc / l cast to q.dtype."""
    dt = q.dtype
    BH, N, D = q.shape
    qs = (q.float() * D ** -0.5).to(dt).float()
    bias = (rel_h.to(dt).float()[..., :, None]
            + rel_w.to(dt).float()[..., None, :]).reshape(BH, N, N)
    logits = torch.matmul(qs, k.float().transpose(-1, -2)) + bias
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(dt), lse


def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("vit_flash_attn", "vit_flash_attn_forward",
                          [i] + [p] * 7 + [i] * 5 + [ctypes.c_float, p])


def vit_flash_attn(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                   rel_w: Tensor) -> Tuple[Tensor, Tensor]:
    """q, k, v [BH, N, D]; rel_h [BH, N, KH]; rel_w [BH, N, KW] (all one
    dtype, float32 or bfloat16). Returns (o [BH, N, D], lse [BH, N] f32).

    CPU tensors run ``vit_flash_attn_plain``; CUDA tensors launch the kernel
    (D = 64 or 80, N % 64 == 0, KH, KW <= 64) or raise."""
    if q.device.type == "cpu":
        return vit_flash_attn_plain(q, k, v, rel_h, rel_w)
    if q.device.type != "cuda":
        raise ValueError(f"vit_flash_attn: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"vit_flash_attn: unsupported dtype {q.dtype}")
    BH, N, D = q.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if D not in _HEAD_DIMS or N % 64 or KH * KW != N or KH > 64 or KW > 64:
        raise ValueError(f"vit_flash_attn: unsupported shape N={N} D={D} "
                         f"KH={KH} KW={KW}")
    for t, name, shape in ((q, "q", (BH, N, D)), (k, "k", (BH, N, D)),
                           (v, "v", (BH, N, D)),
                           (rel_h, "rel_h", (BH, N, KH)),
                           (rel_w, "rel_w", (BH, N, KW))):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"vit_flash_attn: {name} is {t.dtype} on "
                             f"{t.device}, expected {q.dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"vit_flash_attn: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"vit_flash_attn: {name} is not contiguous "
                             f"and 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((BH, N), device=q.device, dtype=torch.float32)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), BH, N, D, KH, KW,
                 float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"vit_flash_attn kernel launch failed: "
                           f"cudaError {err}")
    vit_flash_attn.launches += 1
    return o, lse


vit_flash_attn.launches = 0


def _heads(t: Tensor, nh: int) -> Tensor:
    """[B, N, nh*hd] -> [B*nh, N, hd], contiguous and 16-byte aligned (a
    reshape of a permuted view may stay a view)."""
    B, N, C = t.shape
    return build.aligned(t.reshape(B, N, nh, C // nh).permute(0, 2, 1, 3)
                         .reshape(B * nh, N, C // nh))


def _merge(t: Tensor, B: int) -> Tensor:
    """[B*nh, N, hd] -> [B, N, nh*hd]."""
    BH, N, D = t.shape
    return t.reshape(B, BH // B, N, D).permute(0, 2, 1, 3).reshape(B, N, -1)


def vit_flash_attn_packed_plain(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                                nh: int) -> Tuple[Tensor, Tensor]:
    """B14 in plain PyTorch: qkv [B, N, 3C] -> (o [B, N, C], lse [B*nh, N]
    f32), B2's function and rounding points on each head."""
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    o, lse = vit_flash_attn_plain(q, k, v, rel_h, rel_w)
    return _merge(o, qkv.shape[0]), lse


def vit_flash_attn_packed(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                          nh: int) -> Tuple[Tensor, Tensor]:
    """B14: qkv [B, N, 3C] (q | k | v, head h at h*hd of each, hd = C / nh,
    64 or 80); rel_h [B*nh, N, KH], rel_w [B*nh, N, KW] (one dtype, float32
    or bfloat16). Returns (o [B, N, C], lse [B*nh, N] f32).

    CPU tensors run ``vit_flash_attn_packed_plain``; CUDA tensors launch
    the kernel (N % 64 == 0, KH * KW == N, KH, KW <= 64) or raise."""
    if qkv.device.type == "cpu":
        return vit_flash_attn_packed_plain(qkv, rel_h, rel_w, nh)
    name = "vit_flash_attn_packed"
    if qkv.device.type != "cuda" or qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported {qkv.dtype} on {qkv.device}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // nh
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if (C3 % 3 or D * nh != C or D not in _HEAD_DIMS or N % 64
            or KH * KW != N or KH > 64 or KW > 64):
        raise ValueError(f"{name}: unsupported shape qkv {tuple(qkv.shape)} "
                         f"nh={nh} KH={KH} KW={KW}")
    for t, what, shape in ((qkv, "qkv", (B, N, C3)),
                           (rel_h, "rel_h", (B * nh, N, KH)),
                           (rel_w, "rel_w", (B * nh, N, KW))):
        if t.device != qkv.device or t.dtype != qkv.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                             f"expected {qkv.dtype} on {qkv.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not contiguous and 16-byte "
                             f"aligned")
    o = torch.empty((B, N, C), device=qkv.device, dtype=qkv.dtype)
    lse = torch.empty((B * nh, N), device=qkv.device, dtype=torch.float32)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("vit_flash_attn", "vit_flash_attn_packed_forward",
                        [i] + [p] * 5 + [i] * 6 + [ctypes.c_float, p])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODE[qkv.dtype], qkv.data_ptr(), rel_h.data_ptr(),
                 rel_w.data_ptr(), o.data_ptr(), lse.data_ptr(), B, nh, N, D,
                 KH, KW, float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    vit_flash_attn_packed.launches += 1
    return o, lse


vit_flash_attn_packed.launches = 0


def _drel(ds: Tensor, KH: int, KW: int) -> Tuple[Tensor, Tensor]:
    """Row sums of ds [BH, N, N] per key-grid row and column (f32)."""
    ds4 = ds.reshape(ds.shape[0], ds.shape[1], KH, KW)
    return ds4.sum(-1), ds4.sum(-2)


def vit_flash_attn_bwd_plain(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                             rel_w: Tensor, do: Tensor, lse: Tensor,
                             dd: Tensor) -> Tuple[Tensor, ...]:
    """B9 in plain PyTorch: (dq, dk, dv at q.dtype; drel_h, drel_w f32).

    The logits are B2's: s = cast(q * D^-1/2) k^T + bias, with the rel
    factors taken at q.dtype, so p = exp(s - lse) is the forward's
    probability. (The TPU backward scores q k^T * D^-1/2 from unscaled q,
    flash_attention.py:824-827; this port scores as its own forward does.)
    Then, with ds = p (do v^T - dd): dq = ds k * D^-1/2, dk = ds^T cast(q *
    D^-1/2), dv = p^T do. p and ds are rounded to q.dtype before their
    products (flash_attention.py:840-851); drel_h[i, r] = sum_c ds[i, r*KW
    + c] and drel_w[i, c] = sum_r ds[i, r*KW + c] sum the rounded ds in
    f32."""
    dt = q.dtype
    BH, N, D = q.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    scale = D ** -0.5
    qs = (q.float() * scale).to(dt).float()
    bias = (rel_h.to(dt).float()[..., :, None]
            + rel_w.to(dt).float()[..., None, :]).reshape(BH, N, N)
    p = torch.exp(torch.matmul(qs, k.float().transpose(-1, -2)) + bias
                  - lse[..., None])
    g = do.to(dt).float()
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    ds = (p * (dp - dd[..., None])).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), g)
    drel_h, drel_w = _drel(ds, KH, KW)
    return dq.to(dt), dk.to(dt), dv.to(dt), drel_h, drel_w


def _bwd_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("vit_flash_bwd", "vit_flash_attn_backward",
                          [i] + [p] * 13 + [i] * 5 + [ctypes.c_float, p])


def vit_flash_attn_bwd(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                       rel_w: Tensor, do: Tensor, lse: Tensor,
                       dd: Tensor) -> Tuple[Tensor, ...]:
    """B9: q, k, v, do [BH, N, D], rel_h [BH, N, KH], rel_w [BH, N, KW] (one
    dtype, float32 or bfloat16); lse, dd [BH, N] f32. Returns (dq, dk, dv,
    drel_h [BH, N, KH] f32, drel_w [BH, N, KW] f32).

    CPU tensors run ``vit_flash_attn_bwd_plain``; CUDA tensors launch the
    kernel (D = 64, KW dividing 64 and at least 8, KH <= 64) or raise: head
    dim 80 (ViT-H) is not instantiated yet."""
    if q.device.type == "cpu":
        return vit_flash_attn_bwd_plain(q, k, v, rel_h, rel_w, do, lse, dd)
    if q.device.type != "cuda":
        raise ValueError(f"vit_flash_attn_bwd: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"vit_flash_attn_bwd: unsupported dtype {q.dtype}")
    BH, N, D = q.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if D != 64 or KW < 8 or 64 % KW or KH > 64 or KH * KW != N:
        raise ValueError(f"vit_flash_attn_bwd: unsupported shape N={N} D={D}"
                         f" KH={KH} KW={KW}")
    for t, name, shape, dtype in (
            (q, "q", (BH, N, D), q.dtype), (k, "k", (BH, N, D), q.dtype),
            (v, "v", (BH, N, D), q.dtype), (do, "do", (BH, N, D), q.dtype),
            (rel_h, "rel_h", (BH, N, KH), q.dtype),
            (rel_w, "rel_w", (BH, N, KW), q.dtype),
            (lse, "lse", (BH, N), torch.float32),
            (dd, "dd", (BH, N), torch.float32)):
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"vit_flash_attn_bwd: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"vit_flash_attn_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"vit_flash_attn_bwd: {name} is not contiguous "
                             f"and 16-byte aligned")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    drel_h = torch.empty((BH, N, KH), device=q.device, dtype=torch.float32)
    drel_w = torch.empty((BH, N, KW), device=q.device, dtype=torch.float32)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), drel_h.data_ptr(),
                 drel_w.data_ptr(), BH, N, D, KH, KW, float(D ** -0.5),
                 stream)
    if err != 0:
        raise RuntimeError(f"vit_flash_attn_bwd kernel launch failed: "
                           f"cudaError {err}")
    vit_flash_attn_bwd.launches += 1
    return dq, dk, dv, drel_h, drel_w


vit_flash_attn_bwd.launches = 0


class VitFlashAttention(torch.autograd.Function):
    """B2 forward, B9 backward. rel_h / rel_w arrive in float32 and are cast
    to q.dtype inside (as ``_vit_flash_impl`` does), so their gradients come
    back in float32; dd = sum(do * o) is plain PyTorch, as the JAX package
    computes it outside its kernels (flash_attention.py:924)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w):
        rh, rw = (build.aligned(r.to(q.dtype)) for r in (rel_h, rel_w))
        o, lse = vit_flash_attn(q, k, v, rh, rw)
        ctx.rel_dtypes = (rel_h.dtype, rel_w.dtype)
        ctx.save_for_backward(q, k, v, rh, rw, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, rh, rw, o, lse = ctx.saved_tensors
        g = build.aligned(g)
        dd = (g.float() * o.float()).sum(-1)
        dq, dk, dv, drh, drw = vit_flash_attn_bwd(q, k, v, rh, rw, g, lse, dd)
        return (dq, dk, dv, drh.to(ctx.rel_dtypes[0]),
                drw.to(ctx.rel_dtypes[1]))


def vit_flash_attention(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                        rel_w: Tensor) -> Tensor:
    """Differentiable B2 -> o [BH, N, D]; q, k, v contiguous at one dtype,
    rel_h / rel_w at any float dtype (float32 keeps drel in float32)."""
    return VitFlashAttention.apply(q, k, v, rel_h, rel_w)


class VitFlashPacked(torch.autograd.Function):
    """B14 forward; the backward splits qkv, o and the output gradient into
    heads and runs B9, then packs dq, dk, dv back into dqkv [B, N, 3C]
    (``_vit_flash_packed_bwd``). rel_h / rel_w arrive at any float dtype and
    are cast to qkv.dtype inside, so their gradients keep their dtype."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, nh):
        rh, rw = (build.aligned(r.to(qkv.dtype)) for r in (rel_h, rel_w))
        o, lse = vit_flash_attn_packed(qkv, rh, rw, nh)
        ctx.nh = nh
        ctx.rel_dtypes = (rel_h.dtype, rel_w.dtype)
        ctx.save_for_backward(qkv, rh, rw, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, rh, rw, o, lse = ctx.saved_tensors
        nh, B = ctx.nh, qkv.shape[0]
        q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
        g, o = _heads(g, nh), _heads(o, nh)
        dd = (g.float() * o.float()).sum(-1)
        dq, dk, dv, drh, drw = vit_flash_attn_bwd(q, k, v, rh, rw, g, lse, dd)
        dqkv = torch.cat([_merge(t, B) for t in (dq, dk, dv)], dim=-1)
        return (dqkv, drh.to(ctx.rel_dtypes[0]), drw.to(ctx.rel_dtypes[1]),
                None)


def vit_flash_attention_packed(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                               nh: int) -> Tensor:
    """Differentiable B14 -> o [B, N, C]; qkv contiguous, rel_h / rel_w at
    any float dtype (float32 keeps drel in float32)."""
    return VitFlashPacked.apply(qkv, rel_h, rel_w, nh)
