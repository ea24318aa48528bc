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
    (D = 64, N % 64 == 0, KH, KW <= 64) or raise."""
    if q.device.type == "cpu":
        return vit_flash_attn_plain(q, k, v, rel_h, rel_w)
    if q.device.type != "cuda":
        raise ValueError(f"vit_flash_attn: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"vit_flash_attn: unsupported dtype {q.dtype}")
    BH, N, D = q.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if D != 64 or N % 64 or KH * KW != N or KH > 64 or KW > 64:
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
    kernel (D = 64, KW dividing 64 and at least 8, KH <= 64) or raise."""
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
