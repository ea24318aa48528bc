"""B1: the fused windowed ViT attention half-block.

``window_attn`` computes, for pre-partitioned windows x [Bw, n, C]:

    x + proj(attention(mask(LN1(x))))

per head softmax(q k^T * hd^-1/2 + decomposed rel-pos bias) v, with the
normed activations of pad tokens zeroed (edge windows of a padded grid).

It replaces the TPU kernel ``ullsam_tpu/ops/pallas/vit_block.py``
``_window_attn_kernel`` (entry ``fused_window_attn``). On a CUDA tensor it
launches the hand-written Hopper kernel ``csrc/window_attn.cu`` (see the
note there: operation-bound; bf16 on the tensor cores, float32 by FMA);
on a CPU tensor it runs ``window_attn_plain``, the same function in plain
PyTorch. There is no fallback from the kernel to the plain version.

``window_attn_block`` is the differentiable entry: a
``torch.autograd.Function`` (``WindowAttn``) whose forward is B1 and whose
backward recomputes the chain with B3 and differentiates it by B8
(``window_attention.py``), on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels import window_attention as WA

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64  # SAM ViT-B/L heads


def window_pad_mask(Bw: int, n: int, kh: int, kw: int, nwx: int, nwy: int,
                    Hv: int, Wv: int, device) -> Tensor:
    """[Bw, n, 1] f32: 1 for real tokens, 0 for the pad tokens of edge
    windows. Window ``w % (nwy*nwx)`` of an image sits at grid row
    ``// nwx`` and column ``% nwx`` (row-major partition)."""
    w = torch.arange(Bw, device=device)[:, None] % (nwy * nwx)
    t = torch.arange(n, device=device)[None, :]
    row = (w // nwx) * kh + t // kw
    col = (w % nwx) * kw + t % kw
    return ((row < Hv) & (col < Wv)).float()[..., None]


def _window_chain(x: Tensor, norm_w: Tensor, norm_b: Tensor,
                  qkv_w: Tensor, qkv_b: Optional[Tensor], proj_w: Tensor,
                  proj_b: Optional[Tensor], rh: Tensor, rw: Tensor, core, *,
                  eps: float, nwx: int, nwy: int, Hv: int, Wv: int,
                  masked: bool) -> Tensor:
    """LN1 -> pad mask -> qkv -> ``core`` (B3 or its plain version) -> proj
    + residual, with the kernel's rounding points: LN output and qkv (after
    its bias) rounded to x.dtype, products accumulated in f32, the residual
    sum in f32."""
    dt = x.dtype
    Bw, n, C = x.shape
    kh, kw = rh.shape[0], rw.shape[0]
    y = L.layer_norm(x, norm_w, norm_b, eps=eps)
    if masked:
        y = (y.float() * window_pad_mask(Bw, n, kh, kw, nwx, nwy, Hv, Wv,
                                         x.device)).to(dt)
    qkv = torch.matmul(y.float(), qkv_w.to(dt).float().T)
    if qkv_b is not None:
        qkv = qkv + qkv_b.to(dt).float()
    o = core(qkv.to(dt).reshape(Bw * n, 3 * C), rh.to(dt), rw.to(dt))
    out = x.float() + torch.matmul(o.float(), proj_w.to(dt).float().T
                                   ).reshape(Bw, n, C)
    if proj_b is not None:
        out = out + proj_b.to(dt).float()
    return out.to(dt)


def window_attn_plain(x: Tensor, norm_w: Tensor, norm_b: Tensor,
                      qkv_w: Tensor, qkv_b: Optional[Tensor], proj_w: Tensor,
                      proj_b: Optional[Tensor], rh: Tensor, rw: Tensor, *,
                      num_heads: int, eps: float, nwx: int, nwy: int, Hv: int,
                      Wv: int, masked: bool) -> Tensor:
    """The function of the kernel in plain PyTorch, with the same rounding
    points: LN output, qkv (after its bias), p and o are rounded to
    x.dtype; products accumulate in f32; the residual sum is f32."""
    del num_heads  # the tables' head dim gives it
    return _window_chain(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b,
                         rh, rw, WA.window_attn_core_plain, eps=eps, nwx=nwx,
                         nwy=nwy, Hv=Hv, Wv=Wv, masked=masked)


def _check(t: Optional[Tensor], name: str, shape, x: Tensor) -> None:
    if t is None:
        return
    if t.device != x.device or t.dtype != x.dtype:
        raise ValueError(f"window_attn: {name} is {t.dtype} on {t.device}, "
                         f"expected {x.dtype} on {x.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"window_attn: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"window_attn: {name} is not contiguous and "
                         f"16-byte aligned")


def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("window_attn", "window_attn_forward",
                          [i] + [p] * 13 + [i] * 7 + [ctypes.c_float]
                          + [i] * 5 + [p])


def window_attn(x: Tensor, norm_w: Tensor, norm_b: Tensor, qkv_w: Tensor,
                qkv_b: Optional[Tensor], proj_w: Tensor,
                proj_b: Optional[Tensor], rh: Tensor, rw: Tensor, *,
                num_heads: int, eps: float, nwx: int, nwy: int, Hv: int,
                Wv: int, masked: bool) -> Tensor:
    """x [Bw, n, C]; LN1 weight/bias [C]; qkv [3C, C] + [3C]; proj [C, C] +
    [C]; gathered rel-pos tables rh [kh, kh, hd], rw [kw, kw, hd] (from
    ``get_rel_pos``); window geometry (nwx, nwy, Hv, Wv, masked).

    CPU tensors run ``window_attn_plain``; CUDA tensors launch the kernel
    (float32 or bfloat16, every tensor in x's dtype) or raise."""
    args = (x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, rh, rw)
    kw_ = dict(num_heads=num_heads, eps=eps, nwx=nwx, nwy=nwy, Hv=Hv, Wv=Wv,
               masked=masked)
    if x.device.type == "cpu":
        return window_attn_plain(*args, **kw_)
    if x.device.type != "cuda":
        raise ValueError(f"window_attn: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"window_attn: unsupported dtype {x.dtype}")
    Bw, n, C = x.shape
    kh, kw = rh.shape[0], rw.shape[0]
    hd = C // num_heads
    if hd * num_heads != C or hd != _HEAD_DIM or kh * kw != n \
            or n > 256 or kh + kw > 64 or C % 32:
        raise ValueError(f"window_attn: unsupported geometry C={C} "
                         f"heads={num_heads} n={n} kh={kh} kw={kw}")
    for t, name, shape in ((x, "x", (Bw, n, C)), (norm_w, "norm_w", (C,)),
                           (norm_b, "norm_b", (C,)),
                           (qkv_w, "qkv_w", (3 * C, C)),
                           (qkv_b, "qkv_b", (3 * C,)),
                           (proj_w, "proj_w", (C, C)),
                           (proj_b, "proj_b", (C,)),
                           (rh, "rh", (kh, kh, hd)),
                           (rw, "rw", (kw, kw, hd))):
        _check(t, name, shape, x)
    M = Bw * n
    y = torch.empty((M, C), device=x.device, dtype=x.dtype)
    qkv = torch.empty((M, 3 * C), device=x.device, dtype=x.dtype)
    o = torch.empty((M, C), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], *(ptr(t) for t in args),
                 y.data_ptr(), qkv.data_ptr(), o.data_ptr(), out.data_ptr(),
                 Bw, n, C, num_heads, hd, kh, kw, float(eps), nwx, nwy, Hv,
                 Wv, int(masked), stream)
    if err != 0:
        raise RuntimeError(f"window_attn kernel launch failed: "
                           f"cudaError {err}")
    window_attn.launches += 1
    return out


window_attn.launches = 0


class WindowAttn(torch.autograd.Function):
    """B1 with its gradient, as ``vit_block.py:348-405`` (``_window_attn_fwd``
    / ``_window_attn_bwd`` / ``_window_attn_hybrid``): the forward launches
    B1 (its plain version on the CPU) and saves only its inputs; the
    backward recomputes LN1 -> pad mask -> qkv in PyTorch, the attention core
    through B3's Function, then proj + residual, and returns the gradient of
    that chain, so the attention core's gradient is B8."""

    @staticmethod
    def forward(ctx, x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b, rh, rw,
                kw_):
        ctx.kw_ = kw_
        ctx.save_for_backward(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b,
                              rh, rw)
        return window_attn(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b,
                           rh, rw, **kw_)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        kw_ = dict(ctx.kw_)
        kw_.pop("num_heads")
        wrt = [t is not None and need
               for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w) if t is not None else None
                   for t, w in zip(saved, wrt)]
            out = _window_chain(*ins, WA.window_attention, **kw_)
            targets = [t for t, w in zip(ins, wrt) if w]
            grads = iter(torch.autograd.grad(out, targets, g)
                         if targets else ())
        return tuple(next(grads) if w else None for w in wrt) + (None,)


def window_attn_block(x: Tensor, norm_w: Tensor, norm_b: Tensor,
                      qkv_w: Tensor, qkv_b: Optional[Tensor], proj_w: Tensor,
                      proj_b: Optional[Tensor], rh: Tensor, rw: Tensor, *,
                      num_heads: int, eps: float, nwx: int, nwy: int, Hv: int,
                      Wv: int, masked: bool) -> Tensor:
    """Differentiable ``window_attn`` (arguments as there): B1 forward; B3
    and B8 in the backward."""
    kw_ = dict(num_heads=num_heads, eps=eps, nwx=nwx, nwy=nwy, Hv=Hv, Wv=Wv,
               masked=masked)
    return WindowAttn.apply(x, norm_w, norm_b, qkv_w, qkv_b, proj_w, proj_b,
                            rh, rw, kw_)
