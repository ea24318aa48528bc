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
(``window_attention.py``), on both devices. B1 takes head dims 64 (SAM
ViT-B / L) and 80 (ViT-H).

B13, ``ln_mlp``, is the other half of every ViT block:

    x + fc2(gelu_tanh(fc1(LN2(x)) + b1)) + b2

It replaces ``_ln_mlp_kernel`` (entry ``fused_ln_mlp``), which the JAX
package runs under ``ULLSAM_FUSED_VIT_MLP=1`` (``ln_mlp_supported``); on a
CUDA tensor it launches ``csrc/ln_mlp.cu``, on a CPU tensor
``ln_mlp_plain``. ``fused_ln_mlp`` is its differentiable entry
(``LnMlp``): the backward is the gradient of the plain chain, recomputed
under autograd, as ``_ln_mlp_bwd`` takes the vjp of ``_ln_mlp_xla``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import build, flags
from ullsam_tpu_torch.ops.kernels import window_attention as WA

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80)  # SAM ViT-B / L, ViT-H


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


def window_ln_mask(x: Tensor, norm_w: Tensor, norm_b: Tensor, kh: int,
                   kw: int, *, eps: float, nwx: int, nwy: int, Hv: int,
                   Wv: int, masked: bool) -> Tensor:
    """LN1 of windows x [Bw, n, C] (f32 statistics, rounded to x.dtype),
    with the pad tokens' normed activations zeroed."""
    Bw, n, _ = x.shape
    y = L.layer_norm(x, norm_w, norm_b, eps=eps)
    if masked:
        y = (y.float() * window_pad_mask(Bw, n, kh, kw, nwx, nwy, Hv, Wv,
                                         x.device)).to(x.dtype)
    return y


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
    y = window_ln_mask(x, norm_w, norm_b, kh, kw, eps=eps, nwx=nwx, nwy=nwy,
                       Hv=Hv, Wv=Wv, masked=masked)
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
    ``get_rel_pos``; hd 64 or 80); window geometry (nwx, nwy, Hv, Wv,
    masked).

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
    if hd * num_heads != C or hd not in _HEAD_DIMS or kh * kw != n \
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


# ---------------------------------------------------------------------------
# B13: LN2 + MLP + residual
# ---------------------------------------------------------------------------


def gelu_tanh(x: Tensor) -> Tensor:
    """tanh-form GELU in f32, rounded back to x.dtype (``_gelu_tanh``)."""
    f = x.float()
    inner = 0.7978845608028654 * (f + 0.044715 * (f * f * f))
    return (0.5 * f * (1.0 + torch.tanh(inner))).to(x.dtype)


def ln_mlp_plain(x: Tensor, norm_w: Tensor, norm_b: Tensor, fc1_w: Tensor,
                 fc1_b: Optional[Tensor], fc2_w: Tensor,
                 fc2_b: Optional[Tensor], *, eps: float) -> Tensor:
    """B13 in plain PyTorch on rows x [T, C], with the kernel's rounding
    points: LN (one-pass, f32) rounded to x.dtype; fc1 + b1 summed in f32
    and rounded; tanh-GELU in f32, rounded; fc2 + b2 + x summed in f32 and
    rounded once. Weights are taken at x.dtype."""
    dt = x.dtype
    y = L.layer_norm(x, norm_w, norm_b, eps=eps)
    h = torch.matmul(y.float(), fc1_w.to(dt).float().T)
    if fc1_b is not None:
        h = h + fc1_b.to(dt).float()
    h = gelu_tanh(h.to(dt))
    o = x.float() + torch.matmul(h.float(), fc2_w.to(dt).float().T)
    if fc2_b is not None:
        o = o + fc2_b.to(dt).float()
    return o.to(dt)


def ln_mlp(x: Tensor, norm_w: Tensor, norm_b: Tensor, fc1_w: Tensor,
           fc1_b: Optional[Tensor], fc2_w: Tensor, fc2_b: Optional[Tensor],
           *, eps: float) -> Tensor:
    """B13: x [T, C]; LN2 weight/bias [C]; fc1 [F, C] + [F]; fc2 [C, F] +
    [C] (every tensor in x's dtype, float32 or bfloat16) -> [T, C].

    CPU tensors run ``ln_mlp_plain``; CUDA tensors launch the kernel (C and
    F multiples of 32) or raise."""
    args = (x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b)
    if x.device.type == "cpu":
        return ln_mlp_plain(*args, eps=eps)
    name = "ln_mlp"
    if x.device.type != "cuda" or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported {x.dtype} on {x.device}")
    T, C = x.shape
    F = fc1_w.shape[0]
    if C % 32 or F % 32 or T == 0:
        raise ValueError(f"{name}: unsupported shape T={T} C={C} F={F}")
    for t, what, shape in ((x, "x", (T, C)), (norm_w, "norm_w", (C,)),
                           (norm_b, "norm_b", (C,)),
                           (fc1_w, "fc1_w", (F, C)), (fc1_b, "fc1_b", (F,)),
                           (fc2_w, "fc2_w", (C, F)), (fc2_b, "fc2_b", (C,))):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                             f"expected {x.dtype} on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not contiguous and 16-byte "
                             f"aligned")
    y = torch.empty((T, C), device=x.device, dtype=x.dtype)
    h = torch.empty((T, F), device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("ln_mlp", "ln_mlp_forward",
                        [i] + [p] * 10 + [i] * 3 + [ctypes.c_float, p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype],
                 *(None if t is None else t.data_ptr() for t in args),
                 y.data_ptr(), h.data_ptr(), out.data_ptr(), T, C, F,
                 float(eps), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0


class LnMlp(torch.autograd.Function):
    """B13 forward (its plain version on the CPU); the backward is the
    gradient of ``ln_mlp_plain`` recomputed under autograd from the saved
    inputs (``_ln_mlp_bwd``: the vjp of ``_ln_mlp_xla``)."""

    @staticmethod
    def forward(ctx, x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b)
        return ln_mlp(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps=eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wrt = [t is not None and need
               for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w) if t is not None else None
                   for t, w in zip(saved, wrt)]
            out = ln_mlp_plain(*ins, eps=ctx.eps)
            targets = [t for t, w in zip(ins, wrt) if w]
            grads = iter(torch.autograd.grad(out, targets, g)
                         if targets else ())
        return tuple(next(grads) if w else None for w in wrt) + (None,)


def ln_mlp_supported(T: int, C: int, F: int) -> bool:
    """``vit_block.py:131-141``: ``ULLSAM_FUSED_VIT_MLP`` set (read at each
    call), C and F multiples of 128, at least 256 rows."""
    return (flags.fused_vit_mlp() and C % 128 == 0 and F % 128 == 0
            and T >= 256)


def fused_ln_mlp(x: Tensor, norm_w: Tensor, norm_b: Tensor, fc1_w: Tensor,
                 fc1_b: Optional[Tensor], fc2_w: Tensor,
                 fc2_b: Optional[Tensor], *, eps: float) -> Tensor:
    """Differentiable B13 on x [..., C] (rows are independent, so leading
    dims are flattened); weights are cast to x.dtype."""
    C = x.shape[-1]
    dt = x.dtype

    def w(t):
        return None if t is None else build.aligned(t.to(dt))

    out = LnMlp.apply(build.aligned(x.reshape(-1, C)), w(norm_w), w(norm_b),
                      w(fc1_w), w(fc1_b), w(fc2_w), w(fc2_b), eps)
    return out.reshape(x.shape)
