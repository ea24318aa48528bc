"""B3 and B8: the windowed ViT attention core and its gradient.

``window_attn_core(qkv, rh, rw) -> o`` computes, for each window of
n = kh*kw tokens and each head of hd channels,

    o = softmax(q k^T * hd^-1/2 + bias) v
    bias[i, m] = q_i . Rh[row(i), row(m)] + q_i . Rw[col(i), col(m)]

on the natural layout: qkv [Bw*n, 3C] (q | k | v, head h at h*hd of each),
gathered rel-pos tables rh [kh, kh, hd], rw [kw, kw, hd], o [Bw*n, C].
``window_attn_core_bwd(qkv, rh, rw, do) -> (dqkv, drh, drw)`` is its
gradient: it recomputes each row's softmax, takes dd = sum(dp * p) from
the recomputed p (not from o), and sums the table gradients over every
window and head.

They replace the TPU kernels ``ullsam_tpu/ops/pallas/flash_attention.py``
``_vit_window_kernel`` (B3, entry ``vit_window_attention_packed``) and
``_vit_window_bwd_kernel`` (B8, ``_vit_window_packed_bwd_impl``). The TPU
layout pads every head to 128 lanes and rebuilds the bias with selection
matmuls; here there are no pad lanes and no selection matmuls: the bias
gradient is two small sums of ds per query row (``drel_h[i, r] = sum_c
ds[i, r*kw + c]``, ``drel_w[i, c] = sum_r ds[i, r*kw + c]``).

B15, ``window_attn_core_twophase``, computes B3's function in two phases
(every head's logits of a window first, then softmax and p.v); it
replaces ``_vit_window_kernel_twophase``, which the JAX package runs in
B3's place under ``ULLSAM_WINDOW_TWOPHASE=1``.

On a CUDA tensor B3 launches the attention core of ``csrc/window_attn.cu``
(B1's own core), B15 ``csrc/window_attn_twophase.cu`` and B8
``csrc/window_attn_bwd.cu``; on a CPU tensor each runs its plain version
here. B3 and B15 take head dims 64 and 80, B8 64. There is no fallback
from a kernel to its plain version. ``window_attention`` is the
differentiable entry: a ``torch.autograd.Function`` whose forward is B3
(B15 under ``ULLSAM_WINDOW_TWOPHASE=1``, read at each call) and whose
backward is B8 on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ullsam_tpu_torch.ops.kernels import build, flags

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_HEAD_DIMS = (64, 80)  # B3, B15: SAM ViT-B / L and ViT-H
_BWD_HEAD_DIMS = (64,)     # B8
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)


def _split_heads(qkv: Tensor, n: int, hd: int):
    """qkv [Bw*n, 3C] -> f32 q, k, v [Bw, nh, n, hd]."""
    M, C3 = qkv.shape
    nh = C3 // 3 // hd
    t = qkv.float().reshape(M // n, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def _rel_terms(q: Tensor, Rh: Tensor, Rw: Tensor, kh: int, kw: int):
    """Per-row rel-pos terms (f32) of q [Bw, nh, n, hd]: rel_h [.., n, kh],
    rel_w [.., n, kw] with rel_h[i, r] = q_i . Rh[row(i), r]."""
    Bw, nh, n, hd = q.shape
    r_q = q.reshape(Bw, nh, kh, kw, hd)
    rel_h = torch.einsum("bnyxd,ykd->bnyxk", r_q, Rh).reshape(Bw, nh, n, kh)
    rel_w = torch.einsum("bnyxd,xkd->bnyxk", r_q, Rw).reshape(Bw, nh, n, kw)
    return rel_h, rel_w


def _window_logits(q, k, Rh, Rw, kh, kw):
    """f32 logits q k^T * hd^-1/2 + bias of every head: [Bw, nh, n, n]."""
    hd = q.shape[-1]
    rel_h, rel_w = _rel_terms(q, Rh, Rw, kh, kw)
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2)
    return torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5) + bias


def _softmax_p(q, k, Rh, Rw, kh, kw):
    return torch.softmax(_window_logits(q, k, Rh, Rw, kh, kw), dim=-1)


def window_attn_core_plain(qkv: Tensor, rh: Tensor, rw: Tensor) -> Tensor:
    """B3 in plain PyTorch, with the kernel's rounding points: tables taken
    at qkv.dtype, f32 logits and softmax, p rounded to qkv.dtype before
    p.v, o rounded to qkv.dtype."""
    dt = qkv.dtype
    kh, kw, hd = rh.shape[0], rw.shape[0], rh.shape[-1]
    n = kh * kw
    q, k, v = _split_heads(qkv, n, hd)
    p = _softmax_p(q, k, rh.to(dt).float(), rw.to(dt).float(), kh, kw)
    o = torch.matmul(p.to(dt).float(), v)               # [Bw, nh, n, hd]
    return o.permute(0, 2, 1, 3).reshape(qkv.shape[0], -1).to(dt)


def window_attn_core_twophase_plain(qkv: Tensor, rh: Tensor,
                                   rw: Tensor) -> Tensor:
    """B15 in plain PyTorch, in its two phases: every head's f32 logits
    (scaled q.k plus the rel-pos bias) first, then softmax with p rounded
    to qkv.dtype before p.v and o rounded to qkv.dtype. B3's rounding
    points, so the same function as ``window_attn_core_plain``."""
    dt = qkv.dtype
    kh, kw, hd = rh.shape[0], rw.shape[0], rh.shape[-1]
    q, k, v = _split_heads(qkv, kh * kw, hd)
    s = _window_logits(q, k, rh.to(dt).float(), rw.to(dt).float(), kh, kw)
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = torch.matmul(p, v)                              # [Bw, nh, n, hd]
    return o.permute(0, 2, 1, 3).reshape(qkv.shape[0], -1).to(dt)


def window_attn_core_bwd_plain(qkv: Tensor, rh: Tensor, rw: Tensor,
                               do: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """B8 in plain PyTorch: (dqkv [Bw*n, 3C] at qkv.dtype, drh, drw at the
    tables' dtypes). Rounding points of ``_vit_window_bwd_kernel``
    (flash_attention.py:1228-1263): p, ds and drel are rounded to
    qkv.dtype before their products; the softmax, dd = sum(dp * p) and
    every sum are f32."""
    dt = qkv.dtype
    kh, kw, hd = rh.shape[0], rw.shape[0], rh.shape[-1]
    n = kh * kw
    M = qkv.shape[0]
    Bw = M // n

    def r(t):
        return t.to(dt).float()

    q, k, v = _split_heads(qkv, n, hd)
    Rh, Rw = r(rh), r(rw)
    nh = q.shape[1]
    p = _softmax_p(q, k, Rh, Rw, kh, kw)                 # f32
    g = do.float().reshape(Bw, n, nh, hd).permute(0, 2, 1, 3)
    dv = torch.matmul(r(p).transpose(-1, -2), g)
    dp = torch.matmul(g, v.transpose(-1, -2))
    dd = (dp * p).sum(-1, keepdim=True)
    ds = r(p * (dp - dd))                                 # [Bw, nh, n, n]
    ds5 = ds.reshape(Bw, nh, n, kh, kw)
    drel_h = r(ds5.sum(-1))                              # [Bw, nh, n, kh]
    drel_w = r(ds5.sum(-2))                              # [Bw, nh, n, kw]
    scale = hd ** -0.5
    dh = drel_h.reshape(Bw, nh, kh, kw, kh)
    dw = drel_w.reshape(Bw, nh, kh, kw, kw)
    dq = (torch.matmul(ds, k) * scale
          + torch.einsum("bnyxr,yrd->bnyxd", dh, Rh).reshape(q.shape)
          + torch.einsum("bnyxc,xcd->bnyxd", dw, Rw).reshape(q.shape))
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    q5 = q.reshape(Bw, nh, kh, kw, hd)
    drh = torch.einsum("bnyxr,bnyxd->yrd", dh, q5)
    drw = torch.einsum("bnyxc,bnyxd->xcd", dw, q5)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(M, -1)
    return dqkv.to(dt), drh.to(rh.dtype), drw.to(rw.dtype)


def _geometry(qkv: Tensor, rh: Tensor, rw: Tensor, name: str,
              head_dims=_FWD_HEAD_DIMS):
    kh, kw, hd = rh.shape[0], rw.shape[0], rh.shape[-1]
    n = kh * kw
    M, C3 = qkv.shape
    C = C3 // 3
    if (C3 % 3 or hd not in head_dims or C % hd or M % n or n > 256
            or kh + kw > 64 or C % 32 or tuple(rh.shape) != (kh, kh, hd)
            or tuple(rw.shape) != (kw, kw, hd)):
        raise ValueError(f"{name}: unsupported geometry qkv {tuple(qkv.shape)}"
                         f" rh {tuple(rh.shape)} rw {tuple(rw.shape)}")
    return M // n, n, C, C // hd, hd, kh, kw


def _check(ts, ref: Tensor, name: str) -> None:
    for t, what in ts:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                             f"expected {ref.dtype} on {ref.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not contiguous and 16-byte "
                             f"aligned")


def _cuda_only(x: Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")


def bwd_smem_bytes(dtype: torch.dtype, n: int, kh: int, kw: int) -> int:
    """Shared memory of B8's main kernel (``window_attn_bwd.cu``
    ``bwd_smem_bytes``): K, V at the input dtype and dK, dV in f32, each
    [64][n | 1]; 16-row q, do and ds tiles; the rows' rel-pos terms."""
    ld = n | 1
    eb = 4 if dtype == torch.float32 else 2
    return (2 * 64 * ld * eb + 2 * 64 * ld * 4 + 2 * 16 * 64 * 4
            + 16 * ld * 4 + 2 * 16 * (kh + kw) * 4 + 3 * 16 * 4
            + 8 * 16 * 4)


_P, _I = ctypes.c_void_p, ctypes.c_int


def window_attn_core(qkv: Tensor, rh: Tensor, rw: Tensor) -> Tensor:
    """B3: qkv [Bw*n, 3C], rh [kh, kh, hd], rw [kw, kw, hd] with hd 64 or 80
    (one dtype, float32 or bfloat16) -> o [Bw*n, C]. CPU tensors run
    ``window_attn_core_plain``; CUDA tensors launch the kernel or raise."""
    if qkv.device.type == "cpu":
        return window_attn_core_plain(qkv, rh, rw)
    name = "window_attn_core"
    _cuda_only(qkv, name)
    Bw, n, C, nh, hd, kh, kw = _geometry(qkv, rh, rw, name)
    _check(((qkv, "qkv"), (rh, "rh"), (rw, "rw")), qkv, name)
    out = torch.empty((qkv.shape[0], C), device=qkv.device, dtype=qkv.dtype)
    fn = build.function("window_attn", "window_attn_core_forward",
                        [_I] + [_P] * 4 + [_I] * 7 + [_P])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODE[qkv.dtype], qkv.data_ptr(), rh.data_ptr(),
                 rw.data_ptr(), out.data_ptr(), Bw, n, C, nh, hd, kh, kw,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    window_attn_core.launches += 1
    return out


window_attn_core.launches = 0


def window_attn_core_twophase(qkv: Tensor, rh: Tensor, rw: Tensor) -> Tensor:
    """B15: B3's arguments and result (hd 64 or 80). CPU tensors run
    ``window_attn_core_twophase_plain``; CUDA tensors launch the kernel's
    two phases, with the logits in a scratch [Bw, nh, nk, nk] f32 (nk = n
    rounded up to 16) allocated here, or raise."""
    if qkv.device.type == "cpu":
        return window_attn_core_twophase_plain(qkv, rh, rw)
    name = "window_attn_core_twophase"
    _cuda_only(qkv, name)
    Bw, n, C, nh, hd, kh, kw = _geometry(qkv, rh, rw, name)
    _check(((qkv, "qkv"), (rh, "rh"), (rw, "rw")), qkv, name)
    nk = -(-n // 16) * 16
    scratch = torch.empty((Bw, nh, nk, nk), device=qkv.device,
                          dtype=torch.float32)
    out = torch.empty((qkv.shape[0], C), device=qkv.device, dtype=qkv.dtype)
    fn = build.function("window_attn_twophase",
                        "window_attn_twophase_forward",
                        [_I] + [_P] * 5 + [_I] * 7 + [_P])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODE[qkv.dtype], qkv.data_ptr(), rh.data_ptr(),
                 rw.data_ptr(), scratch.data_ptr(), out.data_ptr(), Bw, n, C,
                 nh, hd, kh, kw, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    window_attn_core_twophase.launches += 1
    return out


window_attn_core_twophase.launches = 0


def window_attn_core_bwd(qkv: Tensor, rh: Tensor, rw: Tensor,
                         do: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """B8: the gradient of B3 for the output gradient do [Bw*n, C]:
    (dqkv [Bw*n, 3C], drh, drw). CPU tensors run
    ``window_attn_core_bwd_plain``; CUDA tensors launch the kernel or
    raise."""
    if qkv.device.type == "cpu":
        return window_attn_core_bwd_plain(qkv, rh, rw, do)
    name = "window_attn_core_bwd"
    _cuda_only(qkv, name)
    Bw, n, C, nh, hd, kh, kw = _geometry(qkv, rh, rw, name, _BWD_HEAD_DIMS)
    if tuple(do.shape) != (qkv.shape[0], C):
        raise ValueError(f"{name}: do has shape {tuple(do.shape)}")
    if bwd_smem_bytes(qkv.dtype, n, kh, kw) > _SMEM_LIMIT:
        raise ValueError(f"{name}: n={n} needs more shared memory than a "
                         f"block has at {qkv.dtype}")
    _check(((qkv, "qkv"), (rh, "rh"), (rw, "rw"), (do, "do")), qkv, name)
    dqkv = torch.empty_like(qkv)
    drh = torch.empty(rh.shape, device=qkv.device, dtype=torch.float32)
    drw = torch.empty(rw.shape, device=qkv.device, dtype=torch.float32)
    # the rounded rel-pos gradients of every (window, head, row): the
    # per-row partials that the table reduction sums in a fixed order
    drel = torch.empty((Bw, nh, n, kh + kw), device=qkv.device,
                       dtype=torch.float32)
    # and each window's share of the table gradients, summed in order after
    part = torch.empty((Bw, (kh * kh + kw * kw) * hd), device=qkv.device,
                       dtype=torch.float32)
    fn = build.function("window_attn_bwd", "window_attn_bwd",
                        [_I] + [_P] * 9 + [_I] * 7 + [_P])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODE[qkv.dtype], qkv.data_ptr(), rh.data_ptr(),
                 rw.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                 drh.data_ptr(), drw.data_ptr(), drel.data_ptr(),
                 part.data_ptr(), Bw, n, C, nh, hd, kh, kw, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    window_attn_core_bwd.launches += 1
    return dqkv, drh.to(rh.dtype), drw.to(rw.dtype)


window_attn_core_bwd.launches = 0


class WindowAttnCore(torch.autograd.Function):
    """B3 forward (B15 under ``ULLSAM_WINDOW_TWOPHASE=1``), B8 backward;
    saves only the inputs."""

    @staticmethod
    def forward(ctx, qkv, rh, rw):
        ctx.save_for_backward(qkv, rh, rw)
        core = (window_attn_core_twophase if flags.window_twophase()
                else window_attn_core)
        return core(qkv, rh, rw)

    @staticmethod
    def backward(ctx, do):
        qkv, rh, rw = ctx.saved_tensors
        return window_attn_core_bwd(qkv, rh, rw, build.aligned(do))


def window_attention(qkv: Tensor, rh: Tensor, rw: Tensor) -> Tensor:
    """Differentiable ``window_attn_core`` (or B15 by the switch; the
    gradient is B8)."""
    return WindowAttnCore.apply(qkv, rh, rw)
