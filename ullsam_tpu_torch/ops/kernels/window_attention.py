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

B15, ``window_attn_core_twophase``, computes B3's function in the TPU
kernel's two phases (a row's whole f32 logits first, then its exact max
and sum, p normalized and rounded, then p.v); it replaces
``_vit_window_kernel_twophase``, which the JAX package runs in B3's place
under ``ULLSAM_WINDOW_TWOPHASE=1``. On the card the logits never leave the
chip: one launch, no scratch.

The three compute one function at the JAX kernels' rounding points (f32
logits, the exact row max and sum, the normalized p rounded before p.v),
so B3 (``csrc/window_attn.cu``), B15 (``csrc/window_attn_twophase.cu``)
and B1's core all launch the port's one window core of the dtype and give
bitwise-equal outputs: in bfloat16 ``csrc/window_core.cuh``, in float32
``csrc/window_core_f32.cuh`` (every product on the tensor cores in split
TF32: three TF32 products for each, f32-accurate; its launches are counted
in C, ``window_core_f32.launches``). B8 is ``csrc/window_attn_bwd.cu``. On
a CPU tensor each runs its plain version here. B3, B15 and B8 take head
dims 64 and 80 and windows of at most 16x16 in both dtypes (B8: bfloat16
on the tensor cores; float32 on them too, in split TF32). There is no
fallback from a kernel to its plain version. ``window_attention`` is the differentiable
entry: a ``torch.autograd.Function`` whose forward is B3 (B15 under
``ULLSAM_WINDOW_TWOPHASE=1``, read at each call) and whose backward is B8
on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ullsam_tpu_torch.ops.kernels import build, flags
from ullsam_tpu_torch.ops.kernels.gemm import GemmLaunches

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_HEAD_DIMS = (64, 80)  # B3, B15: SAM ViT-B / L and ViT-H
# B8: bfloat16 on the tensor cores, float32 on them in split TF32
_BWD_HEAD_DIMS = {torch.bfloat16: (64, 80), torch.float32: (64, 80)}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)


def _work(t: Tensor) -> Tensor:
    """t in the plain versions' working type: float64 stays float64 (an
    exact reference), every other dtype computes in float32."""
    return t if t.dtype == torch.float64 else t.float()


def _split_heads(qkv: Tensor, n: int, hd: int):
    """qkv [Bw*n, 3C] -> q, k, v [Bw, nh, n, hd] in the working type."""
    M, C3 = qkv.shape
    nh = C3 // 3 // hd
    t = _work(qkv).reshape(M // n, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def _rel_terms(q: Tensor, Rh: Tensor, Rw: Tensor, kh: int, kw: int,
               mm=torch.matmul):
    """Per-row rel-pos terms of q [Bw, nh, n, hd]: rel_h [.., n, kh],
    rel_w [.., n, kw] with rel_h[i, r] = q_i . Rh[row(i), r] (the rows of
    window row y against Rh[y], of window column x against Rw[x])."""
    Bw, nh, n, hd = q.shape
    r_q = q.reshape(Bw, nh, kh, kw, hd)
    rel_h = mm(r_q, Rh.transpose(-1, -2)).reshape(Bw, nh, n, kh)
    rel_w = mm(r_q.transpose(2, 3), Rw.transpose(-1, -2)).transpose(2, 3)
    return rel_h, rel_w.reshape(Bw, nh, n, kw)


def _window_logits(q, k, Rh, Rw, kh, kw, mm=torch.matmul):
    """Logits q k^T * hd^-1/2 + bias of every head: [Bw, nh, n, n]."""
    hd = q.shape[-1]
    rel_h, rel_w = _rel_terms(q, Rh, Rw, kh, kw, mm)
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).flatten(-2)
    return mm(q, k.transpose(-1, -2)) * (hd ** -0.5) + bias


def _softmax_p(q, k, Rh, Rw, kh, kw, mm=torch.matmul):
    return torch.softmax(_window_logits(q, k, Rh, Rw, kh, kw, mm), dim=-1)


def window_attn_core_plain(qkv: Tensor, rh: Tensor, rw: Tensor,
                           mm=torch.matmul) -> Tensor:
    """B3 in plain PyTorch, with the kernel's rounding points: tables taken
    at qkv.dtype, f32 logits and softmax, p rounded to qkv.dtype before
    p.v, o rounded to qkv.dtype. ``mm`` takes the products that the kernel
    runs on the tensor cores (the rel-pos terms, q k^T and p v);
    ``tf32.mm_3xtf32`` gives the float32 kernel's split TF32. Float64
    inputs compute in float64 throughout."""
    dt = qkv.dtype
    kh, kw, hd = rh.shape[0], rw.shape[0], rh.shape[-1]
    n = kh * kw
    q, k, v = _split_heads(qkv, n, hd)
    p = _softmax_p(q, k, _work(rh.to(dt)), _work(rw.to(dt)), kh, kw, mm)
    o = mm(_work(p.to(dt)), v)                           # [Bw, nh, n, hd]
    return o.permute(0, 2, 1, 3).reshape(qkv.shape[0], -1).to(dt)


def window_attn_core_twophase_plain(qkv: Tensor, rh: Tensor,
                                   rw: Tensor) -> Tensor:
    """B15 in plain PyTorch, in its two phases: every head's f32 logits
    (scaled q.k plus the rel-pos bias) first, then softmax with p rounded
    to qkv.dtype before p.v and o rounded to qkv.dtype. B3's rounding
    points, so the same function as ``window_attn_core_plain``. Float64
    inputs compute in float64 throughout."""
    dt = qkv.dtype
    kh, kw, hd = rh.shape[0], rw.shape[0], rh.shape[-1]
    q, k, v = _split_heads(qkv, kh * kw, hd)
    s = _window_logits(q, k, _work(rh.to(dt)), _work(rw.to(dt)), kh, kw)
    p = _work(torch.softmax(s, dim=-1).to(dt))
    o = torch.matmul(p, v)                              # [Bw, nh, n, hd]
    return o.permute(0, 2, 1, 3).reshape(qkv.shape[0], -1).to(dt)


def window_attn_core_bwd_plain(qkv: Tensor, rh: Tensor, rw: Tensor,
                               do: Tensor, mm=torch.matmul
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """B8 in plain PyTorch: (dqkv [Bw*n, 3C] at qkv.dtype, drh, drw at the
    tables' dtypes). Rounding points of ``_vit_window_bwd_kernel``
    (flash_attention.py:1228-1263): p, ds and drel are rounded to
    qkv.dtype before their products; the softmax, dd = sum(dp * p) and
    every sum are f32. ``mm`` takes the products that the kernel runs on
    the tensor cores: the rel-pos terms, s, dp, dv, dq and dk, dq's rel
    part, and the drel sums as ds . sel (sel the 0 / 1 selection of each
    key's window row or column); ``tf32.mm_3xtf32`` gives the float32
    kernel's split TF32. The table gradients stay sums. Float64 inputs
    compute in float64 throughout."""
    dt = qkv.dtype
    kh, kw, hd = rh.shape[0], rw.shape[0], rh.shape[-1]
    n = kh * kw
    M = qkv.shape[0]
    Bw = M // n

    def r(t):
        return _work(t.to(dt))

    q, k, v = _split_heads(qkv, n, hd)
    Rh, Rw = r(rh), r(rw)
    nh = q.shape[1]
    p = _softmax_p(q, k, Rh, Rw, kh, kw, mm)             # f32
    g = _work(do).reshape(Bw, n, nh, hd).permute(0, 2, 1, 3)
    dv = mm(r(p).transpose(-1, -2), g)
    dp = mm(g, v.transpose(-1, -2))
    dd = (dp * p).sum(-1, keepdim=True)
    ds = r(p * (dp - dd))                                 # [Bw, nh, n, n]
    key = torch.arange(n, device=qkv.device)
    sel_h = (key[:, None] // kw == torch.arange(kh, device=qkv.device)
             ).to(ds.dtype)                              # [n, kh]
    sel_w = (key[:, None] % kw == torch.arange(kw, device=qkv.device)
             ).to(ds.dtype)                              # [n, kw]
    drel_h = r(mm(ds, sel_h))                            # [Bw, nh, n, kh]
    drel_w = r(mm(ds, sel_w))                            # [Bw, nh, n, kw]
    scale = hd ** -0.5
    dh = drel_h.reshape(Bw, nh, kh, kw, kh)
    dw = drel_w.reshape(Bw, nh, kh, kw, kw)
    # window row y's rows against Rh[y], window column x's against Rw[x]
    dq = (mm(ds, k) * scale + mm(dh, Rh).reshape(q.shape)
          + mm(dw.transpose(2, 3), Rw).transpose(2, 3).reshape(q.shape))
    dk = mm(ds.transpose(-1, -2), q) * scale
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


def _nk(n: int) -> int:
    return -(-n // 16) * 16


def bwd_smem_bytes(dtype: torch.dtype, n: int, kh: int, kw: int,
                   hd: int = 64) -> int:
    """Shared memory of B8's main kernel (``window_attn_bwd.cu`` ``BwdMma``
    and ``BwdTf32``). bfloat16: q, k, v and do [nk][hd + 8], the rows'
    rel-pos terms and statistics in f32. float32 (split TF32): two f32
    tiles [nk][hd + 4] (q; then k and v; then q and do), a [16][hd + 4]
    tile for each of the 8 warps (its do rows in pass 1, its k rows in
    pass 2), the rows' rel-pos terms and statistics, with nk the 16-key
    tiles of the instance that runs the window (``tf32_key_tiles``)."""
    rl, nk = kh + kw, _nk(n)
    if dtype == torch.bfloat16:
        return 2 * 4 * nk * (hd + 8) + 4 * (nk * rl + 3 * nk)
    nk = 16 * tf32_key_tiles(n)
    return 4 * (2 * nk * (hd + 4) + 8 * 16 * (hd + 4) + nk * rl + 3 * nk)


# the key-tile counts of B8's float32 instances (``window_attn_bwd.cu``
# ``kTf32Nts``): a window runs the first that holds its keys
TF32_KEY_TILES = (2, 4, 8, 13, 16)


def tf32_key_tiles(n: int) -> int:
    """``tf32_nt``: the key tiles of 16 that B8's float32 instance for a
    window of n tokens spans."""
    return next(t for t in TF32_KEY_TILES if 16 * t >= n)


def core_smem_bytes(n: int, kh: int, kw: int, hd: int) -> int:
    """Shared memory of the bf16 window core (``window_core.cuh``
    ``WinCoreLayout``), which B1, B3 and B15 launch: two slots of k and v
    [16 kh key slots][ld] and two of a query half's rows [half * 16][ld]
    in bf16 (ld = 72 at head dim 64, 80 at 80), the half's rel-pos terms
    in f32."""
    nk, rl = 16 * kh, kh + kw
    half = (_nk(n) // 16 + 1) // 2
    ld = 80 if hd == 80 else hd + 8
    return 2 * 2 * (2 * nk + half * 16) * ld + 4 * half * 16 * rl


# the slot rows of the float32 core's instances (``window_core_f32.cuh``
# ``kCoreF32Nts``): a window of kh rows runs the first that holds them
CORE_F32_SLOT_ROWS = (2, 4, 8, 14, 16)


def core_f32_smem_bytes(n: int, kh: int, kw: int, hd: int) -> int:
    """Shared memory of the float32 window core (``window_core_f32.cuh``
    ``WinCoreF32Layout``), which B1, B3 and B15 launch in float32: k's and
    then v's hi and lo planes [16 NT key slots][hd + 4] (NT the instance's
    slot rows), a query half's rows [half * 16][hd + 4] and their rel-pos
    terms [half * 16][kh + kw], all f32."""
    nt = next(t for t in CORE_F32_SLOT_ROWS if t >= kh)
    half = (_nk(n) // 16 + 1) // 2
    ld = hd + 4
    return 4 * (2 * 16 * nt * ld + half * 16 * ld + half * 16 * (kh + kw))


def check_core_window(dtype: torch.dtype, kh: int, kw: int,
                      name: str) -> None:
    """The window cores of both dtypes take windows of at most 16 x 16 (a
    window row's keys fill one 16-key slot; SAM's windows are 14 x 14);
    raises otherwise."""
    if max(kh, kw) > 16:
        raise ValueError(f"{name}: {dtype} takes windows of at most 16x16 "
                         f"(one 16-key slot a window row); got {kh}x{kw}")


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
    check_core_window(qkv.dtype, kh, kw, name)
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

# launches of the float32 window core (``csrc/window_core_f32.cuh``), which
# B1, B3 and B15 launch in float32, counted in C by each library that holds
# it
window_core_f32 = GemmLaunches(None, ("window_attn", "window_attn_twophase"),
                               "window_core_f32_launch_count")


def window_attn_core_twophase(qkv: Tensor, rh: Tensor, rw: Tensor) -> Tensor:
    """B15: B3's arguments and result (hd 64 or 80). CPU tensors run
    ``window_attn_core_twophase_plain``; CUDA tensors launch the kernel
    (one launch, the logits kept on chip; only ``out`` is allocated; B3's
    own core of the dtype) or raise."""
    if qkv.device.type == "cpu":
        return window_attn_core_twophase_plain(qkv, rh, rw)
    name = "window_attn_core_twophase"
    _cuda_only(qkv, name)
    Bw, n, C, nh, hd, kh, kw = _geometry(qkv, rh, rw, name)
    check_core_window(qkv.dtype, kh, kw, name)
    _check(((qkv, "qkv"), (rh, "rh"), (rw, "rw")), qkv, name)
    out = torch.empty((qkv.shape[0], C), device=qkv.device, dtype=qkv.dtype)
    fn = build.function("window_attn_twophase",
                        "window_attn_twophase_forward",
                        [_I] + [_P] * 4 + [_I] * 7 + [_P])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODE[qkv.dtype], qkv.data_ptr(), rh.data_ptr(),
                 rw.data_ptr(), out.data_ptr(), Bw, n, C, nh, hd, kh, kw,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    window_attn_core_twophase.launches += 1
    return out


window_attn_core_twophase.launches = 0


def window_attn_core_bwd(qkv: Tensor, rh: Tensor, rw: Tensor,
                         do: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """B8: the gradient of B3 for the output gradient do [Bw*n, C]:
    (dqkv [Bw*n, 3C], drh, drw). CPU tensors run
    ``window_attn_core_bwd_plain``; CUDA tensors launch the kernel (head
    dims ``_BWD_HEAD_DIMS[dtype]``; bitwise the same result on every call)
    or raise."""
    if qkv.device.type == "cpu":
        return window_attn_core_bwd_plain(qkv, rh, rw, do)
    name = "window_attn_core_bwd"
    _cuda_only(qkv, name)
    Bw, n, C, nh, hd, kh, kw = _geometry(qkv, rh, rw, name,
                                         _BWD_HEAD_DIMS[qkv.dtype])
    if tuple(do.shape) != (qkv.shape[0], C):
        raise ValueError(f"{name}: do has shape {tuple(do.shape)}")
    if max(kh, kw) > 16:
        raise ValueError(f"{name}: takes windows of at most 16x16 (its drel "
                         f"sums are one 32-column selection product); got "
                         f"{kh}x{kw}")
    if bwd_smem_bytes(qkv.dtype, n, kh, kw, hd) > _SMEM_LIMIT:
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
    # and the table gradients' shares, one per (window, head) (the kernel's
    # third pass), summed in a fixed order after
    bf16 = qkv.dtype == torch.bfloat16
    part = torch.empty((Bw * nh, (kh * kh + kw * kw) * hd),
                       device=qkv.device, dtype=torch.float32)
    # bf16: ds k * scale in f32, kept from the kernel's first pass to its
    # last, where dq's rel-pos part is added and dq rounded once
    dqf = (torch.empty((qkv.shape[0], C), device=qkv.device,
                       dtype=torch.float32) if bf16 else None)
    fn = build.function("window_attn_bwd", "window_attn_bwd",
                        [_I] + [_P] * 10 + [_I] * 7 + [_P])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODE[qkv.dtype], qkv.data_ptr(), rh.data_ptr(),
                 rw.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                 drh.data_ptr(), drw.data_ptr(), drel.data_ptr(),
                 part.data_ptr(), None if dqf is None else dqf.data_ptr(), Bw,
                 n, C, nh, hd, kh, kw, stream)
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
