"""B12: the weight-only int8 matmul (W8A16) of the quantized LLM.

``w8a16_matmul(x, qweight, qscale, bias=None, out_dtype=float32)`` computes

    y[m, n] = (sum_k x[m, k] * qweight[n, k]) * qscale[n] (+ bias[n])

with qweight converted to x's dtype (exact: |q| <= 127) and summed in f32,
then rounded once to ``out_dtype`` (float32, as the TPU kernel returns, or
x's dtype, the JAX linear's cast). It replaces the TPU kernel
``ullsam_tpu/ops/pallas/int8_matmul.py`` ``_w8a16_kernel``; the bias and the
cast are the epilogue of the JAX int8 linear (``ullsam_tpu/ops/layers.py:
76-81``), fused. qweight is the port's natural ``[out, in]`` layout (the JAX
package stores ``[in, out]``).

On a CUDA tensor it launches ``csrc/w8a16_matmul.cu`` (see the note there:
decode memory-bound, prefill operation-bound; N ragged, K a multiple of 16)
or raises; on a CPU tensor it runs ``w8a16_matmul_plain``. There is no
fallback from the kernel: the card never dequantizes into a float matmul.
Which of its seven kernels a call launches is ``w8a16_kernel``: at 2 <= M
<= 16 the decode body on the tensor cores (split over K where
``decode_plan`` says), at M = 1 the CUDA-core GEMV; at prefill the wgmma +
TMA GEMM of ``csrc/gemm_sm90.cuh`` with an int8 W operand where N % 128 ==
0 and K % 64 == 0 (every layer linear of InternLM2-1.8B; split over K where
``sm90_splits`` says: the serving engine's 128- and 256-row segments), else
the mma.sync GEMM (the ragged vocab head). f32 x runs its own instances of
the decode body and the wgmma GEMM (``w8a16_decode_tc_f32``,
``w8a16_sm90_f32``, which also takes the ragged head: ``x3_takes``), the
FMA GEMM only at other widths (K % 64, N < 128): x is split exactly into
three bf16 planes (``split_bf16x3``), each multiplied on the bf16 tensor
cores with the exact bf16 weight, the three products summed in f32; at
prefill a pre-pass kernel (``w8a16_split_x3``) writes the planes. Each
kernel counts its launches in C (``kernel_launches``; ``call_launches``
says which a call launches). A split call takes an f32
workspace of its partials (``torch.empty``; the f32 prefill also x's
planes there) and the device's tile counters, which the kernels leave at
zero: a captured CUDA graph replays it with no memset. Calls on one device
share those
counters, so they run in stream order (the port issues B12 from one stream
at a time); the first split call on a device allocates them and must not
be inside a graph capture.
``check_weights`` holds the weight operands to what the kernel takes; the
decode path's ``QuantLinear`` runs it once on its CUDA buffers and then
calls ``w8a16_matmul_checked``, which checks only x on each call.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels.gemm import (SM90_BK, SM90_BN,
                                               GemmLaunches, sm90_takes)

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the B12 kernels in csrc/w8a16_matmul.cu's order (W8Kernel); the last is
# the f32 prefill's pre-pass, launched before each w8a16_sm90_f32
KERNELS = ("w8a16_gemv", "w8a16_sm90", "w8a16_mma", "w8a16_f32",
           "w8a16_decode_tc", "w8a16_sm90_f32", "w8a16_decode_tc_f32",
           "w8a16_split_x3")
kernel_launches = {name: GemmLaunches(i, ("w8a16_matmul",),
                                      "w8a16_launch_count")
                   for i, name in enumerate(KERNELS)}
# an H100 SXM's SMs: the split rules' default; a call reads its card's
H100_SMS = 132
# the decode body on the tensor cores (w8a16_matmul.cu kTc*): warps a block
# (each on 16 weight rows), x's slice in shared memory at most, the least M
# it takes (M = 1 keeps the GEMV), the bf16 a staged x row is padded by
TC_WARPS, TC_X_BYTES, TC_MIN_M, TC_X_PAD = 8, 131072, 2, 8
# the int8 wgmma kind's split-K (gemm_sm90.cuh): k-blocks a unit keeps, and
# a unit's f32 partial (its 256 consumer threads' 72 accumulators)
SM90_MIN_SPLIT_KB, SM90_PART_FLOATS = 4, 256 * 72
# the int8 kernel (gemm_sm90.cuh Sm90Layout<kSm90Int8>): x rows a tile,
# stages, floats a staging row; its f32-x kind (Sm90Layout<kSm90Int8X3>):
# x's planes a stage, stages, x rows staged at a time
W8_BM, W8_STAGES, W8_STG_LD = 144, 6, 12
X3_PLANES, X3_STAGES, X3_STG_ROWS = 3, 3, 72


def w8a16_matmul_plain(x: Tensor, qweight: Tensor, qscale: Tensor,
                       bias: Optional[Tensor] = None,
                       out_dtype: torch.dtype = torch.float32) -> Tensor:
    """The kernel's function in plain PyTorch: x [M, K], qweight [N, K]
    int8, qscale [N], bias [N] or None -> [M, N] ``out_dtype``."""
    y = torch.matmul(x.float(), qweight.to(x.dtype).float().t())
    y = y * qscale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def split_bf16x3(x: Tensor) -> tuple:
    """The kernels' exact split of f32 x into three bf16 parts, x = b0 +
    b1 + b2 (plain PyTorch; the card splits in ``csrc/w8a16_matmul.cu``
    ``split_bf16x3``): b0 is x cut to its top 16 bits, b1 the remainder r1
    = x - b0 (exact in f32) cut the same way, b2 = r1 - b1 (exact, at most
    8 significant bits) rounded to bf16. Exact for every finite x whose
    bits lie at or above 2^-133 (bf16's least subnormal), so for every |x|
    >= 2^-110; below, b2 rounds to a multiple of 2^-133 and x is rebuilt
    within 2^-134. Cutting b0 instead of rounding it keeps the largest
    floats finite (rounding sends |x| >= (2 - 2^-8) 2^127 to inf). Returns
    (b0, b1, b2), bfloat16 of x's shape."""
    x = x.float()
    b0 = (x.view(torch.int32) & -65536).view(torch.float32)
    r1 = x - b0
    b1 = (r1.view(torch.int32) & -65536).view(torch.float32)
    return b0.bfloat16(), b1.bfloat16(), (r1 - b1).bfloat16()


def decode_plan(M: int, N: int, K: int, sms: int = H100_SMS,
                dtype: torch.dtype = torch.bfloat16) -> tuple:
    """``w8a16_matmul.cu`` ``tc_plan``: (W, S) of the decode body on the
    tensor cores for x [M, K] of ``dtype`` and qweight [N, K], (0, 0) where
    it does not take the shape (M = 1, M > 16, K % 64). W warps of a block
    split a 16-row tile's K (a block takes 128 / W rows), doubled while the
    blocks still fit in one wave of ``sms`` and a warp keeps whole 64-byte
    chunks; S blocks split K, doubled until x's slice (M padded to 8 or 16
    rows; its three bf16 planes with f32 x) fits ``TC_X_BYTES``. With f32
    x, where that splits K across blocks, W is quartered (at least 1) and
    S grows to match: taller blocks, fewer copies of x's f32 slice."""
    if M < TC_MIN_M or M > 16 or K % 64:
        return 0, 0
    mm = 8 if M <= 8 else 16
    planes = X3_PLANES if dtype == torch.float32 else 1
    w = 1
    while (w < TC_WARPS and -(-N // (8 * TC_WARPS // w)) <= sms
           and K % (2 * w * 64) == 0):
        w *= 2
    s = 1
    while planes * mm * (K // s) * 2 > TC_X_BYTES:
        if K % (2 * s * w * 64):
            return 0, 0
        s *= 2
    if planes == X3_PLANES and s > 1:
        shift = min(2, w.bit_length() - 1)
        w, s = w >> shift, s << shift
    return w, s


def decode_groups(M: int, N: int, K: int, sms: int = H100_SMS,
                  dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of weight rows (128 / W each) of the decode body."""
    w, _ = decode_plan(M, N, K, sms, dtype)
    return -(-N // (16 * TC_WARPS // w))


def x3_takes(M: int, N: int, K: int) -> bool:
    """``w8a16_matmul.cu`` ``w8_x3_takes``: the shapes the wgmma GEMM's
    f32-x kind takes, ``sm90_takes``' and a ragged N of at least one tile
    (the vocab head)."""
    return M >= 1 and N >= SM90_BN and K >= SM90_BK and K % SM90_BK == 0


def sm90_splits(M: int, N: int, K: int, sms: int = H100_SMS) -> int:
    """``gemm_sm90.cuh`` ``sm90_int8_splits``: the K splits of the int8
    wgmma kinds (144-row x tiles, 128 weight rows, the last one ragged at
    the head, 64-deep k-blocks), doubled while tiles x splits still fit in
    one wave of ``sms`` and each unit keeps ``SM90_MIN_SPLIT_KB`` k-blocks:
    1 wherever the tiles fill the card (M = 1152 and 9216)."""
    tiles, kt = -(-M // W8_BM) * -(-N // SM90_BN), K // SM90_BK
    s = 1
    while (tiles * s * 2 <= sms and kt % (2 * s) == 0
           and kt // (2 * s) >= SM90_MIN_SPLIT_KB):
        s *= 2
    return s


def w8a16_kernel(M: int, N: int, K: int,
                 dtype: torch.dtype = torch.bfloat16,
                 sms: int = H100_SMS) -> str:
    """Which kernel ``csrc/w8a16_matmul.cu`` launches for x [M, K] of
    ``dtype`` and qweight [N, K] (operands 16-byte aligned) on a card of
    ``sms`` SMs: f32 x takes the ``_f32`` instances of the decode body and
    the wgmma GEMM (the ragged head too), and the FMA GEMM ``w8a16_f32``
    only at widths the wgmma GEMM does not take (K % 64, N < 128)."""
    if M <= 16:
        name = "w8a16_decode_tc" if decode_plan(M, N, K, sms,
                                                dtype)[0] else "w8a16_gemv"
    elif dtype == torch.float32:
        return "w8a16_sm90_f32" if x3_takes(M, N, K) else "w8a16_f32"
    else:
        return "w8a16_sm90" if sm90_takes(M, N, K) else "w8a16_mma"
    return (name + "_f32" if dtype == torch.float32
            and name == "w8a16_decode_tc" else name)


def call_launches(name: str) -> dict:
    """{B12 kernel: launches} of one call that ``plan`` sends to kernel
    ``name``: ``w8a16_sm90_f32`` runs its pre-pass ``w8a16_split_x3``
    first, every other kernel runs alone."""
    if name == "w8a16_sm90_f32":
        return {"w8a16_split_x3": 1, name: 1}
    return {name: 1}


def plan(M: int, N: int, K: int, dtype: torch.dtype = torch.bfloat16,
         sms: int = H100_SMS) -> tuple:
    """(kernel name, splits, the decode body's warps a tile or 0): the
    mirror of the library's own plan (``c_plan``)."""
    name = w8a16_kernel(M, N, K, dtype, sms)
    if name.startswith("w8a16_decode_tc"):
        w, s = decode_plan(M, N, K, sms, dtype)
        return name, s, w
    return (name, sm90_splits(M, N, K, sms)
            if name.startswith("w8a16_sm90") else 1, 0)


def workspace(M: int, N: int, K: int, dtype: torch.dtype = torch.bfloat16,
              sms: int = H100_SMS) -> tuple:
    """(f32 workspace, tile counters) a call needs: where K splits, the
    decode body's 16-row tiles' accumulators (8 or 16 floats a lane) of
    every block, a counter a block row group, or the wgmma GEMM's units'
    ``SM90_PART_FLOATS``, a counter a tile; then, for the f32 prefill
    (``w8a16_sm90_f32``), x's three bf16 planes, 1.5 M K floats; (0, 0) for
    a call that needs neither."""
    name, s, w = plan(M, N, K, dtype, sms)
    planes = M * K * 3 // 2 if name == "w8a16_sm90_f32" else 0
    if s == 1:
        return planes, 0
    if name.startswith("w8a16_decode_tc"):
        groups = decode_groups(M, N, K, sms, dtype)
        nt = 1 if M <= 8 else 2
        return groups * s * (TC_WARPS // w) * nt * 32 * 4, groups
    tiles = -(-M // W8_BM) * -(-N // SM90_BN)
    return tiles * s * SM90_PART_FLOATS + planes, tiles


def decode_smem_bytes(M: int, N: int, K: int, sms: int = H100_SMS,
                      dtype: torch.dtype = torch.bfloat16) -> int:
    """The decode body's shared memory at this shape: x's K slice of 8 or
    16 rows in bf16 (f32 x: its three bf16 planes), each row padded by
    ``TC_X_PAD``; the warps' accumulators for the in-block sum (a float4 a
    lane and 8 rows of x); the flag of a group's last block."""
    nt = 1 if M <= 8 else 2
    planes = X3_PLANES if dtype == torch.float32 else 1
    _, s = decode_plan(M, N, K, sms, dtype)
    return (planes * 8 * nt * (K // s + TC_X_PAD) * 2
            + TC_WARPS * nt * 32 * 16 + 4)


def sm90_smem_bytes(dtype: torch.dtype = torch.bfloat16) -> int:
    """``Sm90Layout<kSm90Int8>::kSmemBytes`` (bf16 x) or
    ``Sm90Layout<kSm90Int8X3>``'s (f32 x): 1024 bytes to align the stages;
    6 stages of x's 144 x 64 bf16 tile and W's 128 x 64 int8 one (f32 x: 3
    stages of x's three bf16 planes and W's tile); the 8 consumer warps'
    epilogue staging (144 rows of 8 + 4 floats each, the swapped product's
    accumulators transposed; f32 x: 72 rows at a time); a full and an empty
    mbarrier a stage and the two consumer warpgroups' turn mbarriers."""
    planes, stages, rows = ((X3_PLANES, X3_STAGES, X3_STG_ROWS)
                            if dtype == torch.float32
                            else (1, W8_STAGES, W8_BM))
    return (1024 + stages * (planes * W8_BM * SM90_BK * 2
                             + SM90_BN * SM90_BK)
            + 8 * rows * W8_STG_LD * 4 + (2 * stages + 2) * 8)


def check_weights(qweight: Tensor, qscale: Tensor,
                  bias: Optional[Tensor] = None, *,
                  kernel: bool = True) -> None:
    """Raise unless these are weight operands of the function: qweight
    [N, K] int8, qscale [N] and bias [N] (or None) f32, all on qweight's
    device. With ``kernel`` (the default), also what the kernel alone needs:
    K a multiple of 16 and every buffer contiguous and 16-byte aligned; the
    plain version takes any width. ``QuantLinear`` runs the kernel's checks
    on CUDA buffers once, and the shape checks on any device."""
    if qweight.dim() != 2 or qweight.dtype != torch.int8:
        raise ValueError(f"w8a16_matmul: qweight is {qweight.dtype} "
                         f"{tuple(qweight.shape)}; it must be int8 [N, K]")
    if kernel and qweight.shape[1] % 16:
        raise ValueError(f"w8a16_matmul: qweight {tuple(qweight.shape)}: "
                         f"the kernel needs K a multiple of 16")
    N = qweight.shape[0]
    for name, t in (("qweight", qweight), ("qscale", qscale),
                    ("bias", bias)):
        if t is None:
            continue
        if name != "qweight" and (t.dtype != torch.float32
                                  or tuple(t.shape) != (N,)):
            raise ValueError(f"w8a16_matmul: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, expected float32 ({N},)")
        if t.device != qweight.device:
            raise ValueError(f"w8a16_matmul: {name} is on {t.device}, "
                             f"qweight on {qweight.device}")
        if kernel and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"w8a16_matmul: {name} is not contiguous and "
                             f"16-byte aligned")


@functools.lru_cache(maxsize=None)
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("w8a16_matmul", "w8a16_matmul",
                          [i] + [p] * 5 + [i] * 4
                          + [p, ctypes.c_longlong, p, i, p])


def c_plan(M: int, N: int, K: int,
           dtype: torch.dtype = torch.bfloat16) -> tuple:
    """(kernel name, splits, the decode body's warps a tile or 0) that the
    built library plans on the current card (``w8a16_splits``): what
    ``plan`` mirrors. Builds the library; needs a card."""
    v = build.function("w8a16_matmul", "w8a16_splits",
                       [ctypes.c_int] * 4)(_DTYPE_CODE[dtype], M, N, K)
    if v < 0:
        raise ValueError(f"w8a16_matmul refuses M={M} N={N} K={K}")
    return KERNELS[v & 255], (v >> 8) & 255, v >> 16


def c_workspace(M: int, N: int, K: int,
                dtype: torch.dtype = torch.bfloat16) -> tuple:
    """(f32 partials, tile counters) that the built library asks for on the
    current card (``w8a16_workspace``): what ``workspace`` mirrors. Builds
    the library; needs a card."""
    f = build.function("w8a16_matmul", "w8a16_workspace",
                       [ctypes.c_int] * 5, ctypes.c_longlong)
    return tuple(f(_DTYPE_CODE[dtype], M, N, K, c) for c in (0, 1))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# each device's split-K tile counters (int32, zero between launches); a
# buffer outgrown is kept, since a captured graph may still use it
_COUNTERS: dict = {}
_OUTGROWN: list = []


def _counters(device: torch.device, n: int) -> Tensor:
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "w8a16_matmul: the first split-K call on a device (which "
                "allocates its tile counters) ran inside a CUDA graph "
                "capture; call it once before capturing")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


def w8a16_matmul(x: Tensor, qweight: Tensor, qscale: Tensor,
                 bias: Optional[Tensor] = None,
                 out_dtype: torch.dtype = torch.float32) -> Tensor:
    """B12: x [M, K] float32 or bfloat16, qweight [N, K] int8, qscale [N]
    f32, bias [N] f32 or None -> [M, N] ``out_dtype`` (float32 or x.dtype).

    CPU tensors run ``w8a16_matmul_plain``; CUDA tensors launch the kernel
    (K a multiple of 16; every operand contiguous, 16-byte aligned, on x's
    device) or raise. Every operand is checked on every call; a caller that
    holds its weights checked (``QuantLinear``) calls
    ``w8a16_matmul_checked``."""
    if x.device.type != "cpu":
        check_weights(qweight, qscale, bias)
    return w8a16_matmul_checked(x, qweight, qscale, bias, out_dtype)


def w8a16_matmul_checked(x: Tensor, qweight: Tensor, qscale: Tensor,
                         bias: Optional[Tensor] = None,
                         out_dtype: torch.dtype = torch.float32) -> Tensor:
    """``w8a16_matmul`` on weights that already passed ``check_weights``.
    A call checks only what can change between calls: x (on qweight's
    device, float32 or bfloat16, [M, K] with qweight's K, contiguous and
    16-byte aligned), out_dtype, and the dtype of qscale and bias (a
    module's ``.to(dtype)`` casts float buffers)."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, qweight, qscale, bias, out_dtype)
    if (x.device.type != "cuda" or x.device != qweight.device
            or x.dtype not in _DTYPE_CODE
            or out_dtype not in (torch.float32, x.dtype)
            or qscale.dtype != torch.float32
            or (bias is not None and bias.dtype != torch.float32)):
        raise ValueError(f"w8a16_matmul: x {x.dtype} on {x.device}, out "
                         f"{out_dtype}, qweight on {qweight.device}, qscale "
                         f"{qscale.dtype}: unsupported")
    if (x.dim() != 2 or x.shape[1] != qweight.shape[1]
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)} must be a "
                         f"contiguous, 16-byte aligned [M, "
                         f"{qweight.shape[1]}]")
    M, N, K = x.shape[0], qweight.shape[0], x.shape[1]
    out = torch.empty((M, N), device=x.device, dtype=out_dtype)
    n_ws, n_cnt = workspace(M, N, K, x.dtype, _sms(x.device.index))
    ws = (torch.empty(n_ws, device=x.device, dtype=torch.float32)
          if n_ws else None)
    cnt = _counters(x.device, n_cnt) if n_cnt else None
    args = (_DTYPE_CODE[x.dtype], x.data_ptr(), qweight.data_ptr(),
            qscale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.float32), M, N, K,
            0 if ws is None else ws.data_ptr(), n_ws,
            0 if cnt is None else cnt.data_ptr(),
            0 if cnt is None else cnt.numel())
    if x.device.index == torch.cuda.current_device():
        err = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = _kernel()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16_matmul kernel launch failed: cudaError "
                           f"{err}")
    w8a16_matmul.launches += 1
    return out


w8a16_matmul.launches = 0


@contextlib.contextmanager
def uncounted():
    """Leave B12's counts (``w8a16_matmul.launches`` and
    ``kernel_launches``) as they were across the block: a CUDA graph's
    capture records launches that do not run then."""
    saved = (w8a16_matmul.launches,
             {k: c.launches for k, c in kernel_launches.items()})
    try:
        yield
    finally:
        w8a16_matmul.launches = saved[0]
        for k, c in kernel_launches.items():
            c.launches = saved[1][k]
