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
``check_weights`` holds the weight operands to what the kernel takes; the
decode path's ``QuantLinear`` runs it once on its buffers and then calls
``w8a16_matmul_checked``, which checks only x on each call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ullsam_tpu_torch.ops.kernels import build

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def check_weights(qweight: Tensor, qscale: Tensor,
                  bias: Optional[Tensor] = None) -> None:
    """Raise unless the kernel takes these as its weight operands: qweight
    [N, K] int8 with K a multiple of 16, qscale [N] and bias [N] (or None)
    f32, all on qweight's device, each contiguous and 16-byte aligned.
    ``QuantLinear`` runs this once on its buffers, when it is made."""
    if qweight.dim() != 2 or qweight.dtype != torch.int8 or \
            qweight.shape[1] % 16:
        raise ValueError(f"w8a16_matmul: qweight is {qweight.dtype} "
                         f"{tuple(qweight.shape)}; it must be int8 [N, K] "
                         f"with K a multiple of 16")
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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a16_matmul: {name} is not contiguous and "
                             f"16-byte aligned")


@functools.lru_cache(maxsize=None)
def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("w8a16_matmul", "w8a16_matmul",
                          [i] + [p] * 5 + [i] * 4 + [p])


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
    M, N = x.shape[0], qweight.shape[0]
    out = torch.empty((M, N), device=x.device, dtype=out_dtype)
    args = (_DTYPE_CODE[x.dtype], x.data_ptr(), qweight.data_ptr(),
            qscale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.float32), M, N,
            x.shape[1])
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
