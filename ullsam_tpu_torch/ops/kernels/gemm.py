"""The products of B1 (qkv, proj) and B13 (fc1, fc2) on the card.

``gemm_bf16(a, w, bias, res, act)`` and ``gemm_f32`` (the same arguments
in float32) compute

    out = act(a @ w.T + bias + res)

for a [M, K], w [N, K] (the natural [out, in] weight), bias [N] and res
[M, N] (either may be None), with the sums in f32 and out rounded to the
dtype once; ``act`` is "none" or "gelu_tanh" (the tanh GELU in f32 of the
sum first rounded to the dtype, B13's fc1). B1 and B13 launch these
products inside their own C entry points; these wrappers run one alone,
at the same choice of kernel, for the tests and the chip checks.

Hand-written kernels compute it (``csrc/gemm_sm90.cuh`` ``gemm_bf16`` and
``gemm_f32`` choose by shape, mirrored by ``gemm_kernel`` here):

* ``gemm_sm90``: wgmma fed by TMA, for N % 128 == 0 and K % 64 == 0 (any
  M) with 16-byte aligned operands and output: every product of SAM
  ViT-B, L and H;
* ``gemm_sm90_f32``: the same kernel's float32 kind at those shapes, in
  split TF32 (three TF32 products for each, f32-accurate);
* ``gemm_mma``: ``csrc/gemm.cuh``'s bf16 mma.sync kernel, for the other
  shapes (K % 32 == 0, N % 8 == 0), and for B4-B7's and B12's products;
* ``gemm_fma``: ``csrc/gemm.cuh``'s float32 FMA kernel, for the other
  float32 shapes (K % 8 == 0), and for B4-B7's float32 products at the
  shapes the f32 kind does not take.

Each kernel's launches are counted in C where it launches (one count per
loaded library, read through ``gemm_launch_count``); ``gemm_sm90.launches``
and the others sum them over the loaded libraries (``gemm_sm90_f32`` and
``gemm_fma`` over B1's and B13's) and can be set to 0 like a wrapper's
count. On a CPU tensor the
wrappers run ``gemm_plain``; on a CUDA tensor they launch a kernel or
raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ullsam_tpu_torch.ops.kernels import build

Tensor = torch.Tensor

SM90_BM, SM90_BN, SM90_BK, SM90_STAGES = 128, 128, 64, 5
SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
_ACTS = {"none": 0, "gelu_tanh": 2}
# the libraries whose sources include csrc/gemm.cuh (and so count launches)
GEMM_LIBS = ("window_attn", "ln_mlp", "decoder_twt", "w8a16_matmul")


def sm90_takes(M: int, N: int, K: int) -> bool:
    """``gemm_sm90.cuh`` ``sm90_takes``: the shapes of the wgmma kernel."""
    return (M >= 1 and N >= SM90_BN and N % SM90_BN == 0 and K >= SM90_BK
            and K % SM90_BK == 0)


def gemm_kernel(M: int, N: int, K: int,
                dtype: torch.dtype = torch.bfloat16) -> str:
    """Which kernel ``gemm_bf16`` (``gemm_f32`` for float32) launches for
    16-byte aligned operands."""
    if dtype == torch.float32:
        return "gemm_sm90_f32" if sm90_takes(M, N, K) else "gemm_fma"
    return "gemm_sm90" if sm90_takes(M, N, K) else "gemm_mma"


def sm90_smem_bytes() -> int:
    """``kSm90SmemBytes``: the stages (A and W tiles of 128 x 64 bf16), 1024
    bytes to align them, the 8 consumer warps' epilogue staging (8 rows of
    128 + 8 floats each), a full and an empty mbarrier a stage and the two
    consumer warpgroups' turn mbarriers."""
    return (1024 + SM90_STAGES * (SM90_BM + SM90_BN) * SM90_BK * 2
            + 8 * 8 * (SM90_BN + 8) * 4 + (2 * SM90_STAGES + 2) * 8)


SM90_F32_BK, SM90_F32_STAGES = 32, 3


def sm90_f32_smem_bytes() -> int:
    """``Sm90Layout<kSm90F32>::kSmemBytes``: the stages (A's and W's tiles
    of 128 x 32 f32 as TMA lands them, and W's lo plane), 1024 bytes to
    align them, the epilogue staging and mbarriers as the bf16 kind's."""
    return (1024 + SM90_F32_STAGES * (SM90_BM + 2 * SM90_BN) * SM90_F32_BK * 4
            + 8 * 8 * (SM90_BN + 8) * 4 + (2 * SM90_F32_STAGES + 2) * 8)


class GemmLaunches:
    """The launch count of one kernel, kept in C (read by the entry point
    ``fn``, with ``kernel`` as its one argument unless it is None) by every
    loaded library of ``libs`` that launches it; reading it builds
    nothing."""

    def __init__(self, kernel: Optional[int], libs=GEMM_LIBS,
                 fn: str = "gemm_launch_count"):
        self._kernel = kernel
        self._libs = libs
        self._fn = fn
        self._base = 0

    def _total(self) -> int:
        if self._kernel is None:
            return sum(build.function(lib, self._fn, [],
                                      ctypes.c_longlong)()
                       for lib in self._libs if build.loaded(lib))
        return sum(build.function(lib, self._fn, [ctypes.c_int],
                                  ctypes.c_longlong)(self._kernel)
                   for lib in self._libs if build.loaded(lib))

    @property
    def launches(self) -> int:
        return self._total() - self._base

    @launches.setter
    def launches(self, value: int) -> None:
        self._base = self._total() - value


gemm_mma = GemmLaunches(0)
gemm_sm90 = GemmLaunches(1)
# the f32 kind's launches by B1 and B13 (B4-B7's float32 token-side products
# launch it too, counted apart: ``decoder.decoder_gemm_f32``)
gemm_sm90_f32 = GemmLaunches(2, ("window_attn", "ln_mlp"))
# the FMA kernel's launches by B1 and B13 (B4-B7's float32 products launch
# it too, from their own libraries)
gemm_fma = GemmLaunches(3, ("window_attn", "ln_mlp"))


def gemm_plain(a: Tensor, w: Tensor, bias: Optional[Tensor] = None,
               res: Optional[Tensor] = None, act: str = "none",
               mm=torch.matmul) -> Tensor:
    """The kernels' function in plain PyTorch: f32 products and sums,
    bias and res added in f32, the GELU of the sum rounded to a.dtype,
    out rounded to a.dtype once. ``mm`` takes the product
    (``tf32.mm_3xtf32``: the float32 kernel's split TF32); float64 inputs
    compute in float64."""
    dt = a.dtype
    f = (lambda t: t) if dt == torch.float64 else (lambda t: t.float())
    out = mm(f(a), f(w).T)
    if bias is not None:
        out = out + f(bias)
    if res is not None:
        out = out + f(res)
    if act == "gelu_tanh":
        x = f(out.to(dt))
        inner = 0.7978845608028654 * (x + 0.044715 * (x * x * x))
        out = 0.5 * x * (1.0 + torch.tanh(inner))
    return out.to(dt)



def _gemm(name: str, entry: str, dtype: torch.dtype, a: Tensor, w: Tensor,
          bias: Optional[Tensor], res: Optional[Tensor], act: str) -> Tensor:
    if act not in _ACTS:
        raise ValueError(f"{name}: unsupported act {act!r}")
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, res, act)
    M, K = a.shape
    N = w.shape[0]
    if a.device.type != "cuda" or a.dtype != dtype:
        raise ValueError(f"{name}: unsupported {a.dtype} on {a.device}")
    if (K % 32 or N % 8) if dtype == torch.bfloat16 else (K % 8 or N < 1):
        raise ValueError(f"{name}: unsupported shape M={M} N={N} K={K}")
    if M == 0:
        raise ValueError(f"{name}: unsupported shape M={M} N={N} K={K}")
    for t, what, shape in ((a, "a", (M, K)), (w, "w", (N, K)),
                           (bias, "bias", (N,)), (res, "res", (M, N))):
        if t is None:
            continue
        if t.device != a.device or t.dtype != a.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)},"
                             f" expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not contiguous and "
                             f"16-byte aligned")
    out = torch.empty((M, N), device=a.device, dtype=a.dtype)
    p = ctypes.c_void_p
    fn = build.function("ln_mlp", entry, [p] * 5 + [ctypes.c_int] * 4 + [p])
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 None if res is None else res.data_ptr(), out.data_ptr(),
                 M, N, K, _ACTS[act], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return out


def gemm_bf16(a: Tensor, w: Tensor, bias: Optional[Tensor] = None,
              res: Optional[Tensor] = None, act: str = "none") -> Tensor:
    """a [M, K], w [N, K], bias [N], res [M, N], all bfloat16 -> [M, N].
    CPU tensors run ``gemm_plain``; CUDA tensors launch the kernel
    ``gemm_kernel`` names (K % 32 == 0 and N % 8 == 0) or raise."""
    return _gemm("gemm_bf16", "gemm_bf16_forward", torch.bfloat16, a, w,
                 bias, res, act)


def gemm_f32(a: Tensor, w: Tensor, bias: Optional[Tensor] = None,
             res: Optional[Tensor] = None, act: str = "none") -> Tensor:
    """``gemm_bf16``'s function in float32 (every tensor float32; the GELU
    of the unrounded sum). CPU tensors run ``gemm_plain``; CUDA tensors
    launch the kernel ``gemm_kernel(.., torch.float32)`` names (K % 8 ==
    0) or raise."""
    return _gemm("gemm_f32", "gemm_f32_forward", torch.float32, a, w, bias,
                 res, act)
