"""Core NN building blocks: plain functions on tensors plus thin modules.

Mirrors ``ullsam_tpu/ops/layers.py`` (the numerics), in PyTorch idiom:

  * Linear weights are stored PyTorch-style ``[out, in]``; convolution
    weights OIHW. Activations at the public boundaries stay NHWC, as in the
    JAX package, so a conv permutes to NCHW and back around ``F.conv2d``.
  * Every matmul computes in the activation dtype with f32 accumulation
    (what ``preferred_element_type=f32`` followed by a cast does in JAX).
  * Norm statistics are f32. LayerNorm is one-pass (E[x], E[x^2]) from 32
    channels up and two-pass below, exactly as ``layers.py:164-183``.
  * GELU is the exact erf form in f32 and the tanh form in bf16
    (``layers.py:241-253``); ``nn.GELU()`` alone would be erf in both.
  * A weight-only int8 linear (``QuantLinear``) runs kernel B12 on the card
    (``layers.py:51-81``).

The modules only hold parameters under the reference checkpoint names
(``weight``/``bias``) and call the functions; ``init_`` fills them from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels.int8_matmul import (check_weights,
                                                      w8a16_matmul_checked)

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def linear(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """x @ weight.T + bias in x.dtype (weight ``[out, in]``)."""
    dt = x.dtype
    return F.linear(x, weight.to(dt), None if bias is None else bias.to(dt))


def conv2d(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None, *,
           stride: int = 1, padding: int = 0) -> Tensor:
    """NHWC conv with an OIHW weight (``layers.py:114-131``)."""
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(dt),
                 None if bias is None else bias.to(dt),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def layer_norm(x: Tensor, weight: Tensor, bias: Tensor, *,
               eps: float = 1e-6) -> Tensor:
    """LayerNorm over the last axis, f32 statistics, cast back."""
    x32 = x.float()
    m1 = x32.mean(-1, keepdim=True)
    if x.shape[-1] >= 32:
        m2 = (x32 * x32).mean(-1, keepdim=True)
        var = (m2 - m1 * m1).clamp_min(0.0)
    else:
        # two-pass for tiny channel counts (cancellation in E[x^2]-E[x]^2)
        var = ((x32 - m1) ** 2).mean(-1, keepdim=True)
    y = (x32 - m1) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def layer_norm_noparam(x: Tensor, *, eps: float = 1e-5) -> Tensor:
    """LayerNorm without affine params, one-pass f32 (``layers.py:186-192``)."""
    x32 = x.float()
    m1 = x32.mean(-1, keepdim=True)
    m2 = (x32 * x32).mean(-1, keepdim=True)
    var = (m2 - m1 * m1).clamp_min(0.0)
    return ((x32 - m1) * torch.rsqrt(var + eps)).to(x.dtype)


def rms_norm(x: Tensor, weight: Tensor, *, eps: float = 1e-5) -> Tensor:
    """RMSNorm in f32, cast back (``layers.py:204-233``)."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def gelu(x: Tensor) -> Tensor:
    """Exact erf GELU, except the tanh form for bfloat16 inputs."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def mlp_block(x: Tensor, fc1_w: Tensor, fc1_b: Optional[Tensor],
              fc2_w: Tensor, fc2_b: Optional[Tensor], act=gelu) -> Tensor:
    """Linear -> act -> Linear (SAM MLPBlock)."""
    return linear(act(linear(x, fc1_w, fc1_b)), fc2_w, fc2_b)


def linear_int8(x: Tensor, qweight: Tensor, qscale: Tensor,
                bias: Optional[Tensor] = None) -> Tensor:
    """Weight-only int8 linear (``layers.py:51-81``): x [..., in] @ int8
    qweight [out, in] summed in f32, times the per-output-channel f32
    qscale, plus the bias in f32, cast to x.dtype. Kernel B12 on a CUDA
    tensor (it fuses the scale, bias and cast), its plain version on a CPU
    tensor (``ops/kernels/int8_matmul.py``). CUDA weights must have passed
    ``check_weights`` (``QuantLinear`` checks its CUDA buffers once); x is
    checked on each call."""
    x2 = build.aligned(x.reshape(-1, x.shape[-1]))
    y = w8a16_matmul_checked(x2, qweight, qscale,
                             None if bias is None else bias.float(),
                             out_dtype=x.dtype)
    return y.reshape(x.shape[:-1] + (qweight.shape[0],))


def embedding(ids: Tensor, table: Tensor) -> Tensor:
    return F.embedding(ids, table)


# ---------------------------------------------------------------------------
# parameter modules
# ---------------------------------------------------------------------------


def _uniform_(p: Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        p.uniform_(-bound, bound, generator=gen)


class Linear(nn.Module):
    """``[out, in]`` weight and optional bias; torch's default init bounds."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim, **kw))
        self.bias = (nn.Parameter(torch.empty(out_dim, **kw)) if bias
                     else None)

    def init_(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, gen)
        if self.bias is not None:
            _uniform_(self.bias, bound, gen)

    def forward(self, x: Tensor) -> Tensor:
        return linear(x, self.weight, self.bias)


class QuantLinear(nn.Module):
    """Weight-only int8 linear (W8A16): int8 ``qweight`` [out, in], f32
    ``qscale`` [out] and the optional ``bias`` (kept in f32, exact), all
    buffers: a quantized module is inference-only and has no parameters to
    train. Made by ``models/internlm2/quant.py`` ``quantize_linear``. Types
    and shapes are checked when it is made; what B12 alone needs (K a
    multiple of 16, aligned buffers) only for buffers on a CUDA device: when
    it is made there, or on its first CUDA call after a ``.to()``, and not
    again on each call. On the CPU any width runs (the plain version)."""

    def __init__(self, qweight: Tensor, qscale: Tensor,
                 bias: Optional[Tensor] = None):
        super().__init__()
        bias = None if bias is None else bias.float().contiguous()
        on_card = qweight.device.type == "cuda"
        check_weights(qweight, qscale, bias, kernel=on_card)
        self.register_buffer("qweight", qweight)
        self.register_buffer("qscale", qscale)
        self.register_buffer("bias", bias)
        self._kernel_checked = on_card

    def _apply(self, fn, *args, **kwargs):
        # .to() / .cuda() may move or replace the buffers: check them again
        # on the next CUDA call
        out = super()._apply(fn, *args, **kwargs)
        self._kernel_checked = False
        return out

    def forward(self, x: Tensor) -> Tensor:
        if not self._kernel_checked and self.qweight.device.type == "cuda":
            check_weights(self.qweight, self.qscale, self.bias)
            self._kernel_checked = True
        return linear_int8(x, self.qweight, self.qscale, self.bias)


class Conv2d(nn.Module):
    """OIHW weight on NHWC activations."""

    def __init__(self, in_ch: int, out_ch: int, k: int, bias: bool = True, *,
                 stride: int = 1, padding: int = 0, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, k, k, **kw))
        self.bias = nn.Parameter(torch.empty(out_ch, **kw)) if bias else None
        self.stride, self.padding = stride, padding

    def init_(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, gen)
        if self.bias is not None:
            _uniform_(self.bias, bound, gen)

    def forward(self, x: Tensor) -> Tensor:
        return conv2d(x, self.weight, self.bias, stride=self.stride,
                      padding=self.padding)


class ConvTranspose2x2(nn.Module):
    """Transposed conv with kernel == stride == 2 (SAM output upscaling);
    weight ``[in, out, 2, 2]`` as torch's ConvTranspose2d stores it. With no
    output overlap it is one per-pixel matmul plus a 2x2 block expand."""

    def __init__(self, in_ch: int, out_ch: int, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 2, 2, **kw))
        self.bias = nn.Parameter(torch.empty(out_ch, **kw))

    def init_(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1] * 4)
        _uniform_(self.weight, bound, gen)
        _uniform_(self.bias, bound, gen)

    def forward_f32(self, x: Tensor) -> Tensor:
        """NHWC x -> f32 [B, 2H, 2W, out] (products in x.dtype, f32 sums)."""
        B, H, W, _ = x.shape
        w = self.weight.to(x.dtype).float()
        y = torch.einsum("bhwc,cokl->bhkwlo", x.float(), w)
        y = y.reshape(B, 2 * H, 2 * W, w.shape[1])
        return y + self.bias.to(x.dtype).float()


class Embedding(nn.Module):
    """A ``[num, dim]`` table under the name ``weight``, normal init."""

    def __init__(self, num: int, dim: int, std: float = 1.0, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim, device=device,
                                               dtype=dtype))
        self.std = std

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, self.std, generator=gen)

    def forward(self, ids: Tensor) -> Tensor:
        return embedding(ids, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(dim, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return rms_norm(x, self.weight, eps=self.eps)


class MLPBlock(nn.Module):
    """SAM MLPBlock: ``lin1`` -> act -> ``lin2``."""

    def __init__(self, dim: int, hidden: int, act=gelu, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.lin1 = Linear(dim, hidden, **kw)
        self.lin2 = Linear(hidden, dim, **kw)
        self.act = act

    def forward(self, x: Tensor) -> Tensor:
        return mlp_block(x, self.lin1.weight, self.lin1.bias,
                         self.lin2.weight, self.lin2.bias, act=self.act)


class MLPStack(nn.Module):
    """N-layer ReLU MLP (SAM hypernetwork / IoU head): ``layers.{j}``."""

    def __init__(self, dims: Sequence[int], *, device=None, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], device=device, dtype=dtype)
            for i in range(len(dims) - 1))

    def forward(self, x: Tensor) -> Tensor:
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def init_module_(module: nn.Module, gen: torch.Generator) -> None:
    """Run ``init_`` on every submodule that defines one. Each ``init_``
    fills only the module's own direct parameters, so order is free."""
    for m in module.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
