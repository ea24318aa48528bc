"""Bilinear resize as two interpolation matmuls (``ullsam_tpu/ops/resize.py``).

Half-pixel centres, no antialias: the same values as
``F.interpolate(mode="bilinear", align_corners=False)``. A chain of resizes
and crops (the SAM postprocess) folds into one matrix per axis. The
matrices are built on the input's device, so no host-to-device copy stalls
the stream.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _bilinear_matrix(out_size: int, in_size: int, device) -> Tensor:
    """[out, in] row-stochastic interpolation matrix (f32)."""
    if out_size == in_size:
        return torch.eye(out_size, device=device)
    src = (torch.arange(out_size, dtype=torch.float64, device=device)
           + 0.5) * (in_size / out_size) - 0.5
    src = src.clamp(0.0, in_size - 1)
    lo = src.floor().long()
    hi = (lo + 1).clamp(max=in_size - 1)
    w = (src - lo).float()
    rows = torch.arange(out_size, device=device)
    m = torch.zeros((out_size, in_size), device=device)
    m.index_put_((rows, lo), 1.0 - w, accumulate=True)
    m.index_put_((rows, hi), w, accumulate=True)
    return m


def sam_postprocess_matrix(low: int, model_size: int, input_size: int,
                           out: int, device) -> Tensor:
    """[out, low]: resize low -> model_size, crop :input_size, resize
    input_size -> out (one axis of the SAM postprocess)."""
    m1 = _bilinear_matrix(model_size, low, device)[:input_size, :]
    return _bilinear_matrix(out, input_size, device) @ m1


def resize2d(x: Tensor, mat_h: Tensor, mat_w: Tensor) -> Tensor:
    """x [..., H, W] -> f32 [..., H2, W2] with precomputed matrices."""
    return torch.matmul(torch.matmul(mat_h, x.float()), mat_w.T)


def bilinear_resize(x: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bilinear resize of the last two axes (f32 result)."""
    return resize2d(x, _bilinear_matrix(out_h, x.shape[-2], x.device),
                    _bilinear_matrix(out_w, x.shape[-1], x.device))


def sam_postprocess_resize(masks: Tensor, model_size: int,
                           input_hw: Tuple[int, int],
                           out_hw: Tuple[int, int]) -> Tensor:
    """The fused SAM postprocess chain on [..., low, low] logits."""
    mh = sam_postprocess_matrix(masks.shape[-2], model_size, input_hw[0],
                                out_hw[0], masks.device)
    mw = sam_postprocess_matrix(masks.shape[-1], model_size, input_hw[1],
                                out_hw[1], masks.device)
    return resize2d(masks, mh, mw)


def bilinear_resize_nhwc(x: Tensor, out_h: int, out_w: int) -> Tensor:
    """[B, H, W, C] -> f32 [B, out_h, out_w, C] bilinear (torch semantics),
    rows first, as ``ullsam_tpu/ops/resize.py`` ``bilinear_resize_nhwc``."""
    x = x.float()
    if (out_h, out_w) == (x.shape[1], x.shape[2]):
        return x
    mh = _bilinear_matrix(out_h, x.shape[1], x.device)
    mw = _bilinear_matrix(out_w, x.shape[2], x.device)
    y = torch.einsum("ih,bhwc->biwc", mh, x)
    return torch.einsum("jw,biwc->bijc", mw, y)
