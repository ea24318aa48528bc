"""ctypes bindings for the native host ops (``native/csrc/host_ops.cpp``):
COCO RLE encode and decode, 8-connected components and the mask IoU
matrix.

The callers (``inference/amg.py`` ``mask_to_rle``,
``eval/seg_metrics.py`` ``mask_iou_matrix``) take the library whenever
``available()``; otherwise they run their numpy versions, which stay as the
plain reference the tests hold these to. ``remove_small_regions`` labels
through scipy: on the H100 machine's CPU ``connected_components`` measured
slower than ``scipy.ndimage.label`` (PERF.md), so it is held to scipy's
labels but not yet called by the port.
A failed build is not silent: the first ``available()`` warns once with
g++'s error, and ``load_error()`` returns it.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_lib = None
_tried = False
_error: Optional[str] = None


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    try:
        from ullsam_tpu_torch.native.build import build

        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError) as e:
        _error = str(e)
        warnings.warn(f"ullsam_tpu_torch native host ops unavailable, the "
                      f"numpy / scipy versions run instead: {e}",
                      RuntimeWarning, stacklevel=3)
        return None
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rle_encode_masks.restype = i64
    lib.rle_encode_masks.argtypes = [vp, i64, i64, i64, vp, i64, vp]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [vp, i64, i64, i64, vp]
    lib.connected_components.restype = ctypes.c_int32
    lib.connected_components.argtypes = [vp, i64, i64, vp]
    lib.mask_iou_matrix.restype = None
    lib.mask_iou_matrix.argtypes = [vp, i64, vp, i64, i64, vp]
    _lib = lib
    return _lib


def available() -> bool:
    """The library built and loaded (built at the first call)."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library did not load (g++'s output), or None."""
    _load()
    return _error


def _require():
    """The library, or a ``RuntimeError`` naming g++'s error."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host ops unavailable: {_error}")
    return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def mask_to_rle(masks: np.ndarray) -> List[Dict[str, Any]]:
    """[B, H, W] bool / uint8 -> uncompressed COCO RLEs (column-major runs,
    starting with a 0-run)."""
    lib = _require()
    if masks.ndim != 3:
        raise ValueError(f"mask_to_rle: masks [B, H, W], got {masks.shape}")
    B, H, W = masks.shape
    m = np.ascontiguousarray(masks, np.uint8)
    cap = int(B * (H * W + 2))
    counts = np.empty(cap, np.int32)
    lengths = np.empty(B, np.int64)
    total = lib.rle_encode_masks(_ptr(m), B, H, W, _ptr(counts), cap,
                                 _ptr(lengths))
    if total < 0:
        raise RuntimeError("RLE buffer overflow")
    out, off = [], 0
    for b in range(B):
        n = int(lengths[b])
        out.append({"size": [H, W], "counts": counts[off:off + n].tolist()})
        off += n
    return out


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """Uncompressed RLE -> [H, W] bool."""
    lib = _require()
    h, w = rle["size"]
    counts = np.ascontiguousarray(rle["counts"], np.int32)
    if counts.ndim != 1 or (counts < 0).any():
        raise ValueError("rle_to_mask: counts must be non-negative runs")
    out = np.empty((h, w), np.uint8)
    lib.rle_decode(_ptr(counts), len(counts), h, w, _ptr(out))
    return out.astype(bool)


def connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """8-connected labelling of [H, W] -> (labels int32 [H, W], 0 the
    background and components 1..n in the raster order of their first
    pixel, n)."""
    lib = _require()
    if mask.ndim != 2:
        raise ValueError(f"connected_components: mask [H, W], got "
                         f"{mask.shape}")
    m = np.ascontiguousarray(mask, np.uint8)
    H, W = m.shape
    labels = np.empty((H, W), np.int32)
    n = lib.connected_components(_ptr(m), H, W, _ptr(labels))
    return labels, int(n)


def mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU [N, M] float32 between [N, H, W] and [M, H, W] masks:
    exact integer counts on bit-packed rows, divided in float32."""
    lib = _require()
    if a.shape[1:] != b.shape[1:]:
        raise ValueError(f"mask_iou_matrix: masks of {a.shape[1:]} against "
                         f"{b.shape[1:]}")
    N, M = a.shape[0], b.shape[0]
    au = np.ascontiguousarray(a.reshape(N, -1), np.uint8)
    bu = np.ascontiguousarray(b.reshape(M, -1), np.uint8)
    out = np.empty((N, M), np.float32)
    lib.mask_iou_matrix(_ptr(au), N, _ptr(bu), M, au.shape[1], _ptr(out))
    return out
