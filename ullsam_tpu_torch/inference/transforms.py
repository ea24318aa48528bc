"""Longest-side resize geometry for SAM inference: the port's own copy of
``ullsam_tpu/inference/transforms.py`` ``get_preprocess_shape`` and
``ResizeLongestSide.apply_coords`` (that module imports jax)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def get_preprocess_shape(oldh: int, oldw: int, long_side_length: int
                         ) -> Tuple[int, int]:
    """Longest-side resize target with +0.5 rounding."""
    scale = long_side_length * 1.0 / max(oldh, oldw)
    newh, neww = oldh * scale, oldw * scale
    return int(newh + 0.5), int(neww + 0.5)


class ResizeLongestSide:
    """Rescale (x, y) coordinates to an image resized so that its longest
    side is ``target_length``."""

    def __init__(self, target_length: int = 1024):
        self.target_length = target_length

    def apply_coords(self, coords: np.ndarray,
                     original_size: Tuple[int, int]) -> np.ndarray:
        old_h, old_w = original_size
        new_h, new_w = get_preprocess_shape(old_h, old_w, self.target_length)
        coords = np.asarray(coords, np.float32).copy()
        coords[..., 0] = coords[..., 0] * (new_w / old_w)
        coords[..., 1] = coords[..., 1] * (new_h / old_h)
        return coords
