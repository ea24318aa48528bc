"""Host-side image geometry: the port's own copy of
``ullsam_tpu/inference/transforms.py`` (that module imports jax):
``get_preprocess_shape`` and ``ResizeLongestSide.apply_coords`` for SAM
inference, and the serving app's ``pad_to_square`` / ``reverse_padding``
/ ``normalize01`` (``:96-121``)."""

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


def pad_to_square(image: np.ndarray, fill: int = 0):
    """Center pad to square (app.py:111-143). Returns (padded, pad_info)
    where pad_info = (top, bottom, left, right) for reverse_padding."""
    h, w = image.shape[:2]
    size = max(h, w)
    top = (size - h) // 2
    bottom = size - h - top
    left = (size - w) // 2
    right = size - w - left
    pad_width = [(top, bottom), (left, right)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pad_width, constant_values=fill), (top, bottom,
                                                            left, right)


def reverse_padding(image: np.ndarray, pad_info) -> np.ndarray:
    """Undo pad_to_square (app.py:145-161)."""
    top, bottom, left, right = pad_info
    h, w = image.shape[:2]
    return image[top:h - bottom if bottom else h,
                 left:w - right if right else w]


def normalize01(image: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [0, 1] (the uLLSAM serving path feeds
    [0, 1] tensors, Normalize(mean=0, std=1), app.py:242-249)."""
    return np.asarray(image, np.float32) / 255.0
