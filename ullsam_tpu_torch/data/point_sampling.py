"""Host-side point synthesis for segmentation training: the port's own
copy of ``ullsam_tpu/data/point_sampling.py`` (whose package imports jax),
numpy and scipy only, so its output is bitwise the JAX package's for the
same mask and ``rng``.

Behavioral reference: MultimodalSegDataset.__getitem__
(train_joint_v2.py:342-460): positive clicks sampled from the 10-iteration
eroded interior (fallback: centroid, then image center); negative clicks
from the 9-11px EDT band outside the instance (fallback: beyond the
10-iteration dilation, then rejection-sampled background).

Runs in data-loader worker processes (scipy is host-only, SURVEY §2.9).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def sample_instance_points(instance_mask: np.ndarray, rng: np.random.Generator,
                           num_pos: int = 1, num_neg: int = 3,
                           boundary_iters: int = 10,
                           band: Tuple[float, float] = (9.0, 11.0)
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """instance_mask [H, W] bool -> (points [P, 2] xy, labels [P])."""
    H, W = instance_mask.shape
    mask = instance_mask.astype(bool)

    eroded = ndimage.binary_erosion(mask, iterations=boundary_iters)
    dilated = ndimage.binary_dilation(mask, iterations=boundary_iters)

    # positives from deep interior; fallback centroid; fallback center
    inner_y, inner_x = np.nonzero(eroded)
    pos = []
    if len(inner_y) > 0:
        if len(inner_y) >= num_pos:
            idx = rng.choice(len(inner_y), num_pos, replace=False)
        else:
            idx = np.arange(num_pos) % len(inner_y)
        pos = [[int(inner_x[i]), int(inner_y[i])] for i in idx]
    else:
        ys, xs = np.nonzero(mask)
        if len(ys) > 0:
            cy, cx = int(ys.mean()), int(xs.mean())
        else:
            cy, cx = H // 2, W // 2
        pos = [[cx, cy]] * num_pos

    # negatives: ~10px-out EDT band (distance from the instance's own
    # boundary ring), outside the instance
    boundary_ring = np.logical_xor(mask, ndimage.binary_erosion(mask))
    dist = ndimage.distance_transform_edt(~boundary_ring)
    band_region = (dist >= band[0]) & (dist <= band[1]) & ~mask
    by, bx = np.nonzero(band_region)
    neg = []
    if len(by) >= num_neg:
        idx = rng.choice(len(by), num_neg, replace=False)
        neg = [[int(bx[i]), int(by[i])] for i in idx]
    else:
        outer = ~dilated & ~mask
        oy, ox = np.nonzero(outer)
        if len(oy) >= num_neg:
            idx = rng.choice(len(oy), num_neg, replace=False)
            neg = [[int(ox[i]), int(oy[i])] for i in idx]
        else:
            while len(neg) < num_neg:
                x = int(rng.integers(0, W))
                y = int(rng.integers(0, H))
                if not mask[y, x]:
                    neg.append([x, y])

    points = np.asarray(pos + neg, np.float32)
    labels = np.asarray([1] * num_pos + [0] * num_neg, np.int32)
    return points, labels
