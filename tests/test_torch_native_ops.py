"""The port's native host ops (``ullsam_tpu_torch/native``: its copy of the
C++ built by g++ at first use) against its numpy / scipy versions and the
JAX package's functions (``tests/test_native_ops.py``'s cases, larger).

* RLE counts bitwise equal to the numpy encoder's and to JAX's, and both
  decoders give the masks back bitwise;
* 8-connected components: the same count and labels as scipy's
  ``ndimage.label``, and ``remove_small_regions`` (scipy's labelling)
  bitwise equal to its core through the native labelling and to JAX's;
* the IoU matrix within one float32 ulp of the numpy version (which
  divides in float64 and casts; the C++ divides the exact counts in
  float32) and bitwise equal to the JAX package's native one;
* a failed build warns with g++'s error, the callers fall back to numpy
  and the bindings raise with it; shapes the C++ would read out of bounds
  raise first.
"""

import warnings

import numpy as np
import pytest

from ullsam_tpu.eval import seg_metrics as JM
from ullsam_tpu.inference import amg as JA
from ullsam_tpu.native import host_ops as JH
from ullsam_tpu_torch.eval import seg_metrics as TM
from ullsam_tpu_torch.inference import amg as TA
from ullsam_tpu_torch.native import build, host_ops


def _masks(n, h, w, seed, p=0.6):
    rng = np.random.RandomState(seed)
    m = rng.rand(n, h, w) > p
    m[0] = False           # empty
    m[1] = True            # full
    m[2, 0, 0] = True      # a run that starts at the first pixel
    return m


def test_library_builds():
    assert host_ops.available(), host_ops.load_error()
    assert host_ops.load_error() is None


def test_rle_matches_numpy_and_jax():
    masks = _masks(6, 37, 53, 0)
    native = host_ops.mask_to_rle(masks)
    plain = TA._mask_to_rle_numpy(masks)
    assert native == plain == JA.mask_to_rle(masks)
    assert TA.mask_to_rle(masks) == native
    for b, rle in enumerate(native):
        np.testing.assert_array_equal(host_ops.rle_to_mask(rle), masks[b])
        np.testing.assert_array_equal(TA.rle_to_mask(rle), masks[b])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_components_and_small_regions_match_scipy(seed):
    from scipy import ndimage

    m = _masks(3, 41, 47, seed, p=0.55)[2]
    labels, n = host_ops.connected_components(m)
    ref, ref_n = ndimage.label(m, structure=np.ones((3, 3)))
    assert n == ref_n > 3
    np.testing.assert_array_equal(labels, ref)
    for mode in ("islands", "holes"):
        for thresh in (3, 8, 40):
            a, ca = TA._remove_small_regions(m, thresh, mode,
                                             host_ops.connected_components)
            b, cb = TA.remove_small_regions(m, thresh, mode)
            j, cj = JA.remove_small_regions(m, thresh, mode)
            assert ca == cb == cj
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, j)


def test_iou_within_one_ulp_of_numpy():
    a = _masks(9, 61, 67, 4, p=0.5)
    b = _masks(7, 61, 67, 5, p=0.7)
    native = host_ops.mask_iou_matrix(a, b)
    plain = TM._mask_iou_numpy(a, b)
    assert native.dtype == plain.dtype == np.float32
    ulps = np.abs(native.view(np.int32).astype(np.int64)
                  - plain.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert JH.available()
    np.testing.assert_array_equal(native, JH.mask_iou_matrix(a, b))
    np.testing.assert_array_equal(native, JM.mask_iou_matrix(a, b))
    np.testing.assert_array_equal(TM.mask_iou_matrix(a, b), native)
    assert native[0, 0] == 0.0 and native[1, 1] > 0.0


def test_failed_build_warns_and_falls_back(monkeypatch):
    def broken(verbose=False):
        raise RuntimeError("g++ build of the native host ops failed:\nboom")

    monkeypatch.setattr(build, "build", broken)
    monkeypatch.setattr(host_ops, "_lib", None)
    monkeypatch.setattr(host_ops, "_tried", False)
    monkeypatch.setattr(host_ops, "_error", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not host_ops.available()
        assert not host_ops.available()
    assert len(caught) == 1 and "boom" in str(caught[0].message)
    assert "boom" in host_ops.load_error()
    masks = _masks(3, 9, 11, 6)
    assert TA.mask_to_rle(masks) == TA._mask_to_rle_numpy(masks)
    np.testing.assert_array_equal(TM.mask_iou_matrix(masks, masks),
                                  TM._mask_iou_numpy(masks, masks))
    with pytest.raises(RuntimeError, match="boom"):
        host_ops.mask_to_rle(masks)


def test_bad_shapes_raise_before_the_library_runs():
    """The bindings check what the C++ would read out of bounds."""
    with pytest.raises(ValueError):
        host_ops.mask_iou_matrix(np.zeros((2, 4, 4), bool),
                                 np.zeros((2, 4, 5), bool))
    with pytest.raises(ValueError):
        host_ops.mask_to_rle(np.zeros((4, 4), bool))
    with pytest.raises(ValueError):
        host_ops.connected_components(np.zeros((1, 4, 4), bool))
    with pytest.raises(ValueError):
        host_ops.rle_to_mask({"size": [2, 2], "counts": [1, -1]})
