"""The port's ``SamPredictor`` (``ullsam_tpu_torch/inference/predictor.py``)
against the JAX package's on ``tests/test_amg.py``'s TINY_SAM, from the
same weights: one ``set_image``, then a point, a box, a point with a
low-res mask input, multimask on and off, ``return_logits``, and a second
predictor fed the first one's embedding through ``set_image_embedding``.

Tolerances (float32 on both sides): the image embedding, IoU, low-res and
upscaled logits within 1e-4 (summation order through the encoder and the
decoder); the thresholded masks agree on 99.9% of pixels (a pixel may flip
where an upscaled logit lies within rounding of the threshold)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init, jax_params_to_numpy
from test_torch_amg import JCFG, TCFG

from ullsam_tpu.inference.predictor import SamPredictor as JPredictor
from ullsam_tpu.models.sam import sam as JS
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.inference.predictor import SamPredictor
from ullsam_tpu_torch.models.sam import sam as TS

IMAGE = (np.random.RandomState(1).rand(48, 56, 3) * 255).astype(np.uint8)
ATOL = 1e-4


@pytest.fixture(scope="module")
def predictors():
    p = jax_params_to_numpy(jax_init(JS.sam_init, 0, JCFG),
                            np.random.default_rng(0))
    sam = TS.Sam(TCFG, device="cpu")
    sam.load_state_dict(X.sam_state_dict_from_jax(p, TCFG), strict=True)
    jpred = JPredictor(JCFG, jax.tree_util.tree_map(jnp.asarray, p))
    tpred = SamPredictor(TCFG, sam)
    jpred.set_image(IMAGE)
    tpred.set_image(IMAGE)
    return jpred, tpred


def test_set_image_matches_jax(predictors):
    jpred, tpred = predictors
    assert tpred.input_size == tuple(jpred.input_size) == (55, 64)
    assert tpred.original_size == (48, 56)
    np.testing.assert_allclose(tpred.get_image_embedding().numpy(),
                               np.asarray(jpred.get_image_embedding()),
                               atol=ATOL)


POINT = dict(point_coords=np.asarray([[20, 25]]),
             point_labels=np.asarray([1]))
TWO_POINTS = dict(point_coords=np.asarray([[20, 25], [40, 10]]),
                  point_labels=np.asarray([1, 0]))
BOX = dict(box=np.asarray([5, 5, 40, 40]))


@pytest.mark.parametrize("case", [
    "point", "point_single", "two_points", "box", "box_single",
    "point_box", "point_mask_input", "point_logits", "box_logits"])
def test_predict_matches_jax(predictors, case):
    jpred, tpred = predictors
    kw = {"point": POINT, "point_single": dict(POINT, multimask_output=False),
          "two_points": TWO_POINTS, "box": BOX,
          "box_single": dict(BOX, multimask_output=False),
          "point_box": dict(POINT, **BOX),
          "point_logits": dict(POINT, return_logits=True),
          "box_logits": dict(BOX, return_logits=True,
                             multimask_output=False)}.get(case)
    if case == "point_mask_input":
        _, _, low = jpred.predict(**POINT)
        kw = dict(POINT, mask_input=np.asarray(low)[:, :1],
                  multimask_output=False)
    jm, ji, jl = jpred.predict(**kw)
    tm, ti, tl = tpred.predict(**kw)
    M = 1 if kw.get("multimask_output") is False else 3
    assert tm.shape == np.asarray(jm).shape == (1, M, 48, 56)
    assert ti.shape == (1, M) and tl.shape == (1, M, 32, 32)
    np.testing.assert_allclose(ti, np.asarray(ji), atol=ATOL)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=ATOL)
    if kw.get("return_logits"):
        assert tm.dtype == np.float32
        np.testing.assert_allclose(tm, np.asarray(jm), atol=ATOL)
    else:
        assert tm.dtype == bool
        assert (tm == np.asarray(jm)).mean() >= 0.999


def test_set_image_embedding_and_reset(predictors):
    """A second predictor given the first one's embedding decodes the
    same; ``reset_image`` forgets the image; BGR input is flipped."""
    jpred, tpred = predictors
    other = SamPredictor(TCFG, tpred.sam)
    with pytest.raises(RuntimeError, match="set_image"):
        other.predict(**POINT)
    other.set_image_embedding(tpred.get_image_embedding(), (48, 56),
                              (55, 64))
    jpred2 = JPredictor(JCFG, jpred.params)
    jpred2.set_image_embedding(jpred.get_image_embedding(), (48, 56),
                               (55, 64))
    for kw in (POINT, BOX):
        tm, ti, tl = other.predict(**kw)
        jm, ji, jl = jpred2.predict(**kw)
        np.testing.assert_allclose(ti, np.asarray(ji), atol=ATOL)
        np.testing.assert_allclose(tl, np.asarray(jl), atol=ATOL)
        assert (tm == np.asarray(jm)).mean() >= 0.999
    other.reset_image()
    assert not other.is_image_set and other.features is None
    other.set_image(np.ascontiguousarray(IMAGE[..., ::-1]),
                    image_format="BGR")
    assert torch.equal(other.get_image_embedding(),
                       tpred.get_image_embedding())
