"""The port's multi-crop automatic mask generation
(``ullsam_tpu_torch/inference/amg.py``, ``crop_n_layers`` > 0) against the
JAX package's generator on ``tests/test_amg.py``'s TINY_SAM, from the same
weights, f32 on the CPU, on both crop paths: the device one (each crop its
own sweep, one cross-crop NMS and placement on the device; one layer of
equal crops, and two layers with unequal edge crops) and the host stitch
(``device_multicrop=False``).

The cases are those of ``tests/test_amg.py``: one layer at box NMS 0.9 and
the default cross-crop NMS 0.7 on a 96x96 image; two layers with both
NMS off (``crop_nms_thresh=1.0``, so every valid candidate is kept and no
tie order is in question) on an 80x72 image.

Tolerances: the committed sets are matched row by row after a lexsort on
(source crop, iou, stability); iou and stability within 1e-5 (summation
order through the encoder and the decoder); boxes within 1e-3 pixels. A
pixel may flip where an upscaled logit lies within rounding of the
threshold (both sides upscale in bf16, as the reference does), so against
JAX the areas agree to 0.5% + 1 pixel and the placed full-frame masks on
99.9% of pixels, as in ``tests/test_torch_amg.py``; the port's device path
against its own host path (the same per-crop sweeps) is held exactly:
areas equal, masks equal pixel for pixel."""

import jax
import numpy as np
import pytest

from torch_port_helpers import jax_init
from test_torch_amg import JCFG, TCFG, _decode_coco

from ullsam_tpu.inference import amg as JA
from ullsam_tpu.models.sam import sam as JS
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.inference import amg as TA
from ullsam_tpu_torch.models.sam import sam as TS

CASES = {
    1: dict(seed=3, hw=(96, 96),
            kw=dict(points_per_side=4, crop_n_layers=1, pred_iou_thresh=0.0,
                    stability_score_thresh=0.0, box_nms_thresh=0.9,
                    max_masks=24, points_per_batch=8)),
    2: dict(seed=5, hw=(80, 72),
            kw=dict(points_per_side=2, crop_n_layers=2, pred_iou_thresh=0.0,
                    stability_score_thresh=0.0, box_nms_thresh=1.0,
                    crop_nms_thresh=1.0, max_masks=256, points_per_batch=4)),
}


def _setup(layers):
    case = CASES[layers]
    p = jax_init(JS.sam_init, case["seed"], JCFG)
    sam = TS.Sam(TCFG, device="cpu")
    sam.load_state_dict(X.sam_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, p), TCFG), strict=True)
    img = (np.random.RandomState(case["seed"]).rand(*case["hw"], 3)
           * 255).astype(np.uint8)
    return p, sam.eval(), img, case["kw"]


@pytest.fixture(scope="module", params=[1, 2], ids=["layer1", "layer2"])
def runs(request):
    """generate_dense of JAX and the port, device and host paths."""
    p, sam, img, kw = _setup(request.param)
    out = {"img": img, "kw": kw, "sam": sam, "p": p}
    for path, dev in (("device", True), ("host", False)):
        jm, jd = JA.AutomaticMaskGenerator(
            JCFG, p, device_multicrop=dev, **kw).generate_dense(img)
        out["jax", path] = (np.asarray(jm), jd)
        tm, td = TA.AutomaticMaskGenerator(
            TCFG, sam, device_multicrop=dev, **kw).generate_dense(img)
        out["port", path] = (tm.numpy(), td)
    return out


def _order(d):
    crop = (d["report_crop_boxes"] if "report_crop_boxes" in d
            else d["crop_boxes"])
    return np.lexsort((d["stability"], d["iou_preds"], *crop.T[::-1]))


def _assert_same(a, b, exact=False):
    (ma, da), (mb, db) = a, b
    assert len(da["iou_preds"]) == len(db["iou_preds"]) > 0
    assert ma.shape == mb.shape == (len(ma), *ma.shape[1:])
    oa, ob = _order(da), _order(db)
    np.testing.assert_allclose(da["iou_preds"][oa], db["iou_preds"][ob],
                               atol=1e-5)
    np.testing.assert_allclose(da["stability"][oa], db["stability"][ob],
                               atol=1e-5)
    np.testing.assert_allclose(da["boxes"][oa], db["boxes"][ob], atol=1e-3)
    if exact:
        np.testing.assert_array_equal(da["areas"][oa], db["areas"][ob])
        np.testing.assert_array_equal(ma[oa], mb[ob])
    else:
        ref = db["areas"][ob]
        assert (np.abs(da["areas"][oa] - ref) <= 0.005 * ref + 1).all()
        assert (ma[oa] == mb[ob]).mean() >= 0.999
    return oa, ob


@pytest.mark.parametrize("path", ["device", "host"])
def test_multicrop_matches_jax(runs, path):
    oa, ob = _assert_same(runs["port", path], runs["jax", path])
    (_, td), (_, jd) = runs["port", path], runs["jax", path]
    h, w = runs["img"].shape[:2]
    assert runs["port", path][0].shape[1:] == (h, w)
    if path == "device":
        np.testing.assert_array_equal(td["report_crop_boxes"][oa],
                                      jd["report_crop_boxes"][ob])
    else:
        np.testing.assert_array_equal(td["crop_index"][oa],
                                      jd["crop_index"][ob])
        np.testing.assert_allclose(td["points"][oa], jd["points"][ob],
                                   atol=1e-4)


def test_device_path_matches_host_path(runs):
    """The port's device path against its own host stitch
    (``test_device_multicrop_layer2_matches_host_path`` on the port); at
    one layer the cross-crop NMS is on, so the two paths' suppressions are
    compared through JAX's instead."""
    if runs["kw"]["crop_n_layers"] == 2:
        _assert_same(runs["port", "device"], runs["port", "host"],
                     exact=True)
        assert len(runs["port", "device"][1]["iou_preds"]) > 20
    masks, data = runs["port", "device"]
    # every mask lies inside its source crop, and its area is its pixels
    for i in range(len(masks)):
        x0, y0, x1, y1 = data["report_crop_boxes"][i].astype(int)
        outside = masks[i].copy()
        outside[y0:y1, x0:x1] = False
        assert not outside.any(), i
    np.testing.assert_array_equal(data["areas"], masks.sum((1, 2)))


@pytest.mark.parametrize("mode", ["binary_mask", "uncompressed_rle",
                                  "coco_rle"])
def test_generate_records_with_crops(runs, mode):
    """``generate()`` of the port against JAX's on the device path: the
    same records (matched by source crop, then iou), each with its source
    ``crop_box``."""
    img, kw = runs["img"], runs["kw"]
    jr = JA.AutomaticMaskGenerator(JCFG, runs["p"], output_mode=mode,
                                   **kw).generate(img)
    tr = TA.AutomaticMaskGenerator(TCFG, runs["sam"], output_mode=mode,
                                   **kw).generate(img)
    assert len(tr) == len(jr) > 0

    def key(r):
        return (r["crop_box"], r["predicted_iou"])

    h, w = img.shape[:2]
    for t, r in zip(sorted(tr, key=key), sorted(jr, key=key)):
        assert abs(t["area"] - r["area"]) <= 0.005 * r["area"] + 1
        assert t["crop_box"] == r["crop_box"]
        np.testing.assert_allclose(t["bbox"], r["bbox"], atol=1)
        assert t["predicted_iou"] == pytest.approx(r["predicted_iou"],
                                                   abs=1e-5)
        if mode == "binary_mask":
            seg_t, seg_r = t["segmentation"], r["segmentation"]
        else:
            seg_t, seg_r = (TA.rle_to_mask(
                s if mode == "uncompressed_rle" else
                {"size": s["size"], "counts": _decode_coco(s["counts"])})
                for s in (t["segmentation"], r["segmentation"]))
        assert seg_t.shape == (h, w)
        assert (seg_t == seg_r).mean() >= 0.999
    # every record's crop is one of the pyramid's
    boxes, _ = TA.generate_crop_boxes((h, w), kw["crop_n_layers"],
                                      512 / 1500)
    allowed = {(b[0], b[1], b[2] - b[0], b[3] - b[1]) for b in boxes}
    assert {tuple(r["crop_box"]) for r in tr} <= allowed


def test_generate_dense_batch_with_crops(runs):
    """With crops the batch API returns each image's ``generate_dense``."""
    gen = TA.AutomaticMaskGenerator(TCFG, runs["sam"], **runs["kw"])
    (bm, bd), = gen.generate_dense_batch([runs["img"]])
    m, d = runs["port", "device"]
    np.testing.assert_array_equal(bm.numpy(), m)
    np.testing.assert_array_equal(bd["iou_preds"], d["iou_preds"])
