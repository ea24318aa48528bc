"""The port's automatic mask generation (``ullsam_tpu_torch/inference``)
against the JAX package: the host helpers against the ``amg_primitives``
golden, the weight conversion of a standalone SAM, and the single-crop
generator end to end on the CPU from the same weights.

Tolerances of the whole-slice parity (float32 on both sides): predicted
IoU and stability 1e-4 (summation order through the encoder and decoder);
a mask pixel may flip where an upscaled logit lies within rounding of the
threshold (both upscale in bf16, as the reference does), so areas agree to
0.5% and boxes to 1 pixel, and dense masks to 99.9% of pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init, jax_params_to_numpy

from ullsam_tpu.convert.torch_sam import convert_sam_state_dict
from ullsam_tpu.core import config as JC
from ullsam_tpu.inference import amg as JA
from ullsam_tpu.models.sam import mask_decoder as JMD
from ullsam_tpu.models.sam import sam as JS
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.inference import amg as TA
from ullsam_tpu_torch.models.sam import sam as TS


def tiny_sam(C):
    """``tests/test_amg.py``'s TINY_SAM in config module ``C``."""
    return C.SamConfig(
        vit=C.ViTConfig(img_size=64, patch_size=8, embed_dim=16, depth=2,
                        num_heads=2, mlp_ratio=2.0, out_chans=16,
                        window_size=2, global_attn_indexes=(1,)),
        prompt_encoder=C.PromptEncoderConfig(
            embed_dim=16, image_embedding_size=(8, 8),
            input_image_size=(64, 64), mask_in_chans=8),
        mask_decoder=C.MaskDecoderConfig(
            transformer_dim=16, transformer_mlp_dim=32,
            transformer_num_heads=2, iou_head_hidden_dim=8))


JCFG, TCFG = tiny_sam(JC), tiny_sam(TC)


def _decode_coco(counts_str):
    """The LEB128 delta coding of ``coco_encode_rle`` decoded back."""
    counts, s, k = [], counts_str.encode("ascii"), 0
    while k < len(s):
        x, shift = 0, 0
        while True:
            c = s[k] - 48
            x |= (c & 0x1F) << shift
            k += 1
            if not c & 0x20:
                if c & 0x10:
                    x |= -1 << (shift + 5)
                break
            shift += 5
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


@pytest.mark.parametrize("case", [
    "stability", "mask_to_box", "rle", "coco_rle", "point_grids",
    "crop_boxes", "nms", "remove_small_regions"])
def test_host_and_device_helpers_match_golden(goldens, case):
    """The cases of tests/test_amg.py (the reference's utils/amg.py
    primitives) on the port's copies."""
    g = goldens("amg_primitives")
    if case == "stability":
        stab = TA.calculate_stability_score(torch.tensor(g["logits"]), 0.0,
                                            1.0)
        np.testing.assert_allclose(stab.numpy(), g["stability"], atol=1e-6)
    elif case == "mask_to_box":
        boxes = TA.batched_mask_to_box(torch.tensor(g["masks"]))
        np.testing.assert_array_equal(boxes.numpy(), g["boxes"])
    elif case == "rle":
        rles = TA.mask_to_rle(g["masks"])
        np.testing.assert_array_equal(rles[0]["counts"], g["rle_counts_0"])
        np.testing.assert_array_equal(rles[3]["counts"], g["rle_counts_3"])
        np.testing.assert_array_equal([TA.area_from_rle(r) for r in rles],
                                      g["areas"])
        for i, r in enumerate(rles):
            np.testing.assert_array_equal(TA.rle_to_mask(r), g["masks"][i])
    elif case == "coco_rle":
        for r in TA.mask_to_rle(g["masks"]):
            enc = TA.coco_encode_rle(r)
            assert enc == JA.coco_encode_rle(r)
            assert _decode_coco(enc["counts"]) == list(r["counts"])
    elif case == "point_grids":
        np.testing.assert_allclose(TA.build_point_grid(4), g["grid4"])
        grids = TA.build_all_layer_point_grids(8, 2, 2)
        for i in range(3):
            np.testing.assert_allclose(grids[i], g[f"grid_all_{i}"])
    elif case == "crop_boxes":
        boxes, layers = TA.generate_crop_boxes((50, 73), 2, 0.34)
        np.testing.assert_array_equal(np.asarray(boxes), g["crop_boxes"])
        np.testing.assert_array_equal(np.asarray(layers), g["layer_idxs"])
    elif case == "nms":
        boxes = np.asarray([[0, 0, 10, 10], [1, 1, 11, 11],
                            [20, 20, 30, 30]], np.float32)
        keep = TA.nms(boxes, np.asarray([0.9, 0.8, 0.7], np.float32), 0.5)
        np.testing.assert_array_equal(sorted(keep), [0, 2])
        scores = torch.tensor([0.9, 0.8, 0.7])
        idx, valid = TA._device_nms_topk(torch.tensor(boxes), scores, 0.5,
                                         3)
        assert idx[:2].tolist() == [0, 2] and valid.tolist() == [
            True, True, False]
    else:
        mask = np.zeros((20, 20), bool)
        mask[2:10, 2:10] = True       # big island
        mask[15:17, 15:17] = True     # small island
        mask[5, 5] = False            # small hole
        out, changed = TA.remove_small_regions(mask, 6, "islands")
        assert changed and not out[15, 15] and out[3, 3]
        out2, changed2 = TA.remove_small_regions(out, 6, "holes")
        assert changed2 and out2[5, 5]


@pytest.fixture(scope="module")
def weights():
    """JAX TINY_SAM params (zero-initialised tables made random) as numpy,
    the same weights in the port's ``Sam``."""
    p = jax_params_to_numpy(jax_init(JS.sam_init, 0, JCFG),
                            np.random.default_rng(0))
    sam = TS.Sam(TCFG, device="cpu")
    sam.load_state_dict(X.sam_state_dict_from_jax(p, TCFG), strict=True)
    return p, sam.eval()


def test_sam_state_dict_from_jax_round_trips(weights):
    """JAX params -> the port's state dict -> the JAX package's own torch
    converter gives back every leaf exactly."""
    p, sam = weights
    back = convert_sam_state_dict(
        {k: v.numpy() for k, v in sam.state_dict().items()}, JCFG)
    flat_p, tree_p = jax.tree_util.tree_flatten(p)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_p == tree_b
    for a, b in zip(flat_p, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


GEN_KW = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=0.0,
              stability_score_thresh=0.0)
IMAGE = (np.random.RandomState(0).rand(50, 60, 3) * 255).astype(np.uint8)


def _generators(weights, **kw):
    p, sam = weights
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    return (JA.AutomaticMaskGenerator(JCFG, jp, **GEN_KW, **kw),
            TA.AutomaticMaskGenerator(TCFG, sam, **GEN_KW, **kw))


def _by_candidate(records):
    """Records in a layout-free order: by prompt point, then IoU."""
    return sorted(records, key=lambda r: (*r["point_coords"][0],
                                          -r["predicted_iou"]))


@pytest.mark.parametrize("nms,cleanup", [(0.7, 0), (1.0, 0), (1.0, 40)],
                         ids=["nms", "topk", "topk-cleanup"])
@pytest.mark.parametrize("output_mode", ["binary_mask", "coco_rle"])
def test_generate_matches_jax(weights, output_mode, nms, cleanup):
    """Thresholds at 0; box NMS at 0.7 (the device NMS path: the random
    tiny model's masks overlap, so one or two survive) or off (top-k, all
    48 candidates), with and without the small-region cleanup."""
    jgen, tgen = _generators(weights, output_mode=output_mode,
                             box_nms_thresh=nms,
                             min_mask_region_area=cleanup)
    ref, got = _by_candidate(jgen.generate(IMAGE)), \
        _by_candidate(tgen.generate(IMAGE))
    assert len(got) == len(ref) >= (1 if nms < 1 or cleanup else 48)
    for r, t in zip(ref, got):
        assert t["point_coords"][0] == pytest.approx(r["point_coords"][0])
        assert t["predicted_iou"] == pytest.approx(r["predicted_iou"],
                                                   abs=1e-4)
        assert t["stability_score"] == pytest.approx(r["stability_score"],
                                                     abs=1e-4)
        assert abs(t["area"] - r["area"]) <= 0.005 * r["area"] + 1
        np.testing.assert_allclose(t["bbox"], r["bbox"], atol=1)
        assert t["crop_box"] == r["crop_box"] == [0, 0, 60, 50]
        if output_mode == "binary_mask":
            seg_t, seg_r = t["segmentation"], r["segmentation"]
        else:
            seg_t, seg_r = (JA.rle_to_mask({"size": s["size"], "counts":
                                            _decode_coco(s["counts"])})
                            for s in (t["segmentation"], r["segmentation"]))
        assert seg_t.shape == (50, 60)
        assert (seg_t == seg_r).mean() >= 0.999


def test_generate_dense_matches_jax(weights):
    """No NMS (the top-k path); the batch API gives the same as one image
    at a time."""
    jgen, tgen = _generators(weights, box_nms_thresh=1.0, max_masks=24)
    jm, jd = jgen.generate_dense(IMAGE)
    tm, td = tgen.generate_dense(IMAGE)
    assert tm.dtype == torch.bool and tm.shape == (24, 50, 60)
    np.testing.assert_allclose(td["iou_preds"], jd["iou_preds"], atol=1e-4)
    np.testing.assert_allclose(td["stability"], jd["stability"], atol=1e-4)
    np.testing.assert_allclose(td["boxes"], jd["boxes"], atol=1e-3)
    np.testing.assert_array_equal(td["points"], jd["points"])
    assert (tm.numpy() == np.asarray(jm)).mean() >= 0.999
    (bm, bd), = tgen.generate_dense_batch([IMAGE])
    assert torch.equal(bm, tm)
    np.testing.assert_array_equal(bd["iou_preds"], td["iou_preds"])


def test_generator_refuses_multi_crop(weights):
    """Multi-crop generation is ported (``tests/test_torch_amg_multicrop.py``
    holds it against JAX): crop layers are taken, and only a negative count
    of them is refused."""
    gen = TA.AutomaticMaskGenerator(TCFG, weights[1], crop_n_layers=2)
    assert len(gen.point_grids) == 3 and gen.device_multicrop
    with pytest.raises(ValueError, match="crop_n_layers"):
        TA.AutomaticMaskGenerator(TCFG, weights[1], crop_n_layers=-1)


@pytest.mark.parametrize("multimask", [True, False], ids=["multi", "single"])
def test_decode_masks_cols_and_stats_match_jax(weights, multimask):
    """``sam.decode_masks_cols`` (B5 + B7) and ``decode_masks_stats`` (B4)
    against the JAX ``decode_masks_cols`` on a shared embedding; the
    statistics exactly against the JAX statistics of the port's logits."""
    p, sam = weights
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    pts = (rng.random((5, 1, 2)) * 64).astype(np.float32)
    labels = np.ones((5, 1), np.int32)
    jcols, jiou = JS.decode_masks_cols(jp, JCFG, jnp.asarray(emb),
                                       (jnp.asarray(pts), jnp.asarray(labels)),
                                       multimask_output=multimask)
    M = jiou.shape[1]
    ref = np.asarray(JMD.cols_to_spatial(jcols, M, 8, 8))
    args = (sam.prompt_encoder, sam.mask_decoder, torch.tensor(emb),
            (torch.tensor(pts), torch.tensor(labels)))
    with torch.no_grad():
        masks, iou = TS.decode_masks_cols(*args, multimask_output=multimask)
        masks2, iou2, (stab, boxes) = TS.decode_masks_stats(
            *args, multimask_output=multimask)
    np.testing.assert_allclose(masks.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-4)
    assert torch.equal(masks, masks2) and torch.equal(iou, iou2)
    x = jnp.asarray(masks.numpy())
    np.testing.assert_array_equal(
        stab.numpy(), np.asarray(JA.calculate_stability_score(x, 0.0, 1.0)))
    np.testing.assert_array_equal(
        boxes.numpy(), np.asarray(JA.batched_mask_to_box(x > 0.0)))


@pytest.mark.parametrize("multimask", [True, False], ids=["multi", "single"])
def test_predict_masks_cols_per_image_batch_matches_jax(weights, multimask):
    """One embedding and one dense prompt per prompt (the route that runs
    the module transformer and then B7 / B6 on a card) against the JAX
    ``predict_masks_cols`` of the same batch, at 1e-4; the statistics
    exactly against the JAX statistics of the port's logits."""
    p, sam = weights
    jmd = jax.tree_util.tree_map(jnp.asarray, p["mask_decoder"])
    rng = np.random.default_rng(4)
    emb, dense = (rng.standard_normal((3, 8, 8, 16)).astype(np.float32)
                  for _ in range(2))
    pe = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    sparse = rng.standard_normal((3, 2, 16)).astype(np.float32)
    jcols, jiou = JMD.predict_masks_cols(
        jmd, JCFG.mask_decoder, *map(jnp.asarray, (emb, pe, sparse, dense)),
        multimask_output=multimask)
    M = jiou.shape[1]
    ref = np.asarray(JMD.cols_to_spatial(jcols, M, 8, 8))
    args = tuple(map(torch.tensor, (emb, pe, sparse, dense)))
    md = sam.mask_decoder
    with torch.no_grad():
        masks, iou = md.predict_masks_cols(*args, multimask_output=multimask)
        masks2, iou2, (stab, boxes) = md.predict_masks_cols_stats(
            *args, multimask_output=multimask, thr=0.0, off=1.0)
    np.testing.assert_allclose(masks.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-4)
    assert torch.equal(masks, masks2) and torch.equal(iou, iou2)
    x = jnp.asarray(masks.numpy())
    np.testing.assert_array_equal(
        stab.numpy(), np.asarray(JA.calculate_stability_score(x, 0.0, 1.0)))
    np.testing.assert_array_equal(
        boxes.numpy(), np.asarray(JA.batched_mask_to_box(x > 0.0)))


def test_packed_weights_are_kept_until_a_parameter_changes():
    """The decoder packs its weights once per dtype and packs again after
    new weights are loaded in place."""
    sam = TS.Sam(TCFG, device="cpu")
    md = sam.mask_decoder
    w = md.packed_weights(torch.float32)
    assert md.packed_weights(torch.float32) is w
    md.load_state_dict({k: v + 1 for k, v in md.state_dict().items()})
    w2 = md.packed_weights(torch.float32)
    assert w2 is not w
    torch.testing.assert_close(w2["up1_b"], w["up1_b"] + 1)
    assert md.packed_weights(torch.bfloat16)["up1_w"].dtype == torch.bfloat16
