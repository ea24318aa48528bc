"""The port's closed-form AMG weight calibration
(``ullsam_tpu_torch/inference/calibrate.py``) against the JAX package's,
from the same ``sam_init`` weights, on ``tests/test_calibrate.py``'s CFG: a
tiny ViT under SAM's production decoder (64x64 embedding, 1024x1024
input), which is what the calibration is tuned for.

Tolerances (float32 on both sides):
  * every tensor the calibration draws at random or sets to a constant is
    bitwise equal to JAX's (the same ``RandomState`` draws in the same
    order, transposed into the port's layout);
  * the probed tensors (the injectors' sink biases, the hypernetworks'
    read-out biases, the IoU head's last layer) within 1e-4 relative to
    each tensor's largest magnitude: the probes sum in another order, and
    the read-out scale ``steepness / margin`` divides by a probed margin,
    which amplifies a 1e-7 probe difference about a thousandfold;
  * the production-config AMG on both sides commits the same candidates,
    with IoU and stability within 1e-4 and masks equal pixel for pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init

from ullsam_tpu.core import config as JC
from ullsam_tpu.inference import amg as JA
from ullsam_tpu.inference.calibrate import calibrate_amg_weights as j_calib
from ullsam_tpu.models.sam import sam as JS
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.inference import amg as TA
from ullsam_tpu_torch.inference.calibrate import calibrate_amg_weights
from ullsam_tpu_torch.models.sam import sam as TS


def prod_decoder_tiny_vit(C):
    """``tests/test_calibrate.py``'s CFG in config module ``C``."""
    return C.SamConfig(
        vit=C.ViTConfig(img_size=1024, patch_size=16, embed_dim=64, depth=2,
                        num_heads=2, mlp_ratio=2.0, out_chans=256,
                        window_size=8, global_attn_indexes=(1,)),
        prompt_encoder=C.PromptEncoderConfig(
            embed_dim=256, image_embedding_size=(64, 64),
            input_image_size=(1024, 1024), mask_in_chans=16),
        mask_decoder=C.MaskDecoderConfig())


JCFG, TCFG = prod_decoder_tiny_vit(JC), prod_decoder_tiny_vit(TC)

# tensors that calibrate_amg_weights computes from probes; every other
# tensor it touches is drawn or set and must be bitwise equal
PROBED = ("transformer.layers.0.cross_attn_image_to_token.q_proj.bias",
          "transformer.layers.1.cross_attn_image_to_token.q_proj.bias",
          "iou_prediction_head.layers.2.")
PROBED_HYPER = ".layers.2.bias"


def _is_probed(name):
    return (any(p in name for p in PROBED) or
            ("output_hypernetworks_mlps" in name
             and name.endswith(PROBED_HYPER)))


@pytest.fixture(scope="module")
def calibrated():
    """(JAX calibrated params, port calibrated Sam, the port's input Sam)
    from one ``sam_init``."""
    p = jax_init(JS.sam_init, 0, JCFG)
    p_np = jax.tree_util.tree_map(np.asarray, p)
    sam = TS.Sam(TCFG, device="cpu")
    sam.load_state_dict(X.sam_state_dict_from_jax(p_np, TCFG), strict=True)
    before = {k: v.clone() for k, v in sam.state_dict().items()}
    tsam = calibrate_amg_weights(sam, TCFG)
    jp = j_calib(p, JCFG)
    return jp, tsam, sam, before


def test_calibrated_tensors_match_jax(calibrated):
    jp, tsam, sam, before = calibrated
    ref = X.sam_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), TCFG)
    got = tsam.state_dict()
    assert set(ref) == set(got)
    exact, probed = 0, 0
    for k, v in got.items():
        r = ref[k].float()
        if _is_probed(k):
            scale = float(r.abs().max()) or 1.0
            err = float((v - r).abs().max()) / scale
            assert err <= 1e-4, (k, err)
            probed += 1
        else:
            assert torch.equal(v, r), k
            exact += 1
    assert probed == 2 + 2 + TCFG.mask_decoder.num_mask_tokens
    # the calibration changed what it should, and left the input alone
    assert not torch.equal(got["image_encoder.neck.3.weight"],
                           before["image_encoder.neck.3.weight"])
    for k, v in sam.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert tsam is not sam


def test_calibrated_masks_track_prompts(calibrated):
    """``tests/test_calibrate.py``'s case on the port."""
    _, tsam, _, _ = calibrated
    emb = torch.zeros((1, 64, 64, 256))
    pts = TA.build_point_grid(8) * 1024
    with torch.no_grad():
        masks, iou = TS.decode_masks(
            tsam.prompt_encoder, tsam.mask_decoder, emb,
            points=(torch.tensor(pts[:, None, :], dtype=torch.float32),
                    torch.ones((64, 1), dtype=torch.int64)),
            multimask_output=True)
    pos = masks.numpy() > 0
    errs, clean = [], []
    for b in range(64):
        mk = pos[b, 0]
        if not mk.any():
            continue
        ys, xs = np.nonzero(mk)
        ex, ey = pts[b] / (1024 / 256)
        errs.append(((xs.mean() - ex) ** 2 + (ys.mean() - ey) ** 2) ** 0.5)
        clean.append((np.hypot(xs - ex, ys - ey) < 48).mean() > 0.9)
    assert len(errs) >= 20, f"only {len(errs)} prompts produced masks"
    assert float(np.median(errs)) < 15.0, sorted(np.round(errs, 1))
    assert float(np.mean(clean)) >= 0.5, np.mean(clean)
    iou = iou.numpy()
    assert 0.8 < float(np.median(iou)) < 1.0
    assert float(np.std(iou)) > 0.005


PROD = dict(points_per_side=8, pred_iou_thresh=0.88,
            stability_score_thresh=0.95, box_nms_thresh=0.7, max_masks=64,
            points_per_batch=32)
IMAGE = (np.random.RandomState(0).rand(1024, 1024, 3) * 255).astype(np.uint8)


def test_realistic_config_commits_masks_end_to_end(calibrated):
    """``tests/test_calibrate.py``'s case on the port, and the port's
    committed set against JAX's: the same candidates, IoU and stability
    within 1e-4, the same masks."""
    jp, tsam, _, _ = calibrated
    masks, data = TA.AutomaticMaskGenerator(TCFG, tsam,
                                            **PROD).generate_dense(IMAGE)
    n = len(data["iou_preds"])
    assert 8 <= n <= 64, n
    assert (data["areas"] > 0).all(), data["areas"]
    assert len(set(map(tuple, data["boxes"].tolist()))) == n
    assert (data["iou_preds"] > 0.88).all()
    assert n < 64 * 3

    jgen = JA.AutomaticMaskGenerator(JCFG, jp, **PROD)
    jm, jd = jgen.generate_dense(IMAGE)
    jv = np.asarray(jd["valid"])
    jm = np.asarray(jm)
    # the port's records carry the candidate index; JAX's are in the same
    # NMS order (the port keeps JAX's tie order)
    jcand = np.asarray(JA._amg_device_sweep(
        jgen.params, JCFG, jnp.asarray(IMAGE[None]),
        jnp.asarray(TA.ResizeLongestSide(1024).apply_coords(
            TA.build_point_grid(8) * 1024, (1024, 1024))),
        points_per_batch=32, max_out=64, pred_iou_thresh=0.88,
        stability_thresh=0.95, stability_offset=1.0, box_nms_thresh=0.7,
        input_hw=(1024, 1024), out_hw=(1024, 1024), n_real=64,
        compute_dtype=jnp.float32)["indices"])[:n]
    assert jv.sum() == n
    np.testing.assert_array_equal(data["candidate"], jcand)
    np.testing.assert_allclose(data["iou_preds"], jd["iou_preds"], atol=1e-4)
    np.testing.assert_allclose(data["stability"], jd["stability"],
                               atol=1e-4)
    np.testing.assert_array_equal(masks.numpy(), jm)
