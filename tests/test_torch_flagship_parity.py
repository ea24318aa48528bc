"""The port at full width against the PyTorch reference's own outputs
(``tests/test_flagship_parity.py``'s goldens): SAM ViT-B end to end (a
768x1000 image resized to 786x1024, point -> mask) and InternLM2 at its
deployed widths (hidden 2048, GQA 16:8, intermediate 8192, vocab 92553; 2
layers), f32 on the CPU through the plain versions. Weights come from
``tools/synth_weights.py`` (numpy and zlib, per key name), as the goldens'
did; the image is regenerated from its seed.

Tolerances are the JAX package's own for these goldens: the embedding
5e-3, iou 2e-3, low-res logits 5e-2 (absolute and relative), each final
mask's IoU >= 0.99; hidden states 2e-3 absolute / 2e-2 relative, head
logits 2e-3, argmax agreement >= 0.99. The card runs the same in float32
and bfloat16 (``chip_smoke.py`` phase 13 (d))."""

import numpy as np
import torch

from tools.synth_weights import manifest_from_arrays, synth_state_dict
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.models.sam import sam as TS


def _mask_iou(a, b):
    return float(np.logical_and(a, b).sum()) / max(
        float(np.logical_or(a, b).sum()), 1.0)


def _weights(g):
    return synth_state_dict(manifest_from_arrays(g["manifest_keys"],
                                                 g["manifest_shapes"]))


def test_sam_vitb_fullsize_parity_fp32(goldens):
    g = goldens("sam_vitb_full")
    cfg = TC.sam_vit_b()
    sam = X.load_reference_state_dict(TS.Sam(cfg, device="cpu"),
                                      _weights(g)).eval()
    image = (np.random.RandomState(123).rand(3, 786, 1024) * 255
             ).astype(np.float32).transpose(1, 2, 0)
    with torch.no_grad():
        x = TS.preprocess(torch.from_numpy(np.ascontiguousarray(image))[None],
                          cfg)
        emb = TS.encode_image(sam.image_encoder, x)
        low, iou = TS.decode_masks(
            sam.prompt_encoder, sam.mask_decoder, emb,
            points=(torch.from_numpy(g["coords"]),
                    torch.from_numpy(g["labels"])), multimask_output=True)
        final = TS.postprocess_masks(low, (786, 1024), (768, 1000), cfg)
    ref_emb = np.transpose(g["emb"].astype(np.float32), (0, 2, 3, 1))
    np.testing.assert_allclose(emb.numpy(), ref_emb, atol=5e-3,
                               err_msg="encoder embedding")
    np.testing.assert_allclose(iou.numpy(), g["iou"], atol=2e-3,
                               err_msg="iou head")
    np.testing.assert_allclose(low.numpy(), g["low_res"].astype(np.float32),
                               atol=5e-2, rtol=5e-2, err_msg="low-res logits")
    ref = np.unpackbits(g["masks_packed"]).astype(bool)
    ref = ref[:int(np.prod(g["masks_shape"]))].reshape(g["masks_shape"])
    binary = (final > cfg.mask_threshold).numpy()
    for m in range(3):
        iou_m = _mask_iou(binary[0, m], ref[0, m])
        assert iou_m >= 0.99, f"fp32 mask {m} IoU {iou_m:.4f}"


def test_internlm2_fulldims_parity(goldens):
    g = goldens("internlm2_fulldims")
    cfg = TC.InternLM2Config(num_hidden_layers=2)  # deployed widths
    assert (cfg.hidden_size, cfg.num_attention_heads,
            cfg.num_key_value_heads, cfg.intermediate_size,
            cfg.vocab_size) == (2048, 16, 8, 8192, 92553)
    lm = X.load_reference_state_dict(
        TM.InternLM2ForCausalLM(cfg, device="cpu"), _weights(g)).eval()
    with torch.no_grad():
        out = TM.internlm2_forward(
            lm, cfg, input_ids=torch.from_numpy(g["input_ids"]),
            attention_mask=torch.from_numpy(g["attention_mask"]),
            output_hidden_states=True)
    valid = g["attention_mask"].astype(bool)
    hs = g["hidden_states"].astype(np.float32)       # [L + 1, B, S, H]
    np.testing.assert_allclose(out["hidden_states"].numpy()[:, valid],
                               hs[:-1][:, valid], atol=2e-3, rtol=2e-2,
                               err_msg="layer-input hidden states")
    np.testing.assert_allclose(out["last_hidden"].numpy()[valid],
                               hs[-1][valid], atol=2e-3, rtol=2e-2,
                               err_msg="final hidden")
    logits = out["logits"].numpy()
    np.testing.assert_allclose(logits[:, :, :512][valid],
                               g["logits_head"].astype(np.float32)[valid],
                               atol=2e-3, err_msg="head logits")
    agree = (logits.argmax(-1)[valid] == g["argmax"][valid]).mean()
    assert agree >= 0.99, f"fp32 argmax agreement {agree:.3f}"
