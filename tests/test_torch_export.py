"""The port's exported prompt decoder (``ullsam_tpu_torch/inference/
export.py``): ``SamOnnxModel`` parity against the reference golden
``onnx_model`` (as ``tests/test_export.py`` holds the JAX package), the
``torch.export`` save / load round trip of the minimal and the full
decoder, and one artifact with a dynamic original size at two sizes
against the static functions.

Tolerances: against the golden those of ``tests/test_export.py`` (upscaled
2e-3 absolute and 1e-3 relative, scores and low-res 1e-3, stability 2e-3,
areas within 3 pixels); an artifact against the eager function it was
traced from 1e-5 (the same ops); the dynamic-size matrices against the
static ones 1e-4 (the tent form of the interpolation weights rounds
differently), as in the JAX test; the minimal decoder against JAX's
``make_decoder_fn`` 1e-4 (summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_init, jax_params_to_numpy
from test_torch_amg import JCFG, TCFG

from ullsam_tpu.inference import export as JE
from ullsam_tpu.models.sam import sam as JS
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.inference.export import (export_decoder,
                                               load_exported_decoder,
                                               make_decoder_fn,
                                               make_onnx_decoder_fn)
from ullsam_tpu_torch.models.sam import sam as TS

T = torch.from_numpy


def _nhwc(x):
    return T(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))


def _micro_sam(g):
    cfg = TC.SamConfig(
        vit=TC.ViTConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,
                         num_heads=2, mlp_ratio=2.0, out_chans=32,
                         window_size=2, global_attn_indexes=(1,)),
        prompt_encoder=TC.PromptEncoderConfig(
            embed_dim=32, image_embedding_size=(8, 8),
            input_image_size=(64, 64), mask_in_chans=8),
        mask_decoder=TC.MaskDecoderConfig(
            transformer_dim=32, transformer_mlp_dim=64,
            transformer_num_heads=2, iou_head_hidden_dim=16))
    return cfg, X.load_reference_state_dict(TS.Sam(cfg, device="cpu"), g)


CASES = [  # (tag, single, stab, extra, has_mask, n_points)
    ("multi_nomask", False, False, False, 0.0, 3),
    ("multi_mask", False, False, False, 1.0, 3),
    ("single_np3", True, False, False, 0.0, 3),
    ("single_np2", True, False, False, 1.0, 2),
    ("stab_extra", False, True, True, 1.0, 3),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_onnx_model_matches_golden(goldens, case):
    tag, single, stab, extra, hm, n = case
    g = goldens("onnx_model")
    cfg, sam = _micro_sam(g)
    orig = tuple(int(v) for v in g["orig_im_size"])
    fn = make_onnx_decoder_fn(cfg, return_single_mask=single,
                              use_stability_score=stab,
                              return_extra_metrics=extra, orig_im_size=orig)
    with torch.no_grad():
        res = fn(sam, _nhwc(g["embedding"]), T(g[f"coords{n}"]),
                 T(g[f"labels{n}"].astype(np.int64)), _nhwc(g["mask_input"]),
                 torch.tensor([hm]))
    if extra:
        up, sc, st, areas, low = res
        np.testing.assert_allclose(st.numpy(), g[tag + "_stability"],
                                   atol=2e-3)
        assert np.abs(areas.numpy() - g[tag + "_areas"]).max() <= 3
    else:
        up, sc, low = res
    np.testing.assert_allclose(up.numpy(), g[tag + "_upscaled"], atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(sc.numpy(), g[tag + "_scores"], atol=1e-3)
    np.testing.assert_allclose(low.numpy(), g[tag + "_lowres"], atol=1e-3,
                               rtol=1e-3)


@pytest.fixture(scope="module")
def tiny():
    """TINY_SAM with the JAX init's weights on both sides."""
    p = jax_params_to_numpy(jax_init(JS.sam_init, 2, JCFG),
                            np.random.default_rng(2))
    sam = TS.Sam(TCFG, device="cpu")
    sam.load_state_dict(X.sam_state_dict_from_jax(p, TCFG), strict=True)
    return jax.tree_util.tree_map(jnp.asarray, p), sam.eval()


def test_export_decoder_round_trip(tiny):
    """The minimal artifact against the eager point decoder (1e-5) and
    the JAX package's ``make_decoder_fn`` (1e-4)."""
    jp, sam = tiny
    blob = export_decoder(sam, TCFG, num_points=2, batch=1)
    assert isinstance(blob, bytes) and len(blob) > 1000
    fn = load_exported_decoder(blob)
    emb = torch.tensor(np.random.RandomState(0).randn(1, 8, 8, 16),
                       dtype=torch.float32)
    coords = torch.tensor([[[10.0, 20.0], [40.0, 50.0]]])
    labels = torch.tensor([[1, 0]])
    masks, iou = fn(emb, coords, labels)
    with torch.no_grad():
        ref_m, ref_i = make_decoder_fn(TCFG)(sam, emb, coords, labels)
    np.testing.assert_allclose(masks.numpy(), ref_m.numpy(), atol=1e-5)
    np.testing.assert_allclose(iou.numpy(), ref_i.numpy(), atol=1e-5)
    jm, ji = JE.make_decoder_fn(JCFG)(jp, jnp.asarray(emb.numpy()),
                                      jnp.asarray(coords.numpy()),
                                      jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(masks.numpy(), np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(iou.numpy(), np.asarray(ji), atol=1e-4)


def _full_inputs(seed):
    rs = np.random.RandomState(seed)
    return (torch.tensor(rs.randn(1, 8, 8, 16), dtype=torch.float32),
            torch.tensor(rs.rand(2, 3, 2) * 32, dtype=torch.float32),
            torch.tensor([[1, 0, -1], [1, 1, -1]]),
            torch.tensor(rs.randn(2, 32, 32, 1), dtype=torch.float32),
            torch.tensor([1.0, 0.0]))


def test_export_full_decoder_round_trip(tiny):
    """The ``full=True`` artifact at one original size against the eager
    ``make_onnx_decoder_fn`` (1e-5), and that against JAX's (1e-4)."""
    jp, sam = tiny
    orig = (30, 50)
    fn = load_exported_decoder(export_decoder(
        sam, TCFG, num_points=3, batch=2, full=True, return_single_mask=True,
        orig_im_size=orig))
    args = _full_inputs(1)
    up, sc, low = fn(*args)
    with torch.no_grad():
        rup, rsc, rlow = make_onnx_decoder_fn(
            TCFG, return_single_mask=True, orig_im_size=orig)(sam, *args)
    assert up.shape == (2, 1) + orig
    for a, b in ((up, rup), (sc, rsc), (low, rlow)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    jres = JE.make_onnx_decoder_fn(JCFG, return_single_mask=True,
                                   orig_im_size=orig)(
        jp, *(jnp.asarray(a.numpy()) for a in args))
    for a, b in zip((up, sc, low), jres):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_export_dynamic_size_one_artifact_two_sizes(tiny):
    """One ``dynamic_size`` artifact serves two original sizes and matches
    the static function at each."""
    _, sam = tiny
    fn = load_exported_decoder(export_decoder(
        sam, TCFG, num_points=3, batch=2, full=True, return_single_mask=True,
        dynamic_size=True))
    args = _full_inputs(2)
    for orig in [(30, 50), (48, 25)]:
        up, sc, low = fn(*args, torch.zeros(orig))
        assert up.shape == (2, 1) + orig
        with torch.no_grad():
            rup, rsc, rlow = make_onnx_decoder_fn(
                TCFG, return_single_mask=True, orig_im_size=orig)(sam, *args)
        np.testing.assert_allclose(up.numpy(), rup.numpy(), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(sc.numpy(), rsc.numpy(), atol=1e-5)
        np.testing.assert_allclose(low.numpy(), rlow.numpy(), atol=1e-5)
