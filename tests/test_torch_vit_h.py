"""SAM ViT-H in the port: the registry, and the image encoder at head dim
80 under each of the JAX package's route switches, against
``ullsam_tpu``'s ``image_encoder_apply`` with the same switches.

The JAX package reads its switches when it traces, so its functions run
un-jitted here, with ``backend_ok`` patched to True and the Pallas kernels
in interpret mode (as ``tests/test_kernels.py`` runs them); the port reads
them at each call and runs its kernels' plain versions on the CPU. The
encoder meets every gate: 8 heads of 80 (C = 640, C % 128 == 0 for B13),
a 32x32 grid (N = 1024 for B14) in 7x7 windows (padded to 35x35: 25
windows, pad tokens masked), one windowed and one global block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_helpers import jax_init, jax_params_to_numpy, to_np

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.sam import image_encoder as JIE
from ullsam_tpu.models.sam.sam import sam_init
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.sam import registry as R
from ullsam_tpu_torch.models.sam import image_encoder as TIE
from ullsam_tpu_torch.models.sam.image_encoder import ImageEncoder
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import flash_attention as TFA
from ullsam_tpu_torch.ops.kernels import vit_block as TVB
from ullsam_tpu_torch.ops.kernels import window_attention as TWA
from ullsam_tpu_torch.tools.main_path import SWITCHES, VIT_H_ROUTES

T = torch.from_numpy

FIELDS = dict(img_size=128, patch_size=4, embed_dim=640, depth=2,
              num_heads=8, mlp_ratio=4.0, out_chans=32, window_size=7,
              global_attn_indexes=(1,))


def _rel(got, ref):
    got, ref = to_np(got), to_np(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _refuse(*args, **kwargs):
    raise AssertionError("an opt-in route ran under remat")


@functools.lru_cache(maxsize=None)
def _encoder():
    """(JAX params, port encoder, image) shared by the route cases."""
    jcfg = JC.ViTConfig(**FIELDS)
    rng = np.random.default_rng(0)
    p = jax_params_to_numpy(jax_init(JIE.image_encoder_init, 0, jcfg), rng)
    enc = ImageEncoder(TC.ViTConfig(**FIELDS), device="cpu")
    X.load_reference_state_dict(enc, X.image_encoder_arrays(p, ""))
    x = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    return jcfg, p, enc.eval(), x


def _set_route(monkeypatch, route):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in VIT_H_ROUTES[route].items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("route", list(VIT_H_ROUTES))
def test_hd80_encoder_routes_match_jax(monkeypatch, route):
    """The hd-80 encoder under one route setting, float32, against the JAX
    encoder under the same setting (B1 / B2 / B3 / B13 / B14 / B15 in
    interpret mode where the route takes them): within 1e-5 of max|out|
    (summation order, and the JAX kernels' hi + lo bias selection)."""
    jcfg, p, enc, x = _encoder()
    _set_route(monkeypatch, route)
    monkeypatch.setattr("ullsam_tpu.ops.pallas.backend_ok", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        ref = JIE.image_encoder_apply(
            jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = enc(T(x))
    assert got.shape == (1, 32, 32, 32)
    assert _rel(got, ref) <= 1e-5


def test_packed_global_route_equals_default_in_f32(monkeypatch):
    """B14 computes B2's function: on the CPU the encoder's output under
    ``ULLSAM_PACKED_GLOBAL=1`` equals the default route's within 1e-6 of
    its max (float32)."""
    _, _, enc, x = _encoder()
    _set_route(monkeypatch, "default")
    with torch.no_grad():
        want = enc(T(x))
        monkeypatch.setenv("ULLSAM_PACKED_GLOBAL", "1")
        got = enc(T(x))
    assert _rel(got, want) <= 1e-6


def test_no_switch_applies_under_remat(monkeypatch):
    """Under remat the JAX package passes ``allow_window_kernel=False``, so
    no switch applies: with every switch set, the remat forward runs the
    default route's remat chain (B1's plain version, B2; no B13, B14, B3 or
    B15) and equals its output to float32 summation order, and its
    gradient flows."""
    fields = dict(FIELDS, embed_dim=256, num_heads=2, mlp_ratio=2.0,
                  depth=2)
    enc = ImageEncoder(TC.ViTConfig(**fields), device="cpu")
    gen = torch.Generator().manual_seed(0)
    L.init_module_(enc, gen)
    x = torch.randn(1, 128, 128, 3, generator=gen)
    _set_route(monkeypatch, "default")
    want = enc(x, remat=True)
    for name, value in (("ULLSAM_FUSED_VIT_ATTN", "0"),
                        ("ULLSAM_FUSED_VIT_MLP", "1"),
                        ("ULLSAM_PACKED_GLOBAL", "1"),
                        ("ULLSAM_WINDOW_TWOPHASE", "1")):
        monkeypatch.setenv(name, value)
    for mod, name in ((TVB, "ln_mlp_plain"),
                      (TFA, "vit_flash_attn_packed_plain"),
                      (TWA, "window_attn_core_twophase_plain"),
                      (TIE, "window_attention")):
        monkeypatch.setattr(mod, name, _refuse)
    got = enc(x, remat=True)
    assert _rel(got, want) <= 1e-6
    got.sum().backward()
    assert enc.blocks[0].mlp.lin1.weight.grad is not None


def test_build_sam_vit_h_shapes_match_jax():
    """``build_sam("vit_h", device="meta")``: every parameter and buffer
    name and shape equals the reference-named state dict carried from the
    shapes of JAX's ``sam_init`` (``jax.eval_shape``, so nothing full-size
    is made on the CPU)."""
    cfg, model = R.build_sam("vit_h", device="meta")
    assert cfg.vit.embed_dim == 1280 and cfg.vit.head_dim == 80
    jcfg = JC.SAM_REGISTRY["vit_h"]()
    shapes = jax.eval_shape(lambda k: sam_init(k, jcfg),
                            jax.random.PRNGKey(0))
    # zero-stride views: the converters transpose, nothing is allocated
    tree = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    arrays = X.image_encoder_arrays(tree["image_encoder"], "image_encoder.")
    arrays.update(X.prompt_encoder_arrays(tree["prompt_encoder"]))
    arrays.update(X.mask_decoder_arrays(tree["mask_decoder"],
                                        cfg.mask_decoder))
    want = {k: tuple(v.shape) for k, v in arrays.items()}
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n = sum(p.numel() for p in model.parameters())
    assert 600e6 < n < 700e6, n


def test_build_sam_seed_checkpoint_and_unknown_variant(monkeypatch,
                                                       tmp_path):
    """Random weights follow the seed; a reference-named ``.pth`` state
    dict loads by name; an unknown variant raises ``KeyError``, as in
    JAX."""
    with pytest.raises(KeyError):
        R.build_sam("vit_x", device="cpu")

    def tiny():
        return TC.SamConfig(
            vit=TC.ViTConfig(img_size=64, patch_size=8, embed_dim=32,
                             depth=2, num_heads=2, out_chans=16,
                             window_size=4, global_attn_indexes=(1,)),
            prompt_encoder=TC.PromptEncoderConfig(
                embed_dim=16, image_embedding_size=(8, 8),
                input_image_size=(64, 64), mask_in_chans=8),
            mask_decoder=TC.MaskDecoderConfig(
                transformer_dim=16, transformer_mlp_dim=32,
                transformer_num_heads=2, iou_head_hidden_dim=8))

    monkeypatch.setitem(R.SAM_REGISTRY, "tiny", tiny)
    _, a = R.build_sam("tiny", seed=3, device="cpu")
    _, b = R.build_sam("tiny", seed=3, device="cpu")
    _, c = R.build_sam("tiny", seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "image_encoder.blocks.0.attn.qkv.weight"
    assert not torch.equal(sa[w], sc[w])
    path = tmp_path / "tiny.pth"
    torch.save(sc, path)
    _, d = R.build_sam("tiny", checkpoint=str(path), seed=3, device="cpu")
    assert all(torch.equal(v, sc[k]) for k, v in d.state_dict().items())
    assert not a.training and not d.training
