"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked ``gpu``; each test skips when no CUDA card is present (decided
inside the fixture, never at import, so every xdist worker collects the
same tests). On a machine with a card and no jax, run from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

This file imports neither jax nor ullsam_tpu. Tolerances are relative to
max|plain|: f32 1e-4 (summation order; the plain versions take no TF32,
the kernels' split TF32 is f32-accurate), bf16 2e-2 (a few bf16 steps
where a different sum rounds a value the other way). The f32 kernels on
the tensor cores (split TF32) are also held against a float64 evaluation
of their plain version: at most 4x the plain f32 version's own error.
"""

import math

import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid,ws,hd,masked", [
    ((64, 64), 14, 64, True),    # ViT-B main path: 70x70 padded, 25 windows
    ((28, 28), 14, 64, False),   # whole windows, no pad tokens
    ((20, 30), 8, 64, True)])    # non-square grid, 8x8 windows
def test_window_attn_kernel_matches_plain(cuda, dt, grid, ws, hd, masked):
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    dtype = getattr(torch, dt)
    H, W = grid
    nwy, nwx = -(-H // ws), -(-W // ws)
    nh = 2
    C = nh * hd
    Bw, n = 2 * nwx * nwy, ws * ws

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=cuda, device="cuda")
                * s).to(dtype)

    args = (r(Bw, n, C), 1 + r(C, s=0.1), r(C, s=0.1),
            r(3 * C, C, s=C ** -0.5), r(3 * C, s=0.1),
            r(C, C, s=C ** -0.5), r(C, s=0.1), r(ws, ws, hd, s=0.2),
            r(ws, ws, hd, s=0.2))
    kw = dict(num_heads=nh, eps=1e-6, nwx=nwx, nwy=nwy, Hv=H, Wv=W,
              masked=masked)
    before = VB.window_attn.launches
    got = VB.window_attn(*args, **kw)
    torch.cuda.synchronize()
    assert VB.window_attn.launches == before + 1
    assert _rel_err(got, VB.window_attn_plain(*args, **kw)) <= TOL[dt]


# (BH, KH, KW) of B2's cases: the 64x64 grid of SAM at 1024 (a 64-key tile
# is one key row), KW 16 and 32 (four and two rows a tile), KW 8 at N = 64
# (one block of 64 queries) and KW 48, which divides no tile (the per-logit
# bias; N = 192, a last block of 64 queries)
_FLASH_GRIDS = [(12, 64, 64), (3, 16, 16), (2, 8, 32), (2, 8, 8), (2, 4, 48)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("BH,KH,KW", _FLASH_GRIDS)
def test_vit_flash_attn_kernel_matches_plain(cuda, dt, D, BH, KH, KW):
    """B2 against its plain version at head dims 64 and 80 and at key grids
    on both bias paths (``key_rows_per_tile``): o within TOL, lse within
    1e-5 of max|lse|, one launch."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    dtype = getattr(torch, dt)
    N = KH * KW
    q, k, v = (torch.randn(BH, N, D, generator=cuda, device="cuda")
               .to(dtype) for _ in range(3))
    rh, rw = ((torch.randn(BH, N, K, generator=cuda, device="cuda") * 0.5)
              .to(dtype) for K in (KH, KW))
    before = FA.vit_flash_attn.launches
    o, lse = FA.vit_flash_attn(q, k, v, rh, rw)
    torch.cuda.synchronize()
    assert FA.vit_flash_attn.launches == before + 1
    ro, rlse = FA.vit_flash_attn_plain(q, k, v, rh, rw)
    assert bool(torch.isfinite(o).all())
    assert _rel_err(o, ro) <= TOL[dt]
    assert _rel_err(lse, rlse) <= 1e-5


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("B,nh,KH,KW", [(1, 12, 64, 64), (2, 3, 16, 16),
                                        (1, 2, 8, 32), (2, 2, 4, 48)])
def test_vit_flash_packed_kernel_matches_plain(cuda, dt, D, B, nh, KH, KW):
    """B14 (B2's body reading q, k, v from [B, N, 3C] and writing o into
    [B, N, C]) against its plain version on both bias paths and head dims:
    o within TOL, lse within 1e-5 of max|lse|, one launch."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    dtype = getattr(torch, dt)
    N, C = KH * KW, nh * D
    qkv = torch.randn(B, N, 3 * C, generator=cuda, device="cuda").to(dtype)
    rh, rw = ((torch.randn(B * nh, N, K, generator=cuda, device="cuda")
               * 0.5).to(dtype) for K in (KH, KW))
    before = FA.vit_flash_attn_packed.launches
    o, lse = FA.vit_flash_attn_packed(qkv, rh, rw, nh)
    torch.cuda.synchronize()
    assert FA.vit_flash_attn_packed.launches == before + 1
    ro, rlse = FA.vit_flash_attn_packed_plain(qkv, rh, rw, nh)
    assert o.shape == (B, N, C) and bool(torch.isfinite(o).all())
    assert _rel_err(o, ro) <= TOL[dt]
    assert _rel_err(lse, rlse) <= 1e-5


@pytest.mark.parametrize("kind", ["B2", "B14"])
@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("KH,KW", [(64, 64), (4, 48)])
def test_vit_flash_f32_error_vs_float64(cuda, kind, D, KH, KW):
    """B2's and B14's float32 body (split TF32 on wgmma) against a float64
    evaluation of its plain version, at SAM's 64x64 grid (rel_w from
    registers) and at KW 48 (the per-logit bias; a last block of 64
    queries): o and lse each within 4x the plain float32 version's error
    (TF32 off); two calls give bitwise the same outputs (no atomics)."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    N, nh = KH * KW, 3
    rh, rw = (torch.randn(nh, N, K, generator=cuda, device="cuda") * 0.5
              for K in (KH, KW))
    if kind == "B2":
        args = tuple(torch.randn(nh, N, D, generator=cuda, device="cuda")
                     for _ in range(3)) + (rh, rw)
        kernel, plain, kw = FA.vit_flash_attn, FA.vit_flash_attn_plain, {}
    else:
        args = (torch.randn(1, N, 3 * nh * D, generator=cuda,
                            device="cuda"), rh, rw)
        kernel = FA.vit_flash_attn_packed
        plain, kw = FA.vit_flash_attn_packed_plain, {"nh": nh}
    got, again = kernel(*args, **kw), kernel(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    ref = plain(*(t.double() for t in args), **kw)
    for name, a, b, r in zip(("o", "lse"), got, plain(*args, **kw), ref):
        err, err_plain = _rel_err64(a, r), _rel_err64(b, r)
        assert err <= 4 * err_plain, (name, err, err_plain)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,HW,M,T", [
    (3, 8, 3, 7),       # 64 image rows: fewer than a work unit's 128
    (3, 32, 3, 7),      # the JAX package's kernel test shape
    (1, 64, 1, 4),      # one prompt, single mask, the 64x64 grid
    (3, 32, 4, 16),     # every mask token, 16 tokens
    (256, 64, 3, 7)])   # the AMG chunk of SAM ViT-B
def test_decoder_kernels_match_plain(cuda, dt, B, HW, M, T):
    """B4, B5, B6, B7 against their plain versions; statistics exactly
    against the plain statistics of the kernel's own logits."""
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.tools.main_path import (decoder_cases,
                                                  decoder_outputs)
    cases = decoder_cases(getattr(torch, dt), cuda, B=B, H=HW, W=HW, T=T,
                          M=M)
    for name, (args, kw, _, _) in cases.items():
        kernel, plain = getattr(D, name), getattr(D, name + "_plain")
        before = kernel.launches
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, name
        ref = plain(*args, **kw)
        g_f, g_i, logits = decoder_outputs(name, got)
        r_f, _, _ = decoder_outputs(name, ref)
        for a, b in zip(g_f, r_f):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel_err(a, b) <= TOL[dt], name
        if g_i is not None:
            for a, b in zip(g_i, D.upscale_stats_plain(logits, kw["thr"],
                                                       kw["off"])):
                assert torch.equal(a, b), name


@pytest.mark.parametrize("B,HW,T", [(3, 8, 7), (3, 32, 7), (2, 32, 16),
                                    (256, 64, 7)])
def test_decoder_fused_kernels_match_plain(cuda, B, HW, T):
    """The fused bf16 kernels (B5's two image stages and the token ->
    image attention from their partials, B6 / B7's upscale) against the
    plain chain, at a grid smaller than a work unit, 32x32 (7 and 16
    tokens) and the AMG chunk: each launched as often as a call needs, the
    statistics exactly the plain statistics of the kernel's own logits,
    and two runs bitwise equal."""
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.tools.main_path import decoder_cases
    cases = decoder_cases(torch.bfloat16, cuda, B=B, H=HW, W=HW, T=T, M=3)
    want = {"decode_masks": {"image_stage1": 1, "image_stage2": 1,
                             "t2i_part": 2, "upscale_unit_stats": 1},
            "two_way_transformer": {"image_stage1": 1, "image_stage2": 1,
                                    "t2i_part": 2},
            "upscale_hypernet_stats": {"upscale_unit_stats": 1},
            "upscale_hypernet": {"upscale_unit": 1}}
    for name, (args, kw, _, _) in cases.items():
        kernel, plain = getattr(D, name), getattr(D, name + "_plain")
        before = {k: c.launches for k, c in D.FUSED_KERNELS.items()}
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        ran = {k: c.launches - before[k] for k, c in D.FUSED_KERNELS.items()
               if c.launches != before[k]}
        assert ran == want[name], name
        again = kernel(*args, **kw)
        ref = plain(*args, **kw)
        outs = got if isinstance(got, tuple) else (got,)
        for a, b in zip(outs, again if isinstance(again, tuple) else
                        (again,)):
            assert torch.equal(a, b), name
        refs = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(outs, refs):
            if a.dtype == torch.int32:
                continue
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel_err(a, b) <= TOL["bfloat16"], name
        if name in ("decode_masks", "upscale_hypernet_stats"):
            logits, st = outs[-4], outs[-3:]
            for a, b in zip(st, D.upscale_stats_plain(logits, kw["thr"],
                                                      kw["off"])):
                assert torch.equal(a, b), name


# the fused f32 kernels one call of each wrapper launches
_F32_FUSED = {"decode_masks": {"image_stage1_f32": 1, "image_stage2_f32": 1,
                               "t2i_part_f32": 2, "t2i_f32": 1,
                               "upscale_unit_stats_f32": 1},
              "two_way_transformer": {"image_stage1_f32": 1,
                                      "image_stage2_f32": 1,
                                      "t2i_part_f32": 2, "t2i_f32": 1},
              "upscale_hypernet_stats": {"upscale_unit_stats_f32": 1},
              "upscale_hypernet": {"upscale_unit_f32": 1}}


def _as_f64(args):
    """A decoder case's arguments in float64 (the weights dict too)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.double()
        return t
    return tuple(conv(a) for a in args)


@pytest.mark.parametrize("B,HW,T", [(1, 32, 7), (1, 64, 16), (256, 32, 7),
                                    (256, 64, 7), (3, 8, 7)])
def test_decoder_fused_f32_kernels_match_plain(cuda, B, HW, T):
    """float32 at SAM's decoder widths: B4-B7 on the fused f32 kernels
    (split TF32, units of 64 rows), at two grids with B = 1 and 256 and a
    grid of one unit: each fused f32 kernel launched as often as a call
    needs (no bf16 one), within 1e-4 of max|plain|, the statistics exactly
    the plain statistics of the kernel's own logits, two calls bitwise
    equal, and each output's error against a float64 evaluation of the
    plain version within 4x the plain float32 version's."""
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.tools.main_path import (decoder_cases,
                                                  decoder_outputs)
    cases = decoder_cases(torch.float32, cuda, B=B, H=HW, W=HW, T=T, M=3)
    for name, (args, kw, _, _) in cases.items():
        kernel, plain = getattr(D, name), getattr(D, name + "_plain")
        before = {k: c.launches for k, c in D.FUSED_KERNELS.items()}
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        ran = {k: c.launches - before[k] for k, c in D.FUSED_KERNELS.items()
               if c.launches != before[k]}
        assert ran == _F32_FUSED[name], name
        again = kernel(*args, **kw)
        g_f, g_i, logits = decoder_outputs(name, got)
        for a, b in zip(g_f + (g_i or ()),
                        decoder_outputs(name, again)[0]
                        + (decoder_outputs(name, again)[1] or ())):
            assert torch.equal(a, b), name
        del again
        ref = plain(*args, **kw)
        r_f = decoder_outputs(name, ref)[0]
        for a, b in zip(g_f, r_f):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel_err(a, b) <= TOL["float32"], name
        if g_i is not None:
            for a, b in zip(g_i, D.upscale_stats_plain(logits, kw["thr"],
                                                       kw["off"])):
                assert torch.equal(a, b), name
        r64 = decoder_outputs(name, plain(*_as_f64(args), **kw))[0]
        for i, (a, b, r) in enumerate(zip(g_f, r_f, r64)):
            err, err_plain = _rel_err64(a, r), _rel_err64(b, r)
            assert err <= F64_RATIO * err_plain, (name, i, err, err_plain)
        del got, ref, r64
        torch.cuda.empty_cache()


def test_decoder_f32_token_side_takes_the_f32_kind(cuda):
    """float32 B4 at SAM's widths: the token side's products and the
    hypernet MLPs' first two layers on the wgmma GEMM's f32 kind (19 + 2 M
    launches a call, by decoder_twt's own count), the hypernets' last
    layers (N = 32) on the FMA kernel."""
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.tools.main_path import decoder_cases
    (args, kw, _, _) = decoder_cases(torch.float32, cuda, B=2, H=16, W=16,
                                     T=7, M=3)["decode_masks"]
    D.decode_masks(*args, **kw)
    before = D.decoder_gemm_f32.launches
    D.decode_masks(*args, **kw)
    torch.cuda.synchronize()
    assert D.decoder_gemm_f32.launches - before == 19 + 2 * 3


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_decoder_other_widths_run_the_chain(cuda, dt):
    """bf16 and f32 at widths other than SAM's decoder (C = 128, 4 heads)
    take the chain of primitive kernels, held to the plain version; no
    fused kernel launches."""
    from ullsam_tpu_torch.core.config import MaskDecoderConfig
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.tools.main_path import (decoder_cases,
                                                  decoder_outputs)
    cfg = MaskDecoderConfig(transformer_dim=128, transformer_num_heads=4,
                            transformer_mlp_dim=256)
    cases = decoder_cases(getattr(torch, dt), cuda, B=2, H=16, W=16, T=7,
                          M=3, cfg=cfg)
    before = {k: c.launches for k, c in D.FUSED_KERNELS.items()}
    for name, (args, kw, _, _) in cases.items():
        got = getattr(D, name)(*args, **kw)
        ref = getattr(D, name + "_plain")(*args, **kw)
        torch.cuda.synchronize()
        g_f, g_i, logits = decoder_outputs(name, got)
        for a, b in zip(g_f, decoder_outputs(name, ref)[0]):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel_err(a, b) <= TOL[dt], name
        if g_i is not None:
            for a, b in zip(g_i, D.upscale_stats_plain(logits, kw["thr"],
                                                       kw["off"])):
                assert torch.equal(a, b), name
    assert {k: c.launches for k, c in D.FUSED_KERNELS.items()} == before


def test_wrappers_raise_on_unsupported_cuda_shapes(cuda):
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    q = torch.zeros(1, 96, 32, device="cuda")   # D != 64, N % 64 != 0
    rel = torch.zeros(1, 96, 8, device="cuda")
    with pytest.raises(ValueError):
        FA.vit_flash_attn(q, q, q, rel, rel[..., :12].contiguous())
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.tools.main_path import decoder_cases
    cases = decoder_cases(torch.float32, cuda, B=2, H=8, W=8, T=7, M=3)
    (w, src, pe, tokens), kw, _, _ = cases["decode_masks"]
    with pytest.raises(ValueError):       # 17 tokens
        D.decode_masks(w, src, pe, tokens.repeat(1, 3, 1)[:, :17], **kw)
    with pytest.raises(ValueError):       # 5 masks
        D.decode_masks(w, src, pe, tokens, **dict(kw, m_lo=0, M=5))
    (w, keys, hyper), kw, _, _ = cases["upscale_hypernet"]
    with pytest.raises(ValueError):       # hypernet width 16, not C / 8
        D.upscale_hypernet(w, keys, hyper[..., :16].contiguous(), **kw)


def test_small_model_on_card_matches_cpu(cuda):
    """A small image encoder (hd = 64, padded windows, a global block) from
    one set of weights: kernels on the card vs plain versions on the CPU."""
    from ullsam_tpu_torch.core.config import ViTConfig
    from ullsam_tpu_torch.models.sam.image_encoder import ImageEncoder
    from ullsam_tpu_torch.ops.layers import init_module_
    cfg = ViTConfig(img_size=256, patch_size=16, embed_dim=128, depth=3,
                    num_heads=2, out_chans=32, window_size=14,
                    global_attn_indexes=(1,))
    cpu = ImageEncoder(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init_module_(cpu, gen)
    gpu = ImageEncoder(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(1, 256, 256, 3, generator=gen)
    with torch.no_grad():
        ref = cpu(x)
        got = gpu(x.cuda())
    assert _rel_err(got.cpu(), ref) <= 1e-4


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_per_image_batch_runs_upscale_kernels(cuda, dt):
    """One embedding per prompt at SAM's decoder width: the module
    transformer, then B7 (``predict_masks_cols``) and B6
    (``predict_masks_cols_stats``), against the same decoder's plain
    ``predict_masks``; statistics exactly against the plain statistics of
    the kernel's own logits."""
    from ullsam_tpu_torch.core.config import MaskDecoderConfig
    from ullsam_tpu_torch.models.sam.mask_decoder import (MaskDecoder,
                                                          stats_from_kernel)
    from ullsam_tpu_torch.ops.kernels import decoder as D
    from ullsam_tpu_torch.ops.layers import init_module_
    dtype = getattr(torch, dt)
    cfg = MaskDecoderConfig()
    md = MaskDecoder(cfg, device="cuda")
    init_module_(md, cuda)
    md = md.to(dtype)

    def r(*shape):
        return torch.randn(*shape, generator=cuda, device="cuda").to(dtype)

    emb, dense, pe = r(2, 32, 32, 256), r(2, 32, 32, 256), r(1, 32, 32, 256)
    sparse = r(2, 2, 256)
    counts = {k.__name__: k.launches for k in D.KERNELS}
    with torch.no_grad():
        masks, iou = md.predict_masks_cols(emb, pe, sparse, dense, True)
        masks2, iou2, (stab, boxes) = md.predict_masks_cols_stats(
            emb, pe, sparse, dense, True, thr=0.0, off=1.0)
        ref, ref_iou = md.predict_masks(emb, pe, sparse, dense)
    torch.cuda.synchronize()
    assert {k.__name__: k.launches - counts[k.__name__]
            for k in D.KERNELS} == {
        "decode_masks": 0, "two_way_transformer": 0,
        "upscale_hypernet_stats": 1, "upscale_hypernet": 2}
    assert masks.shape == (2, 3, 128, 128)
    assert _rel_err(masks, ref[:, 1:]) <= TOL[dt]
    assert _rel_err(iou, ref_iou[:, 1:]) <= TOL[dt]
    assert torch.equal(iou, iou2)
    assert _rel_err(masks2, masks) <= TOL[dt]
    want = stats_from_kernel(*D.upscale_stats_plain(masks2, 0.0, 1.0))
    assert torch.equal(stab, want[0]) and torch.equal(boxes, want[1])


def _window_core_inputs(gen, dtype, Bw, ws, nh, hd=64):
    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * s).to(dtype)
    n, C = ws * ws, nh * hd
    return (r(Bw * n, 3 * C, s=0.5), r(ws, ws, hd, s=0.2),
            r(ws, ws, hd, s=0.2), r(Bw * n, C, s=0.5))


@pytest.mark.parametrize("dt,Bw,ws,nh,hd", [
    (dt, *shape) for shape in [(25, 14, 12, 64),   # ViT-B main path
                               (4, 8, 2, 64), (3, 5, 1, 64)]
    for dt in ("float32", "bfloat16")] + [
    ("bfloat16", 25, 14, 16, 80), ("float32", 25, 14, 16, 80)])   # ViT-H
def test_window_core_kernels_match_plain(cuda, dt, Bw, ws, nh, hd):
    """B3 and B8 against their plain versions (every output)."""
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    qkv, rh, rw, do = _window_core_inputs(cuda, getattr(torch, dt), Bw, ws,
                                          nh, hd)
    before = (WA.window_attn_core.launches, WA.window_attn_core_bwd.launches)
    o = WA.window_attn_core(qkv, rh, rw)
    grads = WA.window_attn_core_bwd(qkv, rh, rw, do)
    torch.cuda.synchronize()
    assert (WA.window_attn_core.launches,
            WA.window_attn_core_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert _rel_err(o, WA.window_attn_core_plain(qkv, rh, rw)) <= TOL[dt]
    for a, b in zip(grads, WA.window_attn_core_bwd_plain(qkv, rh, rw, do)):
        assert a.dtype == b.dtype and bool(torch.isfinite(a).all())
        assert _rel_err(a, b) <= TOL[dt]


@pytest.mark.parametrize("dt,nh,hd", [("bfloat16", 12, 64),
                                      ("bfloat16", 16, 80),
                                      ("float32", 12, 64),
                                      ("float32", 16, 80)])
def test_window_core_bwd_is_deterministic(cuda, dt, nh, hd):
    """B8 sums in a fixed order with no atomics: two calls on the same
    inputs give bitwise-equal dqkv, drh and drw (25 windows of 14x14)."""
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    args = _window_core_inputs(cuda, getattr(torch, dt), 25, 14, nh, hd)
    first = WA.window_attn_core_bwd(*args)
    second = WA.window_attn_core_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _rel_err64(got, ref):
    """max|got - ref| / max|ref| in float64."""
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.parametrize("nh,hd", [(12, 64), (16, 80)])   # ViT-B, ViT-H
def test_window_core_bwd_f32_error_vs_float64(cuda, nh, hd):
    """B8's float32 kernel (split TF32 on the tensor cores) against a
    float64 evaluation of its plain version at the main path's shapes (25
    windows of 14x14): on every output its max-relative error is at most
    4x the plain float32 version's own (cuBLAS, TF32 off)."""
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    args = _window_core_inputs(cuda, torch.float32, 25, 14, nh, hd)
    got = WA.window_attn_core_bwd(*args)
    plain = WA.window_attn_core_bwd_plain(*args)
    ref = WA.window_attn_core_bwd_plain(*(t.double() for t in args))
    torch.cuda.synchronize()
    for name, a, b, r in zip(("dqkv", "drh", "drw"), got, plain, ref):
        err, err_plain = _rel_err64(a, r), _rel_err64(b, r)
        assert err <= 4 * err_plain, (name, err, err_plain)


def _vit_flash_bwd_inputs(gen, dtype, BH, KH, KW, D):
    """B9's inputs: q, k, v, do [BH, N, D], rel_h, rel_w, lse from B2 and
    dd = sum(do * o)."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    N = KH * KW
    q, k, v, do = (torch.randn(BH, N, D, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    rh, rw = ((torch.randn(BH, N, K, generator=gen, device="cuda") * 0.5)
              .to(dtype) for K in (KH, KW))
    o, lse = FA.vit_flash_attn(q, k, v, rh, rw)
    dd = (do.float() * o.float()).sum(-1)
    return q, k, v, rh, rw, do, lse, dd


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,KH,KW,D", [
    (12, 64, 64, 64),    # the ViT-B global blocks
    (16, 64, 64, 80),    # ViT-H's
    (2, 16, 64, 64), (2, 32, 32, 80), (3, 8, 16, 64),
    (2, 8, 8, 80)])      # N = 64: one warpgroup of a bf16 block
def test_vit_flash_bwd_kernel_matches_plain(cuda, dt, BH, KH, KW, D):
    """B9 against its plain version on dq, dk, dv, drel_h and drel_w, with
    lse from B2 and dd = sum(do * o), at head dims 64 and 80 and every
    key-grid width whose whole rows a 64-key tile covers."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    args = _vit_flash_bwd_inputs(cuda, getattr(torch, dt), BH, KH, KW, D)
    before = FA.vit_flash_attn_bwd.launches
    got = FA.vit_flash_attn_bwd(*args)
    torch.cuda.synchronize()
    assert FA.vit_flash_attn_bwd.launches == before + 1
    ref = FA.vit_flash_attn_bwd_plain(*args)
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, ref):
        assert a.dtype == b.dtype and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= TOL[dt], (name, _rel_err(a, b))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,D", [(12, 64), (16, 80)])
def test_vit_flash_bwd_is_deterministic(cuda, dt, BH, D):
    """B9's two kernels sum in a fixed order with no atomics: two calls on
    the same inputs give bitwise-equal gradients (the global blocks' N =
    4096)."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    args = _vit_flash_bwd_inputs(cuda, getattr(torch, dt), BH, 64, 64, D)
    first = FA.vit_flash_attn_bwd(*args)
    second = FA.vit_flash_attn_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("BH,D", [(12, 64), (16, 80)])   # ViT-B, ViT-H
def test_vit_flash_bwd_f32_error_vs_float64(cuda, BH, D):
    """B9's float32 kernels (split TF32 on wgmma) against a float64
    evaluation of their plain version at the global blocks' shapes (N =
    4096, lse from B2): on every output the max-relative error is at most
    4x the plain float32 version's own (cuBLAS, TF32 off)."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    args = _vit_flash_bwd_inputs(cuda, torch.float32, BH, 64, 64, D)
    got = FA.vit_flash_attn_bwd(*args)
    plain = FA.vit_flash_attn_bwd_plain(*args)
    ref = FA.vit_flash_attn_bwd_plain(*(t.double() for t in args))
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for name, a, b, r in zip(names, got, plain, ref):
        err, err_plain = _rel_err64(a, r), _rel_err64(b, r)
        assert err <= 4 * err_plain, (name, err, err_plain)


@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("remat,want", [
    (False, [2, 2, 2, 1, 1]),   # B1, B3, B8, B2, B9
    (True, [0, 0, 0, 2, 1])])   # windows plain; B2 forward + recompute
def test_image_encoder_gradients_on_card_match_cpu(cuda, remat, want, hd):
    """A backward through a small ImageEncoder (2 heads of 64, or of 80 as
    ViT-H's; padded windows, a global block) gives the same gradients on
    the card (kernels) as on the CPU (plain versions), f32, for every
    parameter and the input, with and without remat."""
    from ullsam_tpu_torch.core.config import ViTConfig
    from ullsam_tpu_torch.models.sam.image_encoder import ImageEncoder
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    from ullsam_tpu_torch.ops.layers import init_module_
    cfg = ViTConfig(img_size=256, patch_size=16, embed_dim=2 * hd, depth=3,
                    num_heads=2, out_chans=32, window_size=14,
                    global_attn_indexes=(1,))
    cpu = ImageEncoder(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init_module_(cpu, gen)
    gpu = ImageEncoder(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(1, 256, 256, 3, generator=gen)
    w = torch.randn(1, 16, 16, 32, generator=gen)
    kernels = (VB.window_attn, WA.window_attn_core, WA.window_attn_core_bwd,
               FA.vit_flash_attn, FA.vit_flash_attn_bwd)
    before = [k.launches for k in kernels]
    xs = [x.clone().requires_grad_(), x.cuda().requires_grad_()]
    for m, xi in zip((cpu, gpu), xs):
        (m(xi, remat=remat) * w.to(xi.device)).sum().backward()
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == want
    assert _rel_err(xs[1].grad.cpu(), xs[0].grad) <= 1e-4
    for (name, a), b in zip(cpu.named_parameters(), gpu.parameters()):
        assert _rel_err(b.grad.cpu(), a.grad) <= 1e-4, name


def _llm_segments(B, S, kind):
    """(q_seg, kv_seg) [B, S] int32 on the card: "padded" left padding on
    row 0 and a second segment on row 1 (tests/test_kernels.py's);
    "packed" the sft path's row (1124 + 1224 tokens, 212 pad; boundaries
    off the 64-row tiles); "empty" a query segment no key has and a run of
    queries whose segment's keys all come later."""
    import numpy as np
    from ullsam_tpu_torch.tools.main_path import packed_segments
    if kind == "packed":
        seg = packed_segments((1124, 1224), S, B)
        return (torch.from_numpy(seg).cuda(),) * 2
    seg = np.ones((B, S), np.int32)
    seg[0, :50] = 0
    seg[-1, S * 2 // 3:] = 2
    q_seg, kv_seg = seg.copy(), seg.copy()
    if kind == "empty":
        q_seg[0, 60:70] = 7
        q_seg[-1, :40] = 3
        kv_seg[-1, 40:80] = 3
    return torch.from_numpy(q_seg).cuda(), torch.from_numpy(kv_seg).cuda()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,nh,nkv,D,kind", [
    (2, 300, 8, 4, 64, "padded"),     # the JAX kernel tests' shape
    (2, 300, 8, 8, 128, "padded"),    # group 1, ragged S at D = 128
    (1, 2560, 16, 8, 128, "packed"),  # the packed sft path
    (2, 130, 4, 1, 128, "empty"),     # group 4, rows with no valid key
    (1, 200, 8, 2, 64, "empty")])     # the same at D = 64
def test_llm_flash_kernels_match_plain(cuda, dt, causal, B, S, nh, nkv, D,
                                       kind):
    """B10 (o, lse) and B11 (dq, dk, dv) against their plain versions; rows
    with no valid key exactly o = 0, lse = -1e30 on both. TOL relative to
    max|plain|; in bf16 B11 sums dq by f32 atomics, whose order changes
    from run to run (a bf16 step at most, inside TOL)."""
    from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
    dtype = getattr(torch, dt)
    q, do = (torch.randn(B, S, nh, D, generator=cuda, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(B, S, nkv, D, generator=cuda, device="cuda")
            .to(dtype) for _ in range(2))
    q_seg, kv_seg = _llm_segments(B, S, kind)
    before = (LF.llm_flash_attn.launches, LF.llm_flash_attn_bwd.launches)
    o, lse = LF.llm_flash_attn(q, k, v, q_seg, kv_seg, nkv, causal)
    dd = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = LF.llm_flash_attn_bwd(q, k, v, q_seg, kv_seg, do, lse, dd, nkv,
                                causal)
    torch.cuda.synchronize()
    assert (LF.llm_flash_attn.launches, LF.llm_flash_attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ro, rlse = LF.llm_flash_attn_plain(q, k, v, q_seg, kv_seg, nkv, causal)
    live = rlse > LF.NEG_INF / 2
    assert torch.equal(lse > LF.NEG_INF / 2, live)
    assert bool((o.transpose(1, 2)[~live] == 0).all())
    assert _rel_err(o, ro) <= TOL[dt]
    assert _rel_err(lse[live], rlse[live]) <= 1e-5
    ref = LF.llm_flash_attn_bwd_plain(q, k, v, q_seg, kv_seg, do, lse, dd,
                                      nkv, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == b.dtype and bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= TOL[dt], (name, _rel_err(a, b))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,nh,nkv,D,kind", [
    (1, 2560, 16, 4, 128, "packed"),  # the sft row, groups of 4, D = 128
    (1, 2560, 16, 16, 64, "packed"),  # groups of 1, D = 64
    (2, 300, 8, 8, 128, "padded"),    # ragged S, groups of 1
    (2, 130, 4, 1, 64, "empty")])     # groups of 4, rows with no valid key
def test_llm_flash_f32_error_vs_float64(cuda, causal, B, S, nh, nkv, D,
                                        kind):
    """B10's and B11's float32 kernels (split TF32 on wgmma) against a
    float64 evaluation of their plain versions: on o, lse (the rows with a
    valid key), dq, dk and dv the max-relative error is at most 4x the
    plain float32 version's own (TF32 off); two calls of each give bitwise
    the same outputs (no atomics)."""
    from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
    q, do = (torch.randn(B, S, nh, D, generator=cuda, device="cuda")
             for _ in range(2))
    k, v = (torch.randn(B, S, nkv, D, generator=cuda, device="cuda")
            for _ in range(2))
    q_seg, kv_seg = _llm_segments(B, S, kind)
    fwd = [LF.llm_flash_attn(q, k, v, q_seg, kv_seg, nkv, causal)
           for _ in range(2)]
    o, lse = fwd[0]
    dd = (do * o).sum(-1).transpose(1, 2).contiguous()
    bwd = [LF.llm_flash_attn_bwd(q, k, v, q_seg, kv_seg, do, lse, dd, nkv,
                                 causal) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip((*fwd[0], *bwd[0]), (*fwd[1], *bwd[1])):
        assert torch.equal(a, b)
    args = (q, k, v, q_seg, kv_seg)
    plain = LF.llm_flash_attn_plain(*args, nkv, causal)
    ref = LF.llm_flash_attn_plain(q.double(), k.double(), v.double(), q_seg,
                                  kv_seg, nkv, causal)
    live = ref[1] > LF.NEG_INF / 2
    bargs = (q, k, v, q_seg, kv_seg, do, lse, dd)
    plain_b = LF.llm_flash_attn_bwd_plain(*bargs, nkv, causal)
    ref_b = LF.llm_flash_attn_bwd_plain(
        *(t.double() if t.is_floating_point() else t for t in bargs), nkv,
        causal)
    names = ("o", "lse", "dq", "dk", "dv")
    for name, a, b, r in zip(names, (o, lse[live], *bwd[0]),
                             (plain[0], plain[1][live], *plain_b),
                             (ref[0], ref[1][live], *ref_b)):
        err, err_plain = _rel_err64(a, r), _rel_err64(b, r)
        assert err <= 4 * err_plain, (name, err, err_plain)


def test_packed_llm_gradients_on_card_match_cpu(cuda, monkeypatch):
    """A small InternLM2 (head dim 128, GQA 2:1) over two packed rows with
    padding, through the flash route (``LLM_FLASH_MIN`` lowered so B10 /
    B11 run at S = 200) and with remat: the loss over valid rows and every
    weight gradient, f32, card kernels against CPU plain versions."""
    import numpy as np
    from ullsam_tpu_torch.core.config import InternLM2Config
    from ullsam_tpu_torch.models.internlm2 import model as M
    from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
    from ullsam_tpu_torch.ops.layers import init_module_
    monkeypatch.setattr(M, "LLM_FLASH_MIN", 1)
    cfg = InternLM2Config(vocab_size=96, hidden_size=256,
                          intermediate_size=256, num_hidden_layers=2,
                          num_attention_heads=2, num_key_value_heads=1)
    cpu = M.InternLM2ForCausalLM(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init_module_(cpu, gen)
    gpu = M.InternLM2ForCausalLM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 96, (2, 200)))
    seg = torch.zeros(2, 200, dtype=torch.long)
    seg[0, :90], seg[0, 90:170] = 1, 2
    seg[1, :130], seg[1, 130:] = 1, 2
    w = torch.randn(2, 200, 96, generator=gen) * (seg != 0)[..., None]
    before = (LF.llm_flash_attn.launches, LF.llm_flash_attn_bwd.launches)
    losses = []
    for m in (cpu, gpu):
        dev = next(m.parameters()).device
        out = M.internlm2_forward(m, cfg, input_ids=ids.to(dev),
                                  segment_ids=seg.to(dev), remat=True)
        loss = (out["logits"] * w.to(dev)).sum()
        loss.backward()
        losses.append(float(loss))
    torch.cuda.synchronize()
    # 2 layers: forward and the remat recompute, then one backward each
    assert (LF.llm_flash_attn.launches - before[0],
            LF.llm_flash_attn_bwd.launches - before[1]) == (4, 2)
    assert abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0])
    for (name, a), b in zip(cpu.named_parameters(), gpu.parameters()):
        assert _rel_err(b.grad.cpu(), a.grad) <= 1e-4, name


# B12's prefill shapes: M from just above the GEMV's 16 to the batch-8
# caption prompt, N and K of InternLM2-1.8B's layer linears (wqkv 4096 x
# 2048, wo 2048 x 2048, w1 / w3 8192 x 2048, w2 2048 x 8192) and beyond
_W8_PREFILL = [(M, N, K) for M in (17, 129, 1152, 9216)
               for N in (2048, 4096, 8192) for K in (2048, 8192)]
# the serving shapes: decode at 2-16 rows (the tensor-core body, split over
# K) and the engine's prompt segments (the wgmma GEMM split over K), at each
# linear of InternLM2-1.8B, the vocab head and the tp 2 ranks' own shapes
_W8_LINEARS = ((4096, 2048), (2048, 2048), (8192, 2048), (2048, 8192),
               (92553, 2048), (2048, 1024), (2048, 4096))
_W8_SERVE = [(M, N, K) for M in (2, 4, 8, 16, 128, 256)
             for N, K in _W8_LINEARS]


def _sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K", [
    (1, 8192, 2048),    # decode, w1 at batch 1
    (8, 2053, 8192),    # decode, batch 8, ragged N, K tiled in shared memory
    (3, 200, 48),       # K not a multiple of 32, N not of 8
    (1152, 4100, 2048),  # prefill (tensor cores in bf16), ragged N
    (40, 300, 80)] + _W8_PREFILL + _W8_SERVE)  # K % 32 == 16; layer shapes
def test_w8a16_kernel_matches_plain(cuda, dt, M, N, K):
    """B12 against its plain version: the f32 output within 1e-5 of
    max|plain| (exact products, only the summation order differs), with
    and without a bias; cast to x's dtype, with and without a bias, within
    one step of that dtype. Each call launches the kernel that
    ``w8a16_kernel`` names, by its own count: in bf16 at M > 16 with N %
    128 == 0 and K % 64 == 0 the wgmma GEMM (split-K where
    ``sm90_splits`` says), at 2 <= M <= 16 the decode body on the tensor
    cores (K split as ``decode_plan`` says); the library's own plan
    (``c_plan``) is the Python mirror's."""
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.tools.main_path import w8a16_case
    dtype = getattr(torch, dt)
    (x, q, s), _, _, _ = w8a16_case(dtype, cuda, M, N, K)
    bias = torch.randn(N, generator=cuda, device="cuda")
    name = Q.w8a16_kernel(M, N, K, dtype, _sms())
    if dt == "bfloat16" and M > 16 and N % 128 == 0:
        assert name == "w8a16_sm90"
    if dt == "bfloat16" and 2 <= M <= 16 and K % 64 == 0:
        assert name == "w8a16_decode_tc"
    assert Q.c_plan(M, N, K, dtype) == Q.plan(M, N, K, dtype, _sms())
    assert Q.c_workspace(M, N, K, dtype) == Q.workspace(M, N, K, dtype,
                                                        _sms())
    before = Q.w8a16_matmul.launches
    counts = {k: c.launches for k, c in Q.kernel_launches.items()}
    got = Q.w8a16_matmul(x, q, s)
    got_b = Q.w8a16_matmul(x, q, s, bias)
    got_cast = Q.w8a16_matmul(x, q, s, bias, out_dtype=dtype)
    got_cast0 = Q.w8a16_matmul(x, q, s, out_dtype=dtype)
    torch.cuda.synchronize()
    assert Q.w8a16_matmul.launches == before + 4
    assert {k: c.launches - counts[k] for k, c in Q.kernel_launches.items()
            } == {k: 4 * Q.call_launches(name).get(k, 0) for k in Q.KERNELS}
    assert got.dtype == torch.float32 and got_cast.dtype == dtype
    assert _rel_err(got, Q.w8a16_matmul_plain(x, q, s)) <= 1e-5
    assert _rel_err(got_b, Q.w8a16_matmul_plain(x, q, s, bias)) <= 1e-5
    # the cast is the kernel's own f32 result rounded once
    assert torch.equal(got_cast, got_b.to(dtype))
    assert torch.equal(got_cast0, got.to(dtype))
    for out, bb in ((got_cast, bias), (got_cast0, None)):
        ref = Q.w8a16_matmul_plain(x, q, s, bb, dtype)
        # one step of bf16 at max|plain| for the prefill and serving
        # shapes (two f32 sums that differ in their last bits may round to
        # neighbouring values), 2^-8 of it for the others as before
        top = float(ref.float().abs().max())
        step = (1e-5 * top if dtype == torch.float32
                else 2.0 ** (math.frexp(top)[1] - 8)
                if (M, N, K) in _W8_PREFILL + _W8_SERVE
                else 2.0 ** -8 * top)
        assert float((out.float() - ref.float()).abs().max()) <= step


@pytest.mark.parametrize("M,N,K", [
    (8, 2048, 2048), (8, 2048, 8192), (4, 2048, 1024), (16, 4096, 2048),
    (16, 2048, 8192), (12, 2048, 8192), (8, 92553, 2048),
    (256, 2048, 2048), (256, 4096, 2048), (128, 2048, 8192),
    (256, 2048, 1024)])
def test_w8a16_split_k_is_bitwise_and_replays(cuda, M, N, K):
    """B12 at the serving shapes that split K (the decode body's warps on a
    tile's K and, for w2 at 9-16 rows, its blocks; the wgmma GEMM's units:
    a fixed order of the partials, tile counters that reset themselves)
    and the head (no split): two calls are bitwise equal, and a CUDA graph
    of the call, replayed twice with no memset in between, is bitwise the
    eager call."""
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.tools.main_path import w8a16_case
    (x, q, s), _, _, _ = w8a16_case(torch.bfloat16, cuda, M, N, K)
    bias = torch.randn(N, generator=cuda, device="cuda")
    _, splits, warps = Q.plan(M, N, K, torch.bfloat16, _sms())
    if (M, N) != (8, 92553):
        assert splits > 1 or warps > 1
    a = Q.w8a16_matmul(x, q, s, bias, out_dtype=torch.bfloat16)
    b = Q.w8a16_matmul(x, q, s, bias, out_dtype=torch.bfloat16)
    f = Q.w8a16_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    graph = torch.cuda.CUDAGraph()
    before = Q.w8a16_matmul.launches
    with Q.uncounted(), torch.cuda.graph(graph):
        g = Q.w8a16_matmul(x, q, s, bias, out_dtype=torch.bfloat16)
        gf = Q.w8a16_matmul(x, q, s)
    assert Q.w8a16_matmul.launches == before
    for _ in range(2):
        g.zero_()
        gf.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g, a) and torch.equal(gf, f)
    assert torch.equal(Q.w8a16_matmul(x, q, s, bias,
                                      out_dtype=torch.bfloat16), a)


@pytest.mark.parametrize("M,N,K", [
    (2, 2048, 2048), (8, 2048, 8192), (16, 4096, 2048), (16, 92553, 2048),
    (256, 2048, 8192), (256, 4096, 2048), (200, 2048, 2048),
    (1152, 2048, 2048), (1152, 92553, 2048), (300, 4100, 2048),
    (17, 200, 64), (40, 136, 2048)])
def test_w8a16_f32_bodies_match_plain(cuda, M, N, K):
    """The f32-x bodies (x split exactly into three bf16 planes, each
    product on the bf16 tensor cores): the decode body at 2, 8 and 16 rows
    (K split across a block's warps, and at 8 and 16 rows across blocks;
    the ragged head), the wgmma GEMM at 200 and 256 rows (K split across
    units), at 1152 (none) and at a ragged N (the head; 4100, whose rows
    are not 16-byte aligned; 200 and 136, whose rows are, with a last tile
    past N). Each call launches its f32 kind (the wgmma GEMM after its
    pre-pass); the f32 output with a bias within 1e-5 of max|plain|, at
    most 4x the plain f32 version's error against float64, two calls
    bitwise equal, a CUDA graph's replay bitwise the eager call, and a call
    into a longer buffer leaves everything after its M x N floats as it
    was."""
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    from ullsam_tpu_torch.tools.main_path import w8a16_case
    (x, q, s), _, _, _ = w8a16_case(torch.float32, cuda, M, N, K)
    bias = torch.randn(N, generator=cuda, device="cuda")
    name, splits, warps = Q.plan(M, N, K, torch.float32, _sms())
    assert name == ("w8a16_decode_tc_f32" if M <= 16 else "w8a16_sm90_f32")
    assert Q.c_plan(M, N, K, torch.float32) == (name, splits, warps)
    assert Q.c_workspace(M, N, K, torch.float32) == Q.workspace(
        M, N, K, torch.float32, _sms())
    if M in (8, 16, 200, 256):
        assert splits > 1
    counts = {k: c.launches for k, c in Q.kernel_launches.items()}
    a = Q.w8a16_matmul(x, q, s, bias)
    b = Q.w8a16_matmul(x, q, s, bias)
    torch.cuda.synchronize()
    assert {k: c.launches - counts[k] for k, c in Q.kernel_launches.items()
            } == {k: 2 * Q.call_launches(name).get(k, 0) for k in Q.KERNELS}
    assert torch.equal(a, b)
    ref = Q.w8a16_matmul_plain(x, q, s, bias)
    assert _rel_err(a, ref) <= 1e-5
    ref64 = (x.double() @ q.double().t()) * s.double() + bias.double()
    top = float(ref64.abs().max())
    err = float((a.double() - ref64).abs().max()) / top
    err_plain = float((ref.double() - ref64).abs().max()) / top
    assert err <= 4 * err_plain, (err, err_plain)
    graph = torch.cuda.CUDAGraph()
    with Q.uncounted(), torch.cuda.graph(graph):
        g = Q.w8a16_matmul(x, q, s, bias)
    for _ in range(2):
        g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g, a)
    # the columns past N are dropped, not written into the next row or past
    # the end: the C entry into a buffer with a tail of sentinels
    n_ws, n_cnt = Q.workspace(M, N, K, torch.float32, _sms())
    ws = torch.empty(max(n_ws, 1), device="cuda")
    cnt = Q._counters(x.device, n_cnt) if n_cnt else None
    buf = torch.full((M * N + 4096,), 7.0, device="cuda")
    with Q.uncounted():
        err = Q._kernel()(0, x.data_ptr(), q.data_ptr(), s.data_ptr(),
                          bias.data_ptr(), buf.data_ptr(), 1, M, N, K,
                          ws.data_ptr(), n_ws,
                          0 if cnt is None else cnt.data_ptr(),
                          0 if cnt is None else cnt.numel(),
                          torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(buf[:M * N].view(M, N), a)
    assert bool((buf[M * N:] == 7.0).all())


def test_w8a16_wrapper_refusals(cuda):
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    x = torch.randn(2, 64, device="cuda")
    q = torch.randint(-127, 128, (32, 64), device="cuda", dtype=torch.int8)
    s = torch.rand(32, device="cuda")
    before = Q.w8a16_matmul.launches
    with pytest.raises(ValueError):       # qweight not contiguous
        Q.w8a16_matmul(x, q.t().contiguous().t(), s)
    with pytest.raises(ValueError):       # K = 40, not a multiple of 16
        Q.w8a16_matmul(x[:, :40].contiguous(), q[:, :40].contiguous(), s)
    with pytest.raises(ValueError):       # qscale on the CPU
        Q.w8a16_matmul(x, q, s.cpu())
    with pytest.raises(ValueError):       # float16 x
        Q.w8a16_matmul(x.half(), q, s)
    assert Q.w8a16_matmul.launches == before


def test_quant_linear_checks_x_on_each_call(cuda):
    """A ``QuantLinear`` on the card launches B12 for a good x and raises
    for an x of another dtype or K, and after a ``.to(dtype)`` of the
    module cast its f32 scales."""
    from ullsam_tpu_torch.ops import layers as L
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    q = torch.randint(-127, 128, (32, 64), device="cuda", dtype=torch.int8)
    lin = L.QuantLinear(q, torch.rand(32, device="cuda"))
    x = torch.randn(2, 3, 64, device="cuda")
    before = Q.w8a16_matmul.launches
    y = lin(x)
    assert Q.w8a16_matmul.launches == before + 1
    assert _rel_err(y, Q.w8a16_matmul_plain(
        x.reshape(6, 64), q, lin.qscale).reshape(2, 3, 32)) <= 1e-5
    for bad in (x.half(), x[..., :48].contiguous()):
        with pytest.raises(ValueError):
            lin(bad)
    lin.to(torch.bfloat16)
    with pytest.raises(ValueError):
        lin(x.bfloat16())
    assert Q.w8a16_matmul.launches == before + 1


def test_quantized_caption_on_card_matches_cpu(cuda):
    """A small uLLSAM (LLM hidden 64, MLP 128) with its LLM quantized on
    each device, f32: ``caption_ids`` with an image gives the same int8
    weights, the same 12 greedy tokens on the card (B12 in every linear) as
    on the CPU (plain versions), each step's logits within 1e-4 of their
    max."""
    import numpy as np
    from ullsam_tpu_torch.core.config import (FusionConfig, InternLM2Config,
                                              MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.internlm2.quant import quantize_llm_int8
    from ullsam_tpu_torch.models.ullsam import chat
    from ullsam_tpu_torch.models.ullsam import fusion as F
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    cfg = FusionConfig(
        sam=SamConfig(
            vit=ViTConfig(img_size=256, patch_size=16, embed_dim=128,
                          depth=3, num_heads=2, out_chans=64, window_size=14,
                          global_attn_indexes=(1,)),
            prompt_encoder=PromptEncoderConfig(
                embed_dim=64, image_embedding_size=(16, 16),
                input_image_size=(256, 256)),
            mask_decoder=MaskDecoderConfig(transformer_dim=64,
                                           transformer_mlp_dim=128,
                                           transformer_num_heads=2,
                                           iou_head_hidden_dim=32)),
        llm=InternLM2Config(vocab_size=128, hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2),
        vit_feature_dim=64, img_context_token_id=100)
    cpu = F.build_ullsam(cfg, device="cpu", seed=0)
    gpu = F.ULLSAM(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    for m in (cpu, gpu):
        quantize_llm_int8(m.fusion.language_model)
    for (name, a), b in zip(cpu.state_dict().items(),
                            gpu.state_dict().values()):
        if name.endswith("qweight"):
            assert torch.equal(a, b.cpu()), name
    rng = np.random.default_rng(0)
    rows = [[1, 11] + [100] * cfg.num_image_token + [7] * n for n in (6, 9)]
    ids, mask = chat.left_pad(rows, 0)
    pixels = rng.standard_normal((1, 256, 256, 3)).astype(np.float32)
    gen = GenerationConfig(max_new_tokens=12, eos_token_id=-1)
    res = []
    for m in (cpu, gpu):
        logits = []
        toks, lens = chat.caption_ids(
            m, cfg, pixels, ids, mask, gen,
            step_hook=lambda i, lg: logits.append(lg.float().cpu()))
        res.append((toks.cpu(), lens.cpu(), logits))
    before = Q.w8a16_matmul.launches
    chat.caption_ids(gpu, cfg, pixels, ids, mask, gen)
    torch.cuda.synchronize()
    # 11 linears (2 layers x 5 + the head) in the prefill and 11 decode steps
    assert Q.w8a16_matmul.launches - before == 11 * 12
    assert torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1],
                                                             res[1][1])
    for a, b in zip(res[0][2], res[1][2]):
        assert _rel_err(b, a) <= 1e-4


# ---------------------------------------------------------------------------
# SAM ViT-H: head dim 80 in B1-B3, and the opt-in kernels B13, B14, B15
# ---------------------------------------------------------------------------

def _vit_h_kernels():
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    return {"window_attn": (VB.window_attn, VB.window_attn_plain),
            "vit_flash_attn": (FA.vit_flash_attn, FA.vit_flash_attn_plain),
            "window_attn_core": (WA.window_attn_core,
                                 WA.window_attn_core_plain),
            "ln_mlp": (VB.ln_mlp, VB.ln_mlp_plain),
            "vit_flash_attn_packed": (FA.vit_flash_attn_packed,
                                      FA.vit_flash_attn_packed_plain),
            "window_attn_core_twophase": (WA.window_attn_core_twophase,
                                          WA.window_attn_core_twophase_plain)}


def _vit_h_case(name, width, dtype, gen):
    """(args, kwargs) of kernel ``name`` at the main path's shapes of SAM
    ``width`` ("vit_h": 16 heads of 80; "vit_b": 12 of 64)."""
    from ullsam_tpu_torch.tools import main_path as MP
    w = MP.VIT_H if width == "vit_h" else MP.VIT_B
    if name in ("window_attn_core", "window_attn_core_twophase"):
        fwd, _, _, _ = MP.window_core_case(dtype, gen, nh=w["nh"],
                                           hd=w["C"] // w["nh"])
        return fwd, {}
    case = {"window_attn": MP.window_attn_case,
            "vit_flash_attn": MP.vit_flash_case, "ln_mlp": MP.ln_mlp_case,
            "vit_flash_attn_packed": MP.vit_flash_packed_case}[name]
    args, kw, _, _ = case(dtype, gen, **w)
    return args, kw


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,width", [
    ("window_attn", "vit_h"), ("vit_flash_attn", "vit_h"),
    ("window_attn_core", "vit_h"), ("ln_mlp", "vit_h"),
    ("vit_flash_attn_packed", "vit_h"), ("window_attn_core_twophase", "vit_h"),
    ("ln_mlp", "vit_b"), ("vit_flash_attn_packed", "vit_b"),
    ("window_attn_core_twophase", "vit_b")])
def test_vit_h_kernels_match_plain(cuda, dt, name, width):
    """B1, B2, B3 at head dim 80 and B13, B14, B15 at ViT-H's (and
    ViT-B's) main-path shapes against their plain versions, every output;
    each call launches its kernel once."""
    kernel, plain = _vit_h_kernels()[name]
    args, kw = _vit_h_case(name, width, getattr(torch, dt), cuda)
    before = kernel.launches
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert _rel_err(a, b) <= TOL[dt]


def test_vit_h_wrappers_refuse_unsupported(cuda):
    """On the card the wrappers raise for what their kernels do not take,
    with no fallback: head dim 96 in B1, B2, B3, B14, B15 and B8; C % 32
    in B13; float32 B8 at head dim 80 on 16x16 windows (its k, v and dv
    need more shared memory than a block has) and B9 at head dim 96; windows
    wider than 16 in bfloat16 B8, and in B3 and B15 in both dtypes (the one
    window core of each dtype); and a
    ``QuantLinear`` made on the CPU at a width B12 does not take (K = 72)
    raises on its first call after ``.to("cuda")``."""
    from ullsam_tpu_torch.ops import layers as L
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    z = lambda *s: torch.zeros(*s, device="cuda")  # noqa: E731
    C, ws = 192, 8
    with pytest.raises(ValueError):
        VB.window_attn(z(2, 64, C), z(C), z(C), z(3 * C, C), z(3 * C),
                       z(C, C), z(C), z(ws, ws, 96), z(ws, ws, 96),
                       num_heads=2, eps=1e-6, nwx=1, nwy=1, Hv=8, Wv=8,
                       masked=False)
    with pytest.raises(ValueError):
        FA.vit_flash_attn(z(2, 1024, 96), z(2, 1024, 96), z(2, 1024, 96),
                          z(2, 1024, 32), z(2, 1024, 32))
    for core in (WA.window_attn_core, WA.window_attn_core_twophase):
        with pytest.raises(ValueError):
            core(z(128, 3 * C), z(ws, ws, 96), z(ws, ws, 96))
    with pytest.raises(ValueError):
        FA.vit_flash_attn_packed(z(1, 1024, 3 * C), z(2, 1024, 32),
                                 z(2, 1024, 32), 2)
    with pytest.raises(ValueError):
        VB.ln_mlp(z(256, 40), z(40), z(40), z(160, 40), z(160), z(40, 160),
                  z(40), eps=1e-6)
    with pytest.raises(ValueError):       # float32 B8, hd 80, 16x16
        WA.window_attn_core_bwd(z(256, 480), z(16, 16, 80), z(16, 16, 80),
                                z(256, 160))
    b = lambda *s: z(*s).to(torch.bfloat16)  # noqa: E731
    with pytest.raises(ValueError):       # bfloat16 B8 at head dim 96
        WA.window_attn_core_bwd(b(128, 3 * C), b(ws, ws, 96), b(ws, ws, 96),
                                b(128, C))
    with pytest.raises(ValueError):       # bfloat16 B8, 4x32 windows
        WA.window_attn_core_bwd(b(128, 3 * C), b(4, 4, 64), b(32, 32, 64),
                                b(128, C))
    for core in (WA.window_attn_core, WA.window_attn_core_twophase):
        with pytest.raises(ValueError):   # the bf16 core, 4x32 windows
            core(b(128, 3 * C), b(4, 4, 64), b(32, 32, 64))
        with pytest.raises(ValueError):   # the f32 core, 4x32 windows
            core(z(128, 3 * C), z(4, 4, 64), z(32, 32, 64))
    q = z(2, 1024, 96)
    with pytest.raises(ValueError):
        FA.vit_flash_attn_bwd(q, q, q, z(2, 1024, 32), z(2, 1024, 32), q,
                              z(2, 1024), z(2, 1024))
    lin = L.QuantLinear(torch.randint(-127, 128, (8, 72), dtype=torch.int8),
                        torch.rand(8))
    lin(torch.randn(2, 72))  # the CPU takes any width
    lin.to("cuda")
    with pytest.raises(ValueError):
        lin(torch.randn(2, 72, device="cuda"))


@pytest.mark.parametrize("route", ["default", "fused_mlp", "packed_global",
                                   "unfused_window", "unfused_twophase"])
def test_hd80_encoder_on_card_matches_cpu(cuda, monkeypatch, route):
    """A small encoder with head dim 80 that every route's gate takes (8
    heads, C = 640, a 32x32 grid in padded 14x14 windows, a windowed and a
    global block) from one set of weights, under each route setting of the
    JAX package's switches: kernels on the card against plain versions on
    the CPU, f32, with exactly the route's launches."""
    from ullsam_tpu_torch.core.config import ViTConfig
    from ullsam_tpu_torch.models.sam.image_encoder import ImageEncoder
    from ullsam_tpu_torch.ops.layers import init_module_
    from ullsam_tpu_torch.tools.main_path import (SWITCHES, VIT_H_ROUTES,
                                                  route_launches)
    env = VIT_H_ROUTES[route]
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = ViTConfig(img_size=512, patch_size=16, embed_dim=640, depth=2,
                    num_heads=8, out_chans=64, window_size=14,
                    global_attn_indexes=(1,))
    cpu = ImageEncoder(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init_module_(cpu, gen)
    gpu = ImageEncoder(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(1, 512, 512, 3, generator=gen)
    kernels = {k: v[0] for k, v in _vit_h_kernels().items()}
    before = {k: f.launches for k, f in kernels.items()}
    with torch.no_grad():
        ref = cpu(x)
        got = gpu(x.cuda())
    torch.cuda.synchronize()
    d = {k: f.launches - before[k] for k, f in kernels.items()
         if f.launches != before[k]}
    assert d == route_launches(env, 1, 1)
    assert _rel_err(got.cpu(), ref) <= 1e-4


@pytest.mark.parametrize("hd", [64, 80])
def test_packed_global_gradients_on_card_match_cpu(cuda, monkeypatch, hd):
    """B14's backward (split into heads, B9, repack) on the card against the
    CPU's plain versions: a global block's attention at head dims 64 and 80
    (ViT-H's) over a 32x32 grid, f32, x's and every parameter's
    gradient."""
    from ullsam_tpu_torch.core.config import ViTConfig
    from ullsam_tpu_torch.models.sam.image_encoder import Block
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.layers import init_module_
    monkeypatch.setenv("ULLSAM_PACKED_GLOBAL", "1")
    cfg = ViTConfig(img_size=512, patch_size=16, embed_dim=2 * hd, depth=1,
                    num_heads=2, window_size=0, global_attn_indexes=(0,))
    cpu = Block(cfg, 0, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    init_module_(cpu, gen)
    gpu = Block(cfg, 0, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(1, 32, 32, 2 * hd, generator=gen)
    xs = [x.clone().requires_grad_(), x.cuda().requires_grad_()]
    before = (FA.vit_flash_attn_packed.launches,
              FA.vit_flash_attn_bwd.launches)
    for m, xi in zip((cpu, gpu), xs):
        (m.global_attention(xi) ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (FA.vit_flash_attn_packed.launches - before[0],
            FA.vit_flash_attn_bwd.launches - before[1]) == (1, 1)
    assert _rel_err(xs[1].grad.cpu(), xs[0].grad) <= 1e-4
    for (name, a), b in zip(cpu.attn.named_parameters(),
                            gpu.attn.parameters()):
        assert _rel_err(b.grad.cpu(), a.grad) <= 1e-4, name


# ---------------------------------------------------------------------------
# the wgmma + TMA GEMM of B1's and B13's products, and the one bf16 window
# core that B1, B3 and B15 share
# ---------------------------------------------------------------------------

# (N, K) of each bf16 product: B1's qkv and proj and B13's fc1 and fc2 at
# SAM ViT-H (C 1280, F 5120), B1's qkv and proj at ViT-B (C 768)
_PRODUCTS = [(3840, 1280), (1280, 1280), (5120, 1280), (1280, 5120),
             (2304, 768), (768, 768)]


@pytest.mark.parametrize("M", [4900, 4096, 257])
@pytest.mark.parametrize("N,K", _PRODUCTS)
def test_gemm_sm90_matches_plain(cuda, M, N, K):
    """The wgmma GEMM against its f32 plain product at every bf16 product
    shape of B1 and B13, M a windowed block's 4900 rows, a global block's
    4096 and a ragged 257, with each epilogue (bias; bias + tanh-GELU;
    bias + residual); every call launches the wgmma kernel once."""
    from ullsam_tpu_torch.ops.kernels import gemm as G

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=cuda, device="cuda")
                * s).to(torch.bfloat16)

    a, w, b, res = r(M, K), r(N, K, s=K ** -0.5), r(N, s=0.1), r(M, N)
    assert G.gemm_kernel(M, N, K) == "gemm_sm90"
    for bias, rr, act in ((b, None, "none"), (b, None, "gelu_tanh"),
                          (b, res, "none")):
        before = (G.gemm_sm90.launches, G.gemm_mma.launches)
        got = G.gemm_bf16(a, w, bias, rr, act)
        torch.cuda.synchronize()
        assert (G.gemm_sm90.launches, G.gemm_mma.launches) == (
            before[0] + 1, before[1])
        ref = G.gemm_plain(a, w, bias, rr, act)
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
        assert _rel_err(got, ref) <= TOL["bfloat16"]


def test_gemm_dispatch_takes_mma_off_the_sm90_shapes(cuda):
    """Shapes the wgmma kernel does not take (N % 128, K % 64) run the
    mma.sync kernel, by its own count, and agree with the plain product."""
    from ullsam_tpu_torch.ops.kernels import gemm as G
    for M, N, K in ((300, 200, 96), (64, 136, 64)):
        a = torch.randn(M, K, generator=cuda, device="cuda").bfloat16()
        w = torch.randn(N, K, generator=cuda, device="cuda").bfloat16()
        assert G.gemm_kernel(M, N, K) == "gemm_mma"
        before = (G.gemm_sm90.launches, G.gemm_mma.launches)
        got = G.gemm_bf16(a, w)
        torch.cuda.synchronize()
        assert (G.gemm_sm90.launches, G.gemm_mma.launches) == (
            before[0], before[1] + 1)
        assert _rel_err(got, G.gemm_plain(a, w)) <= TOL["bfloat16"]


@pytest.mark.parametrize("name,width", [("window_attn", "vit_b"),
                                        ("window_attn", "vit_h"),
                                        ("ln_mlp", "vit_h")])
def test_b1_b13_products_take_the_sm90_gemm(cuda, name, width):
    """In bf16 each of B1's two products (qkv, proj) and B13's two (fc1,
    fc2) launches the wgmma kernel, none the mma.sync one."""
    from ullsam_tpu_torch.ops.kernels import gemm as G
    kernel, plain = _vit_h_kernels()[name]
    args, kw = _vit_h_case(name, width, torch.bfloat16, cuda)
    before = (G.gemm_sm90.launches, G.gemm_mma.launches)
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert (G.gemm_sm90.launches, G.gemm_mma.launches) == (before[0] + 2,
                                                           before[1])
    assert _rel_err(got, plain(*args, **kw)) <= TOL["bfloat16"]


@pytest.mark.parametrize("Bw,ws,nh,hd", [(25, 14, 12, 64), (25, 14, 16, 80),
                                         (4, 8, 2, 64), (3, 5, 2, 80),
                                         (2, 16, 2, 80)])
def test_b3_and_b15_bf16_are_one_core(cuda, Bw, ws, nh, hd):
    """B3 and B15 launch the one bf16 window core: bitwise-equal outputs,
    both within the bf16 tolerance of the plain version (the JAX
    kernels' rounding points)."""
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    qkv, rh, rw, _ = _window_core_inputs(cuda, torch.bfloat16, Bw, ws, nh,
                                         hd)
    b3 = WA.window_attn_core(qkv, rh, rw)
    b15 = WA.window_attn_core_twophase(qkv, rh, rw)
    torch.cuda.synchronize()
    assert torch.equal(b3, b15)
    assert _rel_err(b3, WA.window_attn_core_plain(qkv, rh, rw)) <= TOL[
        "bfloat16"]


# ---------------------------------------------------------------------------
# float32 B1, B3, B13 and B15 on the tensor cores in split TF32: the wgmma
# GEMM's f32 kind and the one f32 window core
# ---------------------------------------------------------------------------

# each f32 output against a float64 evaluation of its plain version: at
# most F64_RATIO x the plain f32 version's own error (cuBLAS, TF32 off)
F64_RATIO = 4.0


def _f32_counts():
    from ullsam_tpu_torch.ops.kernels import gemm as G
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    return (G.gemm_sm90_f32.launches, G.gemm_fma.launches,
            WA.window_core_f32.launches, G.gemm_sm90.launches)


@pytest.mark.parametrize("M", [4900, 257])
@pytest.mark.parametrize("N,K", _PRODUCTS)
def test_gemm_f32_error_vs_float64(cuda, M, N, K):
    """The f32 kind of the wgmma GEMM (split TF32) at every product shape
    of B1 and B13 at ViT-B and ViT-H (fc2: K = 5120, 640 steps of 8), M a
    windowed block's 4900 rows and a ragged 257, with each epilogue:
    against float64 within 4x the plain f32 version's error, one launch of
    the kernel (none of the FMA kernel), two calls bitwise equal."""
    from ullsam_tpu_torch.ops.kernels import gemm as G

    def r(*shape, s=1.0):
        return torch.randn(*shape, generator=cuda, device="cuda") * s

    a, w, b, res = r(M, K), r(N, K, s=K ** -0.5), r(N, s=0.1), r(M, N)
    assert G.gemm_kernel(M, N, K, torch.float32) == "gemm_sm90_f32"
    for bias, rr, act in ((b, None, "none"), (b, None, "gelu_tanh"),
                          (b, res, "none")):
        before = _f32_counts()
        got = G.gemm_f32(a, w, bias, rr, act)
        again = G.gemm_f32(a, w, bias, rr, act)
        torch.cuda.synchronize()
        d = [x - y for x, y in zip(_f32_counts(), before)]
        assert d == [2, 0, 0, 0]
        assert torch.equal(got, again)
        plain = G.gemm_plain(a, w, bias, rr, act)
        ref = G.gemm_plain(*(None if t is None else t.double()
                             for t in (a, w, bias, rr)), act)
        err, err_plain = _rel_err64(got, ref), _rel_err64(plain, ref)
        assert err <= F64_RATIO * err_plain, (act, err, err_plain)


def test_gemm_f32_dispatch_takes_fma_off_the_sm90_shapes(cuda):
    """Float32 shapes the wgmma kernel does not take (N % 128, K % 64) run
    gemm.cuh's FMA kernel, by its own count, and agree with plain."""
    from ullsam_tpu_torch.ops.kernels import gemm as G
    for M, N, K in ((300, 200, 96), (64, 136, 64), (40, 128, 32)):
        a = torch.randn(M, K, generator=cuda, device="cuda")
        w = torch.randn(N, K, generator=cuda, device="cuda")
        assert G.gemm_kernel(M, N, K, torch.float32) == "gemm_fma"
        before = _f32_counts()
        got = G.gemm_f32(a, w)
        torch.cuda.synchronize()
        assert [x - y for x, y in zip(_f32_counts(), before)] == [0, 1, 0, 0]
        assert _rel_err(got, G.gemm_plain(a, w)) <= TOL["float32"]


# the launches of one f32 call of each kernel at SAM widths: (gemm_sm90_f32,
# gemm_fma, window_core_f32, gemm_sm90)
_F32_LAUNCHES = {"window_attn": [2, 0, 1, 0], "window_attn_core": [0, 0, 1, 0],
                 "window_attn_core_twophase": [0, 0, 1, 0],
                 "ln_mlp": [2, 0, 0, 0]}


@pytest.mark.parametrize("width", ["vit_b", "vit_h"])
@pytest.mark.parametrize("name", ["window_attn", "window_attn_core",
                                  "window_attn_core_twophase", "ln_mlp"])
def test_f32_vit_kernels_error_vs_float64(cuda, name, width):
    """Float32 B1, B3, B15 and B13 at the main path's shapes of ViT-B and
    ViT-H (B13 at a windowed block's 4900 rows): every product on the new
    split-TF32 kernels (the wgmma GEMM's f32 kind, the one f32 window core;
    no FMA GEMM), the output within 4x the plain f32 version's error
    against a float64 evaluation of the plain version, two calls bitwise
    equal."""
    kernel, plain = _vit_h_kernels()[name]
    args, kw = _vit_h_case(name, width, torch.float32, cuda)
    before = _f32_counts()
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    d = [x - y for x, y in zip(_f32_counts(), before)]
    assert d == [2 * c for c in _F32_LAUNCHES[name]], d
    assert torch.equal(got, again)
    ref = plain(*(t.double() if isinstance(t, torch.Tensor) else t
                  for t in args), **kw)
    err = _rel_err64(got, ref)
    err_plain = _rel_err64(plain(*args, **kw), ref)
    assert err <= F64_RATIO * err_plain, (err, err_plain)


@pytest.mark.parametrize("Bw,ws,nh,hd", [(4, 8, 2, 64), (3, 5, 2, 80),
                                         (2, 16, 2, 80), (3, 4, 2, 64),
                                         (2, 2, 2, 64), (2, 12, 2, 80)])
def test_b3_and_b15_f32_are_one_core(cuda, Bw, ws, nh, hd):
    """In float32 B3 and B15 launch the one f32 window core, at every
    instance's slot rows (2, 4, 8, 16, and windows of 5 and 12 rows in the
    8- and 14-row instances): bitwise-equal outputs within 1e-4 of the
    plain version."""
    from ullsam_tpu_torch.ops.kernels import window_attention as WA
    qkv, rh, rw, _ = _window_core_inputs(cuda, torch.float32, Bw, ws, nh, hd)
    before = WA.window_core_f32.launches
    b3 = WA.window_attn_core(qkv, rh, rw)
    b15 = WA.window_attn_core_twophase(qkv, rh, rw)
    torch.cuda.synchronize()
    assert WA.window_core_f32.launches == before + 2
    assert torch.equal(b3, b15)
    assert _rel_err(b3, WA.window_attn_core_plain(qkv, rh, rw)) <= TOL[
        "float32"]


@pytest.mark.parametrize("name,width", [("window_attn", "vit_b"),
                                        ("window_attn", "vit_h"),
                                        ("window_attn_core", "vit_h"),
                                        ("ln_mlp", "vit_h")])
def test_bf16_vit_kernels_take_no_f32_kernel(cuda, name, width):
    """Bfloat16 B1, B3 and B13 launch only their bf16 kernels (B1 and B13
    two wgmma GEMMs; none of the f32 kinds or the f32 core) and two calls
    are bitwise equal."""
    kernel, plain = _vit_h_kernels()[name]
    args, kw = _vit_h_case(name, width, torch.bfloat16, cuda)
    before = _f32_counts()
    got = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    d = [x - y for x, y in zip(_f32_counts(), before)]
    assert d == [0, 0, 0, 0 if name == "window_attn_core" else 4]
    assert torch.equal(got, again)
    assert _rel_err(got, plain(*args, **kw)) <= TOL["bfloat16"]


# ---------------------------------------------------------------------------
# the serving engine: decode chunks as captured CUDA graphs
# ---------------------------------------------------------------------------

_SPECIAL = {"<|im_end|>": 92542, "<|im_start|>": 92543, "<img>": 92544,
            "</img>": 92545, "<IMG_CONTEXT>": 92546}


class _StubTokenizer:
    """One id per character after a BOS of 1, the chat template's special
    tokens at their real ids, pad 2 (the tokenizer asset is not in the
    repository)."""
    pad_token_id = 2

    def encode(self, text):
        import re
        ids, pos = [1], 0
        for m in re.finditer("|".join(map(re.escape, _SPECIAL)), text):
            ids += [3 + ord(c) % 90000 for c in text[pos:m.start()]]
            ids.append(_SPECIAL[m.group()])
            pos = m.end()
        return ids + [3 + ord(c) % 90000 for c in text[pos:]]

    def decode(self, ids):
        return "".join(chr(i - 3) for i in ids
                       if 3 <= i < 90003 and not 0xD800 <= i - 3 < 0xE000)

    def convert_tokens_to_ids(self, token):
        return _SPECIAL[token]


def _serve_model():
    """A small uLLSAM on the card (the kernels' ViT: hd 64, 14x14 windows,
    one global block) with a 2-layer LLM of hidden 64 and the deployed
    vocab, f32, and a 256x256 uint8 image."""
    import numpy as np
    from ullsam_tpu_torch.core.config import (FusionConfig, InternLM2Config,
                                              MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    from ullsam_tpu_torch.models.ullsam import fusion as F
    cfg = FusionConfig(
        sam=SamConfig(
            vit=ViTConfig(img_size=256, patch_size=16, embed_dim=128,
                          depth=3, num_heads=2, out_chans=64, window_size=14,
                          global_attn_indexes=(1,)),
            prompt_encoder=PromptEncoderConfig(
                embed_dim=64, image_embedding_size=(16, 16),
                input_image_size=(256, 256)),
            mask_decoder=MaskDecoderConfig(transformer_dim=64,
                                           transformer_mlp_dim=128,
                                           transformer_num_heads=2,
                                           iou_head_hidden_dim=32)),
        llm=InternLM2Config(vocab_size=92553, hidden_size=64,
                            intermediate_size=128, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2),
        vit_feature_dim=64)
    img = np.random.default_rng(0).integers(0, 256, (1, 256, 256, 3),
                                            dtype=np.uint8)
    return cfg, F.build_ullsam(cfg, device="cuda", seed=0), img


def _serve_engine(cfg, model, **kw):
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.serve.engine import GenerationEngine
    return GenerationEngine(model, cfg, _StubTokenizer(), max_batch=2,
                            max_len=512, cache_dtype=torch.float32,
                            gen=GenerationConfig(max_new_tokens=12),
                            prefill_chunk=128, device="cuda", **kw)


def test_serve_engine_graphs_match_generate(cuda):
    """f32 engine on the card, decode chunks replayed from captured graphs:
    3 greedy requests (2 with the uint8 image) into 2 slots give exactly
    the batch-1 ``caption_ids`` tokens of their prompts."""
    import numpy as np
    from ullsam_tpu_torch.models.internlm2.generate import GenerationConfig
    from ullsam_tpu_torch.models.ullsam import chat
    cfg, model, img = _serve_model()
    eng = _serve_engine(cfg, model)
    try:
        prompts = [(eng.prompt_ids(q, im), img if im else None)
                   for q, im in (("Describe.", True), ("Hi?", False),
                                 ("Count the cells. " * 8, True))]
        reqs = [eng.submit_ids(ids, pv, 12) for ids, pv in prompts]
        assert all(r.event.wait(120) and r.error is None for r in reqs)
    finally:
        eng.shutdown()
    assert eng.graphs and sum(eng.replays.values()) > 0
    gen = GenerationConfig(max_new_tokens=12, eos_token_id=92542,
                           pad_token_id=2)
    for r, (ids, pv) in zip(reqs, prompts):
        pixels = None if pv is None else pv.astype(np.float32) / 255
        toks, lens = chat.caption_ids(model, cfg, pixels,
                                      *chat.left_pad([ids], 2), gen)
        assert r.tokens == toks[0, :int(lens[0])].tolist()


def test_serve_engine_int8_counts_b12_per_step(cuda):
    """``quant="int8"``: every captured key's warm-up launches B12 11 times
    a decode step (2 layers x 5 linears + the head), the model's own LLM
    stays unquantized, and the wrapper counts only launches that ran: the
    prompt's segments (10 each, the head once on the last) and the
    warm-ups, not the captures, which record the same launches."""
    from ullsam_tpu_torch.ops import layers as L
    from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
    cfg, model, _ = _serve_model()
    eng = _serve_engine(cfg, model, quant="int8")
    before = Q.w8a16_matmul.launches
    try:
        ids = eng.prompt_ids("Hi?", False)
        r = eng.submit_ids(ids, None, 12)
        assert r.event.wait(120) and r.error is None
    finally:
        eng.shutdown()
    assert eng.step_launches and set(eng.step_launches.values()) == {11.0}
    segments = -(-len(ids) // 128)
    warm = sum(11 * key[0] for key in eng.graphs)
    assert Q.w8a16_matmul.launches - before == 10 * segments + 1 + warm
    assert isinstance(eng.lm.output, L.QuantLinear)
    assert not isinstance(model.fusion.language_model.output, L.QuantLinear)


@pytest.mark.parametrize("dynamic", [False, True])
def test_serve_chunk_replay_is_bitwise_repeatable(cuda, dynamic):
    """A captured decode chunk (8 steps, two active rows of different
    lengths, greedy or per-row sampling from a fixed draw buffer), replayed
    twice from the same inputs, emits bitwise-equal tokens and cache, equal
    to the eager step's tokens."""
    from ullsam_tpu_torch.models.internlm2.generate import (GenerationConfig,
                                                            SamplingParams)
    from ullsam_tpu_torch.serve import engine as E
    cfg, model, _ = _serve_model()
    eng = _serve_engine(cfg, model)
    eng.shutdown()                 # drive the graphs from this thread
    st = eng.state
    st.cache.k.normal_(generator=cuda)
    st.cache.v.normal_(generator=cuda)
    st.cache.mask.zero_()
    st.cache.mask[0, :40] = 1
    st.cache.mask[1, :75] = 1
    st.tokens.copy_(torch.tensor([5, 6]))
    st.active.fill_(True)
    E._upload_samp(st.samp, SamplingParams.from_configs(
        [GenerationConfig(do_sample=dynamic, temperature=0.8, top_k=40,
                          top_p=0.9)] * 2))
    st.uniform.uniform_(generator=cuda)
    inputs = [t.clone() for t in (st.cache.k, st.cache.v, st.cache.mask,
                                  st.tokens)]

    def reset():
        for t, saved in zip((st.cache.k, st.cache.v, st.cache.mask,
                             st.tokens), inputs):
            t.copy_(saved)

    key = (8, 512, dynamic)
    with torch.inference_mode():
        graph = eng._graph(key)
        outs = []
        for _ in range(2):
            reset()
            graph.replay()
            torch.cuda.synchronize()
            outs.append((st.emitted.clone(), st.cache.k.clone(),
                         st.cache.mask.clone()))
        reset()
        eager = E._engine_step(eng.lm, cfg, st, 8, dynamic, 2, 512).clone()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert torch.equal(outs[0][0], eager)


# ---------------------------------------------------------------------------
# the rest of inference: calibration, SamPredictor, multi-crop AMG
# ---------------------------------------------------------------------------


def _small_sam(prod_decoder_only=False):
    """A small SAM with SAM's full-width decoder, random weights from seed
    0, on the CPU: a ViT of head dim 64 with a padded window and a global
    block (every kernel takes it), or, for the calibration (which never
    runs the encoder), the tiny ViT of ``tests/test_torch_calibrate.py``
    on the 64x64 embedding the calibration is tuned for."""
    from ullsam_tpu_torch.core.config import (MaskDecoderConfig,
                                              PromptEncoderConfig, SamConfig,
                                              ViTConfig)
    from ullsam_tpu_torch.models.sam.sam import Sam
    from ullsam_tpu_torch.ops import layers as L
    if prod_decoder_only:
        cfg = SamConfig(
            vit=ViTConfig(img_size=1024, patch_size=16, embed_dim=64,
                          depth=2, num_heads=2, mlp_ratio=2.0,
                          out_chans=256, window_size=8,
                          global_attn_indexes=(1,)),
            prompt_encoder=PromptEncoderConfig(
                image_embedding_size=(64, 64), input_image_size=(1024, 1024),
                mask_in_chans=16),
            mask_decoder=MaskDecoderConfig())
    else:
        cfg = SamConfig(
            vit=ViTConfig(img_size=256, patch_size=16, embed_dim=128,
                          depth=3, num_heads=2, out_chans=256, window_size=14,
                          global_attn_indexes=(1,)),
            prompt_encoder=PromptEncoderConfig(
                image_embedding_size=(16, 16), input_image_size=(256, 256)),
            mask_decoder=MaskDecoderConfig())
    cpu = Sam(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    L.init_module_(cpu, gen)
    gpu = Sam(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu.eval(), gpu.eval()


def test_calibration_on_card_matches_cpu(cuda):
    """``calibrate_amg_weights`` on the card against the CPU from the same
    weights: every tensor within 1e-4 of its largest magnitude (the
    tolerance ``tests/test_torch_calibrate.py`` states against JAX), the
    drawn ones bitwise, the copy on the card."""
    from ullsam_tpu_torch.inference.calibrate import calibrate_amg_weights
    cfg, cpu, gpu = _small_sam(prod_decoder_only=True)
    ref = calibrate_amg_weights(cpu, cfg).state_dict()
    cal = calibrate_amg_weights(gpu, cfg)
    assert next(cal.parameters()).device.type == "cuda"
    for k, v in cal.state_dict().items():
        err = float((v.cpu() - ref[k]).abs().max())
        assert err <= 1e-4 * max(float(ref[k].abs().max()), 1e-30), (k, err)


def test_predictor_on_card_matches_cpu(cuda):
    """``SamPredictor`` on the card (B1, B2 in ``set_image``, the plain
    decoder in ``predict``, no kernel there) against the CPU: embedding,
    IoU and low-res logits within 1e-4 of max|CPU| (f32 with TF32 off),
    masks on 99.9% of pixels."""
    from ullsam_tpu_torch.inference.predictor import SamPredictor
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.ops.kernels import vit_block as VB
    cfg, cpu, gpu = _small_sam()
    image = (torch.rand(200, 240, 3, generator=torch.Generator().manual_seed(
        1)) * 255).to(torch.uint8).numpy()
    p_cpu, p_gpu = SamPredictor(cfg, cpu), SamPredictor(cfg, gpu)
    p_cpu.set_image(image)
    b0 = (VB.window_attn.launches, FA.vit_flash_attn.launches)
    p_gpu.set_image(image)
    assert (VB.window_attn.launches - b0[0],
            FA.vit_flash_attn.launches - b0[1]) == (2, 1)
    assert _rel_err(p_gpu.get_image_embedding().cpu(),
                    p_cpu.get_image_embedding()) <= 1e-4
    import numpy as np
    point = dict(point_coords=np.asarray([[120, 90]]),
                 point_labels=np.asarray([1]))
    _, _, low = p_cpu.predict(**point)
    for kw in (point, dict(box=np.asarray([30, 40, 180, 150]),
                           multimask_output=False),
               dict(point, mask_input=low[:, :1], multimask_output=False)):
        launched = (VB.window_attn.launches, FA.vit_flash_attn.launches)
        mg, ig, lg = p_gpu.predict(**kw)
        assert (VB.window_attn.launches, FA.vit_flash_attn.launches) == \
            launched
        mc, ic, lc = p_cpu.predict(**kw)
        assert float(np.abs(ig - ic).max()) <= 1e-4
        assert float(np.abs(lg - lc).max()) <= 1e-4 * float(
            np.abs(lc).max())
        assert (mg == mc).mean() >= 0.999


def test_multicrop_amg_on_card_matches_cpu(cuda):
    """One crop layer on the device path, card against CPU: the same
    committed candidates (each crop's sweep on the card is bitwise the
    same as the host path's, so the host path must agree exactly), iou
    and stability within 1e-4, masks on 99.9% of pixels."""
    import numpy as np
    from ullsam_tpu_torch.inference.amg import AutomaticMaskGenerator
    cfg, cpu, gpu = _small_sam()
    image = np.random.default_rng(0).integers(0, 256, (300, 360, 3),
                                              dtype=np.uint8)
    kw = dict(points_per_side=4, points_per_batch=16, crop_n_layers=1,
              pred_iou_thresh=0.0, stability_score_thresh=0.0,
              box_nms_thresh=1.0, crop_nms_thresh=1.0, max_masks=256)
    mc, dc = AutomaticMaskGenerator(cfg, cpu, **kw).generate_dense(image)
    mg, dg = AutomaticMaskGenerator(cfg, gpu, **kw).generate_dense(image)
    mh, dh = AutomaticMaskGenerator(cfg, gpu, device_multicrop=False,
                                    **kw).generate_dense(image)

    def order(d):
        crop = (d["report_crop_boxes"] if "report_crop_boxes" in d
                else d["crop_boxes"])
        return np.lexsort((d["stability"], d["iou_preds"], *crop.T[::-1]))

    oc, og, oh = order(dc), order(dg), order(dh)
    assert len(oc) == len(og) == len(oh) == 5 * 48
    np.testing.assert_allclose(dg["iou_preds"][og], dc["iou_preds"][oc],
                               atol=1e-4)
    np.testing.assert_allclose(dg["stability"][og], dc["stability"][oc],
                               atol=1e-4)
    assert (mg.cpu().numpy()[og] == mc.numpy()[oc]).mean() >= 0.999
    assert torch.equal(mg[torch.from_numpy(og).cuda()],
                       mh[torch.from_numpy(oh).cuda()])


def test_train_cli_segment_on_card(cuda, tmp_path, monkeypatch):
    """``python -m ullsam_tpu_torch.train.cli`` at full width on the card
    (SAM ViT-B + InternLM2-1.8B from the seed, f32 with remat, the CLI's
    defaults): 2 micro-steps of --grad_accum 2 with the Hungarian matching
    on two synthetic 1024x1024 images, a stub tokenizer. Finite metrics,
    the final checkpoint, and B2 / B9 launched by the steps."""
    import json
    import os

    import ullsam_tpu_torch.data.tokenizer as tok
    from torch_port_helpers import StubTokenizer, write_synthetic_dataset
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    from ullsam_tpu_torch.train import cli

    monkeypatch.setattr(tok, "load_tokenizer",
                        lambda path=None: StubTokenizer())
    data = write_synthetic_dataset(str(tmp_path / "data"), n=2,
                                   img_size=1024)
    out = str(tmp_path / "run")
    b2, b9 = FA.vit_flash_attn.launches, FA.vit_flash_attn_bwd.launches
    cli.main(["--mode", "segment", "--data_path", data, "--output_dir", out,
              "--epochs", "1", "--grad_accum", "2", "--instance_matching",
              "hungarian", "--log_every", "1", "--image_log_every", "0"])
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    for r in rows:
        assert all(math.isfinite(v) for v in r.values()), r
    assert os.path.isdir(os.path.join(out, "ckpt", "2"))
    assert FA.vit_flash_attn.launches - b2 == 16   # 4 global blocks, remat
    assert FA.vit_flash_attn_bwd.launches - b9 == 8
