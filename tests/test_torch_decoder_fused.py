"""The fused stages of the port's mask decoder (``ops/kernels/decoder.py``
``_Stages``, run on the card by ``csrc/decoder_image.cu`` and
``csrc/decoder_upscale.cu``, in bf16 and in float32) on the CPU: each
stage's plain version against the plain primitive operations it replaces,
bitwise, in float32 and bfloat16; the kernels' shape and unit rules (128-row
units in bf16, 64-row ones in float32); their shared-memory mirrors against
the constants of ``csrc/decoder_sm90.cuh`` and ``csrc/decoder_f32.cuh``;
their launch counters with no card. SAM's decoder widths (C = 256, Cd = 128, 8 heads, T = 7), an
8x8 grid, 2 prompts. No jax."""

import os
import re

import pytest
import torch

from ullsam_tpu_torch.core.config import MaskDecoderConfig
from ullsam_tpu_torch.models.sam.mask_decoder import MaskDecoder
from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import decoder as D

B, T, HW, M = 2, 7, 8, 3
N = HW * HW
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ullsam_tpu_torch", "csrc")


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request):
    """Weights, the image side and a stage's token-side inputs at dtype."""
    dtype = getattr(torch, request.param)
    cfg = MaskDecoderConfig()
    gen = torch.Generator()
    gen.manual_seed(0)
    md = MaskDecoder(cfg, device="cpu")
    L.init_module_(md, gen)
    w = D.pack_weights(md, dtype)
    C, Cd = cfg.transformer_dim, w["l0.t2i_q_w"].shape[0]

    def r(*shape, s=0.5):
        return (torch.randn(*shape, generator=gen) * s).to(dtype)

    img = D.image_side(w, r(N, C), r(N, C))
    toks = {k: r(B * T, Cd) for k in ("kt1", "vt1", "kt2", "vt2", "q2",
                                      "qf")}
    return dict(w=w, img=img, heads=cfg.transformer_num_heads,
                eps=cfg.ln_eps, keys=r(B * N, C, s=1.0),
                hyper=r(B, M, C // 8), **toks)


def test_image_stage1_plain_is_its_primitives(case):
    w, img, P = case["w"], case["img"], D._PLAIN
    kv, part, carry = P.image_stage1(
        w, img, case["kt1"], case["vt1"], case["q2"], B, case["heads"],
        case["eps"])
    keys1, q_img = carry
    o = P.i2t(img["qi1"], case["kt1"], case["vt1"], B, case["heads"], True)
    want = P.ln(P.gemm(o, w["l0.i2t_out_w"], w["l0.i2t_out_b"],
                       res=img["src"]), w["l0.norm4_w"], w["l0.norm4_b"],
                case["eps"])
    prj = P.gemm(want, w["img2_w"], res=img["res2"])
    assert part is None
    assert torch.equal(keys1, want)
    assert torch.equal(kv, prj[:, :256]) and torch.equal(q_img, prj[:, 256:])


def test_image_stage2_plain_is_its_primitives(case):
    w, img, P = case["w"], case["img"], D._PLAIN
    keys1 = case["keys"]
    q_img = (keys1[:, :128] * 0.5).contiguous()
    carry = [keys1, q_img]
    keys2, kv, part = P.image_stage2(
        w, img, carry, case["kt2"], case["vt2"], case["qf"], B,
        case["heads"], case["eps"])
    assert carry == []  # emptied, so each tensor is freed once read
    o = P.i2t(q_img, case["kt2"], case["vt2"], B, case["heads"], False)
    want = P.ln(P.gemm(o, w["l1.i2t_out_w"], w["l1.i2t_out_b"], res=keys1),
                w["l1.norm4_w"], w["l1.norm4_b"], case["eps"])
    assert part is None and torch.equal(keys2, want)
    assert torch.equal(kv, P.gemm(want, w["imgf_w"], res=img["resf"]))


def test_t2i_part_plain_is_t2i(case):
    P = D._PLAIN
    kv = case["keys"]
    got = P.t2i_part(case["q2"], kv, None, B, case["heads"])
    want = P.t2i(case["q2"], kv[:, :128], kv[:, 128:], B, case["heads"],
                 False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("stats", [None, (0.0, 1.0)], ids=["b7", "b6"])
def test_upscale_plain_is_its_primitives(case, stats):
    w, P, keys, hyper = case["w"], D._PLAIN, case["keys"], case["hyper"]
    got = P.upscale(w, keys, hyper, HW, HW, stats)
    u1 = P.gemm(keys, w["up1_w"], w["up1_b"], out_f32=True)
    u1 = P.ln_gelu(u1, w["up_ln_w"], w["up_ln_b"], D.UPSCALE_LN_EPS,
                   keys.dtype)
    u2 = P.gemm(u1.view(4 * B * N, -1), w["up2_w"], w["up2_b"])
    logits = P.upscale_out(u2.view(B * N, -1), hyper, HW, HW)
    if stats is None:
        assert torch.equal(got, logits)
        return
    want = (logits, *P.stats(logits, *stats))
    assert len(got) == 4 and all(torch.equal(a, b)
                                 for a, b in zip(got, want))


@pytest.mark.parametrize("n,units,slots,scratch", [
    (64, 1, 2, B * 1 * T * 8 * 16),      # 8x8: less than a unit
    (1024, 8, 16, B * 2 * T * 8 * 16),   # 32x32
    (4096, 32, 64, B * 8 * T * 8 * 16)])  # 64x64, the AMG grid
def test_unit_rule(n, units, slots, scratch):
    """128 image rows a unit (the last one ragged), two logit partials a
    unit, decoder_t2i_part's scratch in 512-row tiles."""
    assert D.units(n) == units and D.partial_slots(n) == slots
    assert D.t2i_part_scratch(B, n, T) == scratch


@pytest.mark.parametrize("n,units,slots,scratch", [
    (64, 1, 1, B * 1 * T * 8 * 16),       # 8x8: one unit
    (1000, 16, 16, B * 2 * T * 8 * 16),   # a ragged last unit
    (1024, 16, 16, B * 2 * T * 8 * 16),   # 32x32
    (4096, 64, 64, B * 8 * T * 8 * 16)])  # 64x64, the AMG grid
def test_f32_unit_rule(n, units, slots, scratch):
    """float32: 64 image rows a unit (the two warpgroups split each
    product's columns), one token -> image partial a unit; block 1's
    attention against the shared image (decoder_t2i_f32) takes a partial
    of 18 floats a 512-row tile."""
    f32 = torch.float32
    assert D.units(n, f32) == units and D.partial_slots(n, f32) == slots
    assert D.t2i_f32_scratch(B, n, T) == scratch * 18 // 16


@pytest.mark.parametrize("dtype,C,Cd,heads,twt,up", [
    ("bfloat16", 256, 128, 8, True, True),    # SAM's decoder
    ("float32", 256, 128, 8, True, True),     # f32 takes the fused kernels
    ("float32", 128, 64, 4, False, False),    # f32 elsewhere keeps the chain
    ("float16", 256, 128, 8, False, False),   # no kernel takes float16
    ("bfloat16", 128, 64, 4, False, False)])  # other widths keep it too
def test_fused_route_rule(dtype, C, Cd, heads, twt, up):
    dt = getattr(torch, dtype)
    assert D.fused_twt(dt, C, Cd, heads) is twt
    assert D.fused_upscale(dt, C) is up


def _constants(path):
    with open(path) as f:
        src = f.read()
    return {k: int(v) for k, v in re.findall(
        r"\b(k\w+) = (\d+)\b", src)}


def test_sm90_smem_mirror_matches_the_source():
    """``sm90_smem_bytes`` and the mirrored constants against
    csrc/decoder_sm90.cuh and csrc/decoder_image.cu, under one block's
    232,448 bytes."""
    c = _constants(os.path.join(CSRC, "decoder_sm90.cuh"))
    assert (c["kUnitRows"], c["kUnitStages"], c["kUnitC"], c["kUnitCd"],
            c["kUnitHeads"]) == (D.UNIT_ROWS, D.UNIT_STAGES, D.UNIT_C,
                                 D.UNIT_CD, D.UNIT_HEADS)
    assert c["kUnitThreads"] == 384 and c["kUnitMaxTok"] == D.UNIT_MAX_TOK
    x, q = c["kUnitRows"] * c["kUnitC"] * 2, c["kUnitRows"] * c["kUnitCd"] * 2
    slot = c["kUnitC"] * 64 * 2
    prompt = 3 * c["kUnitMaxTok"] * (c["kUnitCd"] + 8) * 2
    bars = 2 * c["kUnitStages"] + 4
    assert D.sm90_smem_bytes() == (1024 + x + q + c["kUnitStages"] * slot
                                   + 2 * prompt + bars * 8)
    assert D.sm90_smem_bytes() <= D.SMEM_LIMIT == 232448
    assert _constants(os.path.join(CSRC, "decoder_image.cu"))[
        "kT2iRows"] == D.T2I_ROWS


def test_f32_smem_mirror_matches_the_source():
    """``f32_smem_bytes`` and its constants against csrc/decoder_f32.cuh
    (with decoder_sm90.cuh's widths), under one block's 232,448 bytes: X
    [64][256] and Q [64][128] f32, three ring slots of a [256][16] k-block
    in both TF32 planes, three [16][132] prompt rows, the LayerNorm's
    exchange, 8 mbarriers."""
    c = {**_constants(os.path.join(CSRC, "decoder_sm90.cuh")),
         **_constants(os.path.join(CSRC, "decoder_f32.cuh"))}
    assert (c["kF32Rows"], c["kF32Stages"], c["kF32WK"],
            c["kF32PromptLd"]) == (D.F32_UNIT_ROWS, D.F32_UNIT_STAGES,
                                   D.F32_WK, D.F32_PROMPT_LD)
    rows, C, Cd, tok = c["kF32Rows"], c["kUnitC"], c["kUnitCd"], c[
        "kUnitMaxTok"]
    x, q = rows * C * 4, rows * Cd * 4
    slot = 2 * C * c["kF32WK"] * 4
    prompt = 3 * tok * c["kF32PromptLd"] * 4
    bars = 2 * c["kF32Stages"] + 2
    assert D.f32_smem_bytes() == (1024 + x + q + c["kF32Stages"] * slot
                                  + prompt + 2 * 2 * rows * 4 + bars * 8)
    assert D.f32_smem_bytes() == 224064 <= D.SMEM_LIMIT


def test_launch_counters_with_no_card(case):
    """The CPU runs the plain chain: no wrapper and no fused kernel counts
    a launch."""
    from ullsam_tpu_torch.tools.main_path import decoder_cases
    gen = torch.Generator()
    gen.manual_seed(1)
    before = ({k.__name__: k.launches for k in D.KERNELS},
              {k: c.launches for k, c in D.FUSED_KERNELS.items()})
    assert set(before[1]) == {
        "image_stage1", "image_stage2", "t2i_part", "upscale_unit",
        "upscale_unit_stats", "image_stage1_f32", "image_stage2_f32",
        "t2i_part_f32", "t2i_f32", "upscale_unit_f32",
        "upscale_unit_stats_f32"}
    cases = decoder_cases(torch.float32, gen, B=1, H=HW, W=HW, T=T, M=M)
    for name, (args, kw, _, _) in cases.items():
        getattr(D, name)(*args, **kw)
    after = ({k.__name__: k.launches for k in D.KERNELS},
             {k: c.launches for k, c in D.FUSED_KERNELS.items()})
    assert after == before
    assert D.split_tf32.launches == 0 and "img2_w_hi" not in cases[
        "decode_masks"][0][0]  # no TF32 planes are made on the CPU
