"""Host-side rules of the Hopper kernels behind B12's prefill (the wgmma +
TMA GEMM with an int8 W operand) and B2 / B14's bf16 global flash body, on
the CPU: each Python mirror against the constants of its CUDA source and
against the 232,448 bytes of shared memory an H100 block may use.

* ``int8_matmul.w8a16_kernel``: which of B12's kernels a call launches
  (the decode body on the tensor cores at 2 <= M <= 16, the GEMV at M = 1,
  the wgmma GEMM at prefill where ``gemm_sm90.cuh`` ``sm90_takes`` holds,
  the mma.sync GEMM for the ragged vocab head; f32 x on the ``_f32``
  instances of the decode body and the wgmma GEMM, the head included, x
  split into three bf16 planes, the FMA GEMM only at other widths), at
  every InternLM2-1.8B linear and
  the caption and serving paths' M; the split rules ``decode_plan`` and
  ``sm90_splits`` and the workspace they ask for; the decode body's
  constants and shared memory and ``int8_matmul.sm90_smem_bytes``
  (``Sm90Layout<kSm90Int8>`` and ``<kSm90Int8X3>``) against the sources;
  the per-kernel launch counts with no card.
* ``flash_attention.sm90_smem_bytes`` (``FlashSm90Layout<D>``) at head
  dims 64 and 80, and ``key_rows_per_tile``: when a 64-key tile covers
  whole key-grid rows, so that the bias comes from registers.
* The f32 kind of the wgmma GEMM (``Sm90Layout<kSm90F32>``, split TF32:
  B1's and B13's f32 products) and the f32 window core
  (``window_core_f32.cuh``, B1's, B3's and B15's f32 core): their shape
  rules, instances and shared memory.
* B9's two bf16 bodies (``vit_flash_bwd.cu`` ``BwdSm90Layout<D>``: dq and
  drel query-major, dk and dv key-major) and its two float32 ones
  (``F32Layout<D>``, split TF32) at head dims 64 and 80:
  ``bwd_sm90_smem_bytes`` and ``bwd_f32_smem_bytes`` against the source's
  constants and the block.
* B2 / B14's float32 body (``vit_flash_attn.cu`` ``vit_flash_tf32``, split
  TF32 on wgmma): ``fwd_f32_smem_bytes`` (``F32Layout<D>``) at head dims 64
  and 80 against the source's constants and the block, its bias rule
  ``f32_bias_kw`` and its scratch rule ``fwd_f32_scratch_floats`` at ViT-B
  and ViT-H; the CUDA-core body it replaced and ``attn_fma.cuh`` are gone.
* B10's and B11's float32 bodies (split TF32 on wgmma, ``llm_f32.cuh``):
  ``llm_flash_attention.f32_smem_bytes`` / ``bwd_f32_smem_bytes`` at head
  dims 64 and 128 against the sources' constants and the block beside the
  static segment scan, and the scratch rules ``fwd_scratch_floats`` /
  ``bwd_scratch_floats`` at the packed sft shape.

The plain B12 and B2 stay held to the JAX package by
``tests/test_torch_quant.py`` and ``tests/test_torch_kernels.py``.
"""

import os
import re

import pytest
import torch

from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels import flash_attention as FA
from ullsam_tpu_torch.ops.kernels import gemm as G
from ullsam_tpu_torch.ops.kernels import int8_matmul as Q
from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF
from ullsam_tpu_torch.ops.kernels import window_attention as WA
from ullsam_tpu_torch.tools.main_path import (W8A16_DECODE_M, W8A16_LINEARS,
                                              W8A16_PREFILL_M,
                                              W8A16_TP2_LINEARS, W8A16_TP2_M)


def _const(source: str, pattern: str) -> int:
    with open(os.path.join(build.CSRC, source)) as f:
        m = re.search(pattern, f.read())
    assert m, f"{pattern!r} not found in {source}"
    return int(m.group(1))


def test_w8a16_sm90_mirror_matches_the_source():
    """The tile, stage and staging constants that ``int8_matmul`` and
    ``gemm`` mirror are those of ``gemm_sm90.cuh``."""
    src = "gemm_sm90.cuh"
    assert (_const(src, r"kSm90BM = (\d+)"), _const(src, r"kSm90BN = (\d+)"),
            _const(src, r"kSm90BK = (\d+)")) == (G.SM90_BM, G.SM90_BN,
                                                   G.SM90_BK)
    assert _const(src, r"kBM = kInt8W \? (\d+)") == Q.W8_BM
    assert _const(src, r"kStages = kX3 \? \d+ : kInt8W \? (\d+)") == \
        Q.W8_STAGES
    assert _const(src, r"kStgLd = kInt8W \? (\d+)") == Q.W8_STG_LD
    # the f32-x kind: x's three planes a stage, its stages and the x rows
    # its epilogue stages at a time
    assert _const(src, r"kPlanes = kX3 \? (\d+)") == Q.X3_PLANES
    assert _const(src, r"kStages = kX3 \? (\d+)") == Q.X3_STAGES
    assert Q.W8_BM // _const(src, r"kStgRows = kX3 \? kBM / (\d+)") == \
        Q.X3_STG_ROWS


def test_gemm_f32_mirror_matches_the_source():
    """The f32 kind of the wgmma GEMM (split TF32): its k-block, stages and
    producer warpgroup in ``gemm_sm90.cuh`` are those ``gemm`` mirrors; its
    shared memory (three stages of A's and W's 128 x 32 f32 tiles and W's
    lo plane, the bf16 kind's staging and mbarriers) fits one block; every
    f32 product of B1 and B13 at SAM's widths takes it, other widths the
    FMA kernel."""
    src = "gemm_sm90.cuh"
    assert (_const(src, r"kSm90F32BK = (\d+)"),
            _const(src, r"kSm90F32Stages = (\d+)")) == (G.SM90_F32_BK,
                                                        G.SM90_F32_STAGES)
    # a producer warpgroup that gives its registers away (f32, and the
    # int8 kind's f32-x instance)
    assert "kRegs=kF32||kX3;" in _squeezed(src)
    assert _const(src, r"kThreads = kRegs \? (\d+)") == 3 * 128
    assert G.sm90_f32_smem_bytes() == 183360 <= G.SMEM_LIMIT
    for C in (768, 1024, 1280):
        for N, K in ((3 * C, C), (C, C), (4 * C, C), (C, 4 * C)):
            for M in (4900, 4096, 257):
                assert G.gemm_kernel(M, N, K, torch.float32) == "gemm_sm90_f32"
    for M, N, K in ((300, 200, 96), (64, 136, 64), (4900, 1280, 32)):
        assert G.gemm_kernel(M, N, K, torch.float32) == "gemm_fma"


def test_window_core_f32_mirror_matches_the_source():
    """The f32 window core's instances (slot rows 2, 4, 8, 14, 16 in
    ``window_core_f32.cuh``) are those ``window_attention`` mirrors, and
    its shared memory at SAM's 14x14 windows is k's hi and lo planes of 224
    slots, 7 query tiles and their rel-pos terms."""
    with open(os.path.join(build.CSRC, "window_core_f32.cuh")) as f:
        m = re.search(r"kCoreF32Nts\[\] = \{([\d, ]+)\}", f.read())
    assert tuple(int(v) for v in m.group(1).split(",")) == \
        WA.CORE_F32_SLOT_ROWS
    for hd in (64, 80):
        ld = hd + 4
        assert WA.core_f32_smem_bytes(196, 14, 14, hd) == 4 * (
            2 * 224 * ld + 112 * ld + 112 * 28)


def test_w8a16_sm90_smem_fits_a_block():
    """The int8 kernel's shared memory (6 stages of x's 144-row bf16 and
    W's 128-row int8 tiles, the transposed epilogue staging, the
    mbarriers) fits one block, as the bf16 GEMM's does; its 144-row tiles
    cut the caption prompt (M = 1152) and its batch of 8 into whole
    tiles."""
    assert Q.sm90_smem_bytes() == 216176
    assert 1152 % Q.W8_BM == 0 and 9216 % Q.W8_BM == 0
    assert Q.sm90_smem_bytes() <= G.SMEM_LIMIT == 232448
    assert G.sm90_smem_bytes() <= G.SMEM_LIMIT
    # f32 x: 3 stages of x's three 144 x 64 bf16 planes (1024-byte aligned
    # each) and W's tile; the staging at 72 rows; a fourth stage would not
    # fit
    assert Q.sm90_smem_bytes(torch.float32) == 219200 <= G.SMEM_LIMIT
    stage = Q.X3_PLANES * Q.W8_BM * G.SM90_BK * 2 + G.SM90_BN * G.SM90_BK
    assert stage % 1024 == 0 and Q.W8_BM * G.SM90_BK * 2 % 1024 == 0
    assert Q.sm90_smem_bytes(torch.float32) + stage > G.SMEM_LIMIT


def _squeezed(source: str) -> str:
    with open(os.path.join(build.CSRC, source)) as f:
        return re.sub(r"\s+", "", f.read())


def test_w8a16_decode_tc_mirror_matches_the_source():
    """The decode body's constants and the split rules' thresholds that
    ``int8_matmul`` mirrors are those of ``w8a16_matmul.cu`` and
    ``gemm_sm90.cuh``, and each rule doubles on the conditions the mirror
    does."""
    src = "w8a16_matmul.cu"
    assert _const(src, r"kTcWarps = (\d+)") == Q.TC_WARPS
    assert _const(src, r"kTcXBytes = (\d+) \* 1024") * 1024 == Q.TC_X_BYTES
    assert _const(src, r"kTcMinM = (\d+)") == Q.TC_MIN_M
    assert _const(src, r"kTcXPad = (\d+)") == Q.TC_X_PAD
    assert _const(src, r"W8Kernel : int \{\s*kW8Gemv = 0, kW8Sm90 = 1, "
                  r"kW8Mma = 2, kW8F32 = 3, kW8DecodeTc = (\d+)") == \
        Q.KERNELS.index("w8a16_decode_tc")
    assert _const(src, r"kW8Sm90F32 = (\d+)") == \
        Q.KERNELS.index("w8a16_sm90_f32")
    assert _const(src, r"kW8DecodeTcF32 = (\d+)") == \
        Q.KERNELS.index("w8a16_decode_tc_f32")
    assert _const(src, r"kW8SplitX3 = (\d+)") == \
        Q.KERNELS.index("w8a16_split_x3")
    assert _const(src, r"kW8Kernels = (\d+)") == len(Q.KERNELS)
    assert _const("gemm_sm90.cuh", r"kSm90MinSplitKb = (\d+)") == \
        Q.SM90_MIN_SPLIT_KB
    assert (_const("gemm_sm90.cuh", r"kSm90PartFloats = (\d+) \* 144 / 2")
            * 144 // 2) == Q.SM90_PART_FLOATS
    text = _squeezed(src)
    for cond in ("while(w<kTcWarps&&(N+8*kTcWarps/w-1)/(8*kTcWarps/w)<="
                 "sms&&K%(2*w*64)==0)w*=2;",
                 "while((longlong)planes*mm*(K/s)*2>kTcXBytes){"
                 "if(K%(2*s*w*64))return{0,0};s*=2;}",
                 "tc_plan(M,N,K,num_sms(),f32?3:1);"):
        assert cond in text, cond
    assert ("while(tiles*s*2<=sms&&kt%(2*s)==0&&kt/(2*s)>=kSm90MinSplitKb)"
            "s*=2;") in _squeezed("gemm_sm90.cuh")
    assert ("if(planes==3&&s>1)for(inti=0;i<2&&w>1;++i)w/=2,s*=2;"
            "return{w,s};") in text


def test_w8a16_decode_smem_fits_a_block():
    """The decode body's shared memory (x's K slice of 8 or 16 rows in
    bf16, padded; the warps' accumulators for the in-block sum; a flag) at
    every decode shape of the serving and caption paths fits one block
    (w2 at 16 rows the most: half its K a block), and two blocks fit an SM
    at the head's shape, whose 724 groups are the only ones beyond one
    wave (its launch bounds ask for two)."""
    shapes = [(M, N, K) for M in range(2, 17)
              for N, K in W8A16_LINEARS + W8A16_TP2_LINEARS]
    most = max(Q.decode_smem_bytes(*s) for s in shapes)
    assert most == Q.decode_smem_bytes(16, 2048, 8192) == (
        16 * (4096 + Q.TC_X_PAD) * 2 + 8 * 2 * 32 * 16 + 4)
    assert most <= G.SMEM_LIMIT
    assert 2 * Q.decode_smem_bytes(16, 92553, 2048) <= G.SMEM_LIMIT
    # f32 x: three bf16 planes of the slice, which splits K across blocks
    # at fewer rows (K = 2048 from 9 rows on, w2 at 2-8 rows), and there
    # blocks four times as tall; two blocks still fit an SM everywhere
    f32 = torch.float32
    most = max(Q.decode_smem_bytes(*s, dtype=f32) for s in shapes)
    assert most == Q.decode_smem_bytes(16, 92553, 2048, dtype=f32) == (
        3 * 16 * (1024 + Q.TC_X_PAD) * 2 + 8 * 2 * 32 * 16 + 4)
    assert Q.decode_smem_bytes(8, 2048, 2048, dtype=f32) == (
        3 * 8 * (2048 + Q.TC_X_PAD) * 2 + 8 * 1 * 32 * 16 + 4)
    assert 2 * most <= G.SMEM_LIMIT
    assert Q.decode_plan(8, 2048, 2048, dtype=f32) == (8, 1)
    assert Q.decode_plan(16, 2048, 2048, dtype=f32) == (2, 8)
    assert Q.decode_plan(8, 2048, 8192, dtype=f32) == (2, 16)


@pytest.mark.parametrize("M", W8A16_DECODE_M + W8A16_PREFILL_M)
def test_w8a16_kernel_of_each_internlm2_linear(M):
    """At a decode step's 4, 8 or 16 rows every linear runs the decode body
    on the tensor cores, at batch 1 the GEMV; at the serving engine's
    prompt segments (M = 128, 256) and the caption prompt's prefill (M =
    1152, 9216) in bf16 wqkv, wo, w1 / w3 and w2 run the wgmma GEMM and the
    92,553-column head the mma.sync GEMM. f32 x runs the f32 instances of
    the decode body and the wgmma GEMM there, the head's prefill included,
    and the GEMV at batch 1: no InternLM2-1.8B linear reaches the FMA
    GEMM."""
    for N, K in W8A16_LINEARS:
        if M == 1:
            want = "w8a16_gemv"
        elif M <= 16:
            want = "w8a16_decode_tc"
        elif N % 128:
            want = "w8a16_mma"
        else:
            want = "w8a16_sm90"
        assert Q.w8a16_kernel(M, N, K) == want, (M, N, K)
        want32 = {"w8a16_mma": "w8a16_sm90_f32"}.get(
            want, want if want == "w8a16_gemv" else want + "_f32")
        assert Q.w8a16_kernel(M, N, K, torch.float32) == want32, (M, N, K)
        assert Q.plan(M, N, K, torch.float32)[1:] == (
            Q.plan(M, N, K)[1:] if M > 16 else
            (Q.decode_plan(M, N, K, dtype=torch.float32)[::-1]
             if M > 1 else (1, 0)))
    assert [Q.w8a16_kernel(M, N, K) for N, K in W8A16_LINEARS].count(
        "w8a16_sm90") == (0 if M <= 16 else 4)
    assert [Q.w8a16_kernel(M, N, K, torch.float32)
            for N, K in W8A16_LINEARS].count("w8a16_f32") == 0


def test_w8a16_shape_rule():
    """The decode body takes bf16 x at 2 <= M <= 16 with K % 64 == 0 (its
    64-byte chunks), any N (the ragged head masked); the GEMV the rest of M
    <= 16. The wgmma GEMM takes bf16 x at M > 16 with N % 128 == 0 and K %
    64 == 0 (``sm90_takes``); other widths keep the mma.sync GEMM. f32 x
    follows the same rules on its instances, except that its wgmma kind
    also takes a ragged N >= 128 (``x3_takes``: the head), leaving the FMA
    GEMM the other widths."""
    assert Q.w8a16_kernel(16, 128, 64) == "w8a16_decode_tc"
    assert Q.w8a16_kernel(2, 92553, 2048) == "w8a16_decode_tc"
    for M, N, K in ((1, 128, 64), (16, 128, 48), (8, 200, 80), (3, 200, 48)):
        assert Q.w8a16_kernel(M, N, K) == "w8a16_gemv", (M, N, K)
        assert Q.decode_plan(M, N, K) == (0, 0)
    assert Q.w8a16_kernel(17, 128, 64) == "w8a16_sm90"
    for M, N, K in ((17, 200, 64), (129, 4096, 48), (1152, 4100, 2048),
                    (40, 300, 80), (1152, 92553, 2048)):
        assert Q.w8a16_kernel(M, N, K) == "w8a16_mma", (M, N, K)
        assert not G.sm90_takes(M, N, K)
    # a K whose x slice needs splitting but whose chunks do not halve
    assert Q.decode_plan(16, 128, 4096 + 64) == (0, 0)
    # f32 x: the same shape rules on its instances
    f32 = torch.float32
    assert Q.w8a16_kernel(16, 128, 64, f32) == "w8a16_decode_tc_f32"
    assert Q.w8a16_kernel(2, 92553, 2048, f32) == "w8a16_decode_tc_f32"
    for M, N, K in ((1, 128, 64), (16, 128, 48), (8, 200, 80), (3, 200, 48)):
        assert Q.w8a16_kernel(M, N, K, f32) == "w8a16_gemv", (M, N, K)
    for M, N, K in ((17, 128, 64), (17, 200, 64), (1152, 92553, 2048),
                    (1152, 4100, 2048)):
        assert Q.w8a16_kernel(M, N, K, f32) == "w8a16_sm90_f32", (M, N, K)
        assert Q.x3_takes(M, N, K)
    for M, N, K in ((129, 4096, 48), (40, 300, 80), (17, 120, 64)):
        assert Q.w8a16_kernel(M, N, K, f32) == "w8a16_f32", (M, N, K)
    # the head's prefill: 724 tiles of 128 columns, the last 9 wide
    assert Q.sm90_splits(1152, 92553, 2048) == 1
    assert Q.workspace(256, 92553, 2048, f32) == (256 * 2048 * 3 // 2, 0)
    # three planes split K at a shorter slice than bf16's one
    assert Q.decode_plan(16, 128, 2048 + 64, dtype=f32) == (0, 0)
    assert Q.decode_plan(16, 128, 2048 + 64) != (0, 0)


def _units(M, N, K):
    """(blocks a call runs, the decode body's warps a tile or 0, splits):
    the decode body's groups of 128 / W rows or the wgmma GEMM's 144 x 128
    tiles, times the splits."""
    name, s, w = Q.plan(M, N, K)
    if name == "w8a16_decode_tc":
        return Q.decode_groups(M, N, K) * s, w, s
    return -(-M // Q.W8_BM) * (N // G.SM90_BN) * s, w, s


def test_w8a16_splits_fill_the_card_at_the_serving_shapes():
    """At the serving engine's shapes (decode at 2-16 rows, prompt
    segments of 128 and 256; the tp 2 ranks' own linears at their 4 rows
    and 256) every layer linear runs 120-132 blocks or tiles x splits on
    the H100's 132 SMs, one wave, where one block a 128-row group or tile
    left most of them idle (wo and w2 at 16 groups or 32 tiles): decode by
    W warps on a tile's K inside a block, prefill by split K. Decode splits
    K across blocks only where x's slice would not fit (w2 at 9-16 rows:
    two waves). The head (724 groups) and w1 / w3 at 256 rows (128 tiles)
    fill it unsplit."""
    layer = W8A16_LINEARS[:4]
    shapes = [(M, N, K) for M in (2, 4, 8, 16, 128, 256) for N, K in layer]
    shapes += [(M, N, K) for M in W8A16_TP2_M for N, K in W8A16_TP2_LINEARS]
    for M, N, K in shapes:
        units, w, s = _units(M, N, K)
        if 8 < M <= 16 and (N, K) == (2048, 8192):
            assert (units, w, s) == (256, 8, 2)
            continue
        assert 120 <= units <= Q.H100_SMS, (M, N, K, units, w, s)
    assert _units(256, 8192, 2048) == (128, 0, 1)
    assert _units(8, 92553, 2048) == (724, 1, 1)
    # wo at 8 rows: 128 blocks of one 16-row tile, 8 warps on its K
    assert _units(8, 2048, 2048) == (128, 8, 1)
    assert _units(8, 4096, 2048) == (128, 4, 1)
    assert _units(8, 8192, 2048) == (128, 2, 1)
    # w2 at a 256-row segment: 2 x 16 tiles, 4 splits of 32 k-blocks
    assert _units(256, 2048, 8192) == (128, 0, 4)


def test_w8a16_f32_plans_at_the_serving_shapes():
    """f32 x keeps bf16's plans where its planes fit as bf16 x does: the
    wgmma GEMM's splits at the engine's prompt segments (the same 144 x 128
    tiles) and the decode body's warps a tile; its decode body splits K
    across blocks as soon as x's three planes would not fit
    ``TC_X_BYTES``, and no sooner, and then takes blocks four times as tall
    (W / 4, at least 1; S to match), a warp's share of K unchanged."""
    f32 = torch.float32
    for M in (128, 256, 1152):
        for N, K in W8A16_LINEARS[:4]:
            assert Q.plan(M, N, K, f32) == (("w8a16_sm90_f32",)
                                            + Q.plan(M, N, K)[1:])
    for M in range(2, 17):
        for N, K in W8A16_LINEARS + W8A16_TP2_LINEARS:
            w, s = Q.decode_plan(M, N, K, dtype=f32)
            wb = Q.decode_plan(M, N, K)[0]
            mm = 8 if M <= 8 else 16
            fits = -(-3 * mm * K * 2 // Q.TC_X_BYTES)  # the least split
            least = 1 << (fits - 1).bit_length()
            assert (w, s) == ((wb, 1) if least == 1 else
                              (max(wb // 4, 1), least * wb // max(wb // 4, 1))
                              ), (M, N, K)
            assert K // s // w == K // least // wb  # a warp's K part


@pytest.mark.parametrize("M", [1152, 9216])
def test_w8a16_caption_prefill_keeps_one_split(M):
    """The caption prompt's prefill (M = 1152: 128-512 tiles, a wave or
    more) splits nothing, so its products are bitwise the unsplit
    kernel's, and asks for no workspace."""
    for N, K in W8A16_LINEARS[:4]:
        assert Q.sm90_splits(M, N, K) == 1
        assert Q.workspace(M, N, K) == (0, 0)


def test_w8a16_workspace_rule():
    """A split call's f32 partials: the decode body's 16-row tiles'
    accumulators (a float4 a lane and 8 rows of x) of every block, a
    counter a group; the wgmma GEMM's units' 256 threads x 72
    accumulators, a counter a tile. A call that splits nothing across
    blocks asks for none, the f32 decode body's included; the f32 prefill
    asks for x's three bf16 planes (1.5 M K floats) after any partials. On
    a card with fewer SMs the plans shrink."""
    assert Q.workspace(16, 2048, 8192) == (128 * 2 * 1 * 2 * 32 * 4, 128)
    assert Q.workspace(256, 4096, 2048) == (64 * 2 * 256 * 72, 64)
    for M, N, K in ((8, 2048, 2048), (8, 92553, 2048), (1, 2048, 2048),
                    (1152, 2048, 2048)):
        assert Q.workspace(M, N, K) == (0, 0)
    assert Q.workspace(8, 2048, 2048, torch.float32) == (0, 0)
    assert Q.workspace(256, 2048, 2048, torch.float32) == (
        32 * 4 * 256 * 72 + 256 * 2048 * 3 // 2, 32)
    assert Q.workspace(1152, 2048, 8192, torch.float32) == (
        1152 * 8192 * 3 // 2, 0)
    assert Q.workspace(8, 2048, 8192, torch.float32) == (
        32 * 16 * 4 * 1 * 32 * 4, 32)
    assert Q.decode_plan(8, 2048, 2048, sms=66) == (4, 1)
    assert Q.sm90_splits(256, 2048, 2048, sms=66) == 2
    # a unit keeps at least 4 k-blocks: K = 1024 at one tile stops at 4
    assert Q.sm90_splits(128, 2048, 1024) == 4


@pytest.mark.parametrize("M", [1, 4, 8, 16, 128, 256, 1152])
def test_w8a16_call_launches(M):
    """A call's launches by kernel: the f32 prefill's wgmma GEMM after its
    pre-pass ``w8a16_split_x3``, each once, every other kernel alone; every
    name is one of ``KERNELS``, whose counts the C library keeps."""
    for N, K in ((4096, 2048), (2048, 8192), (92553, 2048), (200, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            name = Q.w8a16_kernel(M, N, K, dtype)
            got = Q.call_launches(name)
            assert set(got) <= set(Q.KERNELS)
            if name == "w8a16_sm90_f32":
                assert got == {"w8a16_split_x3": 1, name: 1}
            else:
                assert got == {name: 1}
            assert (name == "w8a16_sm90_f32") == (
                dtype == torch.float32 and M > 16 and K >= 64)


def test_w8a16_kernel_counts_need_no_card():
    """Each B12 kernel's launch count reads 0 with no library loaded, can
    be set to 0, and a CPU call launches nothing."""
    assert set(Q.kernel_launches) == set(Q.KERNELS)
    for c in Q.kernel_launches.values():
        c.launches = 0
        assert c.launches == 0
    x = torch.randn(20, 64)
    q = torch.randint(-127, 128, (128, 64), dtype=torch.int8)
    Q.w8a16_matmul(x.bfloat16(), q, torch.rand(128))
    assert all(c.launches == 0 for c in Q.kernel_launches.values())


def test_flash_sm90_mirror_matches_the_source():
    """The block, stage and rel-row constants that ``flash_attention``
    mirrors are those of ``vit_flash_attn.cu``."""
    src = "vit_flash_attn.cu"
    assert _const(src, r"kFlashRows = (\d+)") == FA.FLASH_ROWS
    assert _const(src, r"kFlashStages = (\d+)") == FA.FLASH_STAGES
    assert _const(src, r"kBQ = 64, kBK = (\d+)") == FA.FLASH_KEYS
    assert (_const(src, r"kMaxRel = (\d+)")
            + _const(src, r"kRelLd = kMaxRel \+ (\d+)")) == FA.FLASH_REL_LD


def test_flash_bwd_sm90_mirror_matches_the_source():
    """The block, stage and rel-row constants that ``flash_attention``
    mirrors for B9 are those of ``vit_flash_bwd.cu``, and its tiles are
    ``flash_sm90.cuh``'s 64-row tiles (B2's)."""
    src = "vit_flash_bwd.cu"
    assert _const(src, r"kBwdRows = (\d+)") == FA.BWD_ROWS
    assert _const(src, r"kBwdStages = (\d+)") == FA.BWD_STAGES
    assert _const(src, r"kBwdRelLd = (\d+)") == FA.BWD_REL_LD
    assert _const(src, r"kBwdMaxRows = (\d+)") == FA.BWD_MAX_ROWS
    assert _const(src, r"kBwdThreads = (\d+)") == 3 * 128
    assert _const("flash_sm90.cuh", r"kFlashBox = (\d+)") == FA.FLASH_KEYS
    # at most 16 key-grid rows in a block of 128 keys: KW >= 8
    assert FA.BWD_ROWS // min(FA._BWD_KW) == FA.BWD_MAX_ROWS


@pytest.mark.parametrize("D,want", [(64, (136272, 156752)),
                                    (80, (160848, 181328))])
def test_flash_bwd_sm90_smem_fits_a_block(D, want):
    """B9's bf16 bodies fit one block at SAM's head dims: dq + drel (q and
    do of 128 queries, 4 stages of k and v, both rel tables' rows) and dk +
    dv (k and v of 128 keys, 4 stages of q, do and the tile's rel rows,
    lse and dd); at 80 every tile has its 32-byte-swizzled tail."""
    assert FA.bwd_sm90_smem_bytes(D) == want
    assert max(want) <= FA.SMEM_LIMIT == 232448


@pytest.mark.parametrize("D,want", [(64, (230504, 220744)),
                                    (80, (222280, 228920))])
def test_flash_bwd_f32_smem_fits_a_block(D, want):
    """B9's float32 kernels (split TF32 on wgmma) fit one block at head dims
    64 and 80: the 64 fixed rows' hi and lo planes; dq's two rings of 3 / 2
    slots (k and v, k^T) and dk / dv's ring of 4 / 3 slots of 32-row
    planes, with its rel buffers."""
    assert FA.bwd_f32_smem_bytes(D) == want
    assert max(want) <= FA.SMEM_LIMIT


def test_flash_bwd_f32_mirror_matches_the_source():
    """The block, tile and rel-row constants that ``flash_attention``
    mirrors for B9's float32 kernels are those of ``vit_flash_bwd.cu``, and
    its scratch holds the 14 hi / lo planes of the split pre-pass."""
    src = "vit_flash_bwd.cu"
    assert _const(src, r"kF32Rows = (\d+)") == FA.F32_ROWS
    assert _const(src, r"kF32Tile = (\d+)") == FA.F32_TILE
    assert _const(src, r"kF32RwLd = (\d+)") == FA.F32_RW_LD
    assert _const(src, r"kF32MaxRows = (\d+)") == FA.F32_ROWS // min(
        FA._BWD_KW)
    assert _const(src, r"kF32Threads = (\d+)") == 2 * 128
    assert _const(src, r"return dtype == ullsam::kF32 \? (\d+)LL") == 14
    assert FA.bwd_f32_scratch_floats(16, 4096, 80) == 14 * 16 * 4096 * 80


@pytest.mark.parametrize("D,want", [(64, 119888), (80, 140368)])
def test_flash_sm90_smem_fits_a_block(D, want):
    """The bf16 body's shared memory (q's 128 rows, 4 stages of k and v,
    both rel tables' rows, the mbarriers) fits one block at SAM's head
    dims: 64 (ViT-B, L) and 80 (ViT-H, a 32-byte-swizzled tail a row)."""
    assert FA.sm90_smem_bytes(D) == want <= FA.SMEM_LIMIT == 232448


def test_key_rows_per_tile_rule():
    """A 64-key tile covers whole key-grid rows, and each 8-key block of
    the accumulator layout lies in one of them, exactly when KW divides 64
    and is at least 8: then rel_w is one fragment for every tile and rel_h
    one value a row a tile. Every other KW the wrappers take keeps the
    per-logit bias. SAM's 1024-pixel grids (KW = 64) take one row a tile."""
    for KW in range(1, 65):
        rows = FA.key_rows_per_tile(KW)
        whole = all(len({k // KW for k in range(t, t + 64)}) * KW == 64
                    for t in range(0, 64 * KW, 64))
        blocks = all(len({k // KW for k in range(b, b + 8)}) == 1
                     for b in range(0, 64 * KW, 8))
        assert bool(rows) == (whole and blocks), KW
        if rows:
            assert rows * KW == 64
    assert FA.key_rows_per_tile(64) == 1
    assert [FA.key_rows_per_tile(k) for k in (32, 16, 8, 48, 4)] == [
        2, 4, 8, 0, 0]


@pytest.mark.parametrize("D,want", [(64, 197712), (80, 205888)])
def test_flash_f32_smem_fits_a_block(D, want):
    """B2 / B14's float32 body (two consumer warpgroups of 64 rows, qs hi
    and lo of each, stages of k hi, k lo, v^T hi, v^T lo of 32 keys: 4 at
    head dim 64, 3 at 80) fits one block."""
    assert FA.fwd_f32_smem_bytes(D) == want <= FA.SMEM_LIMIT == 232448


def test_flash_f32_mirror_matches_the_source():
    """The block, tile, stage and scratch-plane constants that
    ``flash_attention`` mirrors for B2 / B14's float32 body are those of
    ``vit_flash_attn.cu``; the CUDA-core float32 body it replaced and the
    header that body alone still used are gone."""
    src = "vit_flash_attn.cu"
    assert _const(src, r"kF32Rows = (\d+)") == FA.FWD_F32_ROWS
    assert _const(src, r"kF32Threads = (\d+)") == 3 * 128
    assert _const(src, r"kF32Keys = (\d+)") == FA.FWD_F32_KEYS
    assert (_const(src, r"kStages = D > 64 \? (\d+)"),
            _const(src, r"kStages = D > 64 \? \d+ : (\d+)")) == (
        FA.FWD_F32_STAGES[80], FA.FWD_F32_STAGES[64])
    assert _const(src, r"kF32NatPlanes = 4, kF32Planes = (\d+)") == \
        FA.FWD_F32_PLANES
    assert (_const(src, r"return KW >= (\d+) && \d+ % KW == 0 \? KW"),
            _const(src, r"return KW >= \d+ && (\d+) % KW == 0 \? KW")) == (
        8, 64)
    with open(os.path.join(build.CSRC, src)) as f:
        text = f.read()
    for gone in ("vit_flash_f32", "attn_fma.cuh", "flash_smem_bytes",
                 "launch_f32"):
        assert gone not in text, gone
    assert not os.path.exists(os.path.join(build.CSRC, "attn_fma.cuh"))


def test_f32_bias_kw_rule():
    """The float32 body takes rel_w from registers exactly when every
    8-key block of a 32-key tile lies in one key-grid row and the tiles'
    key columns repeat every one or two tiles (KW 8, 16, 32, 64); every
    other KW keeps the per-logit bias. SAM's grids (KW = 64) take two
    fragments in turns."""
    for KW in range(1, 65):
        keys = range(0, 64 * KW)
        blocks = all(len({k // KW for k in range(b, b + 8)}) == 1
                     for b in range(0, 64 * KW, 8))
        cols = [[k % KW for k in keys[t:t + 32]]
                for t in range(0, 64 * KW, 32)]
        period = next(p for p in range(1, len(cols) + 1)
                      if all(c == cols[i % p] for i, c in enumerate(cols)))
        assert (FA.f32_bias_kw(KW) != 0) == (blocks and period <= 2), KW
        assert FA.f32_bias_kw(KW) in (0, KW)
    assert [FA.f32_bias_kw(k) for k in (64, 32, 16, 8, 48, 4)] == [
        64, 32, 16, 8, 0, 0]


def test_flash_f32_scratch_rule():
    """B2 / B14's float32 scratch: the hi and lo planes of qs, k and v^T,
    6 BH N D floats: 75,497,472 bytes at ViT-B's global blocks (12 heads of
    64) and 125,829,120 at ViT-H's (16 of 80)."""
    assert FA.fwd_f32_scratch_floats(12, 4096, 64) * 4 == 75_497_472
    assert FA.fwd_f32_scratch_floats(16, 4096, 80) * 4 == 125_829_120
    with open(os.path.join(build.CSRC, "vit_flash_attn.cu")) as f:
        assert "? 4LL * ullsam::kF32Planes * BH * N * D" in f.read()


# seg_tiles.cuh SegTiles: n, ids[64], rows[64], starts[2], live[4096 / 32]
SEG_TILES_BYTES = 4 + 64 * 4 + 64 * 4 + 2 * 4 + 4096 // 32 * 4


@pytest.mark.parametrize("D,fwd,bwd", [(64, 99368, (132184, 148584)),
                                       (128, 197672, (189528, 205928))])
def test_llm_flash_f32_smem_fits_a_block(D, fwd, bwd):
    """B10's float32 kernel (q hi / lo of 64 rows, two stages of 32 keys'
    k and v^T planes) and B11's (dq: q and do fixed, three buffers of a
    16-key tile at D = 128; dk / dv: k and v fixed, four buffers of a
    16-query tile; both with p passed between two warpgroups) fit one
    block with the static segment scan (1,036 bytes) at head dims 64 and
    128."""
    assert LF.f32_smem_bytes(D) == fwd
    assert LF.bwd_f32_smem_bytes(D) == bwd
    assert max(fwd, *bwd) + SEG_TILES_BYTES <= FA.SMEM_LIMIT == 232448


def test_llm_flash_f32_mirror_matches_the_source():
    """The tiles, stages, slots and scratch planes that
    ``llm_flash_attention`` mirrors are those of ``llm_flash_attn.cu``,
    ``llm_flash_bwd.cu`` and ``llm_f32.cuh``; the CUDA-core float32
    bodies they replaced are gone."""
    assert _const("llm_flash_attn.cu", r"kLf32FwdTile = (\d+)") == \
        LF.F32_FWD_TILE
    assert _const("llm_flash_attn.cu", r"kLf32FwdStages = (\d+)") == \
        LF.F32_FWD_STAGES
    src = "llm_flash_bwd.cu"
    assert (_const(src, r"kTile = D > 64 \? (\d+)"),
            _const(src, r"kTile = D > 64 \? \d+ : (\d+)")) == (
        LF.bwd_f32_tile(128), LF.bwd_f32_tile(64))
    hdr = "llm_f32.cuh"
    assert _const(hdr, r"kLf32Rows = (\d+)") == 64
    assert _const("llm_flash_attn.cu",
                  r"kLf32FwdThreads = (\d+)") == 2 * 128
    assert _const(src, r"kLf32BwdThreads = (\d+)") == 3 * 128
    assert (_const(hdr, r"kLf32FwdQPlanes = (\d+)"),
            _const(hdr, r"kLf32FwdKvPlanes = (\d+)")) == LF.F32_FWD_PLANES
    assert (_const(hdr, r"kLf32BwdQPlanes = (\d+)"),
            _const(hdr, r"kLf32BwdKvPlanes = (\d+)")) == LF.F32_BWD_PLANES
    for source in ("llm_flash_attn.cu", "llm_flash_bwd.cu"):
        with open(os.path.join(build.CSRC, source)) as f:
            text = f.read()
        for gone in ("llm_flash_f32", "llm_bwd_dq_f32", "llm_bwd_dkv_f32",
                     "attn_fma.cuh"):
            assert gone not in text, (source, gone)


def test_llm_flash_scratch_rules_at_the_sft_shape():
    """The wrappers' scratch at the packed sft shape (B = 1, S = 2560, 16
    heads of 128 over 8): float32 B10 the hi / lo planes of q, k and v^T
    (84 MB), B11 those of q, do, k, v and q^T, do^T, k^T (231 MB); bf16
    B11 its dq sums (21 MB), bf16 B10 none. A ragged S pads to 64 rows."""
    f32, bf16 = torch.float32, torch.bfloat16
    sft = (1, 2560, 16, 8, 128)
    assert LF.fwd_scratch_floats(*sft, f32) == 2560 * 128 * (2 * 16 + 4 * 8)
    assert LF.fwd_scratch_floats(*sft, bf16) == 0
    assert LF.bwd_scratch_floats(*sft, f32) == 2560 * 128 * (8 * 16 + 6 * 8)
    assert LF.bwd_scratch_floats(*sft, f32) * 4 == 230_686_720
    assert LF.bwd_scratch_floats(*sft, bf16) == 16 * 2560 * 128
    assert LF.bwd_scratch_floats(2, 300, 4, 1, 64, f32) == \
        2 * 320 * 64 * (8 * 4 + 6)
