"""The main path's kernel inputs and requests, in one place for the tools
that check, time and profile them (``chip_smoke.py``,
``tools/profile_kernels.py``).

Each kernel case returns (args, kwargs, flops, bytes): inputs drawn from
``gen`` on its device at the SAM ViT-B + InternLM2-1.8B main-path shape,
the operations the call does, and the bytes it must move (each input read
once, each output written once).

The packed LLM fine-tuning path (``--mode sft --pack``) has its own batch,
``packed_train_batch``, and kernel cases, ``llm_flash_case`` (B10, B11);
caption generation its request, ``caption_inputs``, and the B12 cases,
``w8a16_case`` at ``w8a16_cases()``. SAM ViT-H's automatic mask generation
(``VIT_H``) runs B1 and B2 at head dim 80 and, behind the JAX package's
switches, B3, B13, B14 and B15: ``window_attn_case``, ``vit_flash_case``
and ``window_core_case`` take its widths, ``ln_mlp_case`` and
``vit_flash_packed_case`` are the opt-in kernels' own.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ullsam_tpu_torch.core.config import FusionConfig

# B1: the 64x64 ViT-B grid padded to 70x70, 25 windows of 14x14
WINDOW_GEOMETRY = dict(nwx=5, nwy=5, Hv=64, Wv=64, masked=True)


# SAM ViT-H: C = 1280 in 16 heads of 80, MLP 5120; the 64x64 grid in the
# same 25 padded 14x14 windows (T = 4900 rows) and N = 4096 global tokens;
# 28 windowed and 4 global blocks an image
VIT_H = dict(C=1280, nh=16, F=5120)
VIT_B = dict(C=768, nh=12, F=3072)

# the JAX package's encoder switches (``ops/kernels/flags.py``) and the five
# route settings the ViT-H path is driven and timed under
SWITCHES = ("ULLSAM_FUSED_VIT_ATTN", "ULLSAM_FUSED_VIT_MLP",
            "ULLSAM_PACKED_GLOBAL", "ULLSAM_WINDOW_TWOPHASE")
VIT_H_ROUTES = {
    "default": {},
    "fused_mlp": {"ULLSAM_FUSED_VIT_MLP": "1"},
    "packed_global": {"ULLSAM_PACKED_GLOBAL": "1"},
    "unfused_window": {"ULLSAM_FUSED_VIT_ATTN": "0"},
    "unfused_twophase": {"ULLSAM_FUSED_VIT_ATTN": "0",
                         "ULLSAM_WINDOW_TWOPHASE": "1"},
}


@contextlib.contextmanager
def switches(env: dict):
    """The switches set to ``env`` (every other one unset) inside the
    block, restored after it."""
    saved = {k: os.environ.pop(k, None) for k in SWITCHES}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def route_launches(env: dict, windowed: int, global_: int) -> dict:
    """The kernel launches (wrapper name -> count) of one encode with
    ``windowed`` and ``global_`` blocks under the switches ``env``."""
    if env.get("ULLSAM_FUSED_VIT_ATTN", "1") != "0":
        w = "window_attn"
    elif env.get("ULLSAM_WINDOW_TWOPHASE") == "1":
        w = "window_attn_core_twophase"
    else:
        w = "window_attn_core"
    g = ("vit_flash_attn_packed" if env.get("ULLSAM_PACKED_GLOBAL") == "1"
         else "vit_flash_attn")
    want = {w: windowed, g: global_}
    if env.get("ULLSAM_FUSED_VIT_MLP", "0") != "0":
        want["ln_mlp"] = windowed + global_
    return want


def window_attn_case(dtype: torch.dtype, gen: torch.Generator,
                     C: int = 768, nh: int = 12, **_):
    """B1 at the main-path shape: x [25, 196, C], nh heads (ViT-B: 768, 12
    of 64; ViT-H: 1280, 16 of 80)."""
    Bw, n, ws = 25, 196, 14
    hd = C // nh

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * s).to(dtype)

    args = (r(Bw, n, C), 1 + r(C, s=0.1), r(C, s=0.1),
            r(3 * C, C, s=C ** -0.5), r(3 * C, s=0.1), r(C, C, s=C ** -0.5),
            r(C, s=0.1), r(ws, ws, hd, s=0.1), r(ws, ws, hd, s=0.1))
    kw = dict(num_heads=nh, eps=1e-6, **WINDOW_GEOMETRY)
    M = Bw * n
    flops = (2 * M * C * 3 * C + 2 * M * C * C + 4 * Bw * nh * n * n * hd
             + 2 * Bw * nh * n * 2 * ws * hd)
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + M * C * args[0].element_size()
    return args, kw, flops, nbytes


def vit_flash_case(dtype: torch.dtype, gen: torch.Generator,
                   C: int = 768, nh: int = 12, **_):
    """B2 at the global blocks of one image: q, k, v [nh, 4096, C / nh],
    rel_h and rel_w [nh, 4096, 64] (ViT-B: 12 heads of 64; ViT-H: 16 of
    80)."""
    BH, N, D, K = nh, 4096, C // nh, 64

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * s).to(dtype)

    args = (r(BH, N, D), r(BH, N, D), r(BH, N, D), r(BH, N, K, s=0.5),
            r(BH, N, K, s=0.5))
    flops = 4 * BH * N * N * D
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + args[0].numel() * args[0].element_size() + BH * N * 4
    return args, {}, flops, nbytes


# ---------------------------------------------------------------------------
# the train step's backward kernels (B3, B8, B9)
# ---------------------------------------------------------------------------

# B3 / B8: the ViT-B windows of one 1024x1024 image: 25 windows of 14x14,
# 12 heads of 64
WINDOW_CORE = dict(Bw=25, ws=14, nh=12)
# B9: the ViT-B global blocks: 12 heads over the 64x64 grid
FLASH_BWD = dict(BH=12, KH=64, KW=64)


def window_core_flops(Bw: int, ws: int, nh: int, hd: int = 64) -> dict:
    """Operations (2 per multiply-add) of B3 and B8 over Bw windows of
    n = ws*ws tokens: B3 = q.k and p.v plus the rel-pos terms; B8 = five
    n x n x hd products (s, dp, dv, dq, dk), the recomputed rel-pos terms,
    their share of dq and the table gradients."""
    n, rl = ws * ws, 2 * ws
    per = Bw * nh
    rel = 2 * per * n * rl * hd
    return {"fwd": per * 4 * n * n * hd + rel,
            "bwd": per * 10 * n * n * hd + 3 * rel}


def flash_bwd_flops(BH: int, N: int, D: int = 64) -> int:
    """B9: the five products of 2 N^2 D per head that the gradient needs
    (s, dp, dv, dq, dk). The two-kernel split recomputes s and dp in both
    kernels, so the kernels do 7/5 of this."""
    return 10 * BH * N * N * D


def window_core_case(dtype: torch.dtype, gen: torch.Generator, Bw: int = 25,
                     ws: int = 14, nh: int = 12, hd: int = 64):
    """B3 (and B15) and B8 inputs: qkv [Bw*n, 3C], rh, rw [ws, ws, hd], do
    [Bw*n, C] with C = nh * hd; returns (args_fwd, args_bwd, flops, bytes)
    with flops and bytes dicts keyed "fwd" / "bwd"."""
    n, C = ws * ws, nh * hd

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * s).to(dtype)

    qkv, rh, rw, do = (r(Bw * n, 3 * C, s=0.5), r(ws, ws, hd, s=0.2),
                       r(ws, ws, hd, s=0.2), r(Bw * n, C, s=0.5))
    eb = qkv.element_size()
    tables = (rh.numel() + rw.numel()) * eb
    nbytes = {"fwd": (qkv.numel() + Bw * n * C) * eb + tables,
              "bwd": (2 * qkv.numel() + do.numel()) * eb + tables
              + (rh.numel() + rw.numel()) * 4}
    return ((qkv, rh, rw), (qkv, rh, rw, do),
            window_core_flops(Bw, ws, nh, hd), nbytes)


def vit_flash_bwd_case(dtype: torch.dtype, gen: torch.Generator,
                       BH: int = 12, KH: int = 64, KW: int = 64):
    """B9 inputs at the ViT-B global blocks: q, k, v, do [12, 4096, 64],
    rel_h, rel_w [12, 4096, 64], and the forward's lse and dd = sum(do * o)
    (made by B2, or by its plain version on the CPU); returns (args, flops,
    bytes)."""
    from ullsam_tpu_torch.ops.kernels import flash_attention as FA
    N, D = KH * KW, 64

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * s).to(dtype)

    q, k, v, do = (r(BH, N, D) for _ in range(4))
    rh, rw = r(BH, N, KH, s=0.5), r(BH, N, KW, s=0.5)
    o, lse = FA.vit_flash_attn(q, k, v, rh, rw)
    dd = (do.float() * o.float()).sum(-1)
    eb = q.element_size()
    nbytes = (7 * q.numel() + rh.numel() + rw.numel()) * eb \
        + 2 * lse.numel() * 4 + (rh.numel() + rw.numel()) * 4
    return (q, k, v, rh, rw, do, lse, dd), flash_bwd_flops(BH, N, D), nbytes


def train_batch(cfg: FusionConfig, rng: np.random.Generator,
                n_inst: int = 4, n_pts: int = 2, text_len: int = 64):
    """The flagship train batch of ``benchmarks/bench_train_step.py``: one
    S x S image (pixels in [0, 255)), 1024 image tokens + ``text_len``,
    ``n_inst`` instances of ``n_pts`` positive points, S x S masks."""
    S = cfg.sam.vit.img_size
    n = cfg.num_image_token
    ids = np.full((1, n + text_len), 11, np.int64)
    ids[0, 2:2 + n] = cfg.img_context_token_id
    return {"pixel_values": (rng.random((1, S, S, 3)) * 255).astype(
                np.float32),
            "input_ids": ids, "attention_mask": np.ones_like(ids),
            "point_coords": (rng.random((1, n_inst, n_pts, 2)) * S).astype(
                np.float32),
            "point_labels": np.ones((1, n_inst, n_pts), np.int64),
            "masks": rng.random((1, n_inst, S, S)) > 0.7,
            "instance_valid": np.ones((1, n_inst), np.float32)}


def request_inputs(cfg: FusionConfig, rng: np.random.Generator,
                   n_clicks: int, text_len: int = 64):
    """(pixels [1, S, S, 3] f32, input_ids [1, 1024 + text_len] with the
    IMG_CONTEXT run at 2..1025, clicks [1, n_clicks, 2], labels
    [1, n_clicks]), as `__graft_entry__.py` builds a request."""
    S = cfg.sam.vit.img_size
    n_img = cfg.num_image_token
    ids = np.full((1, n_img + text_len), 11, np.int64)
    ids[0, 2:2 + n_img] = cfg.img_context_token_id
    pixels = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    coords = (rng.random((1, n_clicks, 2)) * S).astype(np.float32)
    labels = np.ones((1, n_clicks), np.int64)
    labels[0, 1:] = rng.integers(0, 2, n_clicks - 1)
    return pixels, ids, coords, labels


def ln_mlp_case(dtype: torch.dtype, gen: torch.Generator, T: int = 4900,
                C: int = 1280, F: int = 5120, **_):
    """B13 inputs: x [T, C], LN2 [C], fc1 [F, C] + [F], fc2 [C, F] + [C]
    (T = 4900: a windowed block's 25 windows of 196; 4096: a global
    block); returns (args, kwargs, flops, bytes). Operations: the two
    products, 4 T C F; bytes: x, the weights and the output (the hidden
    activations h [T, F] are the kernel's own)."""
    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * s).to(dtype)

    args = (r(T, C), 1 + r(C, s=0.1), r(C, s=0.1), r(F, C, s=C ** -0.5),
            r(F, s=0.1), r(C, F, s=F ** -0.5), r(C, s=0.1))
    flops = 4 * T * C * F
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + T * C * args[0].element_size()
    return args, {"eps": 1e-6}, flops, nbytes


def vit_flash_packed_case(dtype: torch.dtype, gen: torch.Generator,
                          C: int = 1280, nh: int = 16, B: int = 1, **_):
    """B14 inputs at the global blocks of B images: qkv [B, 4096, 3C] (the
    projection's natural layout), rel_h, rel_w [B*nh, 4096, 64]; returns
    (args, kwargs, flops, bytes), B2's operations."""
    N, K = 4096, 64
    D = C // nh

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * s).to(dtype)

    args = (r(B, N, 3 * C), r(B * nh, N, K, s=0.5), r(B * nh, N, K, s=0.5))
    flops = 4 * B * nh * N * N * D
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + B * N * C * args[0].element_size() + B * nh * N * 4
    return args, {"nh": nh}, flops, nbytes


# ---------------------------------------------------------------------------
# the automatic-mask-generation sweep (B4-B7)
# ---------------------------------------------------------------------------

# one AMG chunk of SAM ViT-B: 256 point prompts against the 64x64 embedding,
# T = 7 tokens (iou, 4 mask tokens, the point and its pad), M = 3 masks
AMG_CHUNK = dict(B=256, H=64, W=64, T=7, M=3)


def decoder_flops(B: int, N: int, T: int, M: int, C: int = 256,
                  Cd: int = 128, mlp: int = 2048) -> dict:
    """Multiply-add operations (2 per MAC) of each decoder kernel, counted
    from its products: {"twt", "hyper", "upscale", "decode"}."""
    shared = 2 * N * C * Cd * 6            # k1, v1, qi1 and pe's shares
    tok_block = 2 * B * T * (4 * C * C + 2 * T * C + 2 * C * Cd
                             + 2 * N * Cd + 2 * C * mlp + 2 * C * Cd)
    img_block = 2 * B * N * (2 * T * Cd + Cd * C)
    final = 2 * B * N * C * 2 * Cd + 2 * B * T * (2 * C * Cd + 2 * N * Cd)
    twt = (shared + 2 * tok_block + 2 * img_block + 2 * B * N * C * 3 * Cd
           + final)
    C8 = C // 8
    upscale = 2 * B * N * (C * C + C * C // 2 + 16 * C8 * M)
    hyper = 2 * B * M * (2 * C * C + C * C8)
    return {"twt": twt, "hyper": hyper, "upscale": upscale,
            "decode": twt + hyper + upscale}


def decoder_cases(dtype: torch.dtype, gen: torch.Generator, B: int = 256,
                  H: int = 64, W: int = 64, T: int = 7, M: int = 3):
    """B4, B5, B6 and B7 at one decoder shape (default: the AMG chunk of
    SAM ViT-B's full-width decoder, weights drawn from ``gen``): a dict
    name -> (args, kwargs, flops, bytes)."""
    from ullsam_tpu_torch.core.config import MaskDecoderConfig
    from ullsam_tpu_torch.models.sam.mask_decoder import MaskDecoder
    from ullsam_tpu_torch.ops import layers as L
    from ullsam_tpu_torch.ops.kernels import decoder as D

    cfg = MaskDecoderConfig()
    md = MaskDecoder(cfg, device=gen.device)
    L.init_module_(md, gen)
    w = D.pack_weights(md, dtype)
    C, N = cfg.transformer_dim, H * W
    m_lo = 1 if M < cfg.num_mask_tokens else 0

    def r(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * s).to(dtype)

    src, pe, tokens = r(N, C, s=0.5), r(N, C, s=0.5), r(B, T, C, s=0.5)
    keys, hyper = r(B * N, C), r(B, M, C // 8, s=0.5)
    eb = src.element_size()
    fl = decoder_flops(B, N, T, M, C)

    def nbytes(*ts):
        return sum(t.numel() for t in ts) * eb

    w_twt = [v for k, v in w.items() if k.startswith(("l0.", "l1.", "fin_"))]
    w_up = [v for k, v in w.items() if k.startswith("up")]
    w_hyp = [w[f"hyper{m}.{j}_{x}"] for m in range(m_lo, m_lo + M)
             for j in range(3) for x in "wb"]
    logits = B * M * 16 * N
    stats = B * M * (2 + 4 * H + 4 * W) * 4
    twt_kw = dict(heads=cfg.transformer_num_heads, eps=cfg.ln_eps)
    up_kw = dict(H=H, W=W)
    st_kw = dict(H=H, W=W, thr=0.0, off=1.0)
    return {
        "decode_masks": (
            (w, src, pe, tokens), dict(**twt_kw, **st_kw, m_lo=m_lo, M=M),
            fl["decode"], nbytes(src, pe, tokens, tokens, *w_twt, *w_hyp,
                                 *w_up) + logits * eb + stats),
        "two_way_transformer": (
            (w, src, pe, tokens), twt_kw, fl["twt"],
            nbytes(src, pe, tokens, tokens, keys, *w_twt)),
        "upscale_hypernet_stats": (
            (w, keys, hyper), st_kw, fl["upscale"],
            nbytes(keys, hyper, *w_up) + logits * eb + stats),
        "upscale_hypernet": (
            (w, keys, hyper), up_kw, fl["upscale"],
            nbytes(keys, hyper, *w_up) + logits * eb),
    }


def amg_inputs(rng: np.random.Generator, n_images: int, size: int = 1024):
    """``n_images`` uint8 images [size, size, 3] from ``rng``."""
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(n_images)]


def decoder_outputs(name: str, out):
    """(float outputs, int statistics or None, logits or None) of a decoder
    kernel's result, for comparing a kernel with its plain version: the
    statistics must equal the plain statistics of the kernel's own logits."""
    if name == "decode_masks":
        return out[:2], out[2:], out[1]
    if name == "upscale_hypernet_stats":
        return out[:1], out[1:], out[0]
    if name == "two_way_transformer":
        return out, None, None
    return (out,), None, out


# ---------------------------------------------------------------------------
# packed LLM fine-tuning (B10, B11)
# ---------------------------------------------------------------------------

# one packed row of the sft path: two samples of 1124 and 1224 tokens (each
# a 1024-token image run plus text) and 212 pad tokens, S = 2560; the
# segment boundaries fall mid-tile, at 1124 and 2348
PACKED_ROW = dict(lengths=(1124, 1224), S=2560)
# B10 / B11 there: InternLM2-1.8B's 16 query heads of 128 over 8 kv heads
LLM_FLASH = dict(B=1, S=2560, nh=16, nkv=8, D=128)
# the TrainConfig fields the JAX CLI sets for --mode sft (cli.py:180-195):
# language CE only, the LLM, mlp1 and mlp2 train, SAM frozen; remat stays
# at its default, on
SFT_TRAIN = dict(seg_weight=0.0, llm_weight=1.0, use_llm_hidden_states=False,
                 trainable_patterns=(r"llm\..*", r"mlp1\..*", r"mlp2\..*"))


def packed_train_batch(cfg: FusionConfig, rng: np.random.Generator,
                       lengths=PACKED_ROW["lengths"],
                       S: int = PACKED_ROW["S"]):
    """One packed row of ``len(lengths)`` samples, as
    ``data.packing.pack_examples`` builds it: sample i is a start token,
    the image's ``num_image_token`` <IMG_CONTEXT> run and text up to
    ``lengths[i]`` tokens (synthetic ids, no tokenizer), segment id i + 1;
    pad (id 0) to S. Labels are the ids, -100 on image and pad tokens;
    pixel_values [len(lengths), img, img, 3] in [0, 255)."""
    n_img, ctx = cfg.num_image_token, cfg.img_context_token_id
    seg = packed_segments(lengths, S).astype(np.int64)
    ids = np.zeros((1, S), np.int64)
    off = 0
    for n in lengths:
        row = rng.integers(3, min(cfg.llm.vocab_size, ctx), n)
        row[0] = 1
        row[1:1 + n_img] = ctx
        ids[0, off:off + n] = row
        off += n
    labels = np.where((ids == ctx) | (seg == 0), -100, ids)
    img = cfg.sam.vit.img_size
    return {"pixel_values": (rng.random((len(lengths), img, img, 3))
                             * 255).astype(np.float32),
            "input_ids": ids, "segment_ids": seg, "labels": labels}


def packed_segments(lengths=PACKED_ROW["lengths"], S: int = PACKED_ROW["S"],
                    B: int = 1) -> np.ndarray:
    """Segment ids [B, S] of a packed row: 1, 2, ... per sample, 0 after."""
    if sum(lengths) > S:
        raise ValueError(f"samples of {sum(lengths)} tokens overflow S={S}")
    seg = np.zeros((B, S), np.int32)
    off = 0
    for i, n in enumerate(lengths):
        seg[:, off:off + n] = i + 1
        off += n
    return seg


def llm_flash_flops(seg: np.ndarray, nh: int, D: int, causal: bool = True):
    """{"fwd", "bwd"} operations (2 per multiply-add) that B10 and B11 need
    for these segment ids: 2 products (q.k, p.v) of 2 D per valid (query,
    key) pair and head forward, 5 backward (s, dp, dv, dq, dk); a pair is
    valid when the segments match (and key <= query when causal). Also
    {"fwd_causal", "bwd_causal"}: the same over every pair at or below the
    diagonal, the causal half the TPU kernel's tiles cover."""
    pairs = 0
    S = seg.shape[-1]
    for row in seg:
        _, counts = np.unique(row, return_counts=True)
        pairs += int(sum(c * (c + 1) // 2 if causal else c * c
                         for c in counts))
    half = seg.shape[0] * (S * S / 2 if causal else S * S)
    return {"fwd": 4 * D * nh * pairs, "bwd": 10 * D * nh * pairs,
            "fwd_causal": 4 * D * nh * half, "bwd_causal": 10 * D * nh * half}


def llm_flash_case(dtype: torch.dtype, gen: torch.Generator, B: int = 1,
                   S: int = 2560, nh: int = 16, nkv: int = 8, D: int = 128,
                   lengths=PACKED_ROW["lengths"]):
    """B10 and B11 inputs at the packed sft path's shape: q [B, S, nh, D],
    k, v [B, S, nkv, D], segment ids of the packed row, and for B11 do plus
    the forward's lse and dd = sum(do * o) (made by B10, or by its plain
    version on the CPU). Returns (fwd args, bwd args, kwargs, flops dict of
    ``llm_flash_flops``, bytes dict {"fwd", "bwd"})."""
    from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device).to(dtype)

    seg_np = packed_segments(lengths, S, B)
    seg = torch.from_numpy(seg_np).to(gen.device)
    q, k, v, do = r(B, S, nh, D), r(B, S, nkv, D), r(B, S, nkv, D), \
        r(B, S, nh, D)
    kw = dict(num_kv_heads=nkv, causal=True)
    o, lse = LF.llm_flash_attn(q, k, v, seg, seg, **kw)
    dd = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    eb = q.element_size()
    qb, kvb, rows = q.numel() * eb, k.numel() * eb, B * nh * S * 4
    nbytes = {"fwd": 2 * qb + 2 * kvb + 2 * seg.numel() * 4 + rows,
              "bwd": 3 * qb + 4 * kvb + 2 * seg.numel() * 4 + 2 * rows}
    return ((q, k, v, seg, seg), (q, k, v, seg, seg, do, lse, dd), kw,
            llm_flash_flops(seg_np, nh, D), nbytes)


# ---------------------------------------------------------------------------
# caption generation with the int8 weight-only LLM (B12)
# ---------------------------------------------------------------------------

# InternLM2-1.8B's linears as (N, K) = (out, in): wqkv, wo, w1 and w3, w2,
# the vocab head; each runs B12 once a decode step at batch M
W8A16_LINEARS = ((4096, 2048), (2048, 2048), (8192, 2048), (2048, 8192),
                 (92553, 2048))
W8A16_DECODE_M = (1, 8)
# ... and once a prefill, at M = 1152 tokens (the caption prompt) and 8 x
# 1152 (the batch-8 request); there the head's last 128-column tile is
# ragged (92553 % 128 = 9)
W8A16_PREFILL_M = (1152, 9216)
# the caption request: 1024 <IMG_CONTEXT> + 64 text tokens, and a batch of 8
# with distinct text lengths; both left-pad to S = 1152
CAPTION_TEXT = 64
CAPTION_BATCH_TEXT = (64, 57, 50, 43, 36, 29, 22, 15)


def w8a16_cases():
    """(M, N, K) of every B12 case: each linear at the decode batches, then
    at the prefill sizes."""
    return [(M, N, K) for M in W8A16_DECODE_M + W8A16_PREFILL_M
            for N, K in W8A16_LINEARS]


def w8a16_case(dtype: torch.dtype, gen: torch.Generator, M: int, N: int,
               K: int):
    """B12 inputs drawn from ``gen``: x [M, K] ``dtype``, qweight [N, K]
    int8 in [-127, 127], qscale [N] f32 (kwargs: none, the f32 output).
    Returns (args, kwargs, flops, bytes): 2 M N K operations; x, the int8
    weight and the scales read once, the f32 output written once."""
    x = torch.randn(M, K, generator=gen, device=gen.device).to(dtype)
    q = torch.randint(-127, 128, (N, K), generator=gen, device=gen.device,
                      dtype=torch.int8)
    s = torch.rand(N, generator=gen, device=gen.device) * 0.01 + 0.001
    nbytes = M * K * x.element_size() + N * K + N * 4 + M * N * 4
    return (x, q, s), {}, 2 * M * N * K, nbytes


def caption_inputs(cfg: FusionConfig, rng: np.random.Generator,
                   text_lens=(CAPTION_TEXT,)):
    """(pixels [1, S, S, 3] f32, input_ids, attention_mask [B, N]) of a
    caption request: row b is 2 text tokens, the ``num_image_token``
    <IMG_CONTEXT> run and ``text_lens[b] - 2`` more text tokens (synthetic
    ids, no tokenizer), left-padded with the pad id to a multiple of 128
    (``chat.left_pad``). One image serves every row."""
    from ullsam_tpu_torch.models.ullsam.chat import left_pad
    S = cfg.sam.vit.img_size
    n_img, ctx = cfg.num_image_token, cfg.img_context_token_id
    rows = []
    for n in text_lens:
        text = rng.integers(3, min(cfg.llm.vocab_size, ctx), n - 2).tolist()
        rows.append([1, 11] + [ctx] * n_img + text)
    ids, mask = left_pad(rows, cfg.llm.pad_token_id)
    pixels = rng.standard_normal((1, S, S, 3)).astype(np.float32)
    return pixels, ids, mask
