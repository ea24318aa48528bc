"""B4-B7: the SAM mask decoder for many prompts against one shared image
embedding (the automatic-mask-generation sweep).

* B5 ``two_way_transformer(w, src, pe, tokens)`` -> (q [B, T, C], keys
  [B*N, C]): the depth-2 TwoWayTransformer of every prompt's tokens against
  the shared embedding ``src`` [N, C] (image embedding + no-mask prompt) and
  its positional encoding ``pe`` [N, C]. Replaces
  ``ullsam_tpu/ops/pallas/decoder.py`` ``_twt_kernel``.
* B7 ``upscale_hypernet(w, keys, hyper, H, W)`` -> logits [B, M, 4H, 4W]:
  two k = s = 2 transposed convs with grouped LayerNorm and GELU, then the
  hypernetwork dot. Replaces ``_upscale_kernel``.
* B6 ``upscale_hypernet_stats(..., thr, off)``: B7 plus the mask statistics
  (hi / lo pixel counts at thr +- off, row / column occupancy at thr).
  Replaces ``_upscale_stats_kernel`` + ``_stats_of_block``.
* B4 ``decode_masks(w, src, pe, tokens, ...)``: B5, the hypernet MLPs of the
  selected mask tokens (contiguous from ``m_lo``), then B6. Replaces
  ``_decode_kernel`` (``fused_decode_masks``).

The decode is written once (``_twt``, ``ops.upscale``, ``_decode``) over an
ops object. Its token side ([B*T, .] rows) runs primitive operations (a
GEMM, LayerNorm, the attentions), its per-prompt image side ([B*N, .] rows)
two image stages, each followed by the token -> image attention against
what it wrote, and the upscale one operation (``_Stages`` composes the
stages from the primitives). Three ops objects:

* ``_PLAIN``: plain PyTorch with the same rounding points, so each
  wrapper's plain version (``*_plain``) is the chain on ``_PLAIN``;
* ``_CUDA``: the primitives as hand-written kernels (``csrc/decoder_twt.cu``,
  ``csrc/decoder_upscale.cu``), the stages composed from them, every
  intermediate through device memory: widths other than SAM's decoder;
* ``_CUDA_FUSED`` (bf16 at SAM's widths, ``fused_twt`` / ``fused_upscale``):
  the token side as ``_CUDA``; the image stages, their token -> image
  attention and the upscale on the wgmma + TMA kernels of
  ``csrc/decoder_image.cu`` and ``csrc/decoder_upscale.cu``, which keep
  each unit of (prompt, 128 image rows)'s intermediates on chip
  (``csrc/decoder_sm90.cuh``; their notes say what bounds them);
* ``_CUDA_FUSED_F32`` (float32 at SAM's widths): the same stages on the
  float32 kernels of those files, units of (prompt, 64 image rows), their
  products in split TF32 on wgmma (``csrc/decoder_f32.cuh``), each weight
  read as its hi and lo TF32 planes (``tf32_planes``, made once when the
  weights are packed); the token -> image attentions split as flash
  decoding splits them (each unit's max, sum and sum of exp(s - max) v,
  combined per prompt); the token side's products on the wgmma GEMM's f32
  kind where it takes the shape.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernels or raises. The plain versions take ``mm`` for their
GEMMs' products (``tf32.mm_3xtf32``: the float32 kernels' split TF32), and
float64 inputs compute in float64 throughout. The shared image-side
projections (the JAX package's ``_twt_prologue``) are plain matmuls,
``image_side``: a caller
that decodes many chunks of prompts against one image (the sweep) computes
them once and passes them to every chunk's ``two_way_transformer`` /
``decode_masks`` as ``image``; without it each call computes them itself.

Rounding points (the working dtype is that of ``src``): every GEMM output
once from f32 with its bias and residual added in f32; LayerNorm outputs;
attention probabilities and outputs; the upscale's first product stays f32
through its grouped LayerNorm and exact GELU, the second is rounded, its
GELU (tanh in bf16, erf in f32, as ``layers.gelu``) rounded again before the
hypernet dot (the fused bf16 upscale takes erf and tanh by approximations
far under the bf16 rounding that follows them; float32 takes erff for
both). Counters: B4, B5, B6 and B7 each count their CUDA launches;
B4 runs B5 and B6, and B6 runs B7, so each stage counts too;
``FUSED_KERNELS`` counts each fused kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ullsam_tpu_torch.ops import layers as L
from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels import gemm as G

Tensor = torch.Tensor
Weights = Dict[str, Tensor]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
UPSCALE_LN_EPS = 1e-6

# The fused bf16 kernels' shape rules and layout (csrc/decoder_sm90.cuh,
# csrc/decoder_image.cu; the tests hold these mirrors to the sources)
UNIT_ROWS = 128          # kUnitRows: image rows (pixels) of a work unit
UNIT_STAGES = 3          # kUnitStages: weight ring slots
UNIT_C, UNIT_CD, UNIT_HEADS = 256, 128, 8  # the widths they take
UNIT_MAX_TOK = 16        # kUnitMaxTok: tokens a prompt
T2I_ROWS = 512           # kT2iRows: image rows of a decoder_t2i_part block
SMEM_LIMIT = 232448      # bytes of shared memory one block may use (H100)


def sm90_smem_bytes() -> int:
    """``kUnitSmemBytes``: 1024 bytes to align, the X tile [128][256] and
    the Q tile [128][128] bf16, the weight ring of [256][64] bf16 slots,
    each warpgroup's three [16][136] bf16 prompt rows (padded from 128), a
    full and an empty mbarrier a slot and the two warpgroups' xfull /
    xempty."""
    return (1024 + UNIT_ROWS * UNIT_C * 2 + UNIT_ROWS * UNIT_CD * 2
            + UNIT_STAGES * UNIT_C * 64 * 2
            + 2 * 3 * UNIT_MAX_TOK * (UNIT_CD + 8) * 2
            + (2 * UNIT_STAGES + 4) * 8)


# The fused float32 kernels' unit (csrc/decoder_f32.cuh): 64 image rows,
# the two consumer warpgroups splitting each product's columns
F32_UNIT_ROWS = 64       # kF32Rows
F32_UNIT_STAGES = 3      # kF32Stages: weight ring slots
F32_WK = 16              # kF32WK: K of a weight k-block (64 bytes)
F32_PROMPT_LD = 132      # kF32PromptLd: floats a prompt row (128, padded)


def f32_smem_bytes() -> int:
    """``kF32SmemBytes``: 1024 bytes to align, the X tile [64][256] and the
    Q tile [64][128] f32, the weight ring of slots of a [256][16] f32
    k-block in each of the hi and lo planes, three [16][132] f32 prompt
    rows, the LayerNorm's exchange [2][2][64] f32, a full and an empty
    mbarrier a slot, xfull and xempty."""
    return (1024 + F32_UNIT_ROWS * UNIT_C * 4 + F32_UNIT_ROWS * UNIT_CD * 4
            + F32_UNIT_STAGES * 2 * UNIT_C * F32_WK * 4
            + 3 * UNIT_MAX_TOK * F32_PROMPT_LD * 4
            + 2 * 2 * F32_UNIT_ROWS * 4 + (2 * F32_UNIT_STAGES + 2) * 8)


def units(N: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Work units a prompt of N image rows: 128-row units in bf16
    (``image_units``), 64-row ones in float32 (``f32_units``)."""
    rows = F32_UNIT_ROWS if dtype == torch.float32 else UNIT_ROWS
    return -(-N // rows)


def partial_slots(N: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Token -> image logit partials a (prompt, token, head): one for each
    warpgroup's 64 rows of a bf16 unit, one a float32 unit (whose two
    warpgroups share its 64 rows)."""
    return units(N, dtype) * (1 if dtype == torch.float32 else 2)


def t2i_part_scratch(B: int, N: int, T: int, heads: int = UNIT_HEADS) -> int:
    """f32 scratch of ``decoder_t2i_part``: a 16-wide sum per (prompt,
    512-row tile, token, head)."""
    return B * -(-N // T2I_ROWS) * T * heads * 16


def t2i_f32_scratch(B: int, N: int, T: int, heads: int = UNIT_HEADS) -> int:
    """f32 scratch of ``decoder_t2i_f32``: a partial (max, sum exp and 16
    sums) per (prompt, 512-row tile, token, head). The float32 stages'
    token -> image attention (``decoder_t2i_part_f32``) takes none: its
    partials are the stages' outputs."""
    return B * -(-N // T2I_ROWS) * T * heads * (2 + 16)


def fused_twt(dtype: torch.dtype, C: int, Cd: int, heads: int) -> bool:
    """Whether B5 runs the fused image stages: bf16 or float32 at SAM's
    decoder widths. Every other width runs the chain of primitive
    kernels."""
    return dtype in _DTYPE_CODE and (C, Cd, heads) == (
        UNIT_C, UNIT_CD, UNIT_HEADS)


def fused_upscale(dtype: torch.dtype, C: int) -> bool:
    """Whether B6 / B7 run the fused upscale (bf16 or float32, C = 256)."""
    return dtype in _DTYPE_CODE and C == UNIT_C


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def pack_weights(md, dtype: torch.dtype) -> Weights:
    """The ``MaskDecoder`` ``md``'s weights at ``dtype`` in the layouts the
    chain takes: linear weights ``[out, in]``; the self-attention's q|k|v
    and the per-prompt image-side projections concatenated along out; the
    transposed convs as per-pixel matmuls (rows (di, dj, c) of convT1,
    (ei, ej, c) of convT2) with their biases tiled to match."""
    w: Weights = {}

    def put(name, lin):
        w[name + "_w"] = lin.weight.detach().to(dtype).contiguous()
        w[name + "_b"] = lin.bias.detach().to(dtype).contiguous()

    tw = md.transformer
    for i, blk in enumerate(tw.layers):
        p = f"l{i}."
        sa = blk.self_attn
        w[p + "sa_w"] = torch.cat([sa.q_proj.weight, sa.k_proj.weight,
                                   sa.v_proj.weight]).detach().to(dtype)
        w[p + "sa_b"] = torch.cat([sa.q_proj.bias, sa.k_proj.bias,
                                   sa.v_proj.bias]).detach().to(dtype)
        put(p + "sa_out", sa.out_proj)
        t2i, i2t = blk.cross_attn_token_to_image, blk.cross_attn_image_to_token
        put(p + "t2i_q", t2i.q_proj)
        put(p + "t2i_k", t2i.k_proj)
        put(p + "t2i_v", t2i.v_proj)
        put(p + "t2i_out", t2i.out_proj)
        put(p + "mlp1", blk.mlp.lin1)
        put(p + "mlp2", blk.mlp.lin2)
        put(p + "i2t_q", i2t.q_proj)
        put(p + "i2t_k", i2t.k_proj)
        put(p + "i2t_v", i2t.v_proj)
        put(p + "i2t_out", i2t.out_proj)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            put(p + n, getattr(blk, n))
    fin = tw.final_attn_token_to_image
    put("fin_q", fin.q_proj)
    put("fin_k", fin.k_proj)
    put("fin_v", fin.v_proj)
    put("fin_out", fin.out_proj)
    put("fin_norm", tw.norm_final_attn)
    for i, mlp in enumerate(md.output_hypernetworks_mlps):
        for j, lin in enumerate(mlp.layers):
            put(f"hyper{i}.{j}", lin)
    up = md.output_upscaling
    W1, W2 = up[0].weight.detach(), up[3].weight.detach()   # [in, out, 2, 2]
    w["up1_w"] = W1.permute(2, 3, 1, 0).reshape(-1, W1.shape[0]).to(
        dtype).contiguous()
    w["up1_b"] = up[0].bias.detach().repeat(4).to(dtype)
    w["up2_w"] = W2.permute(2, 3, 1, 0).reshape(-1, W2.shape[0]).to(
        dtype).contiguous()
    w["up2_b"] = up[3].bias.detach().repeat(4).to(dtype)
    put("up_ln", up[1])
    # the per-prompt image-side projections of block 2 (k | v | q_img) and
    # of the final attention (k | v), one GEMM each
    w["img2_w"] = torch.cat([w["l1.t2i_k_w"], w["l1.t2i_v_w"],
                             w["l1.i2t_q_w"]])
    w["imgf_w"] = torch.cat([w["fin_k_w"], w["fin_v_w"]])
    C, Cd = w["up1_w"].shape[0], w["l0.t2i_q_w"].shape[0]
    if (dtype == torch.float32 and w["img2_w"].is_cuda
            and fused_twt(dtype, C, Cd, tw.layers[0].self_attn.num_heads)):
        tf32_planes(w)
    return w


# the weights the fused float32 kernels multiply by, as hi / lo TF32 planes
TF32_PLANES = ("l0.i2t_out_w", "l1.i2t_out_w", "img2_w", "imgf_w", "up1_w",
               "up2_w")


def tf32_planes(w: Weights) -> Weights:
    """Adds ``name + "_hi"`` = tf32(x) and ``name + "_lo"`` = tf32(x - hi)
    (to nearest, ties away) of each float32 CUDA weight of
    ``TF32_PLANES`` that lacks them, one ``decoder_split_tf32`` launch each
    (counted by ``split_tf32``); returns w."""
    for name in TF32_PLANES:
        if name + "_hi" in w:
            continue
        x = w[name].contiguous()
        hi, lo = torch.empty_like(x), torch.empty_like(x)
        _launch("decoder_split_tf32", x, _ptr(x), _ptr(hi), _ptr(lo),
                x.numel())
        split_tf32.launches += 1
        w[name + "_hi"], w[name + "_lo"] = hi, lo
    return w


def _w32(t: Tensor) -> Tensor:
    """t in the plain chain's working type: float64 stays float64 (a
    reference evaluation), every other dtype f32."""
    return t if t.dtype == torch.float64 else t.float()


def _lin32(x: Tensor, w: Weights, name: str) -> Tensor:
    """x @ W^T + b in f32 (the shared per-image projections)."""
    return _w32(x) @ _w32(w[name + "_w"]).T + _w32(w[name + "_b"])


# ---------------------------------------------------------------------------
# primitive operations: plain PyTorch and the CUDA kernels
# ---------------------------------------------------------------------------


def _heads_split(x: Tensor, batch: int, heads: int) -> Tensor:
    """[batch * n, h * d] -> [batch, h, n, d] in f32."""
    n = x.shape[0] // batch
    return _w32(x.reshape(batch, n, heads, -1).transpose(1, 2))


def _heads_merge(x: Tensor, dtype) -> Tensor:
    """[batch, h, n, d] -> [batch * n, h * d] at dtype."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b * n, h * d).to(dtype)


def _attend(q: Tensor, k: Tensor, v: Tensor, qb: int, kb: int,
            heads: int) -> Tensor:
    """Per-head softmax(q k^T d^-1/2) v with q [qb * n, h d] and k, v
    [kb * m, h d]; a batch of 1 is shared by the other side's batch. The
    probabilities are rounded to q's dtype before p.v."""
    qh = _heads_split(q, qb, heads)
    kh, vh = _heads_split(k, kb, heads), _heads_split(v, kb, heads)
    logits = qh @ kh.transpose(-1, -2) * qh.shape[-1] ** -0.5
    p = _w32(torch.softmax(logits, dim=-1).to(q.dtype))
    return _heads_merge(p @ vh, q.dtype)


class _Stages:
    """B5's per-prompt image side and the upscale as the stages the fused
    bf16 kernels run (``_CudaFusedOps``), composed here from the primitive
    operations: the plain versions, and the CUDA chain of every other dtype
    and width. A stage's ``part`` (the fused kernels' token -> image logit
    partials) is None here. Stage 1's ``carry`` is a list of what stage 2
    reads; stage 2 empties it, so that each tensor is freed once read."""

    def image_stage1(self, w, img, kt1, vt1, q2, B, heads, eps):
        """Block 1's image side against the prompts' tokens kt1, vt1
        [B*T, Cd], and block 2's per-prompt keys and values: (kv [B*N, 2Cd]
        (k | v), part, carry). q2 [B*T, Cd] are the queries kv is attended
        by (block 2's token -> image attention)."""
        Cd = kt1.shape[1]
        o = self.i2t(img["qi1"], kt1, vt1, B, heads, True)
        keys = self.ln(self.gemm(o, w["l0.i2t_out_w"], w["l0.i2t_out_b"],
                                 res=img["src"]),
                       w["l0.norm4_w"], w["l0.norm4_b"], eps)
        prj = self.gemm(keys, w["img2_w"], res=img["res2"])  # k | v | q_img
        return prj[:, :2 * Cd], None, [keys, prj[:, 2 * Cd:]]

    def image_stage2(self, w, img, carry, kt2, vt2, qf, B, heads, eps):
        """Block 2's image side against kt2, vt2 and the final attention's
        keys and values: (keys [B*N, C], kv [B*N, 2Cd], part); qf the final
        attention's queries."""
        keys, q_img = carry
        carry.clear()
        o = self.i2t(q_img, kt2, vt2, B, heads, False)
        del q_img
        keys = self.ln(self.gemm(o, w["l1.i2t_out_w"], w["l1.i2t_out_b"],
                                 res=keys),
                       w["l1.norm4_w"], w["l1.norm4_b"], eps)
        return keys, self.gemm(keys, w["imgf_w"], res=img["resf"]), None

    def t2i_part(self, q, kv, part, B, heads):
        """Token -> image attention of q [B*T, Cd] against a stage's
        per-prompt kv [B*N, 2Cd]."""
        Cd = q.shape[1]
        return self.t2i(q, kv[:, :Cd], kv[:, Cd:], B, heads, False)

    def upscale(self, w, keys, hyper, H, W, stats):
        """keys [B*H*W, C], hyper [B, M, C/8] -> logits [B, M, 4H, 4W], and
        with stats = (thr, off) B6's statistics of them."""
        R = keys.shape[0]
        u1 = self.gemm(keys, w["up1_w"], w["up1_b"], out_f32=True)  # [R, C]
        u1 = self.ln_gelu(u1, w["up_ln_w"], w["up_ln_b"], UPSCALE_LN_EPS,
                          keys.dtype)
        # one row per (pixel, sub-pixel group (di, dj)): [4R, C/4] -> [4R,
        # 4 C8]
        u2 = self.gemm(u1.view(4 * R, -1), w["up2_w"], w["up2_b"])
        logits = self.upscale_out(u2.view(R, -1), hyper, H, W)
        if stats is None:
            return logits
        return (logits, *self.stats(logits, *stats))


class _PlainOps(_Stages):
    """The primitive operations in plain PyTorch; ``mm`` takes the GEMMs'
    products."""

    def __init__(self, mm=torch.matmul):
        self.mm = mm

    def gemm(self, a, w, b=None, res=None, relu=False, out_f32=False):
        y = self.mm(_w32(a), _w32(w).T)
        if b is not None:
            y = y + _w32(b)
        if res is not None:
            y = (y.view(-1, res.shape[0], y.shape[1]) + _w32(res)).view(
                y.shape)
        if relu:
            y = y.relu()
        return y if out_f32 else y.to(a.dtype)

    @staticmethod
    def ln(x, w, b, eps):
        return L.layer_norm(x, w, b, eps=eps)

    @staticmethod
    def self_attn(q, k, v, B, heads):
        """Each prompt's tokens q, k, v [B*T, C] among themselves."""
        return _attend(q, k, v, B, B, heads)

    @staticmethod
    def t2i(q, k, v, B, heads, shared):
        """Token -> image: q [B*T, Cd] against k, v [N, Cd] (shared) or
        [B*N, Cd] (per prompt) -> [B*T, Cd]."""
        return _attend(q, k, v, B, 1 if shared else B, heads)

    @staticmethod
    def i2t(qi, kt, vt, B, heads, shared):
        """Image -> token: qi [N, Cd] (shared) or [B*N, Cd] against each
        prompt's tokens kt, vt [B*T, Cd] -> [B*N, Cd]."""
        return _attend(qi, kt, vt, 1 if shared else B, B, heads)

    @staticmethod
    def ln_gelu(u, w, b, eps, dtype):
        """Grouped LayerNorm of u [R, C] f32 over its four C/4 groups
        (one-pass statistics), exact GELU, at dtype."""
        g = u.view(u.shape[0], 4, -1)
        m1 = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - m1 * m1).clamp_min(0.0)
        y = (g - m1) * torch.rsqrt(var + eps) * _w32(w) + _w32(b)
        return F.gelu(y).reshape(u.shape).to(dtype)

    @staticmethod
    def upscale_out(u2, hyper, H, W):
        """u2 [B*H*W, 16 * C8] (sub-pixels (di, dj, ei, ej)), hyper
        [B, M, C8] -> logits [B, M, 4H, 4W]."""
        B, M, C8 = hyper.shape
        g = _w32(L.gelu(u2)).view(B, H, W, 2, 2, 2, 2, C8)
        out = torch.einsum("bhwijklc,bmc->bmhikwjl", g, _w32(hyper))
        return out.reshape(B, M, 4 * H, 4 * W).to(u2.dtype)

    @staticmethod
    def stats(logits, thr, off):
        """(counts [B, M, 2] of logits > thr + off and > thr - off, rowany
        [B, M, 4H], colany [B, M, 4W] of logits > thr), int32."""
        x = _w32(logits)
        hi = (x > thr + off).sum((-2, -1))
        lo = (x > thr - off).sum((-2, -1))
        z = x > thr
        return (torch.stack([hi, lo], -1).int(), z.any(-1).int(),
                z.any(-2).int())


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    "decoder_gemm": ("decoder_twt", [_I, _I, _P, _P, _P, _P, _I, _P, _I, _I,
                                     _I, _I, _P]),
    "decoder_ln": ("decoder_twt", [_I, _P, _P, _P, _P, _LL, _I, _F, _P]),
    "decoder_self_attn": ("decoder_twt", [_I, _P, _I, _P, _I, _P, _I, _P, _I,
                                          _I, _I, _I, _F, _P]),
    "decoder_t2i_scratch": ("decoder_twt", [_I, _I, _I, _I]),
    "decoder_t2i": ("decoder_twt", [_I, _P, _P, _P, _I, _LL, _P, _P, _I, _I,
                                    _I, _I, _I, _F, _P]),
    "decoder_i2t": ("decoder_twt", [_I, _P, _I, _LL, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _F, _P]),
    "decoder_ln_gelu": ("decoder_upscale", [_I, _P, _P, _P, _P, _LL, _I, _F,
                                            _P]),
    "decoder_upscale_out": ("decoder_upscale", [_I, _P, _P, _P, _I, _I, _I,
                                                _I, _I, _I, _P]),
    "decoder_mask_stats": ("decoder_upscale", [_I, _P, _LL, _I, _I, _F, _F,
                                               _F, _P, _P, _P, _P]),
    "decoder_image_stage": ("decoder_image", [_I] + [_P] * 16
                            + [_I, _I, _I, _F, _F, _P]),
    "decoder_t2i_part": ("decoder_image", [_P] * 5 + [_I, _I, _I, _F, _P]),
    "decoder_upscale_fused": ("decoder_upscale", [_I] + [_P] * 12
                              + [_I] * 4 + [_F] * 4 + [_P]),
    "decoder_image_stage_f32": ("decoder_image", [_I] + [_P] * 20
                                + [_I, _I, _I, _F, _F, _P]),
    "decoder_t2i_part_f32": ("decoder_image", [_P] * 3 + [_I] * 3 + [_P]),
    "decoder_split_tf32": ("decoder_image", [_P, _P, _P, _LL, _P]),
    "decoder_t2i_f32": ("decoder_image", [_P, _P, _P, _I, _LL, _P, _P, _I,
                                          _I, _I, _F, _P]),
    "decoder_upscale_fused_f32": ("decoder_upscale", [_I] + [_P] * 14
                                  + [_I] * 4 + [_F] * 4 + [_P]),
}


def _fn(name: str):
    lib, argtypes = _SIGNATURES[name]
    return build.function(lib, name, argtypes,
                          _LL if name == "decoder_t2i_scratch" else _I)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows(t: Tensor) -> int:
    """Row stride of a 2-D tensor whose rows are contiguous and 16-byte
    aligned (the attention kernels read 16 values of a head at a time)."""
    if (t.dim() != 2 or t.stride(1) != 1 or t.data_ptr() % 16
            or t.stride(0) * t.element_size() % 16):
        raise ValueError(f"decoder: expected 2-D rows with unit stride and "
                         f"16-byte alignment, got {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t.stride(0)


def _launch(name: str, ref: Tensor, *args) -> None:
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = _fn(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


class _CudaOps(_Stages):
    """The same operations as ``_PlainOps`` on the hand-written kernels."""

    @staticmethod
    def gemm(a, w, b=None, res=None, relu=False, out_f32=False):
        M, K = a.shape
        N = w.shape[0]
        for t in (a, w, b, res):
            if t is not None and not t.is_contiguous():
                raise ValueError("decoder_gemm: operands must be contiguous")
        dt = torch.float32 if out_f32 else a.dtype
        out = torch.empty((M, N), device=a.device, dtype=dt)
        _launch("decoder_gemm", a, _DTYPE_CODE[a.dtype], int(out_f32),
                _ptr(a), _ptr(w), _ptr(b), _ptr(res),
                0 if res is None else res.shape[0], _ptr(out), M, N, K,
                int(relu))
        return out

    @staticmethod
    def ln(x, w, b, eps):
        y = torch.empty_like(x)
        _launch("decoder_ln", x, _DTYPE_CODE[x.dtype], _ptr(x), _ptr(w),
                _ptr(b), _ptr(y), x.shape[0], x.shape[1], eps)
        return y

    @staticmethod
    def self_attn(q, k, v, B, heads):
        BT, C = q.shape
        o = torch.empty((BT, C), device=q.device, dtype=q.dtype)
        _launch("decoder_self_attn", q, _DTYPE_CODE[q.dtype], _ptr(q),
                _rows(q), _ptr(k), _rows(k), _ptr(v), _rows(v), _ptr(o), B,
                BT // B, C, heads, (C // heads) ** -0.5)
        return o

    @staticmethod
    def t2i(q, k, v, B, heads, shared):
        BT, Cd = q.shape
        T = BT // B
        N = k.shape[0] if shared else k.shape[0] // B
        ld = _rows(k)
        if _rows(v) != ld:
            raise ValueError("decoder_t2i: k and v need one row stride")
        part = torch.empty(_fn("decoder_t2i_scratch")(B, N, T, heads),
                           device=q.device, dtype=torch.float32)
        o = torch.empty((BT, Cd), device=q.device, dtype=q.dtype)
        _launch("decoder_t2i", q, _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k),
                _ptr(v), ld, 0 if shared else N * ld, _ptr(part), _ptr(o), B,
                N, T, heads, Cd, (Cd // heads) ** -0.5)
        return o

    @staticmethod
    def i2t(qi, kt, vt, B, heads, shared):
        BT, Cd = kt.shape
        N = qi.shape[0] if shared else qi.shape[0] // B
        ld = _rows(qi)
        o = torch.empty((B * N, Cd), device=qi.device, dtype=qi.dtype)
        _launch("decoder_i2t", qi, _DTYPE_CODE[qi.dtype], _ptr(qi), ld,
                0 if shared else N * ld, _ptr(kt), _ptr(vt), _ptr(o), B, N,
                BT // B, heads, Cd, (Cd // heads) ** -0.5)
        return o

    @staticmethod
    def ln_gelu(u, w, b, eps, dtype):
        y = torch.empty(u.shape, device=u.device, dtype=dtype)
        _launch("decoder_ln_gelu", u, _DTYPE_CODE[dtype], _ptr(u), _ptr(w),
                _ptr(b), _ptr(y), u.shape[0], u.shape[1], eps)
        return y

    @staticmethod
    def upscale_out(u2, hyper, H, W):
        B, M, C8 = hyper.shape
        out = torch.empty((B, M, 4 * H, 4 * W), device=u2.device,
                          dtype=u2.dtype)
        _launch("decoder_upscale_out", u2, _DTYPE_CODE[u2.dtype], _ptr(u2),
                _ptr(hyper), _ptr(out), B, H * W, H, W, M, C8)
        return out

    @staticmethod
    def stats(logits, thr, off):
        B, M, H4, W4 = logits.shape
        dev = logits.device
        counts = torch.zeros((B, M, 2), device=dev, dtype=torch.int32)
        rowany = torch.zeros((B, M, H4), device=dev, dtype=torch.int32)
        colany = torch.zeros((B, M, W4), device=dev, dtype=torch.int32)
        _launch("decoder_mask_stats", logits, _DTYPE_CODE[logits.dtype],
                _ptr(logits), B * M, H4, W4, thr + off, thr - off, thr,
                _ptr(counts), _ptr(rowany), _ptr(colany))
        return counts, rowany, colany


class _CudaFusedOps(_CudaOps):
    """bf16 at SAM's decoder widths (``fused_twt`` / ``fused_upscale``): B5's
    image side on ``csrc/decoder_image.cu``'s two stages and its token ->
    image attention from their partials, the upscale on
    ``csrc/decoder_upscale.cu``'s fused kernel; every other operation as
    ``_CudaOps``. The stages' ``carry`` is [keys1 [B*N, C]]."""

    @staticmethod
    def _stage(stage, w, img, rows, kt, vt, qt, B, heads, eps):
        """One launch of image stage ``stage`` (block ``stage - 1``'s image
        side) on ``rows`` (qi1 or keys1): (its keys [B*N, C], k | v
        [B*N, 2Cd], logit partials)."""
        src = img["src"]
        N, C = src.shape
        T, Cd = kt.shape[0] // B, kt.shape[1]
        keys, kv = (torch.empty(B * N, C, device=src.device, dtype=src.dtype)
                    for _ in range(2))
        part = torch.empty((B, partial_slots(N), T * heads, 2),
                           device=src.device, dtype=torch.float32)
        blk = f"l{stage - 1}."
        _launch("decoder_image_stage", src, stage, _ptr(rows), _ptr(src),
                _ptr(img["res2"]), _ptr(img["resf"]),
                *(_ptr(w[blk + k]) for k in ("i2t_out_w", "i2t_out_b",
                                             "norm4_w", "norm4_b")),
                _ptr(w["img2_w" if stage == 1 else "imgf_w"]),
                _ptr(w["img2_w"]), _ptr(kt), _ptr(vt), _ptr(qt), _ptr(keys),
                _ptr(kv), _ptr(part), B, N, T, (Cd // heads) ** -0.5, eps)
        FUSED_KERNELS[f"image_stage{stage}"].launches += 1
        return keys, kv, part

    @staticmethod
    def image_stage1(w, img, kt1, vt1, q2, B, heads, eps):
        keys1, kv, part = _CudaFusedOps._stage(1, w, img, img["qi1"], kt1,
                                               vt1, q2, B, heads, eps)
        return kv, part, [keys1]

    @staticmethod
    def image_stage2(w, img, carry, kt2, vt2, qf, B, heads, eps):
        return _CudaFusedOps._stage(2, w, img, carry.pop(), kt2, vt2, qf, B,
                                    heads, eps)

    @staticmethod
    def t2i_part(q, kv, part, B, heads):
        BT, Cd = q.shape
        T, N = BT // B, kv.shape[0] // B
        scratch = torch.empty(t2i_part_scratch(B, N, T, heads),
                              device=q.device, dtype=torch.float32)
        o = torch.empty((BT, Cd), device=q.device, dtype=q.dtype)
        _launch("decoder_t2i_part", q, _ptr(q), _ptr(kv), _ptr(part),
                _ptr(scratch), _ptr(o), B, N, T, (Cd // heads) ** -0.5)
        FUSED_KERNELS["t2i_part"].launches += 1
        return o

    @staticmethod
    def upscale(w, keys, hyper, H, W, stats):
        B, M, _ = hyper.shape
        dev = keys.device
        out = torch.empty((B, M, 4 * H, 4 * W), device=dev, dtype=keys.dtype)
        st = None
        thr, off = stats if stats is not None else (0.0, 0.0)
        if stats is not None:
            st = tuple(torch.zeros(shape, device=dev, dtype=torch.int32)
                       for shape in ((B, M, 2), (B, M, 4 * H), (B, M, 4 * W)))
        _launch("decoder_upscale_fused", keys, int(st is not None),
                _ptr(keys), *(_ptr(w[k]) for k in (
                    "up1_w", "up1_b", "up_ln_w", "up_ln_b", "up2_w",
                    "up2_b")),
                _ptr(hyper), _ptr(out), *((None,) * 3 if st is None else
                                          (_ptr(t) for t in st)),
                B, H, W, M, thr + off, thr - off, thr, UPSCALE_LN_EPS)
        name = "upscale_unit" if st is None else "upscale_unit_stats"
        FUSED_KERNELS[name].launches += 1
        return out if st is None else (out, *st)


class _CudaFusedF32Ops(_CudaOps):
    """float32 at SAM's decoder widths: ``_CudaFusedOps``'s stages on the
    float32 kernels of ``csrc/decoder_image.cu`` and
    ``csrc/decoder_upscale.cu`` (units of 64 image rows, split TF32), each
    weight they multiply by read as its TF32 planes (``tf32_planes``);
    block 1's token -> image attention on ``decoder_t2i_f32``; every other
    operation as ``_CudaOps``. The stages' ``carry`` is [keys1
    [B*N, C]]."""

    @staticmethod
    def _stage(stage, w, img, rows, kt, vt, qt, B, heads, eps):
        src = img["src"]
        N, C = src.shape
        T, Cd = kt.shape[0] // B, kt.shape[1]
        keys, kv = (torch.empty(B * N, C, device=src.device, dtype=src.dtype)
                    for _ in range(2))
        # each unit's token -> image partials: (max, sum exp) and the 16
        # sums of exp(s - max) v of each (token, head)
        ml, po = (torch.empty((B, partial_slots(N, src.dtype), T * heads, n),
                              device=src.device, dtype=torch.float32)
                  for n in (2, Cd // heads))
        tf32_planes(w)
        blk = f"l{stage - 1}."
        kvw = "img2_w" if stage == 1 else "imgf_w"
        _launch("decoder_image_stage_f32", src, stage, _ptr(rows), _ptr(src),
                _ptr(img["res2"]), _ptr(img["resf"]),
                _ptr(w[blk + "i2t_out_w_hi"]), _ptr(w[blk + "i2t_out_w_lo"]),
                *(_ptr(w[blk + k]) for k in ("i2t_out_b", "norm4_w",
                                             "norm4_b")),
                _ptr(w[kvw + "_hi"]), _ptr(w[kvw + "_lo"]),
                _ptr(w["img2_w_hi"]), _ptr(w["img2_w_lo"]), _ptr(kt),
                _ptr(vt), _ptr(qt), _ptr(keys), _ptr(kv), _ptr(ml), _ptr(po),
                B, N, T, (Cd // heads) ** -0.5, eps)
        FUSED_KERNELS[f"image_stage{stage}_f32"].launches += 1
        return keys, kv, (ml, po)

    @staticmethod
    def image_stage1(w, img, kt1, vt1, q2, B, heads, eps):
        keys1, kv, part = _CudaFusedF32Ops._stage(1, w, img, img["qi1"], kt1,
                                                  vt1, q2, B, heads, eps)
        return kv, part, [keys1]

    @staticmethod
    def image_stage2(w, img, carry, kt2, vt2, qf, B, heads, eps):
        return _CudaFusedF32Ops._stage(2, w, img, carry.pop(), kt2, vt2, qf,
                                       B, heads, eps)

    @staticmethod
    def t2i_part(q, kv, part, B, heads):
        """The stage's token -> image attention from its units' partials
        ``part`` = (ml, po) alone (flash decoding; ``decoder_image.cu``)."""
        BT, Cd = q.shape
        T, N = BT // B, kv.shape[0] // B
        ml, po = part
        o = torch.empty((BT, Cd), device=q.device, dtype=q.dtype)
        _launch("decoder_t2i_part_f32", q, _ptr(ml), _ptr(po), _ptr(o), B, N,
                T)
        FUSED_KERNELS["t2i_part_f32"].launches += 1
        return o

    @staticmethod
    def t2i(q, k, v, B, heads, shared):
        """Block 1's token -> image attention against the image's k1 / v1
        (``shared``) on ``decoder_t2i_f32``: a 512-row tile's partials in
        one pass over k and v, then ``t2i_part``'s combination."""
        BT, Cd = q.shape
        T = BT // B
        N = k.shape[0] if shared else k.shape[0] // B
        ld = _rows(k)
        if _rows(v) != ld:
            raise ValueError("decoder_t2i_f32: k and v need one row stride")
        scratch = torch.empty(t2i_f32_scratch(B, N, T, heads),
                              device=q.device, dtype=torch.float32)
        o = torch.empty((BT, Cd), device=q.device, dtype=q.dtype)
        _launch("decoder_t2i_f32", q, _ptr(q), _ptr(k), _ptr(v), ld,
                0 if shared else N * ld, _ptr(scratch), _ptr(o), B, N, T,
                (Cd // heads) ** -0.5)
        FUSED_KERNELS["t2i_f32"].launches += 1
        return o

    @staticmethod
    def upscale(w, keys, hyper, H, W, stats):
        B, M, _ = hyper.shape
        dev = keys.device
        out = torch.empty((B, M, 4 * H, 4 * W), device=dev, dtype=keys.dtype)
        st = None
        thr, off = stats if stats is not None else (0.0, 0.0)
        if stats is not None:
            st = tuple(torch.zeros(shape, device=dev, dtype=torch.int32)
                       for shape in ((B, M, 2), (B, M, 4 * H), (B, M, 4 * W)))
        tf32_planes(w)
        _launch("decoder_upscale_fused_f32", keys, int(st is not None),
                _ptr(keys), _ptr(w["up1_w_hi"]), _ptr(w["up1_w_lo"]),
                *(_ptr(w[k]) for k in ("up1_b", "up_ln_w", "up_ln_b")),
                _ptr(w["up2_w_hi"]), _ptr(w["up2_w_lo"]), _ptr(w["up2_b"]),
                _ptr(hyper), _ptr(out), *((None,) * 3 if st is None else
                                          (_ptr(t) for t in st)),
                B, H, W, M, thr + off, thr - off, thr, UPSCALE_LN_EPS)
        name = "upscale_unit_f32" if st is None else "upscale_unit_stats_f32"
        FUSED_KERNELS[name].launches += 1
        return out if st is None else (out, *st)


_PLAIN, _CUDA, _CUDA_FUSED = _PlainOps(), _CudaOps(), _CudaFusedOps()
_CUDA_FUSED_F32 = _CudaFusedF32Ops()


class KernelCount:
    """The launches of one of the fused kernels, added to where the kernel
    launches."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


# the fused kernels: decoder_image.cu's stages (one launch each a B5 call)
# and token -> image attention (two a B5 call; float32 also block 1's
# against the shared image, t2i_f32), decoder_upscale.cu's upscale without
# (B7) and with (B6) statistics; bf16, and float32 (_f32)
FUSED_KERNELS = {n: KernelCount(n) for n in (
    "image_stage1", "image_stage2", "t2i_part", "upscale_unit",
    "upscale_unit_stats", "image_stage1_f32", "image_stage2_f32",
    "t2i_part_f32", "t2i_f32", "upscale_unit_f32", "upscale_unit_stats_f32")}
# decoder_split_tf32: a float32 weight's TF32 planes, once a packing
# (``tf32_planes``), not once a call
split_tf32 = KernelCount("split_tf32")
# the wgmma GEMM's f32 kind launched by decoder_gemm (the token side's and
# the hypernet MLPs' float32 products), counted in C
decoder_gemm_f32 = G.GemmLaunches(2, ("decoder_twt",))


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------


def _add(a: Tensor, b: Tensor) -> Tensor:
    """a + b rounded to a's dtype (the reference adds in the dtype)."""
    return (_w32(a) + _w32(b)).to(a.dtype)


def image_side(w: Weights, src: Tensor, pe: Tensor) -> Weights:
    """The transformer's work on the shared image alone, once per image
    (the JAX package's ``_twt_prologue``), in plain matmuls: block 1's keys,
    values and image queries, and the encoding's share of block 2's and the
    final attention's per-prompt image-side projections with their biases
    folded in, so that each prompt's projections are one GEMM with this as
    the shared residual. src, pe [N, C] -> {"src", "k1", "v1", "qi1",
    "res2", "resf"} at src's dtype."""
    dt = src.dtype
    N, Cd = src.shape[0], w["l0.t2i_q_w"].shape[0]
    src = src.contiguous()
    src_pe = _add(src, pe)
    pe32 = _w32(pe)
    return {
        "src": src,
        "k1": _lin32(src_pe, w, "l0.t2i_k").to(dt),
        "v1": _lin32(src, w, "l0.t2i_v").to(dt),
        "qi1": _lin32(src_pe, w, "l0.i2t_q").to(dt),
        "res2": torch.cat([_lin32(pe32, w, "l1.t2i_k"),
                           _w32(w["l1.t2i_v_b"]).expand(N, Cd),
                           _lin32(pe32, w, "l1.i2t_q")], dim=1).to(dt),
        "resf": torch.cat([_lin32(pe32, w, "fin_k"),
                           _w32(w["fin_v_b"]).expand(N, Cd)],
                          dim=1).to(dt)}


def _twt(ops, w: Weights, img: Weights, tokens: Tensor, heads: int,
         eps: float) -> Tuple[Tensor, Tensor]:
    """Depth-2 TwoWayTransformer of tokens [B, T, C] against the shared
    image ``img`` (``image_side``) -> (q [B, T, C], keys [B*N, C]). The
    token side ([B*T, .] rows) runs on the primitive operations; the
    per-prompt image side ([B*N, .] rows) in ops' two image stages, each
    followed by the token -> image attention against what it wrote. Block
    2's self-attention reads only block 1's token side, so it runs before
    stage 1."""
    B, T, C = tokens.shape
    tok = tokens.reshape(B * T, C)

    def nrm(x, name):
        return ops.ln(x, w[name + "_w"], w[name + "_b"], eps)

    def lin(x, name, **kw):
        return ops.gemm(x, w[name + "_w"], w[name + "_b"], **kw)

    # block 1's token side: self-attention without positional encoding or
    # residual, t2i against the shared k1 / v1, MLP
    qkv = ops.gemm(tok, w["l0.sa_w"], w["l0.sa_b"])
    o = ops.self_attn(qkv[:, :C], qkv[:, C:2 * C], qkv[:, 2 * C:], B, heads)
    q = nrm(lin(o, "l0.sa_out"), "l0.norm1")
    o = ops.t2i(lin(_add(q, tok), "l0.t2i_q"), img["k1"], img["v1"], B,
                heads, True)
    q = nrm(lin(o, "l0.t2i_out", res=q), "l0.norm2")
    q = nrm(lin(lin(q, "l0.mlp1", relu=True), "l0.mlp2", res=q), "l0.norm3")
    kt1, vt1 = lin(_add(q, tok), "l0.i2t_k"), lin(q, "l0.i2t_v")

    # block 2's self-attention
    qpe = _add(q, tok)
    qk = ops.gemm(qpe, w["l1.sa_w"][:2 * C], w["l1.sa_b"][:2 * C])
    v = ops.gemm(q, w["l1.sa_w"][2 * C:], w["l1.sa_b"][2 * C:])
    o = ops.self_attn(qk[:, :C], qk[:, C:], v, B, heads)
    q = nrm(lin(o, "l1.sa_out", res=q), "l1.norm1")
    q2 = lin(_add(q, tok), "l1.t2i_q")

    # image stage 1 (block 1's image side, block 2's keys and values), then
    # the rest of block 2's token side
    kv, part, carry = ops.image_stage1(w, img, kt1, vt1, q2, B, heads, eps)
    o = ops.t2i_part(q2, kv, part, B, heads)
    del kv, part
    q = nrm(lin(o, "l1.t2i_out", res=q), "l1.norm2")
    q = nrm(lin(lin(q, "l1.mlp1", relu=True), "l1.mlp2", res=q), "l1.norm3")

    # image stage 2 (block 2's image side, the final attention's keys and
    # values), then the final token -> image attention
    qf = lin(_add(q, tok), "fin_q")
    keys, kv, part = ops.image_stage2(
        w, img, carry, lin(_add(q, tok), "l1.i2t_k"), lin(q, "l1.i2t_v"), qf,
        B, heads, eps)
    o = ops.t2i_part(qf, kv, part, B, heads)
    del kv, part
    q = nrm(lin(o, "fin_out", res=q), "fin_norm")
    return q.view(B, T, C), keys


def _hyper(ops, w: Weights, q: Tensor, m_lo: int, M: int) -> Tensor:
    """The hypernet MLPs of mask tokens m_lo .. m_lo + M - 1 of q [B, T, C]
    -> [B, M, C/8]."""
    outs = []
    for m in range(m_lo, m_lo + M):
        x = q[:, 1 + m].contiguous()
        x = ops.gemm(x, w[f"hyper{m}.0_w"], w[f"hyper{m}.0_b"], relu=True)
        x = ops.gemm(x, w[f"hyper{m}.1_w"], w[f"hyper{m}.1_b"], relu=True)
        outs.append(ops.gemm(x, w[f"hyper{m}.2_w"], w[f"hyper{m}.2_b"]))
    return torch.stack(outs, dim=1)


# ---------------------------------------------------------------------------
# the wrappers: plain versions, shape checks, launch counters
# ---------------------------------------------------------------------------


def _check_twt(w: Weights, src: Tensor, pe: Tensor, tokens: Tensor,
               heads: int) -> None:
    """The kernels take SAM's decoder widths: C = 32 heads, Cd = 16 heads,
    C % 128 == 0, MLP width % 32 == 0, 1 <= T <= 16 tokens."""
    N, C = src.shape
    B, T, Ct = tokens.shape
    Cd, mlp = w["l0.t2i_q_w"].shape[0], w["l0.mlp1_w"].shape[0]
    if (Ct != C or tuple(pe.shape) != (N, C) or C != 32 * heads
            or Cd != 16 * heads or C % 128 or mlp % 32 or not 1 <= T <= 16):
        raise ValueError(f"decoder kernels: unsupported shape C={C} Cd={Cd} "
                         f"heads={heads} mlp={mlp} T={T} (tokens "
                         f"{tuple(tokens.shape)}, src {tuple(src.shape)}, "
                         f"pe {tuple(pe.shape)})")
    _check_dtypes(src, pe, tokens)


def _check_up(w: Weights, keys: Tensor, hyper: Tensor, H: int,
              W: int) -> None:
    """1 <= M <= 4 masks, C % 128 == 0, hypernet width C / 8."""
    R, C = keys.shape
    B, M, C8 = hyper.shape
    if (R != B * H * W or C % 128 or C8 * 8 != C or not 1 <= M <= 4
            or tuple(w["up1_w"].shape) != (C, C)):
        raise ValueError(f"decoder kernels: unsupported upscale shape keys "
                         f"{tuple(keys.shape)} hyper {tuple(hyper.shape)} "
                         f"H={H} W={W}")
    _check_dtypes(keys, hyper)


def _check_dtypes(*ts: Tensor) -> None:
    ref = ts[0]
    if ref.dtype not in _DTYPE_CODE or any(
            t.dtype != ref.dtype or t.device != ref.device for t in ts):
        raise ValueError("decoder kernels: unsupported dtype or device mix "
                         + ", ".join(f"{t.dtype} on {t.device}" for t in ts))


def _cuda_ops(name: str, ref: Tensor, fused: bool = False):
    """_CUDA_FUSED or _CUDA_FUSED_F32 by ref's dtype (``fused``: the shapes
    the fused kernels take) or _CUDA for a CUDA tensor (the CPU's plain
    path is taken before); anything else raises."""
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ref.device}")
    if not fused:
        return _CUDA
    return _CUDA_FUSED_F32 if ref.dtype == torch.float32 else _CUDA_FUSED


def _plain_ops(mm) -> _PlainOps:
    return _PLAIN if mm is torch.matmul else _PlainOps(mm)


def two_way_transformer_plain(w: Weights, src: Tensor, pe: Tensor,
                              tokens: Tensor, *, heads: int, eps: float,
                              image: Optional[Weights] = None,
                              mm=torch.matmul) -> Tuple[Tensor, Tensor]:
    img = image_side(w, src, pe) if image is None else image
    return _twt(_plain_ops(mm), w, img, tokens, heads, eps)


def two_way_transformer(w: Weights, src: Tensor, pe: Tensor, tokens: Tensor,
                        *, heads: int, eps: float,
                        image: Optional[Weights] = None
                        ) -> Tuple[Tensor, Tensor]:
    """B5: (q [B, T, C], keys [B*N, C]) of tokens [B, T, C] against the
    shared src, pe [N, C]; weights from ``pack_weights``, ``image`` from
    ``image_side(w, src, pe)`` (computed here when None)."""
    if src.device.type == "cpu":
        return two_way_transformer_plain(w, src, pe, tokens, heads=heads,
                                         eps=eps, image=image)
    _check_twt(w, src, pe, tokens, heads)
    C, Cd = src.shape[1], w["l0.t2i_q_w"].shape[0]
    ops = _cuda_ops("two_way_transformer", src,
                    fused_twt(src.dtype, C, Cd, heads))
    img = image_side(w, src, pe) if image is None else image
    out = _twt(ops, w, img, tokens.contiguous(), heads, eps)
    two_way_transformer.launches += 1
    return out


def upscale_hypernet_plain(w: Weights, keys: Tensor, hyper: Tensor, *,
                           H: int, W: int, mm=torch.matmul) -> Tensor:
    return _plain_ops(mm).upscale(w, keys, hyper, H, W, None)


def upscale_hypernet(w: Weights, keys: Tensor, hyper: Tensor, *, H: int,
                     W: int) -> Tensor:
    """B7: keys [B*H*W, C], hyper [B, M, C/8] -> logits [B, M, 4H, 4W]."""
    if keys.device.type == "cpu":
        return upscale_hypernet_plain(w, keys, hyper, H=H, W=W)
    _check_up(w, keys, hyper, H, W)
    ops = _cuda_ops("upscale_hypernet", keys,
                    fused_upscale(keys.dtype, keys.shape[1]))
    out = ops.upscale(w, keys.contiguous(), hyper.contiguous(), H, W, None)
    upscale_hypernet.launches += 1
    return out


def upscale_stats_plain(logits: Tensor, thr: float, off: float):
    """B6's statistics of given logits [B, M, 4H, 4W] in plain PyTorch:
    (counts [B, M, 2], rowany [B, M, 4H], colany [B, M, 4W]) int32."""
    return _PLAIN.stats(logits, thr, off)


def upscale_hypernet_stats_plain(w: Weights, keys: Tensor, hyper: Tensor, *,
                                 H: int, W: int, thr: float, off: float,
                                 mm=torch.matmul):
    return _plain_ops(mm).upscale(w, keys, hyper, H, W, (thr, off))


def upscale_hypernet_stats(w: Weights, keys: Tensor, hyper: Tensor, *,
                           H: int, W: int, thr: float, off: float):
    """B6: B7 plus (counts [B, M, 2] (hi, lo) int32, rowany [B, M, 4H],
    colany [B, M, 4W] int32) of the logits: counts of logits > thr + off
    and > thr - off, occupancy of logits > thr."""
    if keys.device.type == "cpu":
        return upscale_hypernet_stats_plain(w, keys, hyper, H=H, W=W,
                                            thr=thr, off=off)
    _check_up(w, keys, hyper, H, W)
    ops = _cuda_ops("upscale_hypernet_stats", keys,
                    fused_upscale(keys.dtype, keys.shape[1]))
    out = ops.upscale(w, keys.contiguous(), hyper.contiguous(), H, W,
                      (float(thr), float(off)))
    upscale_hypernet.launches += 1  # B6 is B7 plus the statistics
    upscale_hypernet_stats.launches += 1
    return out


def _decode(ops, twt, up_stats, w, src, pe, tokens, H, W, heads, eps, m_lo,
            M, thr, off, image):
    q, keys = twt(w, src, pe, tokens, heads=heads, eps=eps, image=image)
    hyper = _hyper(ops, w, q, m_lo, M)
    return (q, *up_stats(w, keys, hyper, H=H, W=W, thr=thr, off=off))


def decode_masks_plain(w: Weights, src: Tensor, pe: Tensor, tokens: Tensor,
                       *, H: int, W: int, heads: int, eps: float, m_lo: int,
                       M: int, thr: float, off: float,
                       image: Optional[Weights] = None, mm=torch.matmul):
    ops = _plain_ops(mm)
    img = image_side(w, src, pe) if image is None else image
    q, keys = _twt(ops, w, img, tokens, heads, eps)
    hyper = _hyper(ops, w, q, m_lo, M)
    return (q, *ops.upscale(w, keys, hyper, H, W, (thr, off)))


def decode_masks(w: Weights, src: Tensor, pe: Tensor, tokens: Tensor, *,
                 H: int, W: int, heads: int, eps: float, m_lo: int, M: int,
                 thr: float, off: float, image: Optional[Weights] = None):
    """B4: the whole per-prompt decode of tokens [B, T, C] against the
    shared src, pe [H*W, C] (``image`` as B5's): (q [B, T, C], logits
    [B, M, 4H, 4W] of mask tokens m_lo .. m_lo + M - 1, counts, rowany,
    colany as B6's)."""
    if src.device.type == "cpu":
        return decode_masks_plain(w, src, pe, tokens, H=H, W=W, heads=heads,
                                  eps=eps, m_lo=m_lo, M=M, thr=thr, off=off,
                                  image=image)
    _check_twt(w, src, pe, tokens, heads)
    C = src.shape[1]
    if not 1 <= M <= 4 or src.shape[0] != H * W or C // 8 > 64:
        raise ValueError(f"decoder kernels: unsupported M={M} or grid "
                         f"{H}x{W} for src {tuple(src.shape)}")
    out = _decode(_cuda_ops("decode_masks", src), two_way_transformer,
                  upscale_hypernet_stats, w, src, pe, tokens, H, W, heads,
                  eps, m_lo, M, thr, off, image)
    decode_masks.launches += 1
    return out


two_way_transformer.launches = 0
upscale_hypernet.launches = 0
upscale_hypernet_stats.launches = 0
decode_masks.launches = 0
KERNELS = (decode_masks, two_way_transformer, upscale_hypernet_stats,
           upscale_hypernet)
