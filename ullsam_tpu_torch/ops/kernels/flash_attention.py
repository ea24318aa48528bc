"""B2: ViT global flash attention with the factored decomposed rel-pos bias.

``vit_flash_attn(q, k, v, rel_h, rel_w) -> (o, lse)`` computes

    o   = softmax(prescale_q(q) k^T + bias) v
    lse = row logsumexp (f32)

with bias[i, key] = rel_h[i, key // KW] + rel_w[i, key % KW], KH*KW = N.

It replaces the TPU kernel ``ullsam_tpu/ops/pallas/flash_attention.py``
``_vit_kernel`` (entry ``vit_flash_attention``). On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/vit_flash_attn.cu`` (see the note
there: operation-bound; bf16 on wgmma fed by TMA, float32 on wgmma in split
TF32, three TF32 products a product, after a pre-pass that writes the hi
and lo planes of qs, k and v^T into scratch the wrapper allocates,
``fwd_f32_scratch_floats``); on a CPU tensor it runs
``vit_flash_attn_plain``. There is no fallback from the kernel. The bf16
body adds the bias from registers when a 64-key tile covers whole key-grid
rows (``key_rows_per_tile``), and per logit from shared memory otherwise;
``sm90_smem_bytes`` mirrors its shared memory. The float32 body streams
32-key tiles and takes rel_w from registers when ``f32_bias_kw`` says so;
``fwd_f32_smem_bytes`` mirrors its shared memory.

B14, ``vit_flash_attn_packed(qkv, rel_h, rel_w, nh)``, is B2's function
read straight from the qkv projection [B, N, 3C] (head h of q, k, v at
columns h*hd, C + h*hd, 2C + h*hd) and written into o [B, N, C] at column
h*hd, the layout proj consumes: no head-split copy, no merge transpose. It
replaces ``_vit_kernel_packed`` (entry ``vit_flash_attention_packed``),
which the JAX package runs under ``ULLSAM_PACKED_GLOBAL=1``; its kernel is
B2's body with other strides (``csrc/vit_flash_attn.cu``). Its gradient
(``VitFlashPacked``) splits into heads and runs B9, as
``_vit_flash_packed_bwd`` does. B2, B14 and B9 take head dims 64 and 80.

B9, ``vit_flash_attn_bwd``, is its gradient (``_vit_bwd_dq_kernel`` and
``_vit_bwd_dkv_kernel``, through ``_vit_flash_bwd_impl``), launched from
``csrc/vit_flash_bwd.cu`` on a CUDA tensor: in bf16 two wgmma + TMA
kernels on B2's tiles (a block of 128 queries for dq and drel, of 128
keys for dk and dv; ``bwd_sm90_smem_bytes`` mirrors their shared memory),
in float32 the same pair on wgmma in split TF32 (three TF32 products a
product, f32-accurate; ``bwd_f32_smem_bytes``) after a pre-pass that
writes the operands' hi and lo planes, some transposed, into scratch. It
scores as the TPU kernels do, from unscaled q. ``vit_flash_attention`` is the
differentiable entry: a ``torch.autograd.Function`` whose forward is B2 and
whose backward is B9 on both devices.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ullsam_tpu_torch.ops.kernels import build

Tensor = torch.Tensor

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80)  # B2, B14, B9: SAM ViT-B / L and ViT-H
# the bf16 body (csrc/vit_flash_attn.cu vit_flash_sm90): 128 queries a block
# (two warpgroups of 64), 64-key tiles in a ring of 4 stages, rel rows of
# 64 + 8 bf16
FLASH_ROWS, FLASH_KEYS, FLASH_STAGES, FLASH_REL_LD = 128, 64, 4, 72
SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
# B9's bf16 bodies (csrc/vit_flash_bwd.cu): 128 queries or keys a block, a
# ring of 4 stages, rel rows of 64 + 8 bf16, at most 16 key-grid rows a
# dk / dv block (KW >= 8)
BWD_ROWS, BWD_STAGES, BWD_REL_LD, BWD_MAX_ROWS = 128, 4, 72, 16
# B9's float32 bodies: 64 queries or keys a block, streamed tiles of 32
# rows, dk / dv's rel_w rows of 32 + 8 floats
F32_ROWS, F32_TILE, F32_RW_LD = 64, 32, 40
_BWD_KW = (8, 16, 32, 64)  # B9: KW divides a 64-key tile
# B2 / B14's float32 body (vit_flash_tf32): 128 queries a block (two
# warpgroups of 64), 32-key stages, 4 of them at head dim 64 and 3 at 80;
# its scratch holds 6 planes of BH N D floats (qs, k, v^T; hi and lo)
FWD_F32_ROWS, FWD_F32_KEYS, FWD_F32_PLANES = 128, 32, 6
FWD_F32_STAGES = {64: 4, 80: 3}


def q_scale(D: int, dtype: torch.dtype) -> float:
    """D^-1/2 rounded to ``dtype``: the constant by which the JAX package's
    ``(q * D ** -0.5).astype(q.dtype)`` multiplies a q of that dtype (a
    weakly typed Python float takes q's dtype, so in bf16 the product is a
    bf16 op by bf16(D^-1/2): 0.08837890625 at D = 128, 0.11181640625 at
    D = 80). Each forward wrapper (B2, B14, B10) passes it to its kernel,
    which multiplies in f32 and rounds once to q's dtype."""
    return torch.tensor(D ** -0.5, dtype=dtype).item()


def prescale_q(q: Tensor) -> Tensor:
    """q * D^-1/2 as the JAX package's forward kernels take it: the product
    by ``q_scale`` in f32 (exact for bf16 operands), rounded once to
    q.dtype. Bitwise equal to ``(q * D ** -0.5).astype(q.dtype)`` in bf16
    and f32."""
    return (q.float() * q_scale(q.shape[-1], q.dtype)).to(q.dtype)


def _tiles(D: int) -> int:
    """Bytes of two 64-row tiles (``flash_sm90.cuh`` ``FlashTiles<D>``):
    128 swizzled bytes a row, at D = 80 32 more."""
    return 2 * (FLASH_KEYS * 128 + FLASH_KEYS * (D - 64) * 2)


def key_rows_per_tile(KW: int) -> int:
    """``vit_flash_attn.cu`` ``key_rows_per_tile``: how many whole key-grid
    rows a 64-key tile covers when KW divides 64 and is at least 8 (then
    rel_w is one fragment for every tile and rel_h a value a row a tile,
    the bias from registers); 0 for any other KW (the bias per logit)."""
    return FLASH_KEYS // KW if KW >= 8 and FLASH_KEYS % KW == 0 else 0


def sm90_smem_bytes(D: int) -> int:
    """``FlashSm90Layout<D>::kSmemBytes``: 1024 bytes to align the tiles;
    q's 128 rows (128 swizzled bytes a row, and at D = 80 32 more); the
    stages, each k and v of 64 keys likewise; rel_h and rel_w rows [128][72]
    bf16; a full and an empty mbarrier a stage and one for each
    warpgroup's q."""
    return (1024 + (1 + FLASH_STAGES) * _tiles(D)
            + 2 * FLASH_ROWS * FLASH_REL_LD * 2 + (2 * FLASH_STAGES + 2) * 8)


def f32_bias_kw(KW: int) -> int:
    """``vit_flash_attn.cu`` ``f32_bias_kw``: the float32 body's bias path
    for 32-key tiles. KW when it divides 64 and is at least 8: each 8-key
    block of a tile lies in one key-grid row, so rel_w is one register
    fragment for every tile (two in turns at KW = 64, a tile half a key
    row) and rel_h 32 / KW values a row a tile; 0 for any other KW (both
    factors per logit)."""
    return KW if KW >= 8 and 64 % KW == 0 else 0


def fwd_f32_smem_bytes(D: int) -> int:
    """``F32Layout<D>::kSmem``: B2 / B14's float32 body. 1024 bytes to
    align; qs hi and lo of each warpgroup's 64 rows (4 D bytes a row); the
    stages (``FWD_F32_STAGES``), each k hi, k lo (32 keys, natural) and v^T
    hi, v^T lo ([D][32]); a full and an empty mbarrier a stage and one for
    each warpgroup's qs."""
    stages = FWD_F32_STAGES[D]
    return (1024 + 4 * 64 * 4 * D + stages * 4 * FWD_F32_KEYS * 4 * D
            + (2 * stages + 2) * 8)


def fwd_f32_scratch_floats(BH: int, N: int, D: int) -> int:
    """Floats of B2 / B14's float32 scratch (``vit_flash_fwd_scratch_bytes``
    / 4): the hi and lo planes of qs and k, natural, and of v transposed,
    that its split pre-pass writes for the kernel's TMA loads."""
    return FWD_F32_PLANES * BH * N * D


def bwd_sm90_smem_bytes(D: int) -> Tuple[int, int]:
    """``BwdSm90Layout<D>``: (dq's, dk / dv's) shared memory. dq: 1024
    bytes to align the tiles; q's and do's 128 rows; the stages, each k and
    v of 64 keys; rel_h and rel_w rows [128][72] bf16; a full and an empty
    mbarrier a stage and one for each warpgroup's q and do. dk / dv: k's
    and v's 128 rows; the stages, each q and do of 64 queries, the tile's
    rel_w transposed [KW <= 64][72] bf16, the block's rel_h columns
    [16][64] f32, lse and dd [64] f32, padded to 1024 bytes; the
    mbarriers."""
    two = _tiles(D)
    rel = FLASH_KEYS * BWD_REL_LD * 2 + BWD_MAX_ROWS * FLASH_KEYS * 4 \
        + 2 * FLASH_KEYS * 4
    stage = -(-(two + rel) // 1024) * 1024
    bars = (2 * BWD_STAGES + 2) * 8
    dq = (1024 + 2 * two + BWD_STAGES * two + 2 * BWD_ROWS * BWD_REL_LD * 2
          + bars)
    return dq, 1024 + 2 * two + BWD_STAGES * stage + bars


def bwd_f32_smem_bytes(D: int) -> Tuple[int, int]:
    """``F32Layout<D>``: (dq's, dk / dv's) shared memory of B9's float32
    kernels (split TF32 on wgmma). An f32 plane of R rows takes 4 R D bytes
    (two 128-byte-swizzled boxes of 32 columns, at D = 80 a 64-byte-swizzled
    one of 16), a transposed plane [D][32] 128 D. dq: 1024 bytes to align;
    q and do of 64 queries, hi and lo; two rings of 3 slots (2 at D = 80),
    one of k and v of 32 keys, hi and lo, one of k^T hi and lo; 32 drel_w
    sums of each of the 128 consumer threads; a full and an empty mbarrier
    a slot and one for q and do. dk / dv: k and v of 64 keys, hi and lo; a
    ring of 4 slots (3 at D = 80), each four planes of 32 rows; two rel
    buffers, each rel_w [64][40], rel_h [8][32], lse and dd [32] f32; the
    mbarriers."""
    plane32, fixed = 4 * F32_TILE * D, 4 * 4 * 64 * D
    stages, slots = (2, 3) if D > 64 else (3, 4)
    rel = 4 * (64 * F32_RW_LD + 8 * F32_TILE + 2 * F32_TILE)
    dq = 1024 + fixed + stages * (4 * plane32 + 2 * 128 * D) \
        + 4 * 32 * 128 + (4 * stages + 1) * 8
    dkv = 1024 + fixed + slots * 4 * plane32 + 2 * rel + (2 * slots + 1) * 8
    return dq, dkv


def bwd_f32_scratch_floats(BH: int, N: int, D: int) -> int:
    """Floats of B9's float32 scratch (``vit_flash_bwd_scratch_bytes``):
    the hi and lo planes of q, k, v and do, and of q, k and do transposed,
    that its split pre-pass writes for the kernels' TMA loads."""
    return 14 * BH * N * D


def _work(t: Tensor) -> Tensor:
    """t in the plain versions' working type: float64 stays float64 (an
    exact reference), every other dtype computes in float32."""
    return t if t.dtype == torch.float64 else t.float()


def vit_flash_attn_plain(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                         rel_w: Tensor, mm=torch.matmul
                         ) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (bias materialized).

    Same rounding points as the kernel: q pre-scaled (``prescale_q``), rel
    factors taken at q.dtype, unnormalized p cast to v.dtype before p.v,
    output acc / l cast to q.dtype. ``mm`` takes the two products (q k^T
    and p v; ``tf32.mm_3xtf32``: the float32 kernel's split TF32); float64
    inputs compute in float64 throughout, q * D^-1/2 included (an exact
    reference)."""
    dt = q.dtype
    BH, N, D = q.shape
    qs = _work(q * D ** -0.5 if dt == torch.float64 else prescale_q(q))
    bias = (_work(rel_h.to(dt))[..., :, None]
            + _work(rel_w.to(dt))[..., None, :]).reshape(BH, N, N)
    logits = mm(qs, _work(k).transpose(-1, -2)) + bias
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    o = mm(_work(p.to(dt)), _work(v)) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(dt), lse


def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("vit_flash_attn", "vit_flash_attn_forward",
                          [i] + [p] * 8 + [i] * 5 + [ctypes.c_float, p])


def _fwd_scratch(BH: int, N: int, D: int, like: Tensor):
    """The float32 body's scratch (``fwd_f32_scratch_floats``) on like's
    device; bf16 needs none (None)."""
    if like.dtype != torch.float32:
        return None
    return torch.empty(fwd_f32_scratch_floats(BH, N, D), device=like.device,
                       dtype=torch.float32)


def vit_flash_attn(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                   rel_w: Tensor) -> Tuple[Tensor, Tensor]:
    """q, k, v [BH, N, D]; rel_h [BH, N, KH]; rel_w [BH, N, KW] (all one
    dtype, float32 or bfloat16). Returns (o [BH, N, D], lse [BH, N] f32).

    CPU tensors run ``vit_flash_attn_plain``; CUDA tensors launch the kernel
    (D = 64 or 80, N % 64 == 0, KH, KW <= 64) or raise."""
    if q.device.type == "cpu":
        return vit_flash_attn_plain(q, k, v, rel_h, rel_w)
    if q.device.type != "cuda":
        raise ValueError(f"vit_flash_attn: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"vit_flash_attn: unsupported dtype {q.dtype}")
    BH, N, D = q.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if D not in _HEAD_DIMS or N % 64 or KH * KW != N or KH > 64 or KW > 64:
        raise ValueError(f"vit_flash_attn: unsupported shape N={N} D={D} "
                         f"KH={KH} KW={KW}")
    for t, name, shape in ((q, "q", (BH, N, D)), (k, "k", (BH, N, D)),
                           (v, "v", (BH, N, D)),
                           (rel_h, "rel_h", (BH, N, KH)),
                           (rel_w, "rel_w", (BH, N, KW))):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"vit_flash_attn: {name} is {t.dtype} on "
                             f"{t.device}, expected {q.dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"vit_flash_attn: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"vit_flash_attn: {name} is not contiguous "
                             f"and 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((BH, N), device=q.device, dtype=torch.float32)
    scratch = _fwd_scratch(BH, N, D, q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                 o.data_ptr(), lse.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), BH, N, D,
                 KH, KW, q_scale(D, q.dtype), stream)
    if err != 0:
        raise RuntimeError(f"vit_flash_attn kernel launch failed: "
                           f"cudaError {err}")
    vit_flash_attn.launches += 1
    return o, lse


vit_flash_attn.launches = 0


def _heads(t: Tensor, nh: int) -> Tensor:
    """[B, N, nh*hd] -> [B*nh, N, hd], contiguous and 16-byte aligned (a
    reshape of a permuted view may stay a view)."""
    B, N, C = t.shape
    return build.aligned(t.reshape(B, N, nh, C // nh).permute(0, 2, 1, 3)
                         .reshape(B * nh, N, C // nh))


def _merge(t: Tensor, B: int) -> Tensor:
    """[B*nh, N, hd] -> [B, N, nh*hd]."""
    BH, N, D = t.shape
    return t.reshape(B, BH // B, N, D).permute(0, 2, 1, 3).reshape(B, N, -1)


def vit_flash_attn_packed_plain(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                                nh: int, mm=torch.matmul
                                ) -> Tuple[Tensor, Tensor]:
    """B14 in plain PyTorch: qkv [B, N, 3C] -> (o [B, N, C], lse [B*nh, N]
    f32), B2's function and rounding points on each head (``mm`` and
    float64 as ``vit_flash_attn_plain``)."""
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    o, lse = vit_flash_attn_plain(q, k, v, rel_h, rel_w, mm=mm)
    return _merge(o, qkv.shape[0]), lse


def vit_flash_attn_packed(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                          nh: int) -> Tuple[Tensor, Tensor]:
    """B14: qkv [B, N, 3C] (q | k | v, head h at h*hd of each, hd = C / nh,
    64 or 80); rel_h [B*nh, N, KH], rel_w [B*nh, N, KW] (one dtype, float32
    or bfloat16). Returns (o [B, N, C], lse [B*nh, N] f32).

    CPU tensors run ``vit_flash_attn_packed_plain``; CUDA tensors launch
    the kernel (N % 64 == 0, KH * KW == N, KH, KW <= 64) or raise."""
    if qkv.device.type == "cpu":
        return vit_flash_attn_packed_plain(qkv, rel_h, rel_w, nh)
    name = "vit_flash_attn_packed"
    if qkv.device.type != "cuda" or qkv.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: unsupported {qkv.dtype} on {qkv.device}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // nh
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if (C3 % 3 or D * nh != C or D not in _HEAD_DIMS or N % 64
            or KH * KW != N or KH > 64 or KW > 64):
        raise ValueError(f"{name}: unsupported shape qkv {tuple(qkv.shape)} "
                         f"nh={nh} KH={KH} KW={KW}")
    for t, what, shape in ((qkv, "qkv", (B, N, C3)),
                           (rel_h, "rel_h", (B * nh, N, KH)),
                           (rel_w, "rel_w", (B * nh, N, KW))):
        if t.device != qkv.device or t.dtype != qkv.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                             f"expected {qkv.dtype} on {qkv.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not contiguous and 16-byte "
                             f"aligned")
    o = torch.empty((B, N, C), device=qkv.device, dtype=qkv.dtype)
    lse = torch.empty((B * nh, N), device=qkv.device, dtype=torch.float32)
    scratch = _fwd_scratch(B * nh, N, D, qkv)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("vit_flash_attn", "vit_flash_attn_packed_forward",
                        [i] + [p] * 6 + [i] * 6 + [ctypes.c_float, p])
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(_DTYPE_CODE[qkv.dtype], qkv.data_ptr(), rel_h.data_ptr(),
                 rel_w.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, nh, N,
                 D, KH, KW, q_scale(D, qkv.dtype), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    vit_flash_attn_packed.launches += 1
    return o, lse


vit_flash_attn_packed.launches = 0


def _drel(ds: Tensor, KH: int, KW: int) -> Tuple[Tensor, Tensor]:
    """Row sums of ds [BH, N, N] per key-grid row and column (f32)."""
    ds4 = ds.reshape(ds.shape[0], ds.shape[1], KH, KW)
    return ds4.sum(-1), ds4.sum(-2)


def vit_flash_attn_bwd_plain(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                             rel_w: Tensor, do: Tensor, lse: Tensor,
                             dd: Tensor, mm=torch.matmul) -> Tuple[Tensor, ...]:
    """B9 in plain PyTorch: (dq, dk, dv at q.dtype; drel_h, drel_w f32).

    Scored as the TPU kernels score (flash_attention.py:824-827): s = f32(q
    k^T) * D^-1/2 + bias from unscaled q, with the rel factors taken at
    q.dtype, and p = exp(s - lse). Then, with ds = p (do v^T - dd): dq =
    (ds k) * D^-1/2, dk = (ds^T q) * D^-1/2, dv = p^T do. p and ds are
    rounded to q.dtype before their products (:840-851, :898-900);
    drel_h[i, r] = sum_c ds[i, r*KW + c] and drel_w[i, c] = sum_r ds[i, r*KW
    + c] sum the rounded ds in f32. ``mm`` takes the five products
    (``tf32.mm_3xtf32``: the float32 kernels' split TF32); float64 inputs
    compute in float64 throughout, drel included."""
    dt = q.dtype
    BH, N, D = q.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    scale = D ** -0.5
    qf, kf = _work(q), _work(k)
    bias = (_work(rel_h.to(dt))[..., :, None]
            + _work(rel_w.to(dt))[..., None, :]).reshape(BH, N, N)
    p = torch.exp(mm(qf, kf.transpose(-1, -2)) * scale + bias
                  - lse.to(qf.dtype)[..., None])
    g = _work(do.to(dt))
    dp = mm(g, _work(v).transpose(-1, -2))
    ds = _work((p * (dp - dd.to(qf.dtype)[..., None])).to(dt))
    dq = mm(ds, kf) * scale
    dk = mm(ds.transpose(-1, -2), qf) * scale
    dv = mm(_work(p.to(dt)).transpose(-1, -2), g)
    drel_h, drel_w = _drel(ds, KH, KW)
    return dq.to(dt), dk.to(dt), dv.to(dt), drel_h, drel_w


def _bwd_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("vit_flash_bwd", "vit_flash_attn_backward",
                          [i] + [p] * 14 + [i] * 5 + [ctypes.c_float, p])


def vit_flash_attn_bwd(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                       rel_w: Tensor, do: Tensor, lse: Tensor,
                       dd: Tensor) -> Tuple[Tensor, ...]:
    """B9: q, k, v, do [BH, N, D], rel_h [BH, N, KH], rel_w [BH, N, KW] (one
    dtype, float32 or bfloat16); lse, dd [BH, N] f32. Returns (dq, dk, dv,
    drel_h [BH, N, KH] f32, drel_w [BH, N, KW] f32).

    CPU tensors run ``vit_flash_attn_bwd_plain``; CUDA tensors launch the
    kernels (D = 64 or 80, KW dividing 64 and at least 8, KH <= 64, N =
    KH * KW a multiple of 64; bitwise the same result on every call) or
    raise."""
    if q.device.type == "cpu":
        return vit_flash_attn_bwd_plain(q, k, v, rel_h, rel_w, do, lse, dd)
    if q.device.type != "cuda":
        raise ValueError(f"vit_flash_attn_bwd: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"vit_flash_attn_bwd: unsupported dtype {q.dtype}")
    BH, N, D = q.shape
    KH, KW = rel_h.shape[-1], rel_w.shape[-1]
    if (D not in _HEAD_DIMS or KW not in _BWD_KW or KH > 64 or KH * KW != N
            or N % 64):
        raise ValueError(f"vit_flash_attn_bwd: unsupported shape N={N} D={D}"
                         f" KH={KH} KW={KW}")
    for t, name, shape, dtype in (
            (q, "q", (BH, N, D), q.dtype), (k, "k", (BH, N, D), q.dtype),
            (v, "v", (BH, N, D), q.dtype), (do, "do", (BH, N, D), q.dtype),
            (rel_h, "rel_h", (BH, N, KH), q.dtype),
            (rel_w, "rel_w", (BH, N, KW), q.dtype),
            (lse, "lse", (BH, N), torch.float32),
            (dd, "dd", (BH, N), torch.float32)):
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"vit_flash_attn_bwd: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"vit_flash_attn_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"vit_flash_attn_bwd: {name} is not contiguous "
                             f"and 16-byte aligned")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    drel_h = torch.empty((BH, N, KH), device=q.device, dtype=torch.float32)
    drel_w = torch.empty((BH, N, KW), device=q.device, dtype=torch.float32)
    # float32: the hi / lo planes of the split pre-pass, read by TMA
    scratch = (torch.empty(bwd_f32_scratch_floats(BH, N, D), device=q.device,
                           dtype=torch.float32)
               if q.dtype == torch.float32 else None)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), drel_h.data_ptr(),
                 drel_w.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), BH, N, D,
                 KH, KW, float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"vit_flash_attn_bwd kernel launch failed: "
                           f"cudaError {err}")
    vit_flash_attn_bwd.launches += 1
    return dq, dk, dv, drel_h, drel_w


vit_flash_attn_bwd.launches = 0


class VitFlashAttention(torch.autograd.Function):
    """B2 forward, B9 backward. rel_h / rel_w arrive in float32 and are cast
    to q.dtype inside (as ``_vit_flash_impl`` does), so their gradients come
    back in float32; dd = sum(do * o) is plain PyTorch, as the JAX package
    computes it outside its kernels (flash_attention.py:924)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w):
        rh, rw = (build.aligned(r.to(q.dtype)) for r in (rel_h, rel_w))
        o, lse = vit_flash_attn(q, k, v, rh, rw)
        ctx.rel_dtypes = (rel_h.dtype, rel_w.dtype)
        ctx.save_for_backward(q, k, v, rh, rw, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, rh, rw, o, lse = ctx.saved_tensors
        g = build.aligned(g)
        dd = (g.float() * o.float()).sum(-1)
        dq, dk, dv, drh, drw = vit_flash_attn_bwd(q, k, v, rh, rw, g, lse, dd)
        return (dq, dk, dv, drh.to(ctx.rel_dtypes[0]),
                drw.to(ctx.rel_dtypes[1]))


def vit_flash_attention(q: Tensor, k: Tensor, v: Tensor, rel_h: Tensor,
                        rel_w: Tensor) -> Tensor:
    """Differentiable B2 -> o [BH, N, D]; q, k, v contiguous at one dtype,
    rel_h / rel_w at any float dtype (float32 keeps drel in float32)."""
    return VitFlashAttention.apply(q, k, v, rel_h, rel_w)


def vit_flash_packed_bwd(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                         o: Tensor, lse: Tensor, g: Tensor, nh: int,
                         bwd=None) -> Tuple[Tensor, Tensor, Tensor]:
    """B14's gradient (``_vit_flash_packed_bwd``): qkv, o and the output
    gradient g [B, N, C] split into heads, B9 (``bwd``, by default
    ``vit_flash_attn_bwd``), dq, dk, dv packed back into dqkv [B, N, 3C].
    Returns (dqkv, drel_h, drel_w f32)."""
    bwd = bwd or vit_flash_attn_bwd
    B = qkv.shape[0]
    q, k, v = (_heads(t, nh) for t in qkv.chunk(3, dim=-1))
    g, o = _heads(g, nh), _heads(o, nh)
    dd = (g.float() * o.float()).sum(-1)
    dq, dk, dv, drh, drw = bwd(q, k, v, rel_h, rel_w, g, lse, dd)
    return torch.cat([_merge(t, B) for t in (dq, dk, dv)], dim=-1), drh, drw


class VitFlashPacked(torch.autograd.Function):
    """B14 forward; the backward is ``vit_flash_packed_bwd`` (B9 on the
    heads). rel_h / rel_w arrive at any float dtype and are cast to
    qkv.dtype inside, so their gradients keep their dtype."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, nh):
        rh, rw = (build.aligned(r.to(qkv.dtype)) for r in (rel_h, rel_w))
        o, lse = vit_flash_attn_packed(qkv, rh, rw, nh)
        ctx.nh = nh
        ctx.rel_dtypes = (rel_h.dtype, rel_w.dtype)
        ctx.save_for_backward(qkv, rh, rw, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        qkv, rh, rw, o, lse = ctx.saved_tensors
        dqkv, drh, drw = vit_flash_packed_bwd(qkv, rh, rw, o, lse, g, ctx.nh)
        return (dqkv, drh.to(ctx.rel_dtypes[0]), drw.to(ctx.rel_dtypes[1]),
                None)


def vit_flash_attention_packed(qkv: Tensor, rel_h: Tensor, rel_w: Tensor,
                               nh: int) -> Tensor:
    """Differentiable B14 -> o [B, N, C]; qkv contiguous, rel_h / rel_w at
    any float dtype (float32 keeps drel in float32)."""
    return VitFlashPacked.apply(qkv, rel_h, rel_w, nh)
