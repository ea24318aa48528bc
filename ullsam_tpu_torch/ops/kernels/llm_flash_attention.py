"""B10 / B11: the LLM's causal GQA flash attention with segment ids, and its
gradient.

``llm_flash_attn(q, k, v, q_seg, kv_seg, num_kv_heads, causal) -> (o, lse)``
computes, for query row i of head h and key j of kv head h // group,

    o   = softmax(prescale_q(q) k^T, over the valid keys) v
    lse = row logsumexp (f32)

where a key is valid iff q_seg[i] == kv_seg[j] (and j <= i when causal). A
row with no valid key gives o = 0 and lse = NEG_INF. It replaces the TPU
kernel ``ullsam_tpu/ops/pallas/flash_attention.py`` ``_llm_kernel`` (through
``_llm_flash_impl``; ``reference_attention`` is its XLA reference). On a
CUDA tensor it launches ``csrc/llm_flash_attn.cu`` (see the note there:
operation-bound; bf16 on ``wgmma``, float32 on ``wgmma`` in split TF32
after a pre-pass that writes the operands' hi and lo planes into a scratch
of ``fwd_scratch_floats``); on a CPU tensor it runs
``llm_flash_attn_plain``. There is no fallback from the kernel.
``prescale_q`` (``flash_attention.py``) rounds q * D^-1/2 as the JAX
package does: the product by D^-1/2 rounded to q's dtype.

B11, ``llm_flash_attn_bwd``, is its gradient (``_llm_bwd_dq_kernel`` and
``_llm_bwd_dkv_kernel``, through ``_llm_flash_bwd_impl``), launched from
``csrc/llm_flash_bwd.cu`` on a CUDA tensor. It scores as those TPU kernels
do, f32(q k^T) * D^-1/2 from unscaled q. In bf16 its kernel sums dq in
f32 by reductions into a scratch the wrapper allocates
(``bwd_scratch_floats``), in an order that varies from run to run, and so
do dq's last bits; float32 runs two kernels in split TF32 with no such
sum, after a pre-pass into its scratch (the same rule), and gives the same
bits every call. The plain versions take ``mm`` (``torch.matmul``; a test
passes ``tf32.mm_3xtf32`` to run them through the float32 kernels'
arithmetic). ``f32_smem_bytes`` and ``bwd_f32_smem_bytes`` mirror the
float32 kernels' shared memory.
``llm_flash_attention`` is the differentiable entry with the JAX entry's
signature: a ``torch.autograd.Function`` whose forward is B10 and whose
backward is B11 on both devices.

Layouts are the natural ones: q, o [B, S, nh, D]; k, v [B, S, n_kv, D];
segment ids [B, S] int32; lse and dd [B, nh, S] f32. The ragged tail
(S not a multiple of the kernels' 64-row tiles) is masked by bounds checks,
so real rows never see it (the TPU pads with the ids -1 / -2 instead).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ullsam_tpu_torch.ops.kernels import build
from ullsam_tpu_torch.ops.kernels.flash_attention import (_work, prescale_q,
                                                        q_scale)

Tensor = torch.Tensor

NEG_INF = -1e30  # lse of a row with no valid key (flash_attention.py:31)
HEAD_DIMS = (64, 128)

# The float32 kernels' split planes (csrc/llm_f32.cuh), each Sp x D floats
# (Sp = S rounded up to 64), per query head and per kv head: the forward's
# q (pre-scaled) and k hi / lo natural and v's transposed; the backward's
# q and do natural and transposed, k natural and transposed, v natural
F32_FWD_PLANES = (2, 4)
F32_BWD_PLANES = (8, 6)
# B10's float32 kernel streams 32-key stages, two of them
# (csrc/llm_flash_attn.cu)
F32_FWD_TILE, F32_FWD_STAGES = 32, 2

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _valid(q_seg: Tensor, kv_seg: Tensor, causal: bool) -> Tensor:
    """[B, 1, S, T] bool: key j is valid for query i."""
    mask = q_seg[:, None, :, None] == kv_seg[:, None, None, :]
    if causal:
        S, T = q_seg.shape[-1], kv_seg.shape[-1]
        ii = torch.arange(S, device=q_seg.device)[:, None]
        jj = torch.arange(T, device=q_seg.device)[None, :]
        mask = mask & (ii >= jj)
    return mask


def _heads(q: Tensor, k: Tensor, v: Tensor, num_kv_heads: int):
    """q [B, S, nh, D] -> [B, nh, S, D]; k, v [B, T, n_kv, D] -> [B, nh, T,
    D] (kv head h // group for query head h), all in the working type
    (``_work``: float64 stays, the rest f32)."""
    group = q.shape[2] // num_kv_heads
    kh = _work(k).transpose(1, 2).repeat_interleave(group, dim=1)
    vh = _work(v).transpose(1, 2).repeat_interleave(group, dim=1)
    return _work(q).transpose(1, 2), kh, vh


def llm_flash_attn_plain(q: Tensor, k: Tensor, v: Tensor, q_seg: Tensor,
                         kv_seg: Tensor, num_kv_heads: int,
                         causal: bool = True,
                         mm=torch.matmul) -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (mask and logits
    materialized). Same rounding points as the kernel and
    ``_llm_flash_impl``: q pre-scaled (``prescale_q``), unnormalized p cast
    to v.dtype before p.v, the output acc / l cast to q.dtype. ``mm`` takes
    the two products (q k^T and p v); float64 inputs compute in float64
    throughout, q * D^-1/2 included (an exact reference)."""
    dt = q.dtype
    qs = (q * q.shape[-1] ** -0.5 if dt == torch.float64 else prescale_q(q))
    qs, kh, vh = _heads(qs, k, v, num_kv_heads)
    valid = _valid(q_seg, kv_seg, causal)
    logits = mm(qs, kh.transpose(-1, -2)).masked_fill(
        ~valid, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)                         # 0 at invalid keys
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    o = mm(_work(p.to(dt)), vh) / torch.where(live, l, 1.0)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                      NEG_INF)[..., 0]
    return o.transpose(1, 2).to(dt), lse


def _check(fn: str, q: Tensor, tensors, num_kv_heads: int) -> None:
    """Raise unless the CUDA kernel takes these operands: q [B, S, nh, D]
    with D in HEAD_DIMS and nh a multiple of num_kv_heads; each of
    ``tensors`` (name, tensor, shape, dtype) as given, on q's device,
    contiguous and 16-byte aligned."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: unsupported dtype {q.dtype}")
    B, S, nh, D = q.shape
    if D not in HEAD_DIMS or num_kv_heads < 1 or nh % num_kv_heads:
        raise ValueError(f"{fn}: unsupported shape nh={nh} "
                         f"n_kv={num_kv_heads} D={D}")
    for name, t, shape, dtype in tensors:
        if t.device != q.device or t.dtype != dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not contiguous and 16-byte "
                             f"aligned")


def _kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("llm_flash_attn", "llm_flash_attn_forward",
                          [i] + [p] * 8 + [i] * 6 + [ctypes.c_float, p])


def _sp(S: int) -> int:
    """S rounded up to the kernels' 64-row tiles."""
    return -(-S // 64) * 64


def fwd_scratch_floats(B: int, S: int, nh: int, nkv: int, D: int,
                       dtype: torch.dtype) -> int:
    """f32 elements of B10's scratch: in float32 the split planes its
    pre-pass writes (``F32_FWD_PLANES``: q pre-scaled and k, hi and lo,
    natural; v's transposed), B Sp D (2 nh + 4 nkv); bf16 needs none."""
    if dtype != torch.float32:
        return 0
    qp, kvp = F32_FWD_PLANES
    return B * _sp(S) * D * (qp * nh + kvp * nkv)


def f32_smem_bytes(D: int) -> int:
    """``Lf32FwdLayout<D>::kSmem``: B10's float32 kernel. 1024 bytes to
    align; q's hi and lo planes of 64 rows (4 D bytes a row); two stages of
    k hi, k lo (natural, 32 keys) and v^T hi, v^T lo ([D][32]); a full and
    an empty mbarrier a stage and one for q."""
    plane = 4 * F32_FWD_TILE * D
    return (1024 + 2 * 4 * 64 * D + F32_FWD_STAGES * 4 * plane
            + (2 * F32_FWD_STAGES + 1) * 8)


def bwd_f32_tile(D: int) -> int:
    """Rows of the tiles that B11's float32 kernels stream
    (``Lf32BwdLayout<D>::kTile``): at D = 128 the fixed 64 rows' hi and
    lo planes take 128 KB, and four buffers of 32 rows would not fit
    beside them."""
    return 16 if D > 64 else 32


def bwd_f32_smem_bytes(D: int) -> Tuple[int, int]:
    """``Lf32BwdLayout<D>``: (dq's, dk / dv's) shared memory of B11's float32
    kernels: 1024 bytes to align; the fixed 64 rows' four planes (q, do
    or k, v; hi and lo), 4 x 64 D bytes each; the streamed tile's buffers,
    each a hi and a lo plane of ``bwd_f32_tile`` rows (dq three: k, v,
    k^T; dk / dv four: q, do^T, do, q^T); two buffers of p passed between
    the warpgroups, [tile / 2][128] f32; the mbarriers (dq 11, dk / dv
    13)."""
    tile = bwd_f32_tile(D)
    head = 1024 + 4 * 4 * 64 * D + 2 * tile // 2 * 128 * 4
    buf = 2 * 4 * tile * D
    return head + 3 * buf + 11 * 8, head + 4 * buf + 13 * 8


def llm_flash_attn(q: Tensor, k: Tensor, v: Tensor, q_seg: Tensor,
                   kv_seg: Tensor, num_kv_heads: int,
                   causal: bool = True) -> Tuple[Tensor, Tensor]:
    """B10: q [B, S, nh, D], k, v [B, S, n_kv, D] (one dtype, float32 or
    bfloat16), q_seg, kv_seg [B, S] int32. Returns (o [B, S, nh, D],
    lse [B, nh, S] f32).

    CPU tensors run ``llm_flash_attn_plain``; CUDA tensors launch the kernel
    (D in 64, 128; nh a multiple of n_kv) or raise."""
    if q.device.type == "cpu":
        return llm_flash_attn_plain(q, k, v, q_seg, kv_seg, num_kv_heads,
                                    causal)
    B, S, nh, D = q.shape
    kv = (B, S, num_kv_heads, D)
    _check("llm_flash_attn", q, (
        ("q", q, (B, S, nh, D), q.dtype), ("k", k, kv, q.dtype),
        ("v", v, kv, q.dtype), ("q_seg", q_seg, (B, S), torch.int32),
        ("kv_seg", kv_seg, (B, S), torch.int32)), num_kv_heads)
    if q.device.type != "cuda":
        raise ValueError(f"llm_flash_attn: unsupported device {q.device}")
    o = torch.empty_like(q)
    lse = torch.empty((B, nh, S), device=q.device, dtype=torch.float32)
    scratch = torch.empty(fwd_scratch_floats(B, S, nh, num_kv_heads, D,
                                             q.dtype),
                          device=q.device, dtype=torch.float32)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), scratch.data_ptr(), B, S, nh,
                 num_kv_heads, D, int(causal), q_scale(D, q.dtype), stream)
    if err != 0:
        raise RuntimeError(f"llm_flash_attn kernel launch failed: "
                           f"cudaError {err}")
    llm_flash_attn.launches += 1
    return o, lse


llm_flash_attn.launches = 0


def llm_flash_attn_bwd_plain(q: Tensor, k: Tensor, v: Tensor, q_seg: Tensor,
                             kv_seg: Tensor, do: Tensor, lse: Tensor,
                             dd: Tensor, num_kv_heads: int,
                             causal: bool = True,
                             mm=torch.matmul) -> Tuple[Tensor, ...]:
    """B11 in plain PyTorch: (dq, dk, dv) at q.dtype.

    Scored as the TPU kernels score (flash_attention.py:604-612): s = f32(q
    k^T) * D^-1/2 from unscaled q, p = exp(s - lse) at the valid keys (0
    elsewhere). With ds = p (do v^T - dd): dq = (ds k) * D^-1/2, dk = (ds^T
    q) * D^-1/2, dv = p^T do, dk and dv summed in f32 over the group's query
    heads. p and ds are rounded to q.dtype before their products
    (flash_attention.py:641-651). ``mm`` takes the five products; float64
    inputs compute in float64 throughout."""
    dt = q.dtype
    B, S, nh, D = q.shape
    group = nh // num_kv_heads
    scale = D ** -0.5
    qh, kh, vh = _heads(q, k, v, num_kv_heads)
    valid = _valid(q_seg, kv_seg, causal)
    s = mm(qh, kh.transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(s - lse.to(s.dtype)[..., None]), 0.0)
    g = _work(do.to(dt)).transpose(1, 2)              # [B, nh, S, D]
    dp = mm(g, vh.transpose(-1, -2))
    ds = _work((p * (dp - dd.to(s.dtype)[..., None])).to(dt))
    dq = mm(ds, kh) * scale
    dk = mm(ds.transpose(-1, -2), qh) * scale  # [B, nh, T, D]
    dv = mm(_work(p.to(dt)).transpose(-1, -2), g)
    T = k.shape[1]

    def per_kv(x: Tensor) -> Tensor:                  # sum the group
        return x.reshape(B, num_kv_heads, group, T, D).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(dt), per_kv(dk).to(dt),
            per_kv(dv).to(dt))


def _bwd_kernel():
    p, i = ctypes.c_void_p, ctypes.c_int
    return build.function("llm_flash_bwd", "llm_flash_attn_backward",
                          [i] + [p] * 12 + [i] * 6 + [ctypes.c_float, p])


def bwd_scratch_floats(B: int, S: int, nh: int, nkv: int, D: int,
                       dtype: torch.dtype) -> int:
    """f32 elements of B11's scratch. bf16: the sum of dq, a chunk of 64 x
    D for each (b, head, 64-row query tile) (``csrc/llm_flash_bwd.cu``
    zeroes it, adds each key block's partial into it by a bulk reduction
    and converts it), B nh Sp D. float32: the split planes its pre-pass
    writes (``F32_BWD_PLANES``: q, do, k, v natural and q, do, k
    transposed, hi and lo), B Sp D (8 nh + 6 nkv)."""
    if dtype == torch.bfloat16:
        return B * nh * _sp(S) * D
    qp, kvp = F32_BWD_PLANES
    return B * _sp(S) * D * (qp * nh + kvp * nkv)


def llm_flash_attn_bwd(q: Tensor, k: Tensor, v: Tensor, q_seg: Tensor,
                       kv_seg: Tensor, do: Tensor, lse: Tensor, dd: Tensor,
                       num_kv_heads: int,
                       causal: bool = True) -> Tuple[Tensor, ...]:
    """B11: q, do [B, S, nh, D], k, v [B, S, n_kv, D] (one dtype, float32 or
    bfloat16); q_seg, kv_seg [B, S] int32; lse (B10's) and dd = sum(do * o)
    [B, nh, S] f32. Returns (dq, dk, dv) at q.dtype.

    CPU tensors run ``llm_flash_attn_bwd_plain``; CUDA tensors launch the
    kernels (D in 64, 128) or raise."""
    if q.device.type == "cpu":
        return llm_flash_attn_bwd_plain(q, k, v, q_seg, kv_seg, do, lse, dd,
                                        num_kv_heads, causal)
    B, S, nh, D = q.shape
    kv = (B, S, num_kv_heads, D)
    _check("llm_flash_attn_bwd", q, (
        ("q", q, (B, S, nh, D), q.dtype), ("k", k, kv, q.dtype),
        ("v", v, kv, q.dtype), ("do", do, (B, S, nh, D), q.dtype),
        ("q_seg", q_seg, (B, S), torch.int32),
        ("kv_seg", kv_seg, (B, S), torch.int32),
        ("lse", lse, (B, nh, S), torch.float32),
        ("dd", dd, (B, nh, S), torch.float32)), num_kv_heads)
    if q.device.type != "cuda":
        raise ValueError(f"llm_flash_attn_bwd: unsupported device "
                         f"{q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = torch.empty(bwd_scratch_floats(B, S, nh, num_kv_heads, D,
                                             q.dtype),
                          device=q.device, dtype=torch.float32)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), B, S, nh,
                 num_kv_heads, D, int(causal), float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"llm_flash_attn_bwd kernel launch failed: "
                           f"cudaError {err}")
    llm_flash_attn_bwd.launches += 1
    return dq, dk, dv


llm_flash_attn_bwd.launches = 0


class LlmFlashAttention(torch.autograd.Function):
    """B10 forward, B11 backward. dd = sum(do * o) is plain PyTorch, as the
    JAX package computes it outside its kernels (flash_attention.py:717);
    the segment ids carry no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, num_kv_heads, causal):
        q, k, v = (build.aligned(t) for t in (q, k, v))
        q_seg, kv_seg = (build.aligned(s.to(torch.int32))
                         for s in (q_seg, kv_seg))
        o, lse = llm_flash_attn(q, k, v, q_seg, kv_seg, num_kv_heads, causal)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, o, lse)
        ctx.num_kv_heads, ctx.causal = num_kv_heads, causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        g = build.aligned(g.to(q.dtype))
        dd = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = llm_flash_attn_bwd(q, k, v, q_seg, kv_seg, g, lse, dd,
                                        ctx.num_kv_heads, ctx.causal)
        return dq, dk, dv, None, None, None, None


def llm_flash_attention(q: Tensor, k: Tensor, v: Tensor,
                        q_segment_ids: Tensor, kv_segment_ids: Tensor,
                        num_kv_heads: int, causal: bool = True) -> Tensor:
    """Differentiable B10 (``flash_attention.py:559-577``): q [B, S, nh, D];
    k, v [B, S, n_kv, D]; segment ids [B, S] (0 = padding; tokens attend only
    within equal segments). Returns [B, S, nh, D]; the D^-1/2 scale is
    applied inside."""
    if k.shape[2] != num_kv_heads:
        raise ValueError(f"llm_flash_attention: k has {k.shape[2]} heads, "
                         f"num_kv_heads={num_kv_heads}")
    return LlmFlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids,
                                   num_kv_heads, causal)
