"""The plain versions of the LLM flash kernels against the TPU kernels they
replace (Pallas interpret mode on the CPU, as tests/test_kernels.py runs
them) and against the JAX package's XLA ``reference_attention``.

B10 ``llm_flash_attn``     <- flash_attention.py ``_llm_kernel``
B11 ``llm_flash_attn_bwd`` <- flash_attention.py ``_llm_bwd_dq_kernel`` and
                              ``_llm_bwd_dkv_kernel``

The inputs are tests/test_kernels.py:14-57's: B = 2, S = 300 (a ragged
tail past the 256-row TPU tiles), 8 query heads over 4 kv heads, left
padding on row 0 and a second packed segment on row 1; head dims 64 (the
JAX kernel tests' shape) and 128 (InternLM2-1.8B's). The TPU kernel returns
lse lane-replicated over padded rows ([B, nh, Sp, 8]); the test takes lane
0 of the first S rows.

Tolerances, all f32: o and lse 1e-5 absolute (measured ~1e-6: another
summation order); dq, dk, dv 5e-5 absolute at gradients of magnitude ~5
(measured ~5e-6; the TPU backward scores q k^T * D^-1/2 from unscaled q,
the port cast(q * D^-1/2) k^T, which differ by f32 rounding only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_helpers import assert_close

from ullsam_tpu.ops.pallas import flash_attention as JFA
from ullsam_tpu_torch.ops.kernels import llm_flash_attention as LF

T = torch.from_numpy


def _case(D, seed=0, B=2, S=300, nh=8, nkv=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, nh, D).astype(np.float32)
    k = rng.randn(B, S, nkv, D).astype(np.float32)
    v = rng.randn(B, S, nkv, D).astype(np.float32)
    w = rng.randn(B, S, nh, D).astype(np.float32)   # the cotangent
    seg = np.ones((B, S), np.int32)
    seg[0, :50] = 0        # left padding
    seg[1, 200:] = 2       # packed second segment
    return q, k, v, w, seg, nkv


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_b10_b11_match_jax_and_tpu_kernels(D, causal):
    """o and lse against the interpret-mode ``_llm_flash_impl`` and o
    against ``reference_attention``; dq, dk, dv through
    ``llm_flash_attention`` (B10 forward, B11 backward) against
    ``jax.grad`` of the interpret-mode kernel pair and of the reference."""
    q, k, v, w, seg, nkv = _case(D)
    jq, jk, jv, jw, js = map(jnp.asarray, (q, k, v, w, seg))
    ref = JFA.reference_attention(jq, jk, jv, js, js, nkv, causal=causal)

    def loss(fn):
        return lambda a, b, c: jnp.sum(fn(a, b, c, js, js, nkv,
                                          causal=causal) * jw)

    g_ref = jax.grad(loss(JFA.reference_attention), argnums=(0, 1, 2))(
        jq, jk, jv)
    with pltpu.force_tpu_interpret_mode():
        j_o, j_lse = JFA._llm_flash_impl(jq, jk, jv, js, js, nkv, causal,
                                         256, 256)
        g_tpu = jax.grad(loss(JFA.llm_flash_attention), argnums=(0, 1, 2))(
            jq, jk, jv)

    o, lse = LF.llm_flash_attn_plain(T(q), T(k), T(v), T(seg), T(seg), nkv,
                                     causal)
    assert o.shape == q.shape and lse.shape == (2, 8, 300)
    assert_close(o, ref, atol=1e-5, name="o vs reference_attention")
    assert_close(o, j_o, atol=1e-5, name="o vs _llm_kernel")
    assert_close(lse, np.asarray(j_lse)[:, :, :300, 0], atol=1e-5,
                 name="lse vs _llm_kernel")

    xs = [T(a).requires_grad_() for a in (q, k, v)]
    out = LF.llm_flash_attention(*xs, T(seg), T(seg), nkv, causal=causal)
    assert_close(out, o, atol=0.0, name="Function forward is B10")
    (out * T(w)).sum().backward()
    for name, x, a, b in zip(("dq", "dk", "dv"), xs, g_tpu, g_ref):
        assert_close(x.grad, a, atol=5e-5, name=f"{name} vs the TPU pair")
        assert_close(x.grad, b, atol=5e-5, name=f"{name} vs jax.grad(ref)")


def test_row_with_no_valid_key():
    """Query rows whose segment id appears at no key at or before them: o =
    0 and lse = NEG_INF (-1e30), as the TPU kernel writes them, and no
    gradient from them; the other rows still match the reference."""
    q, k, v, w, seg, nkv = _case(64, seed=1, S=130)
    q_seg = seg.copy()
    q_seg[0, 60:70] = 7            # no key has segment 7
    kv_seg = seg.copy()
    q_seg[1, :40] = 3              # row 1's first 40 queries: segment 3's
    kv_seg[1, 40:80] = 3           # keys all come later (causally invalid)
    jq, jk, jv, jqs, jks = map(jnp.asarray, (q, k, v, q_seg, kv_seg))
    with pltpu.force_tpu_interpret_mode():
        j_o, j_lse = JFA._llm_flash_impl(jq, jk, jv, jqs, jks, nkv, True,
                                         128, 128)
    o, lse = LF.llm_flash_attn_plain(T(q), T(k), T(v), T(q_seg), T(kv_seg),
                                     nkv, True)
    empty = np.zeros((2, 130), bool)
    empty[0, 60:70] = True
    empty[1, :40] = True
    assert (o.numpy()[empty] == 0).all()
    assert (lse.numpy().transpose(0, 2, 1)[empty] == LF.NEG_INF).all()
    assert_close(o, j_o, atol=1e-5, name="o")
    assert_close(lse, np.asarray(j_lse)[:, :, :130, 0], atol=1e-5,
                 name="lse")
    ref = JFA.reference_attention(jq, jk, jv, jqs, jks, nkv, causal=True)
    assert_close(o, ref, atol=1e-5, name="o vs reference_attention")

    xs = [T(a).requires_grad_() for a in (q, k, v)]
    out = LF.llm_flash_attention(*xs, T(q_seg), T(kv_seg), nkv)
    (out * T(w)).sum().backward()
    assert (xs[0].grad.numpy()[empty] == 0).all()
    g = jax.grad(lambda a, b, c: jnp.sum(JFA.reference_attention(
        a, b, c, jqs, jks, nkv, causal=True) * jnp.asarray(w)),
        argnums=(0, 1, 2))(jq, jk, jv)
    for name, x, b in zip(("dq", "dk", "dv"), xs, g):
        assert_close(x.grad, b, atol=5e-5, name=name)


def test_plain_backward_rounds_as_the_forward_in_bf16():
    """In bf16 the plain B11 scores with B10's cast(q * D^-1/2): its p at
    the valid keys sums to 1 per row in f32 (to bf16 rounding of the
    logits' inputs), and its gradients stay within bf16 steps of the f32
    gradients of the same inputs."""
    q, k, v, w, seg, nkv = _case(128, seed=2, S=96)
    t16 = [T(a).to(torch.bfloat16) for a in (q, k, v, w)]
    o16, lse16 = LF.llm_flash_attn_plain(*t16[:3], T(seg), T(seg), nkv)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    dd = (t16[3].float() * o16.float()).sum(-1).transpose(1, 2)
    g16 = LF.llm_flash_attn_bwd_plain(*t16[:3], T(seg), T(seg), t16[3],
                                      lse16, dd.contiguous(), nkv)
    t32 = [a.float() for a in t16]
    o32, lse32 = LF.llm_flash_attn_plain(*t32[:3], T(seg), T(seg), nkv)
    dd32 = (t32[3] * o32).sum(-1).transpose(1, 2).contiguous()
    g32 = LF.llm_flash_attn_bwd_plain(*t32[:3], T(seg), T(seg), t32[3],
                                      lse32, dd32, nkv)
    assert_close(lse16, lse32, atol=0.05, name="lse")
    for name, a, b in zip(("dq", "dk", "dv"), g16, g32):
        assert a.dtype == torch.bfloat16, name
        assert_close(a, b, atol=0.03 * float(b.abs().max()), name=name)


def test_cuda_wrappers_refuse_unsupported_operands():
    """Off the CPU both wrappers check what their kernels take before
    anything builds or runs (``meta`` tensors stand for a card, as in
    tests/test_torch_decoder.py): a head dim of 80, int64 segment ids, a
    strided q and a mismatched kv head count raise; operands the kernels
    take get as far as the device check."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, device="meta", dtype=dtype)

    def calls(q, k, seg, nkv=2):
        lse = meta(q.shape[0], q.shape[2], q.shape[1])
        return (lambda: LF.llm_flash_attn(q, k, k, seg, seg, nkv),
                lambda: LF.llm_flash_attn_bwd(q, k, k, seg, seg, q, lse, lse,
                                              nkv))

    seg = meta(1, 64, dtype=torch.int32)
    for q, k, s, nkv, msg in (
            (meta(1, 64, 4, 80), meta(1, 64, 2, 80), seg, 2,
             "unsupported shape"),
            (meta(1, 64, 4, 64), meta(1, 64, 2, 64),
             meta(1, 64, dtype=torch.int64), 2, "q_seg is torch.int64"),
            (meta(1, 4, 64, 64).transpose(1, 2), meta(1, 64, 2, 64), seg, 2,
             "not contiguous"),
            (meta(1, 64, 4, 64), meta(1, 64, 2, 64), seg, 3,
             "unsupported shape"),
            (meta(1, 64, 4, 128), meta(1, 64, 2, 128), seg, 2,
             "unsupported device")):
        for call in calls(q, k, s, nkv):
            with pytest.raises(ValueError, match=msg):
                call()
