"""The port's weight-only int8 path against ullsam_tpu: the plain version
of kernel B12 against the interpret-mode Pallas ``w8a16_matmul`` and the
XLA int8 route of ``ops.layers.linear``, ``quantize_llm_int8`` against the
JAX quantization element for element, and the quantized tiny LLM's forward
and greedy generation against JAX on the same int8 weights.

Tolerances: B12 in f32 sums, 1e-5 of max|ref| (only the summation order
differs: int8 -> x's dtype is exact); where the JAX linear rounds that sum
to bf16, one bf16 step (2^-8) of max|ref|, since two f32 sums that differ
in their last bits can round to neighbouring bf16 values. Quantization:
int8 equal, scales rtol 1e-7. Quantized forward, f32 on the CPU: 1e-5."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_helpers import assert_close, jax_init, jax_params_to_numpy

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.internlm2 import model as JM
from ullsam_tpu.models.internlm2 import quant as JQ
from ullsam_tpu.ops import layers as JL
from ullsam_tpu.ops.pallas.int8_matmul import w8a16_matmul as jax_w8a16
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.internlm2 import generate as TG
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.models.internlm2 import quant as TQ
from ullsam_tpu_torch.ops import layers as TL
from ullsam_tpu_torch.ops.kernels.int8_matmul import (check_weights,
                                                      split_bf16x3,
                                                      w8a16_matmul,
                                                      w8a16_matmul_plain)

T = torch.from_numpy
# the package __init__ re-exports a function named ``generate``
JG = importlib.import_module("ullsam_tpu.models.internlm2.generate")
FIELDS = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64, bias=False,
              rope_theta=10000.0, pad_token_id=0, bos_token_id=1,
              eos_token_id=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(rng, M, K, N):
    x = rng.standard_normal((M, K)).astype(np.float32)
    qw = rng.integers(-127, 128, (K, N)).astype(np.int8)     # JAX [in, out]
    qs = (rng.random(N) * 0.01 + 0.001).astype(np.float32)
    return x, qw, qs


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(8, 512, 1024), (1, 256, 384),
                                   (4, 512, 1024), (16, 256, 384)])
def test_plain_b12_matches_interpret_pallas(dt, M, K, N):
    """The plain B12 against the interpret-mode Pallas kernel at the decode
    rows of the card's bodies: 1 (the GEMV), 4 (a beam step, the tp 2
    engine) and 8, 16 (the tensor-core body's two widths)."""
    jdt, tdt = DTYPES[dt]
    x, qw, qs = _operands(np.random.default_rng(M), M, K, N)
    bn = next(b for b in (512, 256, 128) if N % b == 0)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_w8a16(jnp.asarray(x, jdt), jnp.asarray(qw),
                        jnp.asarray(qs), block_n=bn)
    got = w8a16_matmul(T(x).to(tdt), T(qw.T.copy()), T(qs))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel(got, ref) <= 1e-5


def _rebuilt(x):
    """b0 + b1 + b2 of ``split_bf16x3(x)`` in float64 (exact)."""
    return sum(p.double() for p in split_bf16x3(x)).numpy()


def test_split_bf16x3_rebuilds_x():
    """f32 x is the sum of its three bf16 parts exactly: seeded normals
    over exponents 2^-100 to 2^100, +-0, the largest f32 (which rounding
    the first part would send to inf), and values from 2^-110 up. The edge
    is below: a part cannot hold a bit under 2^-133 (bf16's least
    subnormal), so x near 2^-126 (its last bits at 2^-149) is rebuilt
    within 2^-134, exactly where its bits lie at or above 2^-133."""
    rng = np.random.default_rng(23)
    big = np.finfo(np.float32).max
    x = np.concatenate([
        np.ldexp(rng.standard_normal(4096), rng.integers(-100, 101, 4096)),
        [0.0, -0.0, big, -big, 2.0 ** -110, -(2.0 ** -110) * 1.75],
        np.ldexp(1.0 + rng.random(256), rng.integers(-110, -99, 256))
        * rng.choice([-1.0, 1.0], 256)]).astype(np.float32)
    parts = split_bf16x3(T(x))
    assert all(p.dtype == torch.bfloat16 and p.shape == x.shape
               for p in parts)
    assert all(bool(torch.isfinite(p).all()) for p in parts)
    np.testing.assert_array_equal(_rebuilt(T(x)), x.astype(np.float64))
    assert np.array_equal(np.signbit(parts[0].float().numpy()),
                          np.signbit(x))
    assert torch.isinf(torch.tensor(big).bfloat16())
    # near 2^-126: 23 random mantissa bits, the last ones below 2^-133
    tiny = np.ldexp(1.0 + rng.integers(0, 2 ** 23, 512) / 2.0 ** 23,
                    rng.integers(-127, -124, 512)).astype(np.float32)
    tiny *= rng.choice([-1.0, 1.0], 512).astype(np.float32)
    err = np.abs(_rebuilt(T(tiny)) - tiny.astype(np.float64))
    assert err.max() <= 2.0 ** -134 and err.max() > 0
    on_grid = (np.round(tiny.astype(np.float64) * 2.0 ** 133)
               * 2.0 ** -133).astype(np.float32)
    np.testing.assert_array_equal(_rebuilt(T(on_grid)),
                                  on_grid.astype(np.float64))


@pytest.mark.parametrize("M,K,N", [(8, 512, 1024), (1, 256, 384),
                                   (4, 512, 1024), (16, 256, 384)])
def test_split_b12_matches_interpret_pallas(M, K, N):
    """The f32 bodies' arithmetic, each of x's three bf16 parts times the
    int8 weight, the products summed (in float64 here) and scaled, against
    the interpret-mode Pallas kernel at f32 x, within 1e-5 of max|ref|."""
    x, qw, qs = _operands(np.random.default_rng(M), M, K, N)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_w8a16(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(qs),
                        block_n=next(b for b in (512, 256, 128)
                                     if N % b == 0))
    w = T(qw).double()
    got = sum(p.double() @ w for p in split_bf16x3(T(x))) * T(qs).double()
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_b12_matches_xla_int8_linear(dt, with_bias):
    """At a ragged N (200: the TPU kernel needs N % 128), through the int8
    linear of both packages (scale, bias in f32, cast to x's dtype), and
    the f32 sums of B12's plain version against the XLA route's."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(3)
    M, K, N = 5, 96, 200
    x, qw, qs = _operands(rng, M, K, N)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    p = {"qweight": jnp.asarray(qw), "qscale": jnp.asarray(qs)}
    if with_bias:
        p["bias"] = jnp.asarray(b, jdt)
    xj = jnp.asarray(x, jdt)
    ref = JL.linear(p, xj)
    bias = T(b).to(tdt) if with_bias else None
    got = TL.linear_int8(T(x).to(tdt)[None], T(qw.T.copy()), T(qs), bias)
    assert got.dtype == tdt and got.shape == (1, M, N)
    tol = 1e-5 if dt == "float32" else 2.0 ** -8
    assert _rel(got[0].float(), ref) <= tol
    sums = jnp.dot(xj, jnp.asarray(qw).astype(jdt),
                   preferred_element_type=jnp.float32) * jnp.asarray(qs)
    assert _rel(w8a16_matmul_plain(T(x).to(tdt), T(qw.T.copy()), T(qs)),
                sums) <= 1e-5


@pytest.mark.parametrize("bad", ["qweight not contiguous", "K % 16",
                                 "qweight not int8", "qscale float64",
                                 "qscale shape", "bias shape"])
def test_quant_linear_checks_its_buffers_when_made(bad):
    """``check_weights``, which a ``QuantLinear`` runs on its CUDA buffers
    once, refuses each bad operand. A ``QuantLinear`` made on the CPU
    refuses the bad types and shapes at once, and takes what only the
    kernel cannot (K % 16, a strided weight): the plain version computes
    those, as the JAX int8 linear does."""
    q = torch.randint(-127, 128, (32, 64), dtype=torch.int8)
    s, b = torch.rand(32), torch.rand(32)
    if bad == "qweight not contiguous":
        q = q.t().contiguous().t()
    elif bad == "K % 16":
        q = q[:, :40].contiguous()
    elif bad == "qweight not int8":
        q = q.float()
    elif bad == "qscale float64":
        s = s.double()
    elif bad == "qscale shape":
        s = s[:16]
    else:
        b = b[:16]
    with pytest.raises(ValueError):
        check_weights(q, s, b)
    if bad in ("qweight not contiguous", "K % 16"):
        lin = TL.QuantLinear(q, s, b)
        x = torch.randn(3, q.shape[1])
        assert torch.equal(lin(x), w8a16_matmul_plain(x, q, s, b, x.dtype))
    else:
        with pytest.raises(ValueError):
            TL.QuantLinear(q, s, b)


def test_quant_linear_keeps_bias_in_f32():
    """A bf16 bias becomes an f32 buffer (exact), and the module's forward
    equals the int8 linear with the bf16 bias: the sum in f32, then one
    cast to x's dtype."""
    rng = np.random.default_rng(5)
    x, qw, qs = _operands(rng, 3, 48, 40)
    b = T(rng.standard_normal(40).astype(np.float32)).to(torch.bfloat16)
    lin = TL.QuantLinear(T(qw.T.copy()), T(qs), b)
    assert lin.bias.dtype == torch.float32 and torch.equal(lin.bias,
                                                           b.float())
    xb = T(x).to(torch.bfloat16)
    assert torch.equal(lin(xb), TL.linear_int8(xb, T(qw.T.copy()), T(qs), b))


def _jax_llm():
    jcfg = JC.InternLM2Config(**FIELDS)
    return jcfg, jax_params_to_numpy(jax_init(JM.internlm2_init, 0, jcfg))


def _port_llm(p, cfg, quantized_tree=None):
    lm = TM.InternLM2ForCausalLM(cfg, device="cpu")
    X.load_reference_state_dict(lm, X.internlm2_arrays(p, cfg))
    if quantized_tree is not None:
        TQ.quantize_llm_int8(lm)
        X.load_reference_state_dict(lm, X.internlm2_arrays(quantized_tree,
                                                           cfg))
    return lm.eval()


def test_quantize_matches_jax():
    """The port's quantization of weights carried from a JAX tree equals
    JAX ``quantize_llm_int8`` carried by ``internlm2_arrays``: every int8
    weight element for element, every scale to rtol 1e-7."""
    jcfg, p = _jax_llm()
    cfg = TC.InternLM2Config(**FIELDS)
    qtree = jax.tree_util.tree_map(np.asarray, JQ.quantize_llm_int8(p))
    want = X.internlm2_arrays(qtree, cfg)
    lm = TQ.quantize_llm_int8(_port_llm(p, cfg))
    # only the embedding and the norms stay parameters (in their dtype)
    assert all(n.endswith("norm.weight") or "tok_embeddings" in n
               for n, _ in lm.named_parameters())
    sd = lm.state_dict()
    n_q = 0
    for k, v in want.items():
        if k.endswith(".qweight"):
            assert sd[k].dtype == torch.int8
            assert np.array_equal(sd[k].numpy(), v), k
            n_q += 1
        elif k.endswith(".qscale"):
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=1e-7, err_msg=k)
    assert n_q == 5 * cfg.num_hidden_layers + 1


def test_quantized_forward_and_generate_match_jax():
    """JAX ``quantize_llm_int8`` params loaded into a quantized port model:
    the cache-less forward (left padding) within 1e-5 in f32, and greedy
    ``generate`` gives equal tokens and lengths."""
    jcfg, p = _jax_llm()
    cfg = TC.InternLM2Config(**FIELDS)
    qtree = jax.tree_util.tree_map(np.asarray, JQ.quantize_llm_int8(p))
    lm = _port_llm(p, cfg, qtree)
    jq = jax.tree_util.tree_map(jnp.asarray, qtree)
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 128, (2, 12))
    mask = np.ones((2, 12), np.int64)
    mask[1, :5] = 0
    ref = JM.internlm2_forward(jq, jcfg, input_ids=jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        out = TM.internlm2_forward(lm, cfg, input_ids=T(ids),
                                   attention_mask=T(mask))
    valid = mask.astype(bool)
    assert_close(out["logits"].numpy()[valid],
                 np.asarray(ref["logits"])[valid], atol=1e-5, name="logits")
    gen_j = JG.GenerationConfig(max_new_tokens=10, eos_token_id=2,
                                pad_token_id=0)
    gen_t = TG.GenerationConfig(max_new_tokens=10, eos_token_id=2,
                                pad_token_id=0)
    toks_j, lens_j = JG.generate(jq, jcfg, gen_j,
                                 JM.embed_tokens(jq, jnp.asarray(ids)),
                                 jnp.asarray(mask))
    toks_t, lens_t = TG.generate(lm, cfg, gen_t,
                                 TM.embed_tokens(lm, T(ids)), T(mask))
    np.testing.assert_array_equal(toks_t.numpy(), np.asarray(toks_j))
    np.testing.assert_array_equal(lens_t.numpy(), np.asarray(lens_j))


def test_quantize_any_width_on_cpu_matches_jax():
    """A width B12 does not take (intermediate size 72: w2's K % 16 != 0)
    quantizes on the CPU, and its logits match the JAX package's
    ``quantize_llm_int8`` model within 1e-5 of their max (f32; the same
    int8 weights, summation order only)."""
    fields = dict(FIELDS, intermediate_size=72)
    jcfg = JC.InternLM2Config(**fields)
    p = jax_params_to_numpy(jax_init(JM.internlm2_init, 0, jcfg))
    cfg = TC.InternLM2Config(**fields)
    qtree = jax.tree_util.tree_map(np.asarray, JQ.quantize_llm_int8(p))
    lm = TQ.quantize_llm_int8(_port_llm(p, cfg)).eval()
    assert lm.model.layers[0].feed_forward.w2.qweight.shape == (64, 72)
    ids = np.random.default_rng(2).integers(3, 128, (2, 10))
    ref = JM.internlm2_forward(jax.tree_util.tree_map(jnp.asarray, qtree),
                               jcfg, input_ids=jnp.asarray(ids))
    with torch.no_grad():
        out = TM.internlm2_forward(lm, cfg, input_ids=T(ids))
    ref = np.asarray(ref["logits"])
    assert _rel(out["logits"].numpy(), ref) <= 1e-5
