"""The serving steps of the port's InternLM2 against ullsam_tpu: the prompt
segment at a cache offset (``internlm2_prefill_at``), the
continuous-batching step with per-row positions
(``internlm2_decode_step_multi``, held to all three JAX variants of it and
to ``internlm2_decode_step_win`` spliced back), the engine's decode chunk, and per-row sampling
(``sample_token_dynamic``).

Tolerances, f32 on the CPU (only the summation order differs): logits,
hidden states and cache entries atol 1e-5; masks, write slots and tokens
equal. Sampling: greedy rows equal JAX's argmax, and the set of tokens a
sampled row can draw equals the set JAX's ``apply_warpers`` keeps for that
row's config."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, jax_init, jax_params_to_numpy

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.internlm2 import model as JM
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.internlm2 import generate as TG
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.serve import engine as TE

T = torch.from_numpy
# the package __init__ re-exports a function named ``generate``
JG = importlib.import_module("ullsam_tpu.models.internlm2.generate")
FIELDS = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64, bias=False,
              rope_theta=10000.0, pad_token_id=0, bos_token_id=1,
              eos_token_id=2)
NTK = {"rope_scaling_type": "dynamic", "rope_scaling_factor": 2.0,
       "max_position_embeddings": 8}


def _llm(fields, seed=0):
    jcfg, cfg = JC.InternLM2Config(**fields), TC.InternLM2Config(**fields)
    p = jax_params_to_numpy(jax_init(JM.internlm2_init, seed, jcfg))
    lm = TM.InternLM2ForCausalLM(cfg, device="cpu")
    X.load_reference_state_dict(lm, X.internlm2_arrays(p, cfg))
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, p), lm.eval()


def _ragged_cache(cfg, rng, B, max_len, lens):
    """k / v random (0.1 scale) everywhere, rows right-packed to lens."""
    shape = (cfg.num_hidden_layers, B, max_len, cfg.num_key_value_heads,
             cfg.head_dim)
    k = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    mask = np.zeros((B, max_len), np.int32)
    for b, n in enumerate(lens):
        mask[b, :n] = 1
    jc = JM.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                    mask=jnp.asarray(mask), index=jnp.zeros((), jnp.int32))
    tc = TM.KVCache(k=T(k.copy()), v=T(v.copy()), mask=T(mask.copy()),
                    index=0)
    return jc, tc


@pytest.mark.parametrize("rope", [{}, NTK])
def test_prefill_at_matches_jax(rope):
    """A 20-token prompt (B = 2 rows, the second 17 long) in 3 segments of
    8 at offsets 0, 8, 16 into a cache of 32, f32: after every segment the
    logits of every valid row and last_hidden within 1e-5, the cache's k /
    v within 1e-5 in the written slots and its mask equal; ``logit_rows``
    gives the same rows' logits alone. With dynamic NTK (max_len 32 > 8) a
    step that scaled by the segment instead of max_len would fail."""
    jcfg, cfg, jp, lm = _llm(dict(FIELDS, **rope))
    rng = np.random.default_rng(0)
    B, C, max_len = 2, 8, 32
    ids = rng.integers(3, 128, (B, 3 * C))
    valid = np.zeros((B, 3 * C), np.int32)
    valid[0, :20], valid[1, :17] = 1, 1
    jc = JM.init_cache(jcfg, B, max_len, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, max_len, dtype=torch.float32)
    jemb = JM.embed_tokens(jp, jnp.asarray(ids))
    temb = TM.embed_tokens(lm, T(ids))
    for s in range(3):
        off = s * C
        m = valid[:, off:off + C]
        jout, jc = JM.internlm2_prefill_at(
            jp, jcfg, jemb[:, off:off + C], jnp.asarray(m), jc,
            jnp.asarray(off, jnp.int32))
        with torch.no_grad():
            tout, tc = TM.internlm2_prefill_at(
                lm, cfg, temb[:, off:off + C], T(m), tc, off)
        ok = m.astype(bool)
        assert_close(tout["logits"].numpy()[ok],
                     np.asarray(jout["logits"])[ok], atol=1e-5,
                     name=f"segment {s} logits")
        assert_close(tout["last_hidden"].numpy()[ok],
                     np.asarray(jout["last_hidden"])[ok], atol=1e-5,
                     name=f"segment {s} last_hidden")
        assert tc.index == int(jc.index) == off + C
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
        written = np.asarray(jc.mask).astype(bool)
        for name, a, b in (("k", tc.k, jc.k), ("v", tc.v, jc.v)):
            assert_close(a.numpy()[:, written], np.asarray(b)[:, written],
                         atol=1e-5, name=f"segment {s} {name}")
    with torch.no_grad():   # the head alone on rows 2-4 of a first segment
        first, rows = (TM.internlm2_prefill_at(
            lm, cfg, temb[:, :C], T(valid[:, :C]),
            TM.init_cache(cfg, B, max_len, dtype=torch.float32), 0,
            logit_rows=r)[0]["logits"] for r in (None, slice(2, 5)))
    assert rows.shape == (B, 3, 128)
    assert_close(rows, first[:, 2:5], atol=1e-6)


@pytest.mark.parametrize("attend_len", [8, 16, None])
def test_decode_step_multi_matches_jax_variants(attend_len):
    """Ragged right-packed rows (lengths 5, 7, 3), the last inactive, f32:
    the port's in-place step against JAX's ``_multi`` (scan; the unrolled
    and split-softmax variants on the active rows, whose inactive row
    differs by design) and ``_win`` spliced back into the cache: logits
    1e-5, every row's k / v written at the same slots 1e-5, masks equal
    (the inactive row's unchanged)."""
    jcfg, cfg, jp, lm = _llm(FIELDS, seed=1)
    rng = np.random.default_rng(1)
    B, max_len = 3, 16
    jc, tc = _ragged_cache(cfg, rng, B, max_len, [5, 7, 3])
    emb = (rng.standard_normal((B, 1, cfg.hidden_size)) * 0.1
           ).astype(np.float32)
    active = np.array([True, True, False])
    with torch.no_grad():
        tl, tc = TM.internlm2_decode_step_multi(lm, cfg, T(emb), tc,
                                                T(active),
                                                attend_len=attend_len)
    for unroll, split in ((False, False), (True, False), (False, True),
                          (True, True)):
        jl, jc2 = JM.internlm2_decode_step_multi(
            jp, jcfg, jnp.asarray(emb), jc, jnp.asarray(active),
            attend_len=attend_len, unroll=unroll, split_attn=split)
        rows = slice(None) if not split else active
        tag = f"unroll={unroll} split_attn={split}"
        assert_close(tl.numpy()[rows], np.asarray(jl)[rows], atol=1e-5,
                     name=f"{tag} logits")
        np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc2.mask))
        for name, a, b in (("k", tc.k, jc2.k), ("v", tc.v, jc2.v)):
            assert_close(a, np.asarray(b), atol=1e-5, name=f"{tag} {name}")
    W = max_len if attend_len is None else attend_len
    jl, k_new, v_new, new_mask = JM.internlm2_decode_step_win(
        jp, jcfg, jnp.asarray(emb), jc.k[:, :, :W], jc.v[:, :, :W], jc.mask,
        jnp.asarray(active), ntk_seq_len=max_len)
    pos = jnp.sum(jc.mask, axis=-1)
    k_full = jc.k.at[:, jnp.arange(B), pos].set(k_new)
    v_full = jc.v.at[:, jnp.arange(B), pos].set(v_new)
    assert_close(tl, np.asarray(jl), atol=1e-5, name="_win logits")
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(new_mask))
    assert_close(tc.k, np.asarray(k_full), atol=1e-5, name="_win k")
    assert_close(tc.v, np.asarray(v_full), atol=1e-5, name="_win v")


def test_engine_step_matches_jax_chunk():
    """Two greedy 3-step chunks of the port's ``_engine_step`` (ragged rows
    5, 7, 3, the last inactive, window 16 of 32) against JAX's
    ``_engine_step`` with the window carry and with the cache carry, f32:
    emitted tokens equal (pad on the inactive row), the cache's mask equal
    and its k / v within 1e-5."""
    from ullsam_tpu.serve.engine import _engine_step as jax_engine_step

    jcfg, cfg, jp, lm = _llm(FIELDS, seed=3)
    rng = np.random.default_rng(3)
    B, max_len = 3, 32
    jc, tc = _ragged_cache(cfg, rng, B, max_len, [5, 7, 3])
    toks = rng.integers(3, 128, (B,))
    active = np.array([True, True, False])
    jfcfg = JC.FusionConfig(llm=jcfg)
    samp = JG.SamplingParams.from_configs([JG.GenerationConfig()] * B)
    st = TE.StepState(tokens=T(toks.copy()), cache=tc, active=T(active),
                      samp=TG.SamplingParams.from_configs([], pad_to=B),
                      uniform=torch.zeros(3, B),
                      emitted=torch.zeros((B, 3), dtype=torch.int64))
    got = []
    with torch.no_grad():
        for _ in range(2):
            got.append(TE._engine_step(lm, TC.FusionConfig(llm=cfg), st, 3,
                                       False, 0, 16).clone())
    for window in (True, False):
        cache, cur, em = jc, jnp.asarray(toks, jnp.int32), []
        for _ in range(2):
            e, cache, _ = jax_engine_step(
                {"llm": jp}, jfcfg, cur,
                jax.tree_util.tree_map(jnp.array, cache),
                jnp.asarray(active), samp, jax.random.PRNGKey(0), n_steps=3,
                dynamic_sampling=False, pad_token_id=0, attend_len=16,
                window=window)
            cur = e[:, -1]
            em.append(np.asarray(e))
        np.testing.assert_array_equal(torch.cat(got, 1).numpy(),
                                      np.concatenate(em, 1))
        np.testing.assert_array_equal(st.cache.mask.numpy(),
                                      np.asarray(cache.mask))
        assert_close(st.cache.k, np.asarray(cache.k), atol=1e-5)
        assert_close(st.cache.v, np.asarray(cache.v), atol=1e-5)
    assert bool((torch.cat(got, 1)[2] == 0).all())


MIXED = [JG.GenerationConfig(do_sample=True, temperature=0.7, top_k=50,
                             top_p=0.9),
         JG.GenerationConfig(do_sample=True, top_k=5),
         JG.GenerationConfig(do_sample=True, top_p=0.5),
         JG.GenerationConfig(do_sample=False),
         JG.GenerationConfig(do_sample=True, temperature=5.0, top_k=8),
         JG.GenerationConfig(do_sample=True, top_k=1)]


def _port_samp(gens):
    return TG.SamplingParams.from_configs(
        [TG.GenerationConfig(do_sample=g.do_sample, temperature=g.temperature,
                             top_k=g.top_k, top_p=g.top_p) for g in gens])


def test_sample_token_dynamic_matches_jax_per_row():
    """Six rows, each its own config (temperature, top-k, top-p, greedy,
    top-k 1): greedy and top-k-1 rows equal JAX's argmax; each sampled
    row's warped support equals JAX ``apply_warpers`` for that row's config
    alone; 64 seeded draws stay inside it, reach more than one token where
    it holds several, and repeat under the same seed."""
    logits = np.random.RandomState(0).randn(6, 128).astype(np.float32) * 3
    samp = _port_samp(MIXED)
    jsamp = JG.SamplingParams.from_configs(MIXED)
    jdraw = np.asarray(JG.sample_token_dynamic(jnp.asarray(logits), jsamp,
                                               jax.random.PRNGKey(0)))
    support = torch.isfinite(TG.warp_dynamic(T(logits), samp)).numpy()
    for b, g in enumerate(MIXED):
        if g.do_sample:
            want = np.isfinite(np.asarray(JG.apply_warpers(
                jnp.asarray(logits[b:b + 1]), g)))[0]
            np.testing.assert_array_equal(support[b], want, err_msg=str(g))
    draws = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(5)
        draws.append(torch.stack([TG.sample_token_dynamic(T(logits), samp,
                                                          generator=gen)
                                  for _ in range(64)]).numpy())
    np.testing.assert_array_equal(draws[0], draws[1])
    for b, g in enumerate(MIXED):
        d = draws[0][:, b]
        if not g.do_sample or g.top_k == 1:
            assert (d == np.argmax(logits[b])).all() and d[0] == jdraw[b]
            continue
        assert support[b][d].all(), str(g)
        if support[b].sum() > 1:
            assert len(set(d.tolist())) > 1, str(g)


def test_sample_token_dynamic_uniform_inverts_the_cdf():
    """A given uniform draw picks the token whose CDF interval (over the
    warped distribution in descending order) holds it: u = 0 the top token,
    u just below 1 the last kept one."""
    logits = T(np.random.RandomState(1).randn(2, 64).astype(np.float32))
    samp = _port_samp([JG.GenerationConfig(do_sample=True, top_k=4)] * 2)
    top4 = torch.topk(logits, 4).indices
    got = TG.sample_token_dynamic(logits, samp,
                                  uniform=torch.tensor([0.0, 1 - 1e-7]))
    assert int(got[0]) == int(top4[0, 0]) and int(got[1]) == int(top4[1, 3])
