"""Packed-rows LLM training (``--mode sft --pack``) in ``ullsam_tpu_torch``
against ``ullsam_tpu``: the packed InternLM2 forward (the port's mirror of
tests/test_packed.py and the JAX forward itself), the packed fusion loss,
the packing helpers, the sft trainable / no-decay sets and two whole f32
sft steps.

Both attention routes of the port run: the plain one (S below
``LLM_FLASH_MIN``) and the flash one (``LLM_FLASH_MIN`` lowered so the plain
B10 / B11 run through ``LlmFlashAttention`` at these tiny sizes). The JAX
side runs its XLA route (on the CPU it never takes the Pallas kernel). The
two routes differ on padding rows only (segment 0: the flash route lets
them attend each other, the XLA route gives their keys -1e9), so forwards
are compared on rows with ``segment_ids != 0``; the loss and gradients never
read padding rows.

Tolerances, all f32 on the CPU: logits 1e-4 absolute (another summation
order through two layers, as tests/test_torch_internlm2.py); the packed
forward against separate rows 1e-5; losses rtol 1e-5; step-1 gradients
within 1e-3 of each leaf's max|grad| plus 1e-7 absolute, updated weights
2e-5 absolute (|update| <= lr = 1e-3; as tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_close, jax_init, jax_params_to_numpy,
                                tiny_fusion_config)

from ullsam_tpu.core import config as JC
from ullsam_tpu.core.tree import flatten_with_paths
from ullsam_tpu.data import datasets as JD
from ullsam_tpu.models.internlm2 import model as JM
from ullsam_tpu.models.ullsam import fusion as JF
from ullsam_tpu.train import step as JS
from ullsam_tpu_torch.convert import from_jax as X
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.data import packing as TP
from ullsam_tpu_torch.models.internlm2 import model as TM
from ullsam_tpu_torch.models.ullsam import fusion as TF
from ullsam_tpu_torch.tools.main_path import SFT_TRAIN, packed_train_batch
from ullsam_tpu_torch.train import step as TS

T = torch.from_numpy
FIELDS = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=2048,
              bias=False, rope_theta=10000.0, pad_token_id=0,
              bos_token_id=1, eos_token_id=2)
TINY = TC.InternLM2Config(**FIELDS)


@pytest.fixture(params=["plain", "flash"])
def route(request, monkeypatch):
    """The port's attention route: the flash one by lowering the threshold
    (the JAX package's ULLSAM_LLM_FLASH_MIN, a module constant here)."""
    if request.param == "flash":
        monkeypatch.setattr(TM, "LLM_FLASH_MIN", 1)
    return request.param


def _llm():
    jcfg = JC.InternLM2Config(**FIELDS)
    p = jax_params_to_numpy(jax_init(JM.internlm2_init, 0, jcfg))
    lm = TM.InternLM2ForCausalLM(TINY, device="cpu")
    X.load_reference_state_dict(lm, X.internlm2_arrays(p, TINY))
    return jcfg, p, lm


def test_packed_forward_matches_separate_rows(route):
    """The port's mirror of tests/test_packed.py:24-48: one row [d1 | d2 |
    pad] gives each document the logits it gets alone."""
    _, _, lm = _llm()
    rng = np.random.RandomState(0)
    d1 = rng.randint(3, 128, size=11)
    d2 = rng.randint(3, 128, size=7)
    ids = np.zeros((1, 24), np.int64)
    seg = np.zeros((1, 24), np.int64)
    ids[0, :11], seg[0, :11] = d1, 1
    ids[0, 11:18], seg[0, 11:18] = d2, 2
    with torch.no_grad():
        lp = TM.internlm2_forward(lm, TINY, input_ids=T(ids),
                                  segment_ids=T(seg))["logits"]
        l1 = TM.internlm2_forward(lm, TINY, input_ids=T(d1[None]))["logits"]
        l2 = TM.internlm2_forward(lm, TINY, input_ids=T(d2[None]))["logits"]
    assert_close(lp[0, :11], l1[0], atol=1e-5, name="document 1")
    assert_close(lp[0, 11:18], l2[0], atol=1e-5, name="document 2")


def test_packed_forward_matches_jax(route):
    """``internlm2_forward(segment_ids=)`` on two rows (three segments and
    a pad tail; two segments after left padding) against the JAX forward:
    logits on the valid rows, hidden states too, and the restarted RoPE
    positions."""
    jcfg, p, lm = _llm()
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 128, (2, 40))
    seg = np.zeros((2, 40), np.int64)
    seg[0, :13], seg[0, 13:29], seg[0, 29:36] = 1, 2, 3
    seg[1, 6:25], seg[1, 25:] = 1, 2
    ref = JM.internlm2_forward(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                               input_ids=jnp.asarray(ids),
                               segment_ids=jnp.asarray(seg),
                               output_hidden_states=True)
    with torch.no_grad():
        out = TM.internlm2_forward(lm, TINY, input_ids=T(ids),
                                   segment_ids=T(seg),
                                   output_hidden_states=True)
    valid = seg != 0
    assert_close(out["logits"].numpy()[valid],
                 np.asarray(ref["logits"])[valid], atol=1e-4, name="logits")
    assert_close(out["hidden_states"].numpy()[:, valid],
                 np.asarray(ref["hidden_states"])[:, valid], atol=1e-4,
                 name="per-layer inputs")
    pos = TM.segment_positions(T(seg)).numpy()
    assert list(pos[0, 11:16]) == [11, 12, 0, 1, 2]
    assert list(pos[1, :8]) == [0] * 6 + [0, 1] and pos[0, 36:].sum() == 0


def _fusion(seed=0):
    jcfg, tcfg = tiny_fusion_config(JC), tiny_fusion_config(TC)
    p = jax_params_to_numpy(jax_init(JF.fusion_init, seed, jcfg),
                            np.random.default_rng(seed))
    model = TF.ULLSAM(tcfg, device="cpu")
    model.load_state_dict(X.fusion_state_dict_from_jax(p, tcfg))
    return jcfg, tcfg, p, model


def test_fusion_packed_loss_matches_jax(route):
    """``fusion_forward(labels, segment_ids)`` on one row of two packed
    samples with their two images: the CE loss (shift masked at the
    boundary) and the valid rows' logits against the JAX forward; the dense
    prompt is refused in packed mode."""
    jcfg, tcfg, p, model = _fusion()
    batch = packed_train_batch(tcfg, np.random.default_rng(2),
                               lengths=(70, 81), S=160)
    ref = JF.fusion_forward(jax.tree_util.tree_map(jnp.asarray, p), jcfg,
                            jnp.asarray(batch["pixel_values"]),
                            jnp.asarray(batch["input_ids"]),
                            labels=jnp.asarray(batch["labels"]),
                            segment_ids=jnp.asarray(batch["segment_ids"]))
    tb = {k: T(v) for k, v in batch.items()}
    with torch.no_grad():
        out = TF.fusion_forward(model, tcfg, tb["pixel_values"],
                                tb["input_ids"], labels=tb["labels"],
                                segment_ids=tb["segment_ids"])
        with pytest.raises(ValueError, match="packed"):
            TF.fusion_forward(model, tcfg, tb["pixel_values"],
                              tb["input_ids"], segment_ids=tb["segment_ids"],
                              output_dense_prompt=True)
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    valid = batch["segment_ids"] != 0
    assert_close(out["logits"].numpy()[valid],
                 np.asarray(ref["logits"])[valid], atol=1e-4, name="logits")
    # the boundary really is masked: scoring it changes the loss
    labels = batch["labels"].copy()
    assert labels[0, 70] != -100 and labels[0, 71] == -100
    with torch.no_grad():
        joined = TF.fusion_forward(model, tcfg, tb["pixel_values"],
                                   tb["input_ids"], labels=tb["labels"],
                                   segment_ids=(tb["segment_ids"] != 0)
                                   .long())
    assert float(joined["loss"]) != float(out["loss"])


class _Dataset:
    """Examples of varied lengths (one too long for any row), each with an
    image whose pixels carry its index."""

    def __init__(self, n=13, width=24):
        rng = np.random.default_rng(5)
        self.lens = rng.integers(3, width, n)
        self.lens[4] = 40
        self.width = max(width, 40)

    def __len__(self):
        return len(self.lens)

    def example(self, i):
        n, w = int(self.lens[i]), self.width
        return {"input_ids": np.arange(w, dtype=np.int32) + 100 * i,
                "attention_mask": (np.arange(w) < n).astype(np.int32),
                "labels": np.arange(w, dtype=np.int32) + 100 * i + 1,
                "pixel_values": np.full((2, 2, 3), i, np.float32)}


@pytest.mark.parametrize("shuffle,index,count", [(True, 0, 1), (True, 1, 2),
                                                 (False, 0, 1)])
def test_packing_matches_jax(shuffle, index, count):
    """``pack_examples`` and every batch of ``packed_batch_iterator_sharded``
    (samples deferred to fresh rows, the oversized one dropped) equal the
    JAX functions' on one fake dataset."""
    ds = _Dataset()
    exs = [ds.example(i) for i in (0, 1, 2)]
    a, b = TP.pack_examples(exs, 48, 0), JD.pack_examples(exs, 48, 0)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    kw = dict(rows_per_batch=2, max_length=32, pad_token_id=0,
              docs_per_row=2, shuffle=shuffle, seed=3, process_index=index,
              process_count=count)
    ours = list(TP.packed_batch_iterator_sharded(ds, **kw))
    theirs = list(JD.packed_batch_iterator_sharded(ds, **kw))
    assert len(ours) == len(theirs) >= 1
    for x, y in zip(ours, theirs):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    with pytest.raises(ValueError, match="overflow"):
        TP.pack_examples(exs, 20, 0)


def test_sft_trainable_and_no_decay_sets_match_jax():
    """The sft patterns on the JAX paths (the LLM's stacked
    ``llm.layers.*`` leaves become per-layer torch names): the same
    parameters train and decay as in the JAX step, and the SAM tower
    trains not at all."""
    jcfg, tcfg, p, model = _fusion()
    jt, tt = JS.TrainConfig(**SFT_TRAIN), TS.TrainConfig(**SFT_TRAIN)
    paths = X.jax_param_paths(model)
    jmask = flatten_with_paths(JS.trainable_mask(p, jt))
    train = TS.trainable_mask(model, tt)
    assert {n for n, m in train.items() if m} == {
        n for n, path in paths.items() if jmask[path]}
    assert all(train[n] == n.startswith(("fusion.language_model.",
                                         "fusion.mlp1.", "fusion.mlp2."))
               for n in train)
    assert train["fusion.language_model.model.layers.1.attention.wqkv.weight"]
    decay = TS.decay_mask(model, tt)
    assert {n for n, d in decay.items() if d} == {
        n for n, path in paths.items()
        if not JS._match_any(path, jt.no_decay_patterns)}
    assert not decay["fusion.language_model.model.tok_embeddings.weight"]
    assert not decay["fusion.language_model.model.layers.0.ffn_norm.weight"]
    assert decay["fusion.language_model.model.layers.0.feed_forward.w1.weight"]


def test_two_packed_sft_steps_match_jax(monkeypatch):
    """Two f32 sft steps (llm, mlp1, mlp2 trainable, remat on) on one
    packed row of two samples, the port through the flash route (plain B10
    / B11 under the layer checkpoints) against
    ``make_train_step(donate=False)`` from the same weights: the loss each
    step, the step-1 gradients leaf by leaf, the updated weights, SAM
    unchanged."""
    monkeypatch.setattr(TM, "LLM_FLASH_MIN", 1)
    jcfg, tcfg, p, model = _fusion(seed=1)
    kw = dict(SFT_TRAIN, learning_rate=1e-3, total_steps=100, remat=True)
    jt, tt = JS.TrainConfig(**kw), TS.TrainConfig(**kw)
    batch = packed_train_batch(tcfg, np.random.default_rng(3),
                               lengths=(75, 90), S=176)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tx, tr, fr = JS.make_trainable_optimizer(
        jax.tree_util.tree_map(jnp.asarray, p), jt)
    state = tx.init(tr)
    jgrad = jax.jit(jax.grad(lambda t: JS.seg_loss_fn(
        JS.combine_params(t, fr), jcfg, jt, jb)[0]))(tr)
    step = JS.make_train_step(jcfg, jt, tx, donate=False)
    jm = []
    for _ in range(2):
        tr, state, m = step(tr, fr, state, jb)
        jm.append(m)

    before = {n: t.clone() for n, t in model.state_dict().items()}
    opt = TS.make_trainable_optimizer(model, tt)
    tstep = TS.make_train_step(tcfg, tt, model, opt)
    for i in range(2):
        m = tstep(batch)
        assert set(m) == set(jm[i]) == {"llm_loss", "loss", "grad_norm"}
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[i][k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        if i == 0:
            tgrad = {n: (torch.zeros_like(q) if q.grad is None
                         else q.grad.clone())
                     for n, q in model.named_parameters() if q.requires_grad}

    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                   fr)
    ref = X.fusion_state_dict_from_jax(JS.combine_params(
        jax.tree_util.tree_map(np.asarray, jgrad), zeros), tcfg)
    assert set(tgrad) == set(opt.names)
    for n, g in tgrad.items():
        assert_close(g, ref[n], atol=1e-3 * float(ref[n].abs().max()) + 1e-7,
                     name=n)
    after = X.fusion_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, JS.combine_params(tr, fr)), tcfg)
    trainable = set(opt.names)
    for n, t in model.state_dict().items():
        assert_close(t, after[n], atol=2e-5, name=n)
        if n not in trainable:
            assert torch.equal(t, before[n]), n
    assert any(n.startswith("fusion.language_model.") and not torch.equal(
        model.state_dict()[n], before[n]) for n in trainable)
