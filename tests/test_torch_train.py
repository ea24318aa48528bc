"""The train step of ``ullsam_tpu_torch`` against ``ullsam_tpu.train``: the
losses and their gradients, the trainable and no-decay parameter sets, the
learning-rate schedule and the optimizer against optax, and three whole
f32 steps on ``tiny_fusion_config`` from carried weights.

Tolerances: losses and metrics rtol 1e-5 (f32, another summation order
through ViT, LLM and decoder; measured ~1e-7); the schedule and the
optimizer against optax 1e-5 relative (the same arithmetic; optax evaluates
the schedule and its bias corrections in f32); step-1 gradients leaf by leaf within 1e-3 of the leaf's max|grad|
plus 1e-7 absolute (the attention k-projection biases have an exactly-zero
gradient, softmax being shift-invariant, so both sides hold rounding noise
of ~1e-9 there); updated weights 2e-5 absolute (|update| <= lr = 1e-3 per
step; measured ~1e-6).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import (assert_close, jax_init, jax_params_to_numpy,
                                tiny_fusion_config, to_np)

from ullsam_tpu.core import config as JC
from ullsam_tpu.core.tree import flatten_with_paths
from ullsam_tpu.models.ullsam import fusion as JF
from ullsam_tpu.ops.resize import _bilinear_matrix as j_bilinear_matrix
from ullsam_tpu.train import losses as JL
from ullsam_tpu.train import step as JS
from ullsam_tpu_torch.convert.from_jax import (fusion_state_dict_from_jax,
                                               jax_param_paths)
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.ullsam import fusion as TF
from ullsam_tpu_torch.ops.resize import _bilinear_matrix
from ullsam_tpu_torch.train import losses as TL
from ullsam_tpu_torch.train import step as TS

T = torch.from_numpy


def _loss_case(seed=3):
    rng = np.random.default_rng(seed)
    low = (rng.standard_normal((2, 3, 16, 16)) * 2).astype(np.float32)
    gt = (rng.random((2, 3, 40, 40)) > 0.6).astype(np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    return low, gt, valid


def test_losses_and_gradients_match_jax():
    """bce, dice, iou, instance_seg_loss and the fused
    upsampled_instance_seg_loss: values, metrics and d/d(logits)."""
    low, gt, valid = _loss_case()
    up = np.einsum("ih,bnhw,jw->bnij", j_bilinear_matrix(40, 16), low,
                   j_bilinear_matrix(40, 16)).astype(np.float32)
    for fn in ("bce_with_logits", "dice_loss", "binary_iou"):
        assert_close(getattr(TL, fn)(T(up), T(gt)),
                     getattr(JL, fn)(jnp.asarray(up), jnp.asarray(gt)),
                     atol=1e-6, name=fn)
    for name, jfn, tfn, x in (
            ("instance", JL.instance_seg_loss, TL.instance_seg_loss, up),
            ("upsampled", JL.upsampled_instance_seg_loss,
             TL.upsampled_instance_seg_loss, low)):
        (jt, jm), jg = jax.value_and_grad(
            lambda a: jfn(a, jnp.asarray(gt), jnp.asarray(valid)),
            has_aux=True)(jnp.asarray(x))
        xt = T(x).requires_grad_()
        tt, tm = tfn(xt, T(gt), T(valid))
        (tg,) = torch.autograd.grad(tt, xt)
        np.testing.assert_allclose(float(tt.detach()), float(jt),
                                   rtol=1e-5, err_msg=name)
        for k in ("bce", "dice", "iou", "seg_loss"):
            np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{name} {k}")
        assert_close(tg, jg, atol=1e-4 * float(np.abs(jg).max()),
                     name=f"{name} grad")
    for out, inp in ((40, 16), (16, 16), (7, 3)):
        assert_close(_bilinear_matrix(out, inp, "cpu"),
                     j_bilinear_matrix(out, inp), atol=1e-7)


def _models(seed=0):
    jcfg, tcfg = tiny_fusion_config(JC), tiny_fusion_config(TC)
    p = jax_params_to_numpy(jax_init(JF.fusion_init, seed, jcfg),
                            np.random.default_rng(seed))
    model = TF.ULLSAM(tcfg, device="cpu")
    model.load_state_dict(fusion_state_dict_from_jax(p, tcfg))
    return jcfg, tcfg, p, model


@pytest.mark.parametrize("freeze_vision", [False, True])
def test_trainable_and_no_decay_sets_match_jax(freeze_vision):
    """Every torch parameter maps to a JAX param path, every JAX leaf is
    reached, and the trainable and no-decay decisions agree."""
    jcfg, tcfg, p, model = _models()
    jt = JS.TrainConfig(freeze_vision=freeze_vision)
    tt = TS.TrainConfig(freeze_vision=freeze_vision)
    paths = jax_param_paths(model)
    jmask = flatten_with_paths(JS.trainable_mask(p, jt))
    assert set(paths.values()) == set(jmask)
    tmask = TS.trainable_mask(model, tt)
    assert {n for n, m in tmask.items() if m} == {
        n for n, path in paths.items() if jmask[path]}
    jdecay = flatten_with_paths(jax.tree_util.tree_map(
        lambda _: True, p))
    jdecay = {k: not JS._match_any(k, jt.no_decay_patterns) for k in jdecay}
    tdecay = TS.decay_mask(model, tt)
    assert {n for n, d in tdecay.items() if d} == {
        n for n, path in paths.items() if jdecay[path]}
    assert any(tdecay.values()) and not all(tdecay.values())


def test_schedule_and_optimizer_match_optax():
    """The warmup-cosine schedule at steps 0..N, and clip + AdamW with a
    decay mask against optax over four steps (the clip triggering on two of
    them), on plain tensors."""
    tcfg = TS.TrainConfig(learning_rate=3e-3, total_steps=40,
                          warmup_ratio=0.1, max_grad_norm=1.0)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 4, 40, 0.0)
    ours = TS.lr_schedule(tcfg)
    for c in range(45):
        # optax evaluates the schedule in f32
        np.testing.assert_allclose(ours(c), float(sched(c)), rtol=1e-5,
                                   atol=1e-12)

    rng = np.random.default_rng(4)
    model = torch.nn.Module()       # names as ULLSAM's: fusion.mlp1.*
    model.fusion = torch.nn.Module()
    model.fusion.mlp1 = TF.ProjMLP(5, 6, 4, 1e-5, device="cpu")
    with torch.no_grad():
        for q in model.parameters():
            q.copy_(T(rng.standard_normal(tuple(q.shape)).astype(
                np.float32)))
    opt = TS.AdamW(model, tcfg)
    jp = {n: jnp.asarray(to_np(p)) for n, p in zip(opt.names, opt.params)}
    decay = {n: not JS._match_any(path, tcfg.no_decay_patterns)
             for n, path in jax_param_paths(model).items()}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=tcfg.weight_decay,
                                 mask={n: decay[n] for n in jp}))
    state = tx.init(jp)
    for step, scale in enumerate((0.1, 3.0, 0.05, 5.0)):
        g = {n: (rng.standard_normal(tuple(p.shape)) * scale).astype(
            np.float32) for n, p in zip(opt.names, opt.params)}
        upd, state = tx.update({n: jnp.asarray(v) for n, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        norm = opt.step([T(g[n]) for n in opt.names])
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(g)), rtol=1e-6)
        for n, p in zip(opt.names, opt.params):
            np.testing.assert_allclose(to_np(p), np.asarray(jp[n]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} {n}")


def _batch(cfg, rng, B=2, I=3, P=2, Hm=96):
    n = cfg.num_image_token
    ids = np.full((B, n + 8), 5, np.int32)
    ids[:, 2:2 + n] = cfg.img_context_token_id
    S = cfg.sam.vit.img_size
    return {"pixel_values": rng.random((B, S, S, 3)).astype(np.float32),
            "input_ids": ids, "attention_mask": np.ones_like(ids),
            "point_coords": (rng.random((B, I, P, 2)) * S).astype(np.float32),
            "point_labels": rng.integers(0, 2, (B, I, P)).astype(np.int32),
            "masks": (rng.random((B, I, Hm, Hm)) > 0.7).astype(np.float32),
            "instance_valid": np.array([[1, 1, 0], [1, 1, 1]], np.float32)}


def steps_match_jax(kw, steps=3, grad_accum=1, seed=0, batch_seed=1):
    """``steps`` f32 steps of the port (``TrainConfig(**kw)``,
    ``grad_accum``) vs the JAX ``make_train_step(donate=False)`` from the
    same weights and batch: loss and metrics each step, the step-1
    gradients leaf by leaf, the updated weights, frozen weights
    unchanged."""
    jcfg, tcfg, p, model = _models(seed)
    kw = dict(dict(learning_rate=1e-3, total_steps=100), **kw)
    jt, tt = JS.TrainConfig(**kw), TS.TrainConfig(**kw)
    batch = _batch(jcfg, np.random.default_rng(batch_seed))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tx, tr, fr = JS.make_trainable_optimizer(
        jax.tree_util.tree_map(jnp.asarray, p), jt, grad_accum=grad_accum)
    state = tx.init(tr)
    jgrad = jax.jit(jax.grad(lambda t: JS.seg_loss_fn(
        JS.combine_params(t, fr), jcfg, jt, jb)[0]))(tr)
    step = JS.make_train_step(jcfg, jt, tx, donate=False)
    jm = []
    for _ in range(steps):
        tr, state, m = step(tr, fr, state, jb)
        jm.append(m)

    before = {n: t.clone() for n, t in model.state_dict().items()}
    opt = TS.make_trainable_optimizer(model, tt, grad_accum=grad_accum)
    tstep = TS.make_train_step(tcfg, tt, model, opt)
    for i in range(steps):
        m = tstep(batch)
        assert set(m) == set(jm[i])
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[i][k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        if i == 0:  # a parameter off the loss's path has no gradient
            tgrad = {n: (torch.zeros_like(q) if q.grad is None
                         else q.grad.clone())
                     for n, q in model.named_parameters() if q.requires_grad}

    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                   fr)
    full = JS.combine_params(jax.tree_util.tree_map(np.asarray, jgrad), zeros)
    ref = fusion_state_dict_from_jax(full, tcfg)
    assert set(tgrad) == set(opt.names)
    for n, g in tgrad.items():
        r = ref[n]
        assert_close(g, r, atol=1e-3 * float(r.abs().max()) + 1e-7, name=n)

    after = fusion_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, JS.combine_params(tr, fr)), tcfg)
    trainable = set(opt.names)
    for n, t in model.state_dict().items():
        assert_close(t, after[n], atol=2e-5, name=n)
        if n not in trainable:
            assert torch.equal(t, before[n]), n
    moved = [n for n in trainable if not torch.equal(
        model.state_dict()[n], before[n])]
    assert moved or steps == 1  # the first update runs at lr 0
    return model, opt


@pytest.mark.parametrize("hidden,freeze,remat", [
    (True, False, False), (True, False, True), (False, False, False),
    (True, True, False)], ids=["llm-dense", "llm-dense-remat", "baseline",
                               "freeze-vision"])
def test_three_train_steps_match_jax(hidden, freeze, remat):
    """Three f32 steps of the port vs ``make_train_step(donate=False)`` from
    the same weights and batch: loss and metrics each step, the step-1
    gradients leaf by leaf, the updated weights, frozen weights unchanged."""
    steps_match_jax(dict(use_llm_hidden_states=hidden, freeze_vision=freeze,
                         remat=remat))


def test_pred_masks_and_unported_options():
    """make_pred_masks_fn gives [B, I, Hm, Wm] logits that agree with the
    JAX one; one step with the Hungarian matching agrees with JAX's."""
    jcfg, tcfg, p, model = _models(seed=2)
    batch = _batch(jcfg, np.random.default_rng(5), B=1, Hm=80)
    jt, tt = JS.TrainConfig(), TS.TrainConfig()
    ref = JS.make_pred_masks_fn(jcfg, jt)(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, batch))
    got = TS.make_pred_masks_fn(tcfg, tt)(model, batch)
    assert got.shape == (1, 3, 80, 80)
    assert_close(got, ref, atol=1e-4)
    steps_match_jax(dict(remat=False, instance_matching="hungarian"),
                    steps=1, seed=2, batch_seed=5)


def test_language_only_loss_and_llm_remat_match_jax():
    """seg_weight = 0 (the pretrain / SFT mode: CE only, no decode), whose
    default checkpoints the LLM's layers too: the loss and every trainable
    gradient against ``jax.value_and_grad`` of the JAX ``seg_loss_fn``."""
    jcfg, tcfg, p, model = _models(seed=3)
    kw = dict(seg_weight=0.0, llm_weight=1.0, remat=True)
    jt, tt = JS.TrainConfig(**kw), TS.TrainConfig(**kw)
    batch = _batch(jcfg, np.random.default_rng(6))
    ids = batch["input_ids"]
    batch["labels"] = np.where(ids == jcfg.img_context_token_id, -100,
                               (ids * 7 + 3) % 64).astype(np.int32)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    _, tr, fr = JS.make_trainable_optimizer(
        jax.tree_util.tree_map(jnp.asarray, p), jt)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda t: JS.seg_loss_fn(
        JS.combine_params(t, fr), jcfg, jt, jb), has_aux=True))(tr)
    opt = TS.make_trainable_optimizer(model, tt)
    total, m = TS.seg_loss_fn(model, tcfg, tt, batch)
    total.backward()
    assert set(m) == set(jm) == {"llm_loss", "loss"}
    np.testing.assert_allclose(float(total.detach()), float(jl), rtol=1e-5)
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32),
                                   fr)
    ref = fusion_state_dict_from_jax(JS.combine_params(
        jax.tree_util.tree_map(np.asarray, jg), zeros), tcfg)
    for n, q in zip(opt.names, opt.params):
        g = torch.zeros_like(q) if q.grad is None else q.grad
        assert_close(g, ref[n], atol=1e-3 * float(ref[n].abs().max()) + 1e-7,
                     name=n)
