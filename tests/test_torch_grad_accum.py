"""Gradient accumulation of the port (``train/step.py`` ``MultiSteps``,
``make_trainable_optimizer(grad_accum=)``) against ``optax.MultiSteps``
and the JAX train step.

Tolerances: in f32 the parameters, the accumulator and the norm within
rtol 1e-5 (the same arithmetic; optax evaluates the schedule in f32); in
bf16 within one bf16 unit in the last place of the value (rtol 2**-7) plus
two of an update of the size of the learning rate (atol lr * 2**-6): the
port rounds to bf16 after each tensor op of AdamW while XLA on the CPU may
keep f32 between the ops it fuses, so an update near a rounding boundary
lands a unit apart; the micro-step and the inner count exactly. The train steps at
``tests/test_torch_train.py``'s tolerances.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import steps_match_jax
from torch_port_helpers import to_np

from ullsam_tpu.train import step as JS
from ullsam_tpu_torch.convert.from_jax import jax_param_paths
from ullsam_tpu_torch.models.ullsam import fusion as TF
from ullsam_tpu_torch.train import step as TS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_multisteps_matches_optax(k, dtype):
    """6 micro-steps of MultiSteps(clip + AdamW with a decay mask) vs
    optax.MultiSteps(chain(clip_by_global_norm, adamw), k), the clip
    triggering on some of them; parameters, accumulator, micro-step and
    inner count after each."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    tcfg = TS.TrainConfig(learning_rate=3e-3, total_steps=40,
                          warmup_ratio=0.1, max_grad_norm=1.0)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, 4, 40, 0.0)
    rng = np.random.default_rng(4)
    model = torch.nn.Module()       # names as ULLSAM's: fusion.mlp1.*
    model.fusion = torch.nn.Module()
    model.fusion.mlp1 = TF.ProjMLP(5, 6, 4, 1e-5, device="cpu", dtype=tdt)
    with torch.no_grad():
        for q in model.parameters():
            q.copy_(torch.from_numpy(rng.standard_normal(
                tuple(q.shape)).astype(np.float32)))
    inner = TS.AdamW(model, tcfg)
    opt = TS.MultiSteps(inner, k)
    jp = {n: jnp.asarray(to_np(p)).astype(jdt)
          for n, p in zip(opt.names, opt.params)}
    decay = {n: not JS._match_any(path, tcfg.no_decay_patterns)
             for n, path in jax_param_paths(model).items()}
    tx = optax.MultiSteps(optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(sched, weight_decay=tcfg.weight_decay,
                    mask={n: decay[n] for n in jp})), every_k_schedule=k)
    state = tx.init(jp)
    tol = (dict(rtol=1e-5, atol=1e-7) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=tcfg.learning_rate * 2 ** -6))
    for step, scale in enumerate((0.1, 3.0, 0.05, 5.0, 0.2, 2.0)):
        g = {n: jnp.asarray((rng.standard_normal(tuple(p.shape)) * scale
                             ).astype(np.float32)).astype(jdt)
             for n, p in zip(opt.names, opt.params)}
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.tensor(np.asarray(g[n].astype(jnp.float32))).to(tdt)
              for n in opt.names]
        norm = opt.step(tg)
        np.testing.assert_allclose(float(norm), float(np.sqrt(sum(
            float(np.sum(to_np(t).astype(np.float64) ** 2)) for t in tg))),
            rtol=1e-6)
        assert opt.mini_step == int(state.mini_step)
        assert inner.count == int(state.inner_opt_state[1][0].count)
        for n, p, a in zip(opt.names, opt.params, opt.acc):
            assert p.dtype == a.dtype == tdt
            np.testing.assert_allclose(
                to_np(p), np.asarray(jp[n].astype(jnp.float32)), **tol,
                err_msg=f"micro-step {step} {n}")
            np.testing.assert_allclose(
                to_np(a), np.asarray(state.acc_grads[n].astype(jnp.float32)),
                **tol, err_msg=f"micro-step {step} acc {n}")


def test_make_trainable_optimizer_wraps_only_above_one():
    model = torch.nn.Module()
    model.fusion = torch.nn.Module()
    model.fusion.mlp1 = TF.ProjMLP(5, 6, 4, 1e-5, device="cpu")
    tcfg = TS.TrainConfig(trainable_patterns=(r"mlp1\..*",))
    assert isinstance(TS.make_trainable_optimizer(model, tcfg), TS.AdamW)
    opt = TS.make_trainable_optimizer(model, tcfg, grad_accum=4)
    assert isinstance(opt, TS.MultiSteps) and opt.every_k == 4


def test_four_micro_steps_at_grad_accum_2_match_jax():
    """The train step under MultiSteps(2) vs the JAX step under
    optax.MultiSteps(2): each micro-step's loss and own grad norm, the
    gradients of micro-step 1, the weights after two updates."""
    steps_match_jax(dict(remat=False), steps=4, grad_accum=2)
