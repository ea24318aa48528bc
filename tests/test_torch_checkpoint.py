"""The port's checkpoints (``train/checkpoint.py``): a save / restore round
trip, keeping the newest ``max_to_keep`` steps, a true resume between the
micro-steps of one accumulation (bitwise equal to never stopping), and the
flat ``.npz`` interchange with ``ullsam_tpu.train.checkpoint`` in both
directions (bitwise)."""

import os

import jax
import numpy as np
import torch

from test_torch_train import _batch, _models
from torch_port_helpers import jax_init, jax_params_to_numpy, \
    tiny_fusion_config

from ullsam_tpu.core import config as JC
from ullsam_tpu.core.tree import flatten_with_paths
from ullsam_tpu.models.ullsam import fusion as JF
from ullsam_tpu.train import checkpoint as JK
from ullsam_tpu_torch.convert.from_jax import fusion_state_dict_from_jax
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.ullsam import fusion as TF
from ullsam_tpu_torch.train import checkpoint as TK
from ullsam_tpu_torch.train import step as TS


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a == b


def test_round_trip_and_max_to_keep(tmp_path):
    params = {"a": torch.arange(4.0), "b": torch.ones(2, 3)}
    opt_state = {"mu": {"a": torch.zeros(4)}, "count": 3, "mini_step": 1,
                 "acc": {"a": torch.full((4,), 0.5, dtype=torch.bfloat16)}}
    mgr = TK.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mgr.latest_step() is None
    for step in (1, 2, 3, 4, 5):
        params["a"] += 1
        assert mgr.save(step, params, opt_state,
                        extra={"step": step, "epoch": step // 2})
    # not past the newest step: not saved again (orbax's policy)
    assert not mgr.save(5, params, opt_state, extra={"epoch": 99}, wait=True)
    mgr.close()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "4", "5"]

    again = TK.CheckpointManager(str(tmp_path / "ckpt"))
    assert again.latest_step() == 5
    p, o, extra = again.restore()
    _equal_trees(p, params)
    _equal_trees(o, opt_state)
    assert extra == {"step": 5, "epoch": 2}
    p3, _, extra3 = again.restore(step=3)
    assert torch.equal(p3["a"], torch.arange(4.0) + 3)
    assert extra3["epoch"] == 1


def _run(model, opt, cfg, tcfg, batches):
    step = TS.make_train_step(cfg, tcfg, model, opt)
    return [float(step(b)["loss"]) for b in batches]


def test_resume_between_micro_steps_is_bitwise(tmp_path):
    """5 micro-steps at grad_accum 2 straight through, against 3, a save,
    a fresh model and optimizer restored from it, then 2 more."""
    jcfg, tcfg, p, model = _models(seed=1)
    tc = TS.TrainConfig(total_steps=10, warmup_ratio=0.2, remat=False)
    batches = [_batch(jcfg, np.random.default_rng(10 + i), B=1)
               for i in range(5)]
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = TS.make_trainable_optimizer(model, tc, grad_accum=2)
    straight = _run(model, opt, tcfg, tc, batches)

    model2 = TF.ULLSAM(tcfg, device="cpu")
    model2.load_state_dict(init)
    opt2 = TS.make_trainable_optimizer(model2, tc, grad_accum=2)
    first = _run(model2, opt2, tcfg, tc, batches[:3])
    assert opt2.mini_step == 1 and opt2.inner.count == 1
    mgr = TK.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, dict(zip(opt2.names, opt2.params)), opt2.state_dict(),
             extra={"step": 3})
    mgr.close()

    model3 = TF.ULLSAM(tcfg, device="cpu")
    model3.load_state_dict(init)
    opt3 = TS.make_trainable_optimizer(model3, tc, grad_accum=2)
    params, opt_state, extra = TK.CheckpointManager(
        str(tmp_path / "ckpt")).restore()
    with torch.no_grad():
        for n, q in zip(opt3.names, opt3.params):
            q.copy_(params[n])
    opt3.load_state_dict(opt_state)
    assert extra == {"step": 3} and opt3.mini_step == 1
    rest = _run(model3, opt3, tcfg, tc, batches[3:])

    assert first + rest == straight
    for (n, a), b in zip(model.state_dict().items(),
                         model3.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(opt.acc + opt.inner.mu + opt.inner.nu,
                    opt3.acc + opt3.inner.mu + opt3.inner.nu):
        assert torch.equal(a, b)


def test_npz_interchange_with_jax(tmp_path):
    """A port .npz loads in JAX's load_params_npz onto the fusion template,
    a JAX .npz in the port's load_params_npz; both bitwise."""
    jcfg, tcfg = tiny_fusion_config(JC), tiny_fusion_config(TC)
    p = jax_params_to_numpy(jax_init(JF.fusion_init, 4, jcfg),
                            np.random.default_rng(4))
    model = TF.ULLSAM(tcfg, device="cpu")
    model.load_state_dict(fusion_state_dict_from_jax(p, tcfg))

    TK.save_params_npz(str(tmp_path / "port.npz"), model)
    template = jax.tree_util.tree_map(np.zeros_like, p)
    back = JK.load_params_npz(str(tmp_path / "port.npz"), template)
    ref, got = flatten_with_paths(p), flatten_with_paths(back)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=k)

    p2 = jax_params_to_numpy(jax_init(JF.fusion_init, 5, jcfg),
                             np.random.default_rng(5))
    JK.save_params_npz(str(tmp_path / "jax.npz"), p2)
    TK.load_params_npz(str(tmp_path / "jax.npz"), model)
    want = fusion_state_dict_from_jax(p2, tcfg)
    for n, t in model.state_dict().items():
        assert torch.equal(t, want[n]), n
