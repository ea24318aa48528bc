"""The Hungarian-matched instance loss of the port
(``train/losses.py`` ``hungarian_instance_loss``, ``hungarian_algorithm``)
against ``ullsam_tpu.train.losses`` and optax 0.2.6's
``optax.assignment.hungarian_algorithm``.

Tolerances: the loss and its metrics rtol 1e-5 and the gradient with
respect to the logits within 1e-5 of its largest magnitude (f32, another
summation order in the cost and the BCE / Dice sums); the assignment
bitwise, ties among equal (padding) costs included; three train steps at
``tests/test_torch_train.py``'s tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train import steps_match_jax

from ullsam_tpu.train import losses as JL
from ullsam_tpu_torch.train import losses as TL


def _case(P, G, invalid, seed=0, B=2, H=24):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, P, H, H)) * 2).astype(np.float32)
    gt = (rng.random((B, G, H, H)) > 0.6).astype(np.float32)
    valid = np.ones((B, G), np.float32)
    if invalid == "some":
        valid[0, -1] = valid[1, :G // 2] = 0.0
    elif invalid == "all":
        valid[:] = 0.0
    return logits, gt, valid


@pytest.mark.parametrize("P,G,invalid", [
    (5, 3, "some"), (4, 4, "none"), (6, 3, "none"), (4, 3, "all"),
    (3, 3, "some")])
def test_loss_metrics_and_gradient_match_jax(P, G, invalid):
    logits, gt, valid = _case(P, G, invalid)
    (jl, jm), jg = jax.value_and_grad(
        lambda x: JL.hungarian_instance_loss(x, jnp.asarray(gt),
                                             jnp.asarray(valid)),
        has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    tl, tm = TL.hungarian_instance_loss(x, torch.from_numpy(gt),
                                        torch.from_numpy(valid))
    (tg,) = torch.autograd.grad(tl, x)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("bce", "dice", "iou", "seg_loss"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    scale = float(np.abs(np.asarray(jg)).max()) or 1.0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                               atol=1e-5 * scale)
    if invalid == "all":
        assert float(tl.detach()) == 0.0 and not tg.any()


@pytest.mark.parametrize("P,G", [(4, 4), (6, 4), (4, 6), (5, 1), (8, 8)])
def test_assignment_is_optax_bitwise(P, G):
    """Random costs, with columns of padding (cost exactly 1.0), all-equal
    matrices and few distinct values (many ties)."""
    fn = jax.jit(optax.assignment.hungarian_algorithm)
    rng = np.random.default_rng(P * 10 + G)
    for t in range(12):
        c = rng.random((P, G)).astype(np.float32)
        if t % 3 == 0:
            c[:, rng.random(G) < 0.5] = 1.0
        if t % 4 == 1:
            c = (np.round(c * 3) / 3).astype(np.float32)
        if t == 11:
            c[:] = 1.0
        ri, rj = fn(jnp.asarray(c))
        gi, gj = TL.hungarian_algorithm(c)
        np.testing.assert_array_equal(gi, np.asarray(ri), err_msg=str(c))
        np.testing.assert_array_equal(gj, np.asarray(rj), err_msg=str(c))


def test_three_hungarian_train_steps_match_jax():
    steps_match_jax(dict(remat=False, instance_matching="hungarian"))
