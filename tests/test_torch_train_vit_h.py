"""The segmentation train step at SAM ViT-H's head dim (80) against
``ullsam_tpu.train``: three f32 steps of a tiny uLLSAM whose encoder has 2
heads of 80 (a padded 16x16 grid in 5x5 windows, one windowed and one
global block), with and without remat, from carried weights. On the CPU
the port's windowed blocks run B1's plain version (B3 / B8's in its
backward) and the global block B2 / B9's at head dim 80, where B9 scores
as the TPU kernels do (from unscaled q; B2's pre-scaled q differs there,
the scale D^-1/2 not being a power of two).

Held as ``tests/test_torch_train.py`` holds ViT-B's tiny model: losses and
metrics rtol 1e-5, step-1 gradients leaf by leaf within 1e-3 of the leaf's
max|grad| plus 1e-7, updated weights 2e-5 absolute, frozen weights
unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _batch
from torch_port_helpers import (assert_close, jax_init, jax_params_to_numpy,
                                tiny_fusion_config)

from ullsam_tpu.core import config as JC
from ullsam_tpu.models.ullsam import fusion as JF
from ullsam_tpu.train import step as JS
from ullsam_tpu_torch.convert.from_jax import fusion_state_dict_from_jax
from ullsam_tpu_torch.core import config as TC
from ullsam_tpu_torch.models.ullsam import fusion as TF
from ullsam_tpu_torch.ops.kernels import flash_attention as TFA
from ullsam_tpu_torch.train import step as TS


def _hd80_config(C):
    """``tiny_fusion_config`` with an encoder of 2 heads of 80: C = 160,
    depth 2 (block 0 windowed, block 1 global)."""
    cfg = tiny_fusion_config(C)
    vit = C.ViTConfig(img_size=64, patch_size=4, embed_dim=160, depth=2,
                      num_heads=2, mlp_ratio=2.0, out_chans=16, window_size=5,
                      global_attn_indexes=(1,))
    return C.FusionConfig(sam=C.SamConfig(
        vit=vit, prompt_encoder=cfg.sam.prompt_encoder,
        mask_decoder=cfg.sam.mask_decoder), llm=cfg.llm,
        vit_feature_dim=cfg.vit_feature_dim,
        img_context_token_id=cfg.img_context_token_id)


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_three_train_steps_at_head_dim_80_match_jax(remat):
    """Three f32 steps of the port vs ``make_train_step(donate=False)`` from
    the same weights and batch, the LLM's hidden states as the dense
    prompt: loss and metrics each step, the step-1 gradients leaf by leaf,
    the updated weights, frozen weights unchanged."""
    jcfg, tcfg = _hd80_config(JC), _hd80_config(TC)
    assert tcfg.sam.vit.head_dim == 80
    p = jax_params_to_numpy(jax_init(JF.fusion_init, 0, jcfg),
                            np.random.default_rng(0))
    model = TF.ULLSAM(tcfg, device="cpu")
    model.load_state_dict(fusion_state_dict_from_jax(p, tcfg))
    kw = dict(learning_rate=1e-3, total_steps=100, remat=remat)
    jt, tt = JS.TrainConfig(**kw), TS.TrainConfig(**kw)
    batch = _batch(jcfg, np.random.default_rng(1))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tx, tr, fr = JS.make_trainable_optimizer(
        jax.tree_util.tree_map(jnp.asarray, p), jt)
    state = tx.init(tr)
    jgrad = jax.jit(jax.grad(lambda t: JS.seg_loss_fn(
        JS.combine_params(t, fr), jcfg, jt, jb)[0]))(tr)
    step = JS.make_train_step(jcfg, jt, tx, donate=False)
    jm = []
    for _ in range(3):
        tr, state, m = step(tr, fr, state, jb)
        jm.append(m)

    before = {n: t.clone() for n, t in model.state_dict().items()}
    opt = TS.make_trainable_optimizer(model, tt)
    tstep = TS.make_train_step(tcfg, tt, model, opt)
    launches = TFA.vit_flash_attn_bwd.launches
    for i in range(3):
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
    # the CPU runs the plain versions: nothing is launched
    assert TFA.vit_flash_attn_bwd.launches == launches

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
    assert any(not torch.equal(model.state_dict()[n], before[n])
               for n in trainable)
