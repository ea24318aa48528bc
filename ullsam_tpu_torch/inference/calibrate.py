"""Closed-form synthetic-weight calibration for realistic-config AMG
(``ullsam_tpu/inference/calibrate.py``).

Under random weights the production AMG config (pred_iou 0.88, stability
0.95, box NMS 0.7) commits about zero masks: the untrained IoU head passes
nothing and every prompt's mask is an unlocalized noise field whose box
spans the image, so NMS collapses the lot. ``calibrate_amg_weights``
rewrites a random ``Sam`` in closed form (no training) so the real decode
math produces localized, high-stability masks around each prompt:

  * the neck's final LN is zeroed, so the image embedding is 0 and all
    spatial structure comes from the Fourier position kernel;
  * both image -> token cross attentions become position-matched
    injectors (identical heads summing groups of sin dims, a sink channel
    whose q-side bias is probed to ``cut_level`` of the logit peak), each
    writing its saturated field along its own cos-region direction;
  * the hypernetworks read out the intersection of the two fields with a
    threshold carried by a constant channel of the second upscale conv
    (both transposed convs tap-averaged), and the IoU head is rescaled
    from a probe to spread around ``iou_center``.

The random draws are made with ``np.random.RandomState(seed)`` in the JAX
package's order and layout (Linear ``[in, out]``, ConvTranspose ``[kh, kw,
I, O]``) and transposed into the port's, so the same seed gives the same
construction; the probes run through the port's own modules in float32 on
the model's device with TF32 off, and their reductions run in numpy where
the JAX code runs numpy on the host.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch
import torch.nn.functional as F

from ullsam_tpu_torch.core.config import SamConfig

Tensor = torch.Tensor


@contextlib.contextmanager
def _no_tf32():
    """float32 products as float32 (cuBLAS and cuDNN default to TF32 on a
    card for some calls), restored after the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def calibrate_amg_weights(sam, cfg: SamConfig, *, seed: int = 0,
                          kappa: float = 8.0, self_beta: float = 4.0,
                          inject_rho: float = 8.0, steepness: float = 30.0,
                          pe_scale: float = 1.0, cut: float = 0.7,
                          cut_level: float = 0.75, iou_center: float = 0.91,
                          iou_spread: float = 0.025, n_probe: int = 16):
    """A calibrated copy of the port's ``Sam`` on its device and in its
    dtype (computed in float32); ``sam`` itself is left as it was."""
    dtype = next(sam.parameters()).dtype
    sam = copy.deepcopy(sam).float().eval()
    with torch.no_grad(), _no_tf32():
        _calibrate(sam, cfg, seed=seed, kappa=kappa, self_beta=self_beta,
                   inject_rho=inject_rho, steepness=steepness,
                   pe_scale=pe_scale, cut=cut, cut_level=cut_level,
                   iou_center=iou_center, iou_spread=iou_spread,
                   n_probe=n_probe)
    return sam.to(dtype)


def _set(param: Tensor, value) -> None:
    """Copy a numpy array or tensor into a parameter in place."""
    param.copy_(torch.as_tensor(np.asarray(value) if not isinstance(
        value, Tensor) else value).to(param.device, param.dtype))


def _np(t: Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _calibrate(sam, cfg: SamConfig, *, seed, kappa, self_beta, inject_rho,
               steepness, pe_scale, cut, cut_level, iou_center, iou_spread,
               n_probe) -> None:
    rng = np.random.RandomState(seed)
    enc, pe_m, dec = sam.image_encoder, sam.prompt_encoder, sam.mask_decoder
    dev = dec.iou_token.weight.device
    mcfg = cfg.mask_decoder
    d = mcfg.transformer_dim
    internal = d // mcfg.attention_downsample_rate
    nm = mcfg.num_mask_tokens
    heads = mcfg.transformer_num_heads
    hd = internal // heads
    n_feat = d // 2
    emb_h = cfg.prompt_encoder.image_embedding_size[0]
    n_group = hd - 1
    g_size = max((n_feat // 4) // n_group, 1)
    sink_cos = n_feat + 40

    # 0. Fourier features, tuned for the 64x64 grid
    pe_eff = pe_scale * float(np.sqrt(64.0 / emb_h))
    _set(pe_m.pe_layer.positional_encoding_gaussian_matrix,
         rng.randn(2, n_feat).astype(np.float32) * pe_eff)

    # 1. image embedding == 0: the neck's final LN affine zeroed
    enc.neck[3].weight.zero_()
    enc.neck[3].bias.zero_()

    # 2. prompt encoder: the positive label marks channel d-1, pads carry a
    #    cos-region identifier, the no-mask vector keeps the sin region pure
    lab = np.zeros((4, d), np.float32)
    lab[1, d - 1] = 2.0
    for i in range(4):
        _set(pe_m.point_embeddings[i].weight, lab[i:i + 1])
    protected = np.array([sink_cos, d - 1])

    def cos_ident(mag=2.0):
        v = np.zeros((d,), np.float32)
        v[n_feat:] = rng.randn(d - n_feat).astype(np.float32) * mag
        v[protected] = 0.0
        return v

    _set(pe_m.not_a_point_embed.weight, cos_ident()[None])
    nm_vec = _np(pe_m.no_mask_embed.weight[0]) * 0.1
    nm_vec[:n_feat] = 0.0
    _set(pe_m.no_mask_embed.weight, nm_vec[None])

    # 3. TwoWayTransformer rewiring (kernels built in the JAX [in, out]
    #    layout, written transposed into the port's [out, in] weights)
    tw = dec.transformer

    def zero_out(attn):
        attn.out_proj.weight.zero_()
        attn.out_proj.bias.zero_()

    def zero_mlp(layer):
        layer.mlp.lin2.weight.zero_()
        layer.mlp.lin2.bias.zero_()

    def make_injector(attn, perms, r_hat: np.ndarray):
        wq = np.zeros((d, internal), np.float32)
        wk = np.zeros((d, internal), np.float32)
        for h in range(heads):
            perm = perms[0] if h < heads // 2 else perms[1]
            for j in range(n_group):
                for s_dim in perm[j * g_size:(j + 1) * g_size]:
                    wq[s_dim, h * hd + j] = kappa
                    wk[s_dim, h * hd + j] = 1.0
            wk[sink_cos, h * hd + hd - 1] = 1.0
        _set(attn.q_proj.weight, wq.T)
        _set(attn.k_proj.weight, wk.T)
        wv = np.zeros((d, internal), np.float32)
        wv[d - 1, :] = 1.0
        _set(attn.v_proj.weight, wv.T)
        wo = np.tile((inject_rho / internal) * r_hat[None, :], (internal, 1))
        _set(attn.out_proj.weight, wo.T)
        for lin in (attn.q_proj, attn.k_proj, attn.v_proj, attn.out_proj):
            lin.bias.zero_()

    def set_sink_bias(attn, B: float):
        b = np.zeros((internal,), np.float32)
        for h in range(heads):
            b[h * hd + hd - 1] = B
        _set(attn.q_proj.bias, b)

    cos_span = np.arange(n_feat, d - 1)
    cos_span = cos_span[cos_span != sink_cos]
    basis = rng.randn(len(cos_span), 2).astype(np.float32)
    q_mat, _ = np.linalg.qr(basis)
    r1 = np.zeros((d,), np.float32)
    r2 = np.zeros((d,), np.float32)
    r1[cos_span] = q_mat[:, 0]
    r2[cos_span] = q_mat[:, 1]

    l1, l2 = tw.layers[0], tw.layers[1]
    eye_d = torch.eye(d, dtype=torch.float32, device=dev)
    sa = l1.self_attn
    _set(sa.q_proj.weight, self_beta * eye_d)
    _set(sa.k_proj.weight, self_beta * eye_d)
    _set(sa.v_proj.weight, eye_d)
    _set(sa.out_proj.weight, eye_d)
    for lin in (sa.q_proj, sa.k_proj, sa.v_proj, sa.out_proj):
        lin.bias.zero_()
    zero_out(l1.cross_attn_token_to_image)
    zero_mlp(l1)
    perm = rng.permutation(n_feat)
    quarter = n_feat // 4
    qs = [perm[i * quarter:(i + 1) * quarter][:n_group * g_size]
          for i in range(4)]
    make_injector(l1.cross_attn_image_to_token, (qs[0], qs[1]), r1)

    zero_out(l2.self_attn)
    zero_out(l2.cross_attn_token_to_image)
    zero_mlp(l2)
    make_injector(l2.cross_attn_image_to_token, (qs[2], qs[3]), r2)
    # the final token -> image attention keeps its random weights

    ident = np.stack([cos_ident() for _ in range(nm)])
    ident[0, sink_cos] = 3.0
    _set(dec.mask_tokens.weight, ident)
    _set(dec.iou_token.weight, cos_ident()[None])

    # 4. upscale convs: both tap-averaged, channel C8-1 of the second
    #    constant (the JAX [kh, kw, I, O] layout is [I, O, kh, kw] here)
    up1, up2 = dec.output_upscaling[0], dec.output_upscaling[3]
    k1 = _np(up1.weight)
    k1[:] = k1.mean(axis=(2, 3), keepdims=True)
    _set(up1.weight, k1)
    c8 = up2.weight.shape[1]
    k2 = _np(up2.weight)
    k2[:] = k2.mean(axis=(2, 3), keepdims=True)
    k2[:, c8 - 1] = 0.0
    _set(up2.weight, k2)
    b2 = _np(up2.bias)
    b2[c8 - 1] = 1.0
    _set(up2.bias, b2)

    # --- probes ----------------------------------------------------------
    h, w = cfg.prompt_encoder.image_embedding_size
    emb = torch.zeros((1, h, w, d), dtype=torch.float32, device=dev)
    g = int(np.ceil(np.sqrt(n_probe)))
    # an even grid over the interior: the sin features vanish at the
    # image center, and border prompts have the weakest kernels
    pts = (np.stack(np.meshgrid(np.linspace(0.15, 0.85, g),
                                np.linspace(0.15, 0.85, g)), -1)
           .reshape(-1, 2)[:n_probe] * cfg.vit.img_size)
    pts_t = torch.tensor(pts[:, None, :], dtype=torch.float32, device=dev)
    P = pts_t.shape[0]
    labels = torch.ones((P, 1), dtype=torch.int64, device=dev)

    sparse, dense = pe_m(points=(pts_t, labels))
    image_pe = pe_m.get_dense_pe()
    pe_flat = image_pe.reshape(1, h * w, d)
    out_tok = torch.cat([dec.iou_token.weight, dec.mask_tokens.weight], 0)
    tokens = torch.cat([out_tok[None].expand(P, 1 + nm, d), sparse], dim=1)
    src = emb + dense[:1]
    src_flat = src.reshape(1, h * w, d)
    pt_idx = 1 + nm

    def tok_chain(layer, t):
        return layer.norm3(layer.norm2(layer.norm1(t)))

    def i2t_point_peak(attn, keys_base, toks):
        """(the weaker head group's point-token peak logit, minimum over
        the probe prompts, x 0.95; the sink logit per unit q-bias)."""
        q = _np(attn.q_proj(keys_base + pe_flat))
        k = _np(attn.k_proj(toks + tokens))
        qh = q.reshape(-1, h * w, heads, hd)[0]
        kh = k.reshape(P, -1, heads, hd)
        lg = np.einsum("xhd,phd->pxh", qh, kh[:, pt_idx]) * (hd ** -0.5)
        ga = lg[:, :, :heads // 2].mean(axis=2).max(axis=1)
        gb = lg[:, :, heads // 2:].mean(axis=2).max(axis=1)
        peak = float(np.minimum(ga, gb).min() * 0.95)
        sink_gain = float(np.median(kh[:, 1, :, hd - 1])) * (hd ** -0.5)
        return peak, sink_gain

    t_sa = l1.self_attn(tokens, tokens, tokens)
    t1 = tok_chain(l1, t_sa)
    peak1, gain1 = i2t_point_peak(l1.cross_attn_image_to_token, src_flat, t1)
    set_sink_bias(l1.cross_attn_image_to_token,
                  cut_level * peak1 / max(gain1, 1e-6))

    # layer 1's keys update with the sink in place, to probe injector 2
    # against its actual queries
    upd = l1.cross_attn_image_to_token(src_flat + pe_flat, t1 + tokens, t1)
    keys_l1 = l1.norm4(src_flat + upd)
    t2 = tok_chain(l2, t1)
    peak2, gain2 = i2t_point_peak(l2.cross_attn_image_to_token, keys_l1, t2)
    set_sink_bias(l2.cross_attn_image_to_token,
                  cut_level * peak2 / max(gain2, 1e-6))

    # four-state intersection read-out: the injected amplitudes at the
    # prompt cell, pushed through the exact upscale math
    cx = np.clip((pts[:, 0] / cfg.vit.img_size * w).astype(int), 0, w - 1)
    cy = np.clip((pts[:, 1] / cfg.vit.img_size * h).astype(int), 0, h - 1)
    n_at = cy * w + cx
    lam1 = float(np.median(_np(upd)[np.arange(P), n_at] @ r1))
    upd2 = l2.cross_attn_image_to_token(keys_l1 + pe_flat, t2 + tokens, t2)
    lam2 = float(np.median(_np(upd2)[np.arange(P), n_at] @ r2))

    c_vec = torch.tensor(nm_vec, device=dev)[None, None, :]
    r1_t, r2_t = torch.tensor(r1, device=dev), torch.tensor(r2, device=dev)

    def key_state(on1, on2):
        k = c_vec + float(on1) * lam1 * r1_t
        k = l1.norm4(k)
        k = k + float(on2) * lam2 * r2_t
        return l2.norm4(k)

    eye1 = torch.eye(c8, dtype=torch.float32, device=dev)[None]

    def u_of(kst):
        # one key cell: the 4x4 upscale of it, sub-pixel 0 (the taps are
        # averaged, so all 16 are equal)
        u = dec.upscale_hypernet(kst, eye1, 1, 1)
        return _np(u)[0, :, 0, 0]

    U00, U10 = u_of(key_state(False, False)), u_of(key_state(True, False))
    U01, U11 = u_of(key_state(False, True)), u_of(key_state(True, True))

    alpha = U11 - 0.5 * (U10 + U01)
    alpha[c8 - 1] = 0.0
    alpha /= np.linalg.norm(alpha) + 1e-9
    f11 = float(U11 @ alpha)
    f_single = max(float(U10 @ alpha), float(U01 @ alpha),
                   float(U00 @ alpha))
    margin = f11 - f_single

    g1 = float(F.gelu(torch.tensor(1.0, dtype=torch.float32)))  # exact erf
    for m in range(nm):
        rho = f_single + margin * (cut - 0.06 * m)
        s_m = steepness / (abs(margin) + 1e-9)
        last = dec.output_hypernetworks_mlps[m].layers[-1]
        last.weight.zero_()
        b = alpha * s_m
        b[c8 - 1] = -(s_m * rho) / g1
        _set(last.bias, b)

    # the IoU head's last layer, rescaled from the token-side outputs
    hs, _ = dec.transformer(src, image_pe, tokens)
    iou = _np(dec.iou_prediction_head(hs[:, 0, :]))
    head = dec.iou_prediction_head.layers[-1]
    k_old = _np(head.weight).T                       # JAX [in, out]
    b_old = _np(head.bias)
    med = np.median(iou, axis=0)
    spread = np.std(iou, axis=0) + 1e-6
    scale = iou_spread / spread
    _set(head.weight, (k_old * scale[None, :]).T)
    _set(head.bias, iou_center - scale * (med - b_old))
