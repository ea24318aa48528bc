"""Weight-only int8 quantization (W8A16) of InternLM2 for serving
(``ullsam_tpu/models/internlm2/quant.py:19-51``).

Decode streams every weight once a step; per-output-channel symmetric int8
halves that stream. Activations keep their dtype and the scale applies to
the f32 sum (``ops/layers.QuantLinear``, kernel B12 on the card). A
quantized model is inference-only: its int8 linears are buffers, with no
parameters to train.
"""

from __future__ import annotations

import torch

from ullsam_tpu_torch.models.internlm2.model import InternLM2ForCausalLM
from ullsam_tpu_torch.ops import layers as L

QUANT_LAYER_LINEARS = ("attention.wqkv", "attention.wo", "feed_forward.w1",
                       "feed_forward.w3", "feed_forward.w2")


@torch.no_grad()
def quantize_linear(lin: L.Linear) -> L.QuantLinear:
    """A ``Linear`` ([out, in] weight) -> its ``QuantLinear``: in f32,
    scale = max(amax over the input axis, 1e-12) / 127, q = clip(round(w /
    scale), -127, 127) (round half to even, as ``jnp.round``); the bias is
    kept in its dtype."""
    w = lin.weight.float()
    amax = w.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    bias = None if lin.bias is None else lin.bias.detach().clone()
    return L.QuantLinear(q, scale[:, 0].contiguous(), bias)


def quantize_llm_int8(lm: InternLM2ForCausalLM) -> InternLM2ForCausalLM:
    """Swap, in place, each layer's wqkv, wo, w1, w3 and w2 and the output
    head for their ``QuantLinear`` (the decode path's weights, about 97% of
    its bytes); the embedding and the norms keep their dtype. Returns
    ``lm``."""
    for layer in lm.model.layers:
        for path in QUANT_LAYER_LINEARS:
            parent, name = path.split(".")
            owner = getattr(layer, parent)
            setattr(owner, name, quantize_linear(getattr(owner, name)))
    lm.output = quantize_linear(lm.output)
    return lm
