"""InternLM2 sequence classification head
(``ullsam_tpu/models/internlm2/classification.py``).

Behavioral reference: InternLM2ForSequenceClassification
(modeling_internlm2.py:1311-1415): a bias-free linear score head over the
LAST NON-PAD token's hidden state, with the regression / single-label /
multi-label loss chosen by ``problem_type``. Unused by uLLSAM but part of
the reference inventory.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ullsam_tpu_torch.core.config import InternLM2Config
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.models.internlm2.model import (InternLM2ForCausalLM,
                                                     internlm2_forward)
from ullsam_tpu_torch.ops import layers as L

Tensor = torch.Tensor


class ClassificationHead(nn.Module):
    """``score``: Linear(hidden, num_labels, bias=False)."""

    def __init__(self, cfg: InternLM2Config, num_labels: int, *,
                 device="cuda", dtype=None):
        super().__init__()
        self.score = L.Linear(cfg.hidden_size, num_labels, bias=False,
                              device=resolve_device(device), dtype=dtype)


def classification_head_init(cfg: InternLM2Config, num_labels: int, *,
                             seed: int = 0, device="cuda"
                             ) -> ClassificationHead:
    """A head with random weights drawn from ``torch.Generator(seed)``."""
    head = ClassificationHead(cfg, num_labels, device=device)
    gen = torch.Generator(device=head.score.weight.device)
    gen.manual_seed(seed)
    L.init_module_(head, gen)
    return head


def internlm2_classify(lm: InternLM2ForCausalLM, head: ClassificationHead,
                       cfg: InternLM2Config, input_ids: Tensor,
                       attention_mask: Optional[Tensor] = None,
                       labels: Optional[Tensor] = None,
                       problem_type: str = "single_label_classification"
                       ) -> dict:
    """{'logits' [B, num_labels] f32, and 'loss' when labels are given}:
    the score of the hidden state at each row's last valid position (the
    reference's pad-token search, :1371-1381)."""
    B, S = input_ids.shape
    if attention_mask is None:
        attention_mask = (input_ids != cfg.pad_token_id).int()
    out = internlm2_forward(lm, cfg, input_ids=input_ids,
                            attention_mask=attention_mask)
    last = S - 1 - torch.argmax(attention_mask.flip(-1).int(), dim=-1)
    hidden = out["last_hidden"][torch.arange(B, device=last.device), last]
    logits = head.score(hidden).float()

    result = {"logits": logits}
    if labels is not None:
        if problem_type == "regression":
            result["loss"] = ((logits.squeeze(-1) - labels) ** 2).mean()
        elif problem_type == "multi_label_classification":
            z, y = logits, labels.float()
            bce = z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))
            result["loss"] = bce.mean()
        else:
            logp = torch.log_softmax(logits, dim=-1)
            result["loss"] = -logp.gather(-1, labels[:, None].long()).mean()
    return result
