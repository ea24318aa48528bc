"""SAM model registry (``ullsam_tpu/models/sam/registry.py``; reference:
build_sam.py:47-107).

``build_sam("vit_b" | "vit_l" | "vit_h", checkpoint=None, seed=0)`` ->
``(cfg, Sam)``: random weights drawn from ``torch.Generator(seed)`` on
``device`` (default: the GPU), or a reference-named state dict (a ``.pth``
file, the reference SAM checkpoint's own names, which the port keeps;
``load_sam_state_dict``). On the ``meta`` device the model has shapes and
no values.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ullsam_tpu_torch.core.config import SAM_REGISTRY, SamConfig
from ullsam_tpu_torch.core.device import resolve_device
from ullsam_tpu_torch.models.sam.sam import Sam
from ullsam_tpu_torch.ops import layers as L


def load_sam_state_dict(path: str) -> dict:
    """A SAM ``.pth`` (or the SAM part of a uLLSAM file) under ``Sam``'s
    names, on the host (``convert.reference.convert_sam_state_dict``)."""
    from ullsam_tpu_torch.convert.reference import convert_sam_state_dict

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state.get("model"), dict):
        state = state["model"]
    return convert_sam_state_dict(state)


def build_sam(variant: str = "vit_b", checkpoint: Optional[str] = None,
              seed: int = 0, *, device="cuda",
              dtype: Optional[torch.dtype] = None) -> Tuple[SamConfig, Sam]:
    if variant not in SAM_REGISTRY:
        raise KeyError(f"unknown SAM variant {variant!r}; "
                       f"options: {sorted(SAM_REGISTRY)}")
    cfg = SAM_REGISTRY[variant]()
    device = resolve_device(device)
    model = Sam(cfg, device=device, dtype=dtype)
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        L.init_module_(model, gen)
    if checkpoint is not None:
        from ullsam_tpu_torch.convert.from_jax import \
            load_reference_state_dict
        load_reference_state_dict(model, load_sam_state_dict(checkpoint))
    return cfg, model.eval()
