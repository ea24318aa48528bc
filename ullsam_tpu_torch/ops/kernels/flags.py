"""The JAX package's switches between its ViT encoder routes, read here at
call time (the JAX package reads them when it traces), with its defaults
and its tests of the values:

* ``ULLSAM_FUSED_VIT_ATTN`` (default on; "0" turns it off,
  ``ullsam_tpu/ops/pallas/vit_block.py:416``): windowed blocks run B1. Off,
  they run LN1, the pad mask and qkv in PyTorch, the attention core through
  B3 (or B15), and proj.
* ``ULLSAM_FUSED_VIT_MLP`` (default off; any value but "0" turns it on,
  ``vit_block.py:139``): every block's LN2 + MLP half runs B13.
* ``ULLSAM_PACKED_GLOBAL`` (default off; "1" turns it on,
  ``ullsam_tpu/models/sam/image_encoder.py:243``): global blocks run B14
  straight from the qkv projection.
* ``ULLSAM_WINDOW_TWOPHASE`` (default off; "1" turns it on,
  ``ullsam_tpu/ops/pallas/flash_attention.py:1162``): wherever B3 runs, B15
  runs in its place.

A route that a switch selects takes its kernel on a CUDA tensor and the
kernel's plain version on a CPU tensor, as the default route does.
"""

from __future__ import annotations

import os


def fused_vit_attn() -> bool:
    return os.environ.get("ULLSAM_FUSED_VIT_ATTN", "1") != "0"


def fused_vit_mlp() -> bool:
    return os.environ.get("ULLSAM_FUSED_VIT_MLP", "0") != "0"


def packed_global() -> bool:
    return os.environ.get("ULLSAM_PACKED_GLOBAL", "0") == "1"


def window_twophase() -> bool:
    return os.environ.get("ULLSAM_WINDOW_TWOPHASE", "0") == "1"
