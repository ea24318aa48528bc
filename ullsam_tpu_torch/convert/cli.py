"""Checkpoint conversion CLI (``ullsam_tpu/convert/cli.py``): reference
files -> a ``.pt`` of the port's state dict, which ``load_state_dict`` (or
``convert.from_jax.load_reference_state_dict``) takes as it is.

  python -m ullsam_tpu_torch.convert.cli --kind sam --variant vit_b \\
      --input sam_vit_b.pth --output sam_vit_b.pt
  python -m ullsam_tpu_torch.convert.cli --kind fusion --input ullsam.pt \\
      --output ullsam_port.pt
  python -m ullsam_tpu_torch.convert.cli --kind internlm2 --input hf_model_dir \\
      --output internlm2.pt --prefix language_model.

sam -> ``models.sam.sam.Sam``'s names; internlm2 (a directory of HF
safetensors shards, merged, or a ``.pt``) -> ``InternLM2ForCausalLM``'s;
fusion -> ``ULLSAM``'s. ``--prefix`` is stripped first.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="reference -> ullsam_tpu_torch "
                                            "checkpoint converter")
    p.add_argument("--kind", choices=["sam", "internlm2", "fusion"],
                   required=True)
    p.add_argument("--input", required=True,
                   help=".pth/.pt file or HF safetensors dir")
    p.add_argument("--output", required=True, help=".pt output path")
    p.add_argument("--variant", default="vit_b",
                   help="the JAX CLI's SAM variant flag; the port's "
                        "conversion renames keys only, so shapes are "
                        "checked when the output is loaded")
    p.add_argument("--prefix", default="",
                   help="key prefix in the source state dict")
    args = p.parse_args(argv)

    import os

    import torch

    from ullsam_tpu_torch.convert import reference as R

    if args.kind == "sam":
        sd = R.load_torch_state_dict(args.input)
        sd = R.convert_sam_state_dict(
            {k[len(args.prefix):]: v for k, v in sd.items()
             if k.startswith(args.prefix)})
    elif args.kind == "internlm2":
        if os.path.isdir(args.input):
            sd = R.load_internlm2_safetensors(args.input, prefix=args.prefix)
        else:
            sd = R.convert_internlm2_state_dict(
                R.load_torch_state_dict(args.input), prefix=args.prefix)
    else:
        sd = R.convert_fusion_state_dict(
            R.load_torch_state_dict(args.input), prefix=args.prefix)
    sd = {k: v.contiguous() for k, v in sd.items()}
    torch.save(sd, args.output)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {args.output}: {n / 1e6:.1f}M params")
    return sd


if __name__ == "__main__":
    main()
