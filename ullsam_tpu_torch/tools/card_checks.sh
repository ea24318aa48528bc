#!/usr/bin/env bash
# The port's checks on the card in one command: the gpu-marked tests,
# chip_smoke.py (with the ptxas report of the bf16 window core, the wgmma
# GEMM and the mask decoder's fused kernels, and the GEMM's HGMMA / UTMALDG
# count from cuobjdump; the B2 / B12 kernel lines, the caption's int8 /
# bf16 prefill, B4-B7 and their fused kernels, the AMG sweeps), the ViT
# regions of tools/profile_kernels.py (one warm ViT-H AMG image and its
# encode under each route setting, the ViT-H segmentation train step, a
# ViT-B encode), its ViT-B AMG image and B4 regions, and its segmentation
# train step region and the packed sft step region: device-busy share,
# peak memory and top device operations. Run from the root of a checkout on
# a machine with one H100:
#
#     bash ullsam_tpu_torch/tools/card_checks.sh LOG_DIR [TAG]
#
# Each step writes its whole output to LOG_DIR/<step>_<TAG>.log (TAG
# defaults to "run"); stdout gets the card's nvidia-smi line, each step's
# exit code and seconds, and the lines of the logs that the port's records
# quote. Stops at the first step that fails, with its exit code.
set -u
out=$1
tag=${2:-run}
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

step() {
    local name=$1
    shift
    local t0
    t0=$(date +%s)
    "$@" > "$out/${name}_${tag}.log" 2>&1
    local rc=$?
    echo "$name rc=$rc s=$(( $(date +%s) - t0 ))"
    return $rc
}

step gpu_tests timeout 600 python -m pytest --noconftest -p no:cacheprovider \
    -q tests/test_torch_gpu.py || { tail -40 "$out/gpu_tests_${tag}.log"; exit 1; }
tail -1 "$out/gpu_tests_${tag}.log"

step smoke timeout 1200 python3 chip_smoke.py
rc=$?
grep -E 'FAIL|\[vit_h\]|\[gemm\]|hd-80|\[amg\]|\[train_vit_h\]|heads of 80' "$out/smoke_${tag}.log" | cut -c1-700
grep -E '\[kernels\] llm_flash|\[packed\]' "$out/smoke_${tag}.log" | cut -c1-500
grep -E '\[kernels\] (decode_masks|two_way_transformer|upscale_hypernet|fused)' \
    "$out/smoke_${tag}.log" | cut -c1-400
grep -E '\[kernels\] (vit_flash_attn|window_attn_core_bwd|w8a16_matmul bfloat16 M=(1152|9216))|\[caption\] (prefill|int8 batch 1|bf16 request|int8 request 1)' \
    "$out/smoke_${tag}.log" | cut -c1-400
# ptxas (-Xptxas -v) of the one bf16 window core at SAM's 14x14 windows
# (NT = 14) and of the wgmma GEMM, from the build's own report
grep -E '\[build\] .*(window_core_bf16<(64|80), 1[46]>|gemm_nt_sm90|vit_flash_sm90|vit_bwd_|bwd_f32|image_stage|upscale_unit|t2i_part|llm_flash_sm90|llm_bwd_sm90)' \
    "$out/smoke_${tag}.log"
tail -2 "$out/smoke_${tag}.log" | cut -c1-300
[ $rc -eq 0 ] || exit $rc

# the wgmma GEMM's SASS: its warpgroup products (HGMMA) and TMA loads
# (UTMALDG), in the one library whose only such kernel it is
objdump=$(command -v cuobjdump || echo "${CUDA_HOME:-/usr/local/cuda}/bin/cuobjdump")
lib=$(python -c 'from ullsam_tpu_torch.ops.kernels import build; print(build.lib_path("ln_mlp"))')
if [ -x "$objdump" ] && [ -f "$lib" ]; then
    "$objdump" -sass "$lib" > "$out/sass_ln_mlp_${tag}.txt" 2>&1
    echo "ln_mlp SASS: HGMMA $(grep -c HGMMA "$out/sass_ln_mlp_${tag}.txt")" \
        "UTMALDG $(grep -c UTMALDG "$out/sass_ln_mlp_${tag}.txt")"
else
    echo "cuobjdump or $lib not found: no SASS counts"
fi

step profile timeout 600 python -m ullsam_tpu_torch.tools.profile_kernels \
    --only vit_ || { tail -40 "$out/profile_${tag}.log"; exit 1; }
grep -E -A26 '^== vit_h_amg' "$out/profile_${tag}.log"
grep -E -A8 '^== vit_b_encode' "$out/profile_${tag}.log"
grep -E -A31 '^== vit_h_train_step' "$out/profile_${tag}.log"
grep -E '^== ' "$out/profile_${tag}.log"

step profile_amg timeout 600 python -m ullsam_tpu_torch.tools.profile_kernels \
    --only amg_image,decode_masks || { tail -40 "$out/profile_amg_${tag}.log"; exit 1; }
grep -E -A14 '^== (amg_image|decode_masks)' "$out/profile_amg_${tag}.log"

step profile_train timeout 600 python -m ullsam_tpu_torch.tools.profile_kernels \
    --only train_step || { tail -40 "$out/profile_train_${tag}.log"; exit 1; }
grep -E -A20 '^== train_step' "$out/profile_train_${tag}.log"

step profile_sft timeout 600 python -m ullsam_tpu_torch.tools.profile_kernels \
    --only packed_sft_step || { tail -40 "$out/profile_sft_${tag}.log"; exit 1; }
grep -E -A20 '^== packed_sft_step' "$out/profile_sft_${tag}.log"
