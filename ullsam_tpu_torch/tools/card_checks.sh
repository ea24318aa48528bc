#!/usr/bin/env bash
# The port's checks on the card in one command: the gpu-marked tests,
# chip_smoke.py, and the ViT-H regions of tools/profile_kernels.py (one warm
# ViT-H AMG image and its encode under each route setting: device-busy
# share and top device operations). Run from the root of a checkout on a
# machine with one H100:
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
grep -E 'FAIL|\[vit_h\]|\[build\] (ln_mlp|window_attn|vit_flash_attn)|hd-80' \
    "$out/smoke_${tag}.log" | cut -c1-700
tail -2 "$out/smoke_${tag}.log" | cut -c1-300
[ $rc -eq 0 ] || exit $rc

step profile timeout 600 python -m ullsam_tpu_torch.tools.profile_kernels \
    --only vit_h || { tail -40 "$out/profile_${tag}.log"; exit 1; }
grep -E -A12 '^== vit_h_amg' "$out/profile_${tag}.log"
grep -E '^== ' "$out/profile_${tag}.log"
