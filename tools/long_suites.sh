#!/usr/bin/env bash
# The small suites of the port at the JAX package's full depths, on one GPU:
# so3_toy for 200,000 steps (the depth of results/so3_toy_r3_train.jsonl)
# then --test with the ancestral, DDIM-50 and probability-flow-50 samplers;
# both lock arms for the default 100,000 steps, then --test; jigsaw for
# 15,000 steps (the depth of the JAX driver's committed
# results/jigsaw_samples.npy; the jigsaw driver's default is 40,000), then --test.
# Each run writes its log, checkpoints and records under OUT (default
# torch_results/long) and prints the card's name and power limit first.
# Rerunning continues each training from its newest checkpoint (--resume),
# so the runs can be split across calls.  A step count of 0 skips a suite.
#
#   bash tools/long_suites.sh [OUT] [TOY_STEPS] [LOCK_STEPS] [JIGSAW_STEPS]
set -euo pipefail
OUT=${1:-torch_results/long}
TOY_STEPS=${2:-200000}
LOCK_STEPS=${3:-100000}
JIGSAW_STEPS=${4:-15000}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'

run() {  # name, then the command; prints its wall milliseconds
  local name=$1; shift
  local t0; t0=$(date +%s%N)
  "$@"
  echo "{\"run\": \"$name\", \"ms\": $(( ($(date +%s%N) - t0) / 1000000 ))}"
}

if [ "$TOY_STEPS" -gt 0 ]; then
  run so3_toy_train python -m diffusion_extensions_tpu_torch.experiments.so3_toy \
    --steps "$TOY_STEPS" --print-every 10000 --ckpt-every 10000 --resume \
    --ckpt "$OUT/so3_toy_ck" --log "$OUT/so3_toy.jsonl"
  for s in ancestral ddim pf; do
    run "so3_toy_test_$s" python -m diffusion_extensions_tpu_torch.experiments.so3_toy \
      --test --sampler "$s" --ckpt "$OUT/so3_toy_ck" --out-dir "$OUT"
  done
fi
if [ "$LOCK_STEPS" -gt 0 ]; then
  for p in so3 euler; do
    run "lock_${p}_train" python -m diffusion_extensions_tpu_torch.experiments.lock \
      --param "$p" --steps "$LOCK_STEPS" --print-every 10000 --ckpt-every 10000 --resume \
      --ckpt "$OUT/lock_${p}_ck" --log "$OUT/lock_$p.jsonl"
    run "lock_${p}_test" python -m diffusion_extensions_tpu_torch.experiments.lock \
      --param "$p" --test --ckpt "$OUT/lock_${p}_ck" --out-dir "$OUT"
  done
fi
if [ "$JIGSAW_STEPS" -gt 0 ]; then
  run jigsaw_train python -m diffusion_extensions_tpu_torch.experiments.jigsaw \
    --steps "$JIGSAW_STEPS" --print-every 500 --ckpt-every 1000 --resume \
    --ckpt "$OUT/jigsaw_ck" --log "$OUT/jigsaw.jsonl"
  run jigsaw_test python -m diffusion_extensions_tpu_torch.experiments.jigsaw \
    --test --ckpt "$OUT/jigsaw_ck" --out-dir "$OUT"
fi
