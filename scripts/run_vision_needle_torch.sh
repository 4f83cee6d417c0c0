#!/bin/bash
# Vision-needle retrieval at long context on one GPU (the PyTorch port):
# scripts/run_vision_needle.sh with its stages, flags and configs, every
# step on the port's modules. A VideoLLaMA (hidden 384, 4 layers, 6 heads of
# 64) learns to name the one pattern frame among noise frames, through
# staged context extension, then is scored on fresh contexts over a grid of
# frame count x depth up to 128 frames (32,896 vision tokens).
#
#   data:     the vision-needle generator on the host
#   stage A:  1-8 frames   (seq 2560,  theta 1e4, fp32, batch 16)
#   stage B:  8-32 frames  (seq 8448,  theta 2e5, bf16, batch 4)
#   stage C: 96-128 frames (seq 33024, theta 2e6, bf16, batch 1)
#   stage D: 24-128 frames mixed (seq 33024, bf16, batch 2)
#   stage E: more mixed steps on fresh data (seq 33024, bf16, batch 2)
#   eval:     frames {32, 64, 128} x depths {0,25,50,75,100} x 2 rounds,
#             greedy at fp32 (K1's fp32 route in each prefill, K4's fp32
#             instance in each step), then the summary grid
#
# The trainers (lwm_tpu_torch.train, each stage warm-started from the last
# one's params:: stream) and the eval run on the card, the port's default
# device; the tokenizer is the repository's tests/fixtures/tokenizer.
#
# Usage: bash scripts/run_vision_needle_torch.sh [WORKDIR]
set -eu

WORK=${1:-/tmp/vneedle}
REPO=$(cd "$(dirname "$0")/.." && pwd)
TOK="$REPO/tests/fixtures/tokenizer"
BASE_CFG="vocab_size=512,vision_vocab_size=8448,hidden_size=384,intermediate_size=1024,num_hidden_layers=4,num_attention_heads=6,scan_attention=True,scan_query_chunk_size=256,scan_key_chunk_size=256,scan_mlp=False,scan_layers=True,param_scan_axis=0,remat_block='nothing_saveable',sample_mode='all'"

cd "$REPO"
mkdir -p "$WORK"

gen () {  # gen OUTPUT ARGS...  (idempotent)
  local OUT=$1; shift
  [ -f "$WORK/$OUT" ] && return 0
  python -m lwm_tpu_torch.apps.create_vision_needle_data --output "$WORK/$OUT" "$@"
}

echo "== 0/4: data =="
gen train_short.jsonl --n_train 24000 --min_frames 1 --max_frames 8 --seed 11
gen train_mid.jsonl --n_train 4000 --min_frames 8 --max_frames 32 --seed 12
gen train_long.jsonl --n_train 1200 --min_frames 96 --max_frames 128 --seed 13

stage () {  # stage NAME DATA SEQ THETA STEPS BATCH LR DTYPE [WARM_CKPT]
  local NAME=$1 DATA=$2 SEQ=$3 THETA=$4 STEPS=$5 BATCH=$6 LR=$7 DTYPE=$8
  local WARM=${9:-}
  if [ -e "$WORK/run_$NAME/done" ]; then return 0; fi
  local LOAD=()
  [ -n "$WARM" ] && LOAD=(--load_checkpoint="params::$WARM")
  python -m lwm_tpu_torch.train \
    --modality='vision,text' \
    --mesh_dim='1,1,1,1' --dtype=$DTYPE --total_steps=$STEPS \
    --log_freq=100 --save_model_freq=$STEPS \
    "${LOAD[@]}" \
    --update_llama_config="dict($BASE_CFG,max_sequence_length=$SEQ,theta=$THETA)" \
    --tokenizer="$TOK" \
    --train_dataset.type=json_vision \
    --train_dataset.vision_text_processor.fields_from_example='fields' \
    --train_dataset.json_vision_dataset.path="$WORK/$DATA" \
    --train_dataset.json_vision_dataset.seq_length=$SEQ \
    --train_dataset.json_vision_dataset.batch_size=$BATCH \
    --train_dataset.json_vision_dataset.mode=pad \
    --optimizer.adamw_optimizer.lr=$LR \
    --optimizer.adamw_optimizer.end_lr=1e-4 \
    --optimizer.adamw_optimizer.lr_warmup_steps=100 \
    --optimizer.adamw_optimizer.lr_decay_steps=$STEPS \
    --logger.output_dir="$WORK/run_$NAME" --logger.experiment_id=v
  touch "$WORK/run_$NAME/done"
}

ckpt () { ls "$WORK"/run_$1/v*/streaming_params* | tail -1; }

mix () {  # mix OUT IN1 IN2  (shuffled concat, idempotent)
  [ -f "$WORK/$1" ] && return 0
  python - "$WORK" "$1" "$2" "$3" <<'EOF'
import random, sys
w, out, a, b = sys.argv[1:5]
rng = random.Random(8)
rows = open(f"{w}/{a}").read().strip().splitlines()
rows += open(f"{w}/{b}").read().strip().splitlines()
rng.shuffle(rows)
open(f"{w}/{out}", "w").write("\n".join(rows) + "\n")
EOF
}

echo "== 1/6: stage A (1-8 frames, learn the task) =="
stage A train_short.jsonl 2560 10000 3000 16 1e-3 fp32
echo "== 2/6: stage B (8-32 frames) =="
stage B train_mid.jsonl 8448 200000 800 4 5e-4 bf16 "$(ckpt A)"
echo "== 3/6: stage C (96-128 frames, 32K+ vision tokens) =="
stage C train_long.jsonl 33024 2000000 400 1 3e-4 bf16 "$(ckpt B)"
echo "== 4/6: stage D (24-128 mixed, volume) =="
gen train_mix_long.jsonl --n_train 2500 --min_frames 24 --max_frames 128 --seed 14
mix train_stageD.jsonl train_mix_long.jsonl train_long.jsonl
stage D train_stageD.jsonl 33024 2000000 1800 2 3e-4 bf16 "$(ckpt C)"
echo "== 5/6: stage E (3000 more mixed steps, fresh data) =="
gen train_mix2.jsonl --n_train 4000 --min_frames 24 --max_frames 128 --seed 15
mix train_stageE.jsonl train_mix2.jsonl train_stageD.jsonl
stage E train_stageE.jsonl 33024 2000000 3000 2 3e-4 bf16 "$(ckpt D)"

echo "== 6/6: eval grid =="
python -m lwm_tpu_torch.apps.eval_vision_needle \
  --checkpoint "$(ckpt E)" \
  --tokenizer "$TOK" \
  --update_llama_config "dict($BASE_CFG,max_sequence_length=33040,theta=2000000)" \
  --n_frames 32,64,128 --depths 0,25,50,75,100 --rounds 2 \
  --output "$WORK/results.json"
python -m lwm_tpu_torch.apps.summarize_vision_needle "$WORK/results.json"
echo "results in $WORK/results.json"
