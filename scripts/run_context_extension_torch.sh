#!/bin/bash
# Staged context extension on one GPU (the PyTorch port):
# scripts/run_context_extension.sh with its flags, every step on the port's
# modules. Train a base model at 2K context, then extend 2K -> 8K -> 32K,
# each stage warm-started from the previous stage's params with a longer
# max_sequence_length and a larger RoPE theta, and prove retrieval with
# eval_needle at 32K context on fresh haystacks. The data generators
# (lwm_tpu_torch.apps.create_*_data) run on the host; the trainers
# (lwm_tpu_torch.train) and the eval on the card, at fp32. The tokenizer
# is the repository's BPE fixture tests/fixtures/tokenizer_bpe.
#
# Data (into $WORK):
#   copy.jsonl (512), copy_mix.jsonl + needle_short/long (1024/2048),
#   needle_8k.jsonl (8192), needle_32k.jsonl (32768), haystack.jsonl
#
# Usage: bash scripts/run_context_extension_torch.sh [WORKDIR]
#        DATA_ONLY=1 bash scripts/run_context_extension_torch.sh [WORKDIR]
set -eu

WORK=${1:-/tmp/ext}
REPO=$(cd "$(dirname "$0")/.." && pwd)
TOK="$REPO/tests/fixtures/tokenizer_bpe"
BASE_CFG="vocab_size=2048,hidden_size=768,intermediate_size=2048,num_hidden_layers=6,num_attention_heads=6,scan_attention=True,scan_mlp=False,scan_layers=True,param_scan_axis=0,remat_block='nothing_saveable'"

cd "$REPO"
mkdir -p "$WORK"

gen () {  # gen OUTPUT ARGS...  (idempotent)
  local OUT=$1; shift
  [ -f "$WORK/$OUT" ] && return 0
  python -m lwm_tpu_torch.apps."$@"
}

echo "== 0/5: synthetic data (skips files that already exist) =="
gen copy.jsonl create_copy_pretrain_data \
  --tokenizer "$TOK" --seq_length 512 --n_train 8000 \
  --output "$WORK/copy.jsonl"
gen copy_mix.jsonl create_copy_pretrain_data \
  --tokenizer "$TOK" --seq_length 1024 --n_train 12000 \
  --output "$WORK/copy_mix.jsonl" --seed 3
gen needle_short.jsonl create_needle_train_data \
  --tokenizer "$TOK" --seq_length 1024 --n_train 24000 \
  --filler_mode pool --n_distractors 2 --qa_all_needles \
  --min_context_tokens 32 --max_context_tokens 450 \
  --train_output "$WORK/needle_short.jsonl"
gen needle_long.jsonl create_needle_train_data \
  --tokenizer "$TOK" --seq_length 2048 --n_train 8000 \
  --filler_mode pool --n_distractors 2 --qa_all_needles \
  --min_context_tokens 256 --seed 2 \
  --train_output "$WORK/needle_long.jsonl" \
  --haystack_output "$WORK/haystack.jsonl" --haystack_sentences 80000
gen needle_8k.jsonl create_needle_train_data \
  --tokenizer "$TOK" --seq_length 8192 --n_train 3400 \
  --filler_mode pool --n_distractors 2 --qa_all_needles \
  --min_context_tokens 1024 --seed 4 \
  --train_output "$WORK/needle_8k.jsonl"
gen needle_32k.jsonl create_needle_train_data \
  --tokenizer "$TOK" --seq_length 32768 --n_train 620 \
  --filler_mode pool --n_distractors 2 --qa_all_needles \
  --min_context_tokens 4096 --seed 5 \
  --train_output "$WORK/needle_32k.jsonl"

if [ ! -f "$WORK/train_mixed.jsonl" ]; then
  python - "$WORK" <<'EOF'
# 2048-token-aligned groups: [copy|needle_short pairs] + [needle_long]
import random, sys
w = sys.argv[1]
rng = random.Random(99)
copy_ = open(f"{w}/copy_mix.jsonl").read().strip().splitlines()
a = open(f"{w}/needle_short.jsonl").read().strip().splitlines()
b = open(f"{w}/needle_long.jsonl").read().strip().splitlines()
rng.shuffle(copy_); rng.shuffle(a); rng.shuffle(b)
groups = []
for i in range(min(len(copy_), len(a))):
    pair = [copy_[i], a[i]]
    rng.shuffle(pair)
    groups.append(pair)
a = a[len(copy_):]
groups += [[a[i], a[i + 1]] for i in range(0, len(a) - 1, 2)]
groups += [[x] for x in b]
rng.shuffle(groups)
with open(f"{w}/train_mixed.jsonl", "w") as f:
    for g in groups:
        f.write("\n".join(g) + "\n")
EOF
fi

# DATA_ONLY=1: stop after data generation (the data build needs no card)
[ "${DATA_ONLY:-0}" = "1" ] && { echo "data ready in $WORK"; exit 0; }

train () {  # train NAME SEQ THETA STEPS BATCH DATA WARM CHUNK LR
  local NAME=$1 SEQ=$2 THETA=$3 STEPS=$4 BATCH=$5 DATA=$6 WARM=$7 CHUNK=$8 LR=$9
  local WARM_FLAG=""
  [ -n "$WARM" ] && WARM_FLAG="--load_checkpoint=params::$WARM"
  python -m lwm_tpu_torch.train \
    --mesh_dim='1,1,1,1' --dtype=fp32 --total_steps=$STEPS --log_freq=100 \
    --save_model_freq=$STEPS $WARM_FLAG \
    --update_llama_config="dict($BASE_CFG,max_sequence_length=$SEQ,theta=$THETA,scan_query_chunk_size=$CHUNK,scan_key_chunk_size=$CHUNK)" \
    --tokenizer="$TOK" \
    --train_dataset.type=json \
    --train_dataset.text_processor.fields='[question],answer,[postpad]' \
    --train_dataset.text_processor.subfield_separator='' \
    --train_dataset.json_dataset.path="$DATA" \
    --train_dataset.json_dataset.seq_length=$SEQ \
    --train_dataset.json_dataset.batch_size=$BATCH \
    --optimizer.adamw_optimizer.lr=$LR --optimizer.adamw_optimizer.end_lr=1e-4 \
    --optimizer.adamw_optimizer.lr_warmup_steps=100 \
    --optimizer.adamw_optimizer.lr_decay_steps=$STEPS \
    --logger.output_dir="$WORK/run_$NAME" --logger.experiment_id="$NAME"
  ls "$WORK/run_$NAME/$NAME"*/streaming_params_* 2>/dev/null | tail -1 \
    || ls "$WORK/run_$NAME/$NAME"*/streaming_params | tail -1
}

echo "== stage 0: copy pretask (induction warm start, 512 ctx) =="
CKPT0=$(train copy 512 10000 1500 64 "$WORK/copy.jsonl" "" 256 1e-3 | tail -1)
echo "stage-0 ckpt: $CKPT0"

echo "== stage 1: base retrieval model, 2048 ctx, theta 1e4 =="
CKPT1=$(train base2k 2048 10000 4000 16 "$WORK/train_mixed.jsonl" "$CKPT0" 256 1e-3 | tail -1)
echo "stage-1 ckpt: $CKPT1"

echo "== stage 2: extend to 8192 ctx, theta 2e5 =="
CKPT2=$(train ext8k 8192 200000 800 4 "$WORK/needle_8k.jsonl" "$CKPT1" 1024 4e-4 | tail -1)
echo "stage-2 ckpt: $CKPT2"

echo "== stage 3: extend to 32768 ctx, theta 2e6 =="
CKPT3=$(train ext32k 32768 2000000 500 1 "$WORK/needle_32k.jsonl" "$CKPT2" 1024 3e-4 | tail -1)
echo "stage-3 ckpt: $CKPT3"

echo "== eval: fresh-needle retrieval at up to 32K context =="
python -m lwm_tpu_torch.apps.eval_needle \
  --haystack_file="$WORK/haystack.jsonl" \
  --output_file="$WORK/results_32k.json" \
  --context_lengths_min=4096 --context_lengths_max=30000 \
  --n_context_length_intervals=3 --n_document_depth_intervals=3 \
  --n_rounds=2 \
  --load_checkpoint="params::$CKPT3" \
  --unscan_for_serving=True \
  --update_llama_config="dict($BASE_CFG,max_sequence_length=32768,theta=2000000,scan_query_chunk_size=1024,scan_key_chunk_size=1024)" \
  --tokenizer="$TOK" \
  --mesh_dim='1,1,1,1' --dtype=fp32 \
  --max_tokens_per_batch=65536
python -m lwm_tpu_torch.apps.summarize_needle "$WORK/results_32k.json" || true
echo "done: $WORK/results_32k.json"
