#!/bin/bash
# End-to-end needle-retrieval validation on one GPU (the PyTorch port):
# scripts/run_needle_validation.sh with its flags, every step on the port's
# modules (lwm_tpu_torch.apps.*, lwm_tpu_torch.train):
#   synthetic data (on the host) -> copy pretask -> warm-started retrieval
#   training -> streamed checkpoint -> scan->unscan conversion ->
#   eval_needle greedy decode -> accuracy.
# The trainers and the eval run on the card (the port's default device);
# the tokenizer is the repository's tests/fixtures/tokenizer, so nothing
# is downloaded. The recipe, and why each step is there, is the JAX
# bundle's (see its header).
#
# Usage: bash scripts/run_needle_validation_torch.sh [WORKDIR]
set -eu

WORK=${1:-/tmp/needle_validation}
REPO=$(cd "$(dirname "$0")/.." && pwd)
TOK="$REPO/tests/fixtures/tokenizer"
MODEL_CFG="dict(vocab_size=512,hidden_size=768,intermediate_size=2048,num_hidden_layers=6,num_attention_heads=6,max_sequence_length=4096,scan_attention=True,scan_query_chunk_size=256,scan_key_chunk_size=256,scan_mlp=False,scan_layers=True,param_scan_axis=0,remat_block='nothing_saveable')"

mkdir -p "$WORK"
cd "$REPO"

echo "== 1/5: synthetic data (copy pretask + needle QA + eval haystack) =="
python -m lwm_tpu_torch.apps.create_copy_pretrain_data \
  --tokenizer "$TOK" --seq_length 512 --n_train 8000 \
  --output "$WORK/copy.jsonl"
python -m lwm_tpu_torch.apps.create_needle_train_data \
  --tokenizer "$TOK" --seq_length 1024 --n_train 24000 \
  --filler_mode pool --n_distractors 2 --qa_all_needles \
  --min_context_tokens 32 --max_context_tokens 450 \
  --train_output "$WORK/needle_short.jsonl"
python -m lwm_tpu_torch.apps.create_needle_train_data \
  --tokenizer "$TOK" --seq_length 2048 --n_train 8000 \
  --filler_mode pool --n_distractors 2 --qa_all_needles \
  --min_context_tokens 256 --seed 2 \
  --train_output "$WORK/needle_long.jsonl" \
  --haystack_output "$WORK/haystack.jsonl"
python -m lwm_tpu_torch.apps.create_copy_pretrain_data \
  --tokenizer "$TOK" --seq_length 1024 --n_train 12000 \
  --output "$WORK/copy_mix.jsonl" --seed 3
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

echo "== 2/5: copy pretask (induction-circuit warm start) =="
python -m lwm_tpu_torch.train \
  --mesh_dim='1,1,1,1' --dtype=fp32 --total_steps=1500 --log_freq=200 \
  --save_model_freq=1500 \
  --update_llama_config="$MODEL_CFG" \
  --tokenizer="$TOK" \
  --train_dataset.type=json \
  --train_dataset.text_processor.fields='[question],answer,[postpad]' \
  --train_dataset.text_processor.subfield_separator='' \
  --train_dataset.json_dataset.path="$WORK/copy.jsonl" \
  --train_dataset.json_dataset.seq_length=512 \
  --train_dataset.json_dataset.batch_size=64 \
  --optimizer.adamw_optimizer.lr=1e-3 --optimizer.adamw_optimizer.end_lr=3e-4 \
  --optimizer.adamw_optimizer.lr_warmup_steps=100 \
  --optimizer.adamw_optimizer.lr_decay_steps=1500 \
  --logger.output_dir="$WORK/run_copy" --logger.experiment_id=copy

COPY_CKPT=$(ls "$WORK"/run_copy/copy*/streaming_params_* 2>/dev/null | tail -1)
[ -n "$COPY_CKPT" ] || COPY_CKPT=$(ls "$WORK"/run_copy/copy*/streaming_params | tail -1)

echo "== 3/5: warm-started retrieval training (answer-masked CE) =="
python -m lwm_tpu_torch.train \
  --mesh_dim='1,1,1,1' --dtype=fp32 --total_steps=7500 --log_freq=250 \
  --save_model_freq=7500 \
  --load_checkpoint="params::$COPY_CKPT" \
  --update_llama_config="$MODEL_CFG" \
  --tokenizer="$TOK" \
  --train_dataset.type=json \
  --train_dataset.text_processor.fields='[question],answer,[postpad]' \
  --train_dataset.text_processor.subfield_separator='' \
  --train_dataset.json_dataset.path="$WORK/train_mixed.jsonl" \
  --train_dataset.json_dataset.seq_length=2048 \
  --train_dataset.json_dataset.batch_size=16 \
  --optimizer.adamw_optimizer.lr=1e-3 --optimizer.adamw_optimizer.end_lr=1e-4 \
  --optimizer.adamw_optimizer.lr_warmup_steps=200 \
  --optimizer.adamw_optimizer.lr_decay_steps=7500 \
  --logger.output_dir="$WORK/run" --logger.experiment_id=needle

CKPT=$(ls "$WORK"/run/needle*/streaming_params_* 2>/dev/null | tail -1)
[ -n "$CKPT" ] || CKPT=$(ls "$WORK"/run/needle*/streaming_params | tail -1)

echo "== 4/5: scan->unscan conversion of the trained checkpoint =="
python -m lwm_tpu_torch.apps.convert_checkpoint \
  --direction=unscan --llama_config='debug' \
  --update_llama_config="$MODEL_CFG" \
  --scan_layers=True --param_scan_axis=0 \
  --streaming_path="$CKPT" \
  --output="$WORK/params_unscanned"

echo "== 5/5: needle eval (fresh haystacks + numbers, greedy decode;"
echo "        unscan_for_serving exercises the scan->unscan serving path) =="
python -m lwm_tpu_torch.apps.eval_needle \
  --haystack_file="$WORK/haystack.jsonl" \
  --output_file="$WORK/results.json" \
  --context_lengths_min=400 --context_lengths_max=1500 \
  --n_context_length_intervals=3 --n_document_depth_intervals=3 \
  --n_rounds=2 \
  --mesh_dim='1,1,1,1' --dtype=fp32 \
  --update_llama_config="$MODEL_CFG" \
  --tokenizer="$TOK" \
  --unscan_for_serving=True \
  --load_checkpoint="params::$CKPT"

python - "$WORK/results.json" <<'EOF'
import json, sys
rs = json.load(open(sys.argv[1]))
n = sum(r["correct"] for r in rs)
print(f"needle accuracy: {n}/{len(rs)} = {n/len(rs):.1%}")
EOF
