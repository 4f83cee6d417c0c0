#!/bin/bash
# End-to-end vision-generation validation on one GPU (the PyTorch port):
# scripts/run_vision_validation.sh with its flags, every step on the port's
# modules:
#   synthetic text -> frame-token data (on the host) -> dual-head
#   VideoLLaMA training (sample_mode='all', fp32) -> params stream -> the
#   CFG generation probe (sample_mode='vision', top-k 1) -> token accuracy.
# A learnable mapping (12 fixed 256-code patterns keyed by a text prompt)
# exercises the VisionTextProcessor framing (<vision>, EOF 8192), the dual
# loss, and generate_vision's cond/uncond CFG loop with an EOF forced every
# 257 tokens. The trainer and the probe run on the card (the JAX bundle runs
# its probe with --platform cpu; the port's runs on the default device).
#
# Usage: bash scripts/run_vision_validation_torch.sh [WORKDIR]
set -eu

WORK=${1:-/tmp/vision_validation}
REPO=$(cd "$(dirname "$0")/.." && pwd)
TOK="$REPO/tests/fixtures/tokenizer"
BASE_CFG="vocab_size=512,vision_vocab_size=8448,hidden_size=384,intermediate_size=1024,num_hidden_layers=4,num_attention_heads=6,max_sequence_length=512,scan_attention=False,scan_mlp=False,scan_layers=True,param_scan_axis=0,remat_block='nothing_saveable'"
MODEL_CFG="dict($BASE_CFG)"
TRAIN_CFG="dict($BASE_CFG,sample_mode='all')"

mkdir -p "$WORK"
cd "$REPO"

echo "== 1/3: synthetic pattern data =="
python -m lwm_tpu_torch.apps.create_vision_train_data \
  --n_train 4000 --n_patterns 12 --output "$WORK/train.jsonl"

echo "== 2/3: dual-head training (sample_mode='all') =="
python -m lwm_tpu_torch.train \
  --modality='vision,text' \
  --mesh_dim='1,1,1,1' --dtype=fp32 --total_steps=3000 --log_freq=200 \
  --save_model_freq=3000 \
  --update_llama_config="$TRAIN_CFG" \
  --tokenizer="$TOK" \
  --train_dataset.type=json_vision \
  --train_dataset.vision_text_processor.fields_from_example='fields' \
  --train_dataset.json_vision_dataset.path="$WORK/train.jsonl" \
  --train_dataset.json_vision_dataset.seq_length=384 \
  --train_dataset.json_vision_dataset.batch_size=32 \
  --train_dataset.json_vision_dataset.mode=pad \
  --optimizer.adamw_optimizer.lr=1e-3 --optimizer.adamw_optimizer.end_lr=1e-4 \
  --optimizer.adamw_optimizer.lr_warmup_steps=100 \
  --optimizer.adamw_optimizer.lr_decay_steps=3000 \
  --logger.output_dir="$WORK/run" --logger.experiment_id=patterns

CKPT=$(ls "$WORK"/run/patterns*/streaming_params_* 2>/dev/null | tail -1)
[ -n "$CKPT" ] || CKPT=$(ls "$WORK"/run/patterns*/streaming_params | tail -1)

echo "== 3/3: CFG-generation probe (sample_mode='vision', top_k=1) =="
python -m lwm_tpu_torch.apps.probe_vision_patterns \
  --checkpoint "$CKPT" \
  --tokenizer "$TOK" \
  --update_llama_config "$MODEL_CFG"
