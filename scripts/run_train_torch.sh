#! /bin/bash
# Text training on one GPU (the PyTorch port's trainer, lwm_tpu_torch/train.py):
# the bundle of scripts/run_train_text.sh with the same flags, on a mesh of one
# device and without the TPU's LIBTPU_INIT_ARGS. TOKENIZER must be a local
# directory (tokenizer.json and tokenizer_config.json, as save_pretrained
# writes them; a hub name is refused: nothing is downloaded), DATASET a local
# JSONL file with a "text" field, OUTPUT_DIR where the run's metrics.jsonl and
# checkpoints go. Arguments are passed on as more flags and override these
# (a later flag wins), e.g. `scripts/run_train_torch.sh --autoresume=True` or
# `scripts/run_train_torch.sh --device=cpu --total_steps=2` on a machine
# without a GPU.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${TOKENIZER:-}" ] || [ -z "${DATASET:-}" ] || [ -z "${OUTPUT_DIR:-}" ]; then
    echo "run_train_torch.sh: set TOKENIZER (a local tokenizer directory), DATASET (a local JSONL file) and OUTPUT_DIR" >&2
    exit 2
fi

# batch_size: one device's rows (run_train_text.sh's 1024 rows are the batch of
# a whole TPU mesh).
python3 -u -m lwm_tpu_torch.train \
    --modality='text' \
    --mesh_dim='1,-1,1,1' \
    --dtype='bf16' \
    --total_steps=200 \
    --log_freq=1 \
    --save_model_freq=0 \
    --save_milestone_freq=10 \
    --load_llama_config='debug' \
    --update_llama_config="dict(theta=10000,max_sequence_length=2048,scan_attention=True,scan_query_chunk_size=256,scan_key_chunk_size=512,scan_mlp=True,scan_mlp_chunk_size=1024,scan_layers=True)" \
    --tokenizer="${TOKENIZER}" \
    --optimizer.type='adamw' \
    --optimizer.accumulate_gradient_steps=1 \
    --optimizer.adamw_optimizer.weight_decay=0.1 \
    --optimizer.adamw_optimizer.lr=8e-5 \
    --optimizer.adamw_optimizer.end_lr=8e-5 \
    --optimizer.adamw_optimizer.lr_warmup_steps=5 \
    --optimizer.adamw_optimizer.lr_decay_steps=200 \
    --use_data_sharded_loader=True \
    --train_dataset.type='json' \
    --train_dataset.text_processor.fields='text' \
    --train_dataset.json_dataset.path="${DATASET}" \
    --train_dataset.json_dataset.seq_length=2048 \
    --train_dataset.json_dataset.batch_size=8 \
    --train_dataset.json_dataset.tokenizer_processes=16 \
    --checkpointer.save_optimizer_state=True \
    --autoresume=False \
    --logger.append_uuid=False \
    --logger.online=False \
    --logger.experiment_id='example-text-train' \
    --logger.output_dir="${OUTPUT_DIR}" \
    "$@"
