#! /bin/bash
# Text training on one GPU or a mesh of them (the PyTorch port's trainer,
# lwm_tpu_torch/train.py): the bundle of scripts/run_train_text.sh with the
# same flags, without the TPU's LIBTPU_INIT_ARGS. TOKENIZER must be a local
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
# a whole TPU mesh); on a mesh the global batch, its rows split over dp x fsdp.
# NPROC > 1 runs it on a mesh of that many cards, a process a card under
# torchrun (rendezvous on this host, NCCL), with MESH_DIM in the JAX grammar
# (dp,fsdp,tp,sp; default !1,-1,2,2 as run_train_text.sh: tp 2 x sp 2, fsdp
# taking the rest; the weights and optimizer state sharded over fsdp x sp).
# The default, NPROC=1, runs on one card (mesh 1,-1,1,1).
NPROC="${NPROC:-1}"
if [ "$NPROC" -gt 1 ]; then
    LAUNCH=(torchrun --standalone --nproc_per_node="$NPROC" -m)
    MESH_DIM="${MESH_DIM:-!1,-1,2,2}"
else
    LAUNCH=(python3 -u -m)
    MESH_DIM="${MESH_DIM:-1,-1,1,1}"
fi

"${LAUNCH[@]}" lwm_tpu_torch.train \
    --modality='text' \
    --mesh_dim="$MESH_DIM" \
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
