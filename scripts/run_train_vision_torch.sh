#! /bin/bash
# Vision-text (VideoLLaMA) training on one GPU or a mesh of them (the PyTorch
# port's trainer, lwm_tpu_torch/train.py): the bundle of
# scripts/run_train_vision_text.sh with the same flags, without the TPU's
# LIBTPU_INIT_ARGS. TOKENIZER must be a local directory (tokenizer.json and
# tokenizer_config.json, as save_pretrained writes them; a hub name is refused:
# nothing is downloaded), DATASET a local JSONL file of pre-tokenized VQ codes
# and text with a "fields" field spec (data/vision.py), OUTPUT_DIR where the
# run's metrics.jsonl and checkpoints go. Arguments are passed on as more flags
# and override these (a later flag wins), e.g.
# `scripts/run_train_vision_torch.sh --freeze_base=True --optimizer.type=palm`
# or `scripts/run_train_vision_torch.sh --device=cpu --total_steps=2` on a
# machine without a GPU.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${TOKENIZER:-}" ] || [ -z "${DATASET:-}" ] || [ -z "${OUTPUT_DIR:-}" ]; then
    echo "run_train_vision_torch.sh: set TOKENIZER (a local tokenizer directory), DATASET (a local JSONL file) and OUTPUT_DIR" >&2
    exit 2
fi

# batch_size: one device's batch, 1 row of 32768 tokens (run_train_vision_text.sh's
# 16 rows are the batch of a whole TPU mesh); on a mesh the global batch, its
# rows split over dp x fsdp (a multiple of dp x fsdp).
# NPROC > 1 runs it on a mesh of that many cards, a process a card under
# torchrun (rendezvous on this host, NCCL), with MESH_DIM in the JAX grammar
# (dp,fsdp,tp,sp; default !1,-1,2,2 as run_train_vision_text.sh: tp 2 x sp 2, fsdp
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
    --modality='vision,text' \
    --mesh_dim="$MESH_DIM" \
    --dtype='bf16' \
    --total_steps=200 \
    --log_freq=1 \
    --save_milestone_freq=10 \
    --load_llama_config='debug' \
    --update_llama_config="dict(theta=50000000,max_sequence_length=32768,scan_attention=True,scan_query_chunk_size=512,scan_key_chunk_size=512,scan_mlp=True,scan_mlp_chunk_size=1024,scan_layers=True)" \
    --tokenizer="${TOKENIZER}" \
    --optimizer.type='adamw' \
    --optimizer.adamw_optimizer.lr=8e-5 \
    --optimizer.adamw_optimizer.end_lr=8e-5 \
    --optimizer.adamw_optimizer.lr_warmup_steps=5 \
    --optimizer.adamw_optimizer.lr_decay_steps=200 \
    --train_dataset.type='json_vision' \
    --train_dataset.vision_text_processor.fields_from_example='fields' \
    --train_dataset.json_vision_dataset.path="${DATASET}" \
    --train_dataset.json_vision_dataset.seq_length=32768 \
    --train_dataset.json_vision_dataset.batch_size=1 \
    --train_dataset.json_vision_dataset.mode='no_pad' \
    --checkpointer.save_optimizer_state=True \
    --logger.output_dir="${OUTPUT_DIR}" \
    "$@"
