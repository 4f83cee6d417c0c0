#! /bin/bash
# Needle-in-a-haystack eval on one GPU or a mesh of them (the PyTorch port's CLI,
# lwm_tpu_torch/apps/eval_needle.py): the bundle of scripts/run_eval_needle.sh
# with its flags (7b, fp32, theta 1e7, max_sequence_length 131072, scan
# chunks 1024, contexts 1000-32000 x 3 depths x 2 rounds), on one device
# (its 4-way mesh with NPROC=4, below). MAX_TOKENS_PER_BATCH sizes the batches for one
# 80 GB card: 40000 gives 13 prompts at context 1000, 2 at 16500 and 1 at
# 32000 (the fp32 KV cache costs 1 MiB a token; the weights 25.1 GiB), at
# a measured peak of 68.7, 70.4 and 67.1 GiB of allocated device memory
# (scripts/measure_needle_batch.py on an NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 5).
# TOKENIZER must be a local directory (tokenizer.json and
# tokenizer_config.json, as save_pretrained writes them), CHECKPOINT a local
# streamed checkpoint and HAYSTACK a local JSONL with a "text" field a line:
# nothing is downloaded.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${TOKENIZER:-}" ] || [ -z "${CHECKPOINT:-}" ] || [ -z "${HAYSTACK:-}" ]; then
    echo "run_eval_needle_torch.sh: set TOKENIZER (a local tokenizer directory), CHECKPOINT (a local params stream) and HAYSTACK (a local JSONL)" >&2
    exit 2
fi

# NPROC > 1 runs it on a mesh of that many cards, a process a card under
# torchrun (rendezvous on this host), with MESH_DIM in the JAX grammar
# (dp,fsdp,tp,sp; default !1,-1,NPROC,1: tp over the cards, as the reference
# bundle's !1,-1,4,1 at NPROC=4). The default, NPROC=1, runs on one card.
NPROC="${NPROC:-1}"
if [ "$NPROC" -gt 1 ]; then
    LAUNCH=(torchrun --standalone --nproc_per_node="$NPROC" -m)
    MESH_DIM="${MESH_DIM:-!1,-1,$NPROC,1}"
else
    LAUNCH=(python3 -u -m)
    MESH_DIM="${MESH_DIM:-1,-1,1,1}"
fi

"${LAUNCH[@]}" lwm_tpu_torch.apps.eval_needle \
    --mesh_dim="$MESH_DIM" \
    --dtype='fp32' \
    --load_llama_config='7b' \
    --update_llama_config="dict(theta=10000000,max_sequence_length=131072,scan_attention=True,scan_query_chunk_size=1024,scan_key_chunk_size=1024,scan_mlp=True,scan_mlp_chunk_size=1024,scan_layers=True)" \
    --tokenizer="${TOKENIZER}" \
    --load_checkpoint="params::${CHECKPOINT}" \
    --haystack_file="${HAYSTACK}" \
    --max_tokens_per_batch="${MAX_TOKENS_PER_BATCH:-40000}" \
    --output_file="${OUTPUT_FILE:-needle_results.json}" \
    --context_lengths_min=1000 \
    --context_lengths_max=32000 \
    --n_context_length_intervals=3 \
    --n_document_depth_intervals=3 \
    --n_rounds=2
