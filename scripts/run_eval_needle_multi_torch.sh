#! /bin/bash
# Multi-needle eval on one GPU or a mesh of them (the PyTorch port's CLI,
# lwm_tpu_torch/apps/eval_needle_multi.py): the bundle of
# scripts/run_eval_needle_multi.sh with its flags (7b, fp32, theta 1e7,
# max_sequence_length 131072, scan chunks 1024, 4 needles, 4 asked, 3
# context lengths up to 32000 x 10 depths x 2 rounds), on one device (its 4-way
# mesh with NPROC=4, below), and a batch budget for one 80 GB card: see
# scripts/run_eval_needle_torch.sh. TOKENIZER, CHECKPOINT and HAYSTACK as
# there: local files, nothing is downloaded.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${TOKENIZER:-}" ] || [ -z "${CHECKPOINT:-}" ] || [ -z "${HAYSTACK:-}" ]; then
    echo "run_eval_needle_multi_torch.sh: set TOKENIZER (a local tokenizer directory), CHECKPOINT (a local params stream) and HAYSTACK (a local JSONL)" >&2
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

"${LAUNCH[@]}" lwm_tpu_torch.apps.eval_needle_multi \
    --mesh_dim="$MESH_DIM" \
    --dtype='fp32' \
    --load_llama_config='7b' \
    --update_llama_config="dict(theta=10000000,max_sequence_length=131072,scan_attention=True,scan_query_chunk_size=1024,scan_key_chunk_size=1024,scan_mlp=True,scan_mlp_chunk_size=1024,scan_layers=True)" \
    --tokenizer="${TOKENIZER}" \
    --load_checkpoint="params::${CHECKPOINT}" \
    --haystack_file="${HAYSTACK}" \
    --max_tokens_per_batch="${MAX_TOKENS_PER_BATCH:-40000}" \
    --output_file="${OUTPUT_FILE:-needle_multi_results.json}" \
    --n_needles_total=4 --n_needles_retrieve=4 \
    --n_context_length_intervals=3 --n_document_depth_intervals=10 --n_rounds=2
