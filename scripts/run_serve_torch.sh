#! /bin/bash
# In-flight batching serving on the GPU (the PyTorch port's CLI,
# lwm_tpu_torch/apps/serve.py): the bundle of scripts/run_serve.sh with the
# same knobs. Requests from a JSONL file (or stdin when INPUT_FILE is empty)
# through a slot pool. QUANTIZE=1 turns on int8 weight-only quantization at
# load. TOKENIZER must be a local directory (tokenizer.json and
# tokenizer_config.json, as save_pretrained writes them) and CHECKPOINT a
# local streamed checkpoint: nothing is downloaded.
# PREFIX_FILE: a document every request is about, prefilled once (prompts are
# suffix-only); PREFIX_CACHE: where its KV index is saved, or loaded from when
# it exists; LOOKUP_K > 0: prompt-lookup verify; ADMIT_CHUNK > 0: chunked
# admission.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${TOKENIZER:-}" ] || [ -z "${CHECKPOINT:-}" ]; then
    echo "run_serve_torch.sh: set TOKENIZER (a local tokenizer directory) and CHECKPOINT (a local params stream)" >&2
    exit 2
fi

python3 -u -m lwm_tpu_torch.apps.serve \
    --input_file="${INPUT_FILE:-}" \
    --output_file="${OUTPUT_FILE:-completions.jsonl}" \
    --slots="${SLOTS:-8}" \
    --cache_len="${CACHE_LEN:-4096}" \
    --prompt_buckets="${PROMPT_BUCKETS:-256,1024,2048}" \
    --max_new_tokens="${MAX_NEW_TOKENS:-256}" \
    --temperature="${TEMPERATURE:-0.0}" \
    --quantize_weights="${QUANTIZE:-False}" \
    --prefix_file="${PREFIX_FILE:-}" \
    --prefix_cache="${PREFIX_CACHE:-}" \
    --lookup_k="${LOOKUP_K:-0}" \
    --admit_chunk="${ADMIT_CHUNK:-0}" \
    --dtype='bf16' \
    --load_llama_config="${LLAMA_CONFIG:-7b}" \
    --update_llama_config="dict(scan_attention=False,scan_mlp=False,theta=${THETA:-50000000})" \
    --tokenizer="${TOKENIZER}" \
    --load_checkpoint="params::${CHECKPOINT}"
