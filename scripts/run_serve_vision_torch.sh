#! /bin/bash
# Video QA serving on the GPU (the PyTorch port's CLI,
# lwm_tpu_torch/apps/serve_vision.py): the bundle of scripts/run_serve_vision.sh
# with the same knobs. The video's VQ codes (INPUT_CODES_FILE: one JSON list
# a frame a line) become a shared vision-masked prefix, prefilled once; the
# questions (QUESTIONS_FILE, JSONL; stdin when empty) are answered in flight
# over it. PREFIX_CACHE persists the built video KV (loaded when it exists);
# LOOKUP_K > 0 adds prompt-lookup verify; ADMIT_CHUNK > 0 chunked admission.
# TOKENIZER must be a local directory and CHECKPOINT a local params stream:
# nothing is downloaded. A video file needs VQGAN, which the port lacks yet.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${INPUT_CODES_FILE:-}" ] || [ -z "${TOKENIZER:-}" ] || [ -z "${CHECKPOINT:-}" ]; then
    echo "run_serve_vision_torch.sh: set INPUT_CODES_FILE (the video's VQ codes), TOKENIZER (a local tokenizer directory) and CHECKPOINT (a local params stream)" >&2
    exit 2
fi

python3 -u -m lwm_tpu_torch.apps.serve_vision \
    --input_codes_file="${INPUT_CODES_FILE}" \
    --questions_file="${QUESTIONS_FILE:-}" \
    --output_file="${OUTPUT_FILE:-answers.jsonl}" \
    --slots="${SLOTS:-4}" \
    --cache_len="${CACHE_LEN:-1024}" \
    --prompt_buckets="${PROMPT_BUCKETS:-64,128,256}" \
    --max_new_tokens="${MAX_NEW_TOKENS:-256}" \
    --temperature="${TEMPERATURE:-0.0}" \
    --prefix_cache="${PREFIX_CACHE:-}" \
    --lookup_k="${LOOKUP_K:-0}" \
    --admit_chunk="${ADMIT_CHUNK:-0}" \
    --dtype='bf16' \
    --load_llama_config="${LLAMA_CONFIG:-7b}" \
    --update_llama_config="dict(scan_attention=False,scan_mlp=False,theta=${THETA:-50000000})" \
    --tokenizer="${TOKENIZER}" \
    --load_checkpoint="params::${CHECKPOINT}"
