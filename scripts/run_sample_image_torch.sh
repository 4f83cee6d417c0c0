#! /bin/bash
# Text to image on one GPU (the PyTorch port's CLI,
# lwm_tpu_torch/apps/vision_generation.py): the bundle of
# scripts/run_sample_image.sh with its flags (7b, fp32, sample_mode
# 'vision', theta 5e7, n_frames 1, the CFG knobs), on one device instead of its
# mesh. TOKENIZER must be a local directory (tokenizer.json and
# tokenizer_config.json, as save_pretrained writes them), CHECKPOINT a
# local streamed checkpoint and VQGAN_CHECKPOINT the VQGAN's pickled flax
# param tree: nothing is downloaded.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${TOKENIZER:-}" ] || [ -z "${CHECKPOINT:-}" ] || [ -z "${VQGAN_CHECKPOINT:-}" ]; then
    echo "run_sample_image_torch.sh: set TOKENIZER (a local tokenizer directory), CHECKPOINT (a local params stream) and VQGAN_CHECKPOINT (the VQGAN pickle)" >&2
    exit 2
fi

python3 -u -m lwm_tpu_torch.apps.vision_generation \
    --prompt="${PROMPT:-Fireworks over the city}" \
    --output_file="${OUTPUT_FILE:-image.png}" \
    --n_frames=1 \
    --mesh_dim='!1,1,-1,1' \
    --dtype='fp32' \
    --load_llama_config='7b' \
    --update_llama_config="dict(sample_mode='vision',theta=50000000,max_sequence_length=32768,scan_attention=False,scan_query_chunk_size=128,scan_key_chunk_size=128,scan_mlp=False,scan_mlp_chunk_size=8192,scan_layers=True)" \
    --vqgan_checkpoint="${VQGAN_CHECKPOINT}" \
    --tokenizer="${TOKENIZER}" \
    --load_checkpoint="params::${CHECKPOINT}" \
    --cfg_scale_image=5.0 --top_k_image=8192 --temperature_image=1.0
