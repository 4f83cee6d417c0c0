#! /bin/bash
# Image or video question answering on one GPU (the PyTorch port's CLI,
# lwm_tpu_torch/apps/vision_chat.py): the bundle of scripts/run_vision_chat.sh
# with its flags (7b, fp32, sample_mode 'text', theta 5e7, scan chunks 128,
# 8 frames, temperature 0.2), on one device instead of its mesh.
# INPUT_FILE is an image or a video: reading it needs PIL (and OpenCV for a
# video) on the machine that runs this. TOKENIZER must be a local directory
# (tokenizer.json and tokenizer_config.json, as save_pretrained writes
# them), CHECKPOINT a local streamed checkpoint and VQGAN_CHECKPOINT the
# VQGAN's pickled flax param tree: nothing is downloaded.
export SCRIPT_DIR="$( cd -- "$( dirname -- "${BASH_SOURCE[0]}" )" &> /dev/null && pwd )"
export PROJECT_DIR="$( cd -- "$( dirname -- "$SCRIPT_DIR" )" &> /dev/null && pwd )"
cd $PROJECT_DIR
export PYTHONPATH="$PYTHONPATH:$PROJECT_DIR"

if [ -z "${INPUT_FILE:-}" ] || [ -z "${TOKENIZER:-}" ] || [ -z "${CHECKPOINT:-}" ] || [ -z "${VQGAN_CHECKPOINT:-}" ]; then
    echo "run_vision_chat_torch.sh: set INPUT_FILE (an image or a video), TOKENIZER (a local tokenizer directory), CHECKPOINT (a local params stream) and VQGAN_CHECKPOINT (the VQGAN pickle)" >&2
    exit 2
fi

python3 -u -m lwm_tpu_torch.apps.vision_chat \
    --prompt="${PROMPT:-What is happening in this video?}" \
    --input_file="${INPUT_FILE}" \
    --vqgan_checkpoint="${VQGAN_CHECKPOINT}" \
    --mesh_dim='!1,1,-1,1' \
    --dtype='fp32' \
    --load_llama_config='7b' \
    --update_llama_config="dict(sample_mode='text',theta=50000000,max_sequence_length=131072,scan_attention=False,scan_query_chunk_size=128,scan_key_chunk_size=128,scan_mlp=False,scan_mlp_chunk_size=2048,scan_layers=True)" \
    --tokenizer="${TOKENIZER}" \
    --load_checkpoint="params::${CHECKPOINT}" \
    --max_n_frames=8 --temperature=0.2
