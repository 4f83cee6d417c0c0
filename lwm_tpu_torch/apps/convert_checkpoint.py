"""Checkpoint conversion on the port.

Counterpart of `lwm_tpu/apps/convert_checkpoint.py`, with its flags and
printed lines (parsed by `utils/flags.py`). Directions:
  hf_to_streaming:  an HF `LlamaForCausalLM` directory → a streamed params
                    checkpoint (loadable as `params::PATH`)
  streaming_to_hf:  streamed params → an HF Llama directory
  unscan / rescan:  flip a streamed checkpoint's scanned-layer stacking
The HF directory is read and written by `utils.hf_dir` (safetensors, or a
`pytorch_model.bin` read), not by transformers; the streams by
`checkpoint.save_tree`, the JAX writer's format. The rotate-half
permutation of q and k is applied at the HF boundary
(`utils.checkpoint_convert`). Conversion runs on the host.

Run: python -m lwm_tpu_torch.apps.convert_checkpoint --direction=hf_to_streaming \\
    --hf_path=LOCAL_HF_DIR --output=ckpt/streaming_params \\
    --llama_config=7b --scan_layers=True
"""

from __future__ import annotations

import dataclasses
import sys

from lwm_tpu_torch import checkpoint
from lwm_tpu_torch.models.llama import LLaMAConfig
from lwm_tpu_torch.utils.checkpoint_convert import (
    flax_to_torch_llama,
    scan_params,
    torch_llama_to_flax,
    unscan_params,
)
from lwm_tpu_torch.utils.flags import parse_flags
from lwm_tpu_torch.utils.hf_dir import read_state_dict, save_llama_dir

DEFAULTS = dict(
    direction="hf_to_streaming",
    hf_path="",
    streaming_path="",
    output="",
    llama_config="7b",
    update_llama_config="",
    scan_layers=True,
    param_scan_axis=0,
    float_dtype="fp32",
)


def model_config(flags):
    config = LLaMAConfig.load_config(flags.llama_config)
    updates = {}
    if flags.update_llama_config:
        # the JAX CLI's spelling: a Python expression, "dict(theta=1e7, ...)"
        updates = dict(eval(flags.update_llama_config, {"dict": dict}))  # noqa: S307
    updates.update(scan_layers=flags.scan_layers, param_scan_axis=flags.param_scan_axis)
    return LLaMAConfig.from_dict({**dataclasses.asdict(config), **updates})


def main(argv=None):
    flags = parse_flags(DEFAULTS, sys.argv[1:] if argv is None else argv,
                        prog="python -m lwm_tpu_torch.apps.convert_checkpoint")
    if not flags.output:
        raise ValueError("--output is required")
    config = model_config(flags)

    if flags.direction == "hf_to_streaming":
        params = torch_llama_to_flax(read_state_dict(flags.hf_path), config)
        checkpoint.save_tree(params, flags.output, float_dtype=flags.float_dtype)
        print(f"wrote streaming params to {flags.output}")
    elif flags.direction == "streaming_to_hf":
        params = checkpoint.load_checkpoint(flags.streaming_path)
        save_llama_dir(flags.output, flax_to_torch_llama(params, config), config)
        print(f"wrote HF model to {flags.output}")
    elif flags.direction in ("unscan", "rescan"):
        params = checkpoint.load_checkpoint(flags.streaming_path)
        flip = unscan_params if flags.direction == "unscan" else scan_params
        params = flip(params, config.num_hidden_layers, scan_axis=flags.param_scan_axis)
        checkpoint.save_tree(params, flags.output, float_dtype=flags.float_dtype)
        print(f"wrote converted params to {flags.output}")
    else:
        raise ValueError(f"unknown direction: {flags.direction}")


if __name__ == "__main__":
    main()
