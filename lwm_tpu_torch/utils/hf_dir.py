"""A Hugging Face Llama model directory, read and written without
`transformers` or `safetensors` (the card's machine has neither).

- safetensors files: an 8-byte little-endian header length, a JSON header
  ({name: {"dtype", "shape", "data_offsets"}}, plus "__metadata__"), padded
  with spaces to a multiple of 8, then each tensor's raw little-endian
  bytes at its offsets. `write_safetensors` / `read_safetensors`.
- `read_state_dict(path)`: a directory's weights, from `model.safetensors`,
  a sharded `model.safetensors.index.json` or `pytorch_model.bin` (through
  `torch.load(weights_only=True)`), as float32 tensors on the host (what
  `LlamaForCausalLM.from_pretrained(..., torch_dtype=torch.float32)`
  holds). A checkpoint whose config ties the embeddings gets the embedding
  as `lm_head.weight`, as HF ties it.
- `save_llama_dir(path, state_dict, config)`: `config.json` with the fields
  that `lwm_tpu/apps/convert_checkpoint.py:72-87` sets (and HF's defaults
  for the rest, `architectures` and `model_type`), and the weights as
  safetensors in float32: one `model.safetensors`, or above `SHARD_BYTES`
  shards `model-0000i-of-0000n.safetensors` with
  `model.safetensors.index.json`, split as `save_pretrained` splits them.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}
SAFE_NAME, SAFE_INDEX, BIN_NAME = "model.safetensors", "model.safetensors.index.json", \
    "pytorch_model.bin"
SHARD_BYTES = 5 * 10**9   # save_pretrained's default max_shard_size, "5GB"


def _tensor(x):
    x = torch.from_numpy(np.ascontiguousarray(x)) if not isinstance(x, torch.Tensor) else x
    return x.detach().cpu().contiguous()


def write_safetensors(path, tensors):
    """{name: tensor or numpy array} → a safetensors file at `path`, the
    tensors in name order, with the metadata transformers asks for."""
    tensors = {name: _tensor(x) for name, x in sorted(tensors.items())}
    header, offset = {}, 0
    for name, x in tensors.items():
        n = x.numel() * x.element_size()
        header[name] = dict(dtype=_NAMES[x.dtype], shape=list(x.shape),
                            data_offsets=[offset, offset + n])
        offset += n
    header["__metadata__"] = {"format": "pt"}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text)
        for x in tensors.values():
            f.write((x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes())


def read_safetensors(path):
    """A safetensors file → {name: tensor} on the host, read a tensor at a time."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        for name, spec in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
            begin, end = spec["data_offsets"]
            f.seek(base + begin)
            data = bytearray(f.read(end - begin))
            dtype = _DTYPES[spec["dtype"]]
            x = (torch.frombuffer(data, dtype=dtype) if data
                 else torch.empty(0, dtype=dtype))
            out[name] = x.reshape(spec["shape"])
    return out


def read_state_dict(path):
    """The weights of an HF model directory as float32 tensors (see the
    module note)."""
    if os.path.exists(os.path.join(path, SAFE_INDEX)):
        with open(os.path.join(path, SAFE_INDEX)) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        sd = {}
        for name in shards:
            sd.update(read_safetensors(os.path.join(path, name)))
    elif os.path.exists(os.path.join(path, SAFE_NAME)):
        sd = read_safetensors(os.path.join(path, SAFE_NAME))
    elif os.path.exists(os.path.join(path, BIN_NAME)):
        sd = torch.load(os.path.join(path, BIN_NAME), map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"{path}: no {SAFE_NAME}, {SAFE_INDEX} or {BIN_NAME} (a local HF model directory "
            "is read; nothing is downloaded)")
    sd = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
    config_path = os.path.join(path, "config.json")
    if "lm_head.weight" not in sd and os.path.exists(config_path):
        with open(config_path) as f:
            if json.load(f).get("tie_word_embeddings", False):
                sd["lm_head.weight"] = sd["model.embed_tokens.weight"]
    return sd


def save_llama_dir(path, state_dict, config):
    """An HF Llama directory at `path`: config.json and the float32 weights
    of `state_dict` ({name: array or tensor}; see the module note)."""
    heads = config.num_attention_heads
    hf_config = dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        vocab_size=config.vocab_size, hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_hidden_layers=config.num_hidden_layers, num_attention_heads=heads,
        num_key_value_heads=config.num_key_value_heads or heads,
        head_dim=config.hidden_size // heads,
        max_position_embeddings=config.max_sequence_length, rms_norm_eps=config.rms_norm_eps,
        rope_theta=float(config.theta), rope_scaling=None, attention_bias=False,
        attention_dropout=0.0, mlp_bias=False, tie_word_embeddings=False, hidden_act="silu",
        initializer_range=config.initializer_range, pretraining_tp=1, use_cache=True,
        bos_token_id=1, eos_token_id=2, torch_dtype="float32",
    )
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2, sort_keys=True)
    tensors = {k: _tensor(v).float() for k, v in state_dict.items()}
    shards, size = [{}], 0
    for name, x in tensors.items():   # save_pretrained's greedy split, in state-dict order
        n = x.numel() * x.element_size()
        if shards[-1] and size + n > SHARD_BYTES:
            shards.append({})
            size = 0
        shards[-1][name] = x
        size += n
    if len(shards) == 1:
        write_safetensors(os.path.join(path, SAFE_NAME), shards[0])
        return
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(path, name), shard)
        weight_map.update({k: name for k in shard})
    total = sum(x.numel() * x.element_size() for x in tensors.values())
    with open(os.path.join(path, SAFE_INDEX), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": dict(sorted(
            weight_map.items()))}, f, indent=2)
