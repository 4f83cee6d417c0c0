"""Checkpoint interop: the flax param tree ↔ HF's `LlamaForCausalLM` state
dict, and scanned ↔ unscanned layer stacking.

Counterpart of `lwm_tpu/utils/checkpoint_convert.py`, on nested dicts of
numpy arrays or tensors (the bfloat16 leaves of `checkpoint.load_stream`)
instead of flax's traversal helpers.

RoPE: this package, like LWM, rotates adjacent pairs (x0, x1), (x2, x3),
...; HF's Llama rotates the first half of a head against the second. So
the q and k projections' rows are permuted between the two layouts at the
HF boundary, and only there (`_permute_rotary`, the standard LLaMA
conversion permutation); under GQA k permutes over its own `kv_dim` rows.
"""

from __future__ import annotations

import numpy as np
import torch

from lwm_tpu_torch.checkpoint import flatten_dict, unflatten_dict


def _take(value, index, axis):
    if isinstance(value, torch.Tensor):
        return value.select(axis, index).clone()
    return np.take(np.asarray(value), index, axis=axis)


def _stack(values, axis):
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values, dim=axis)
    return np.stack([np.asarray(v) for v in values], axis=axis)


def unscan_params(params, num_layers, scan_axis=0, scan_key="scan_decoder"):
    """Stacked scan params [L, ...] → per-layer dicts {'0': ..., '1': ...}."""
    out = {}
    for key, val in flatten_dict(params).items():
        if scan_key in key:
            idx = key.index(scan_key)
            for layer in range(num_layers):
                out[key[:idx] + (str(layer),) + key[idx + 1:]] = _take(val, layer, scan_axis)
        else:
            out[key] = val
    return unflatten_dict(out)


def scan_params(params, num_layers, scan_axis=0, scan_key="scan_decoder"):
    """Per-layer dicts → stacked scan params on `scan_axis`."""
    grouped, passthrough = {}, {}
    for key, val in flatten_dict(params).items():
        layer_positions = [i for i, part in enumerate(key) if part.isdigit()]
        if layer_positions:
            i = layer_positions[0]
            grouped.setdefault(key[:i] + (scan_key,) + key[i + 1:], {})[int(key[i])] = val
        else:
            passthrough[key] = val
    out = dict(passthrough)
    for key, layers in grouped.items():
        assert len(layers) == num_layers, (key, sorted(layers))
        out[key] = _stack([layers[i] for i in range(num_layers)], scan_axis)
    return unflatten_dict(out)


def _permute_rotary(w, n_heads, dim1, dim2, inverse=False):
    """A [dim1, dim2] q/k weight (torch layout [out, in]) between the
    interleaved-pair rotary layout and HF's half-split one: interleaved →
    half-split (flax → HF), or with `inverse` half-split → interleaved."""
    head = dim1 // n_heads
    if not inverse:
        return w.reshape(n_heads, head // 2, 2, dim2).transpose(0, 2, 1, 3).reshape(dim1, dim2)
    return w.reshape(n_heads, 2, head // 2, dim2).transpose(0, 2, 1, 3).reshape(dim1, dim2)


def _numpy(x):
    """A leaf as a numpy array; bfloat16 tensors widen to float32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _kv_dim(config):
    n_heads = config.num_attention_heads
    return config.hidden_size // n_heads * (config.num_key_value_heads or n_heads)


def flax_to_torch_llama(params, config):
    """The flax param tree (scanned or not, with or without "params") → HF
    `LlamaForCausalLM`'s state dict of numpy arrays."""
    if "params" in params:
        params = params["params"]
    if any("scan_decoder" in k for k in flatten_dict(params)):
        params = unscan_params(params, config.num_hidden_layers,
                               scan_axis=config.param_scan_axis)
    n_heads = config.num_attention_heads
    n_kv_heads = config.num_key_value_heads or n_heads
    hidden, kv_dim = config.hidden_size, _kv_dim(config)

    def t(x):   # a flax Dense kernel [in, out] → torch Linear weight [out, in]
        return _numpy(x).T

    tree = params
    sd = {
        "model.embed_tokens.weight": _numpy(tree["transformer"]["wte"]["embedding"]),
        "model.norm.weight": _numpy(tree["transformer"]["ln_f"]["kernel"]),
        "lm_head.weight": t(tree["lm_head"]["kernel"]),
    }
    for layer in range(config.num_hidden_layers):
        block = tree["transformer"]["h"][str(layer)]
        prefix = f"model.layers.{layer}."
        attn, ffn = block["attention"], block["feed_forward"]
        sd[prefix + "self_attn.q_proj.weight"] = _permute_rotary(
            t(attn["wq"]["kernel"]), n_heads, hidden, hidden)
        sd[prefix + "self_attn.k_proj.weight"] = _permute_rotary(
            t(attn["wk"]["kernel"]), n_kv_heads, kv_dim, hidden)
        sd[prefix + "self_attn.v_proj.weight"] = t(attn["wv"]["kernel"])
        sd[prefix + "self_attn.o_proj.weight"] = t(attn["wo"]["kernel"])
        sd[prefix + "mlp.gate_proj.weight"] = t(ffn["w1"]["kernel"])
        sd[prefix + "mlp.down_proj.weight"] = t(ffn["w2"]["kernel"])
        sd[prefix + "mlp.up_proj.weight"] = t(ffn["w3"]["kernel"])
        sd[prefix + "input_layernorm.weight"] = _numpy(block["attention_norm"]["kernel"])
        sd[prefix + "post_attention_layernorm.weight"] = _numpy(block["ffn_norm"]["kernel"])
    return sd


def torch_llama_to_flax(state_dict, config, scan_layers=None, param_scan_axis=None):
    """HF `LlamaForCausalLM`'s state dict (numpy arrays or tensors) → the
    flax param tree, scanned as the config says unless overridden."""
    scan_layers = config.scan_layers if scan_layers is None else scan_layers
    param_scan_axis = config.param_scan_axis if param_scan_axis is None else param_scan_axis
    n_heads = config.num_attention_heads
    n_kv_heads = config.num_key_value_heads or n_heads
    hidden, kv_dim = config.hidden_size, _kv_dim(config)

    def a(name):
        return _numpy(state_dict[name])

    def k(name):   # a torch Linear weight [out, in] → flax kernel [in, out]
        return a(name).T

    tree = {
        "transformer": {
            "wte": {"embedding": a("model.embed_tokens.weight")},
            "ln_f": {"kernel": a("model.norm.weight")},
            "h": {},
        },
        "lm_head": {"kernel": k("lm_head.weight")},
    }
    for layer in range(config.num_hidden_layers):
        p = f"model.layers.{layer}."
        tree["transformer"]["h"][str(layer)] = {
            "attention": {
                "wq": {"kernel": _permute_rotary(a(p + "self_attn.q_proj.weight"), n_heads,
                                                 hidden, hidden, inverse=True).T},
                "wk": {"kernel": _permute_rotary(a(p + "self_attn.k_proj.weight"), n_kv_heads,
                                                 kv_dim, hidden, inverse=True).T},
                "wv": {"kernel": k(p + "self_attn.v_proj.weight")},
                "wo": {"kernel": k(p + "self_attn.o_proj.weight")},
            },
            "feed_forward": {
                "w1": {"kernel": k(p + "mlp.gate_proj.weight")},
                "w2": {"kernel": k(p + "mlp.down_proj.weight")},
                "w3": {"kernel": k(p + "mlp.up_proj.weight")},
            },
            "attention_norm": {"kernel": a(p + "input_layernorm.weight")},
            "ffn_norm": {"kernel": a(p + "post_attention_layernorm.weight")},
        }
    if scan_layers:
        tree = scan_params(tree, config.num_hidden_layers, scan_axis=param_scan_axis)
    return tree
