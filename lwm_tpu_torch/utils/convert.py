"""JAX (flax) LLaMA param tree → the port's state dict.

Counterpart of `lwm_tpu/utils/checkpoint_convert.py:21-33` (`unscan_params`)
and of the name map in `flax_to_torch_llama` (`:77-124`), for the port's own
module names rather than HF's. The tree may be scanned (layers stacked under
`transformer/h/scan_decoder` on `config.param_scan_axis`, 0 or 1) or
unscanned (`transformer/h/{i}`), with or without a top-level "params" key;
leaves are numpy arrays (anything `np.asarray` takes).

Flax dense kernels are [in, out]; they are TRANSPOSED here to torch's
[out, in] `nn.Linear` layout. RoPE stays on interleaved pairs in both
packages, so no q/k row permutation is applied (`_permute_rotary` is for
HF's rotate-half layout only).
"""

from __future__ import annotations

import numpy as np
import torch


def _layer_tree(h, layer, scan_axis):
    """Layer `layer`'s subtree of transformer/h, scanned or not."""
    if "scan_decoder" in h:
        def take(node):
            if isinstance(node, dict):
                return {k: take(v) for k, v in node.items()}
            return np.take(np.asarray(node), layer, axis=scan_axis)

        return take(h["scan_decoder"])
    return h[str(layer)]


def convert_flax_params(params, config, dtype=None):
    """Returns {name: tensor} for `LLaMAForCausalLM.load_state_dict`
    (cast to `dtype` when given)."""
    if "params" in params:
        params = params["params"]
    tr = params["transformer"]

    def t(x, transpose=False):
        x = np.asarray(x)
        x = torch.from_numpy(np.array(x.T if transpose else x, order="C"))  # a writable copy
        return x if dtype is None else x.to(dtype)

    sd = {
        "wte.weight": t(tr["wte"]["embedding"]),
        "ln_f.weight": t(tr["ln_f"]["kernel"]),
    }
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = t(params["lm_head"]["kernel"], transpose=True)
    for i in range(config.num_hidden_layers):
        blk = _layer_tree(tr["h"], i, config.param_scan_axis)
        pre = f"h.{i}."
        for mod, names in (("attention", "wq wk wv wo"), ("feed_forward", "w1 w2 w3")):
            for n in names.split():
                sd[f"{pre}{mod}.{n}.weight"] = t(blk[mod][n]["kernel"], transpose=True)
        sd[pre + "attention_norm.weight"] = t(blk["attention_norm"]["kernel"])
        sd[pre + "ffn_norm.weight"] = t(blk["ffn_norm"]["kernel"])
    return sd
