"""The partition rules over the port's parameter names, and each rank's
slice of a leaf.

Counterpart of `lwm_tpu/parallel/partition.py` and of the rule table
`LLaMAConfig.get_partition_rules` (`lwm_tpu/models/llama.py:230-278`, the
unscanned table): the same regexes over the port's names, with each spec
written for the port's layout. A dense weight is [out, in] here, flax's
kernel [in, out], so each dense spec is the JAX one reversed; the
embedding is [vocab, hidden] in both. First match wins.

What a rank holds in this slice: the dims the rules give to "tp" are split
over tp (wq, wk, wv, w1, w3 by output features; wo and w2 by input
features; lm_head by vocab), so attention runs on a rank's own heads and
the MLP on its own features, with one all-reduce after wo and one after w2
and the vocab-split logits gathered. The dims the rules give to (fsdp, sp)
stay whole on every rank: the weights are replicated over dp × fsdp × sp,
and their FSDP2 sharding comes with ROADMAP A4.1. So does the embedding's
vocab split over tp: its lookup stays whole on every rank, where a split
table would cost an all-reduce a forward for memory alone.
"""

from __future__ import annotations

import re

# (regex over the port's parameter names, a spec per dim of the port's tensor)
PARTITION_RULES = (
    (r"^wte\.weight$", ("tp", ("fsdp", "sp"))),
    (r"attention\.(wq|wk|wv)\.weight$", ("tp", ("fsdp", "sp"))),
    (r"attention\.wo\.weight$", (("fsdp", "sp"), "tp")),
    (r"feed_forward\.(w1|w3)\.weight$", ("tp", ("fsdp", "sp"))),
    (r"feed_forward\.w2\.weight$", (("fsdp", "sp"), "tp")),
    (r"(attention_norm|ffn_norm)\.weight$", (None,)),
    (r"^ln_f\.weight$", (None,)),
    (r"^lm_head\.weight$", ("tp", ("fsdp", "sp"))),
    (r".*", (None,)),
)
# leaves whose tp dim stays whole in this slice (see the module note)
WHOLE = (r"^wte\.weight$",)


def partition_spec(name):
    """The spec of parameter `name` (a tuple with an entry a dim)."""
    for rule, spec in PARTITION_RULES:
        if re.search(rule, name):
            return spec
    raise ValueError(f"no partition rule matched parameter {name}")


def tp_dim(name):
    """The dim of `name` that is split over tp, or None."""
    if any(re.search(r, name) for r in WHOLE):
        return None
    spec = partition_spec(name)
    return spec.index("tp") if "tp" in spec else None


def check_tp(config, tp):
    """Raise unless `config` splits over `tp` ranks: tp must divide the kv
    heads (the cache's head dim is split over tp, as JAX's
    `FlaxLLaMAAttention` requires), and so the query heads, the MLP width
    and an untied head's vocabulary."""
    if tp == 1:
        return
    if config.kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_key_value_heads={config.kv_heads} (the "
                         "cache's head dim shards by tp)")
    for what, n in (("intermediate_size", config.intermediate_size),
                    *(() if config.tie_word_embeddings else (("vocab_size", config.vocab_size),))):
        if n % tp:
            raise ValueError(f"tp={tp} must divide {what}={n}")


def local_slice(name, tensor, mesh):
    """This rank's slice of parameter `name` (a copy of the slice; the
    tensor itself where the rank holds it whole)."""
    dim = tp_dim(name)
    if mesh is None or mesh.tp == 1 or dim is None:
        return tensor
    n = tensor.shape[dim]
    if n % mesh.tp:
        raise ValueError(f"{name}: dim {dim} of {tuple(tensor.shape)} does not split over "
                         f"tp={mesh.tp}")
    w = n // mesh.tp
    return tensor.narrow(dim, mesh.tp_rank * w, w).contiguous().clone()


def shard_state_dict(sd, mesh):
    """{name: this rank's slice} of a whole state dict."""
    return {k: local_slice(k, v, mesh) for k, v in sd.items()}
