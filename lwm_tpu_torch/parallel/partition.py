"""The partition rules over the port's parameter names, and each rank's
slice of a leaf.

Counterpart of `lwm_tpu/parallel/partition.py` and of the rule tables
`LLaMAConfig.get_partition_rules` (`lwm_tpu/models/llama.py:230-278`, the
unscanned table) and `VideoLLaMAConfig.get_partition_rules`
(`lwm_tpu/models/vision_llama.py:80-86`: `vte` and `vision_head`): the same
regexes over the port's names, with each spec written for the port's
layout. A dense weight is [out, in] here, flax's kernel [in, out], so each
dense spec is the JAX one reversed; the embeddings are [vocab, hidden] in
both. First match wins.

What a rank holds:
- over tp, the dims the rules give to "tp" (wq, wk, wv, w1, w3 by output
  features; wo and w2 by input features; lm_head and vision_head by
  vocab), so attention runs on a rank's own heads and the MLP on its own
  features. The embeddings (`WHOLE`: wte, vte) keep their vocab whole over
  tp: a split table would cost an all-reduce a forward for memory alone;
- in training, over the shard group (fsdp × sp, `Mesh.shard`), the dims the
  rules give to ("fsdp", "sp"): rank i of the group holds the i-th of
  fsdp·sp equal slices of its tp-local leaf, as JAX's sharding does
  (`local_shard`, `parallel.fsdp`). Inference keeps the weights whole over
  the shard group (replicated over dp × fsdp × sp).
A dim that does not split raises, naming the leaf and the mesh.
"""

from __future__ import annotations

import re

SHARD = ("fsdp", "sp")
# (regex over the port's parameter names, a spec per dim of the port's tensor)
PARTITION_RULES = (
    (r"^wte\.weight$", ("tp", SHARD)),
    (r"attention\.(wq|wk|wv)\.weight$", ("tp", SHARD)),
    (r"attention\.wo\.weight$", (SHARD, "tp")),
    (r"feed_forward\.(w1|w3)\.weight$", ("tp", SHARD)),
    (r"feed_forward\.w2\.weight$", (SHARD, "tp")),
    (r"(attention_norm|ffn_norm)\.weight$", (None,)),
    (r"^ln_f\.weight$", (None,)),
    (r"^lm_head\.weight$", ("tp", SHARD)),
    (r"^vte\.weight$", ("tp", SHARD)),
    (r"^vision_head\.weight$", ("tp", SHARD)),
    (r".*", (None,)),
)
# leaves whose tp dim stays whole (see the module note)
WHOLE = (r"^wte\.weight$", r"^vte\.weight$")


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


def shard_dim(name):
    """The dim of `name` that is split over the shard group (fsdp × sp), or None."""
    spec = partition_spec(name)
    return spec.index(SHARD) if SHARD in spec else None


def check_tp(config, tp):
    """Raise unless `config` splits over `tp` ranks: tp must divide the kv
    heads (the cache's head dim is split over tp, as JAX's
    `FlaxLLaMAAttention` requires), and so the query heads, the MLP width
    and an untied head's vocabulary (a VideoLLaMA's vision head's too)."""
    if tp == 1:
        return
    if config.kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_key_value_heads={config.kv_heads} (the "
                         "cache's head dim shards by tp)")
    heads = [] if config.tie_word_embeddings else [("vocab_size", config.vocab_size)]
    if not getattr(config, "tie_vision_embeddings", True):
        heads.append(("vision_vocab_size", config.vision_vocab_size))
    for what, n in (("intermediate_size", config.intermediate_size), *heads):
        if n % tp:
            raise ValueError(f"tp={tp} must divide {what}={n}")


def _split(name, tensor, dim, n, i, mesh, what):
    size = tensor.shape[dim]
    if size % n:
        raise ValueError(f"{name}: dim {dim} of {tuple(tensor.shape)} does not split over "
                         f"{what}={n} (mesh {'x'.join(map(str, mesh.dims))} = dp, fsdp, tp, sp)")
    w = size // n
    return tensor.narrow(dim, i * w, w)


def local_slice(name, tensor, mesh):
    """This rank's tp slice of parameter `name` (a copy of the slice; the
    tensor itself where the rank holds it whole over tp)."""
    dim = tp_dim(name)
    if mesh is None or mesh.tp == 1 or dim is None:
        return tensor
    return _split(name, tensor, dim, mesh.tp, mesh.tp_rank, mesh, "tp").contiguous().clone()


def local_shard(name, tensor, mesh):
    """This rank's part of the whole leaf `name` in training: its tp slice,
    then its slice of that over the shard group (a copy; the tensor itself
    where the rank holds it whole)."""
    out = local_slice(name, tensor, mesh)
    dim = shard_dim(name)
    if mesh is None or mesh.shard == 1 or dim is None:
        return out
    return _split(name, out, dim, mesh.shard, mesh.shard_rank, mesh,
                  "fsdp x sp").contiguous().clone()


def whole_leaf(name, part, mesh):
    """The inverse of `local_shard`, a collective over the shard group and
    tp: the whole leaf rebuilt from the ranks' parts, on every rank."""
    if mesh is None:
        return part
    dim = shard_dim(name)
    if mesh.shard > 1 and dim is not None:
        part = mesh.all_gather(part, "shard", dim)
    dim = tp_dim(name)
    if mesh.tp > 1 and dim is not None:
        part = mesh.all_gather(part, "tp", dim)
    return part


def shard_state_dict(sd, mesh):
    """{name: this rank's tp slice} of a whole state dict."""
    return {k: local_slice(k, v, mesh) for k, v in sd.items()}
