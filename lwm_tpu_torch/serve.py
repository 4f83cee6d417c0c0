"""In-flight (continuous) batching over a fixed pool of cache slots.

Counterpart of the single-device `InflightServer` of `lwm_tpu/serve.py`
(`:321-1054`): a pool of `slots` cache rows, each at its own depth; a
request is admitted into a free slot the moment one opens, by a bucketed
batch-1 prefill written straight into that slot's cache row; one decode
step then advances every slot at once, with per-row positions and masks.
Greedy rows emit exactly what a batch-1 greedy rollout would.

Device work per admission: one forward of the prompt bucket over the slot's
cache row (K1 `ops.flash` on CUDA). Per decode round: one forward of one
token per slot over the whole pool (K4 `ops.decode` on CUDA). A model with
int8 weights (`quant_dense`, `--quantize_weights` of the JAX CLI) serves
unchanged: its dense products run K5 `ops.quant.int8_matmul` ("int8") or K6
`ops.quant.w8a8_matmul` ("int8_w8a8"), at m = bucket in an admission and
m = slots in a decode round. Decode rounds run with
`cache.index = max(lengths)` as the kernels' scan bound (the per-row mask
does the exact part). The host loop holds the scheduler (admission, stop
tokens, budgets) and syncs once per round to read the emitted tokens.

Serving modes (the JAX server's, `:328-345`):
- `prefix_ids`: a shared document prefilled once (`build_prefix_cache`, in
  `prefix_chunk`-token chunks) into a frozen batch-1 KV block that every
  slot attends to; prompts are suffix-only and the slot caches hold only
  suffixes. Decode reads the block once a round (`ops.prefix`: two K4 calls
  a layer); an admission adds K1 over the block. `prefix_cache_path` saves
  the block (or loads it, skipping the build) in the JAX package's stream
  format and tree names, so an index built by either package loads in the
  other.
- `lookup_k`: prompt-lookup verify. Each greedy slot proposes the k tokens
  that followed the latest earlier occurrence of its trailing `lookup_ngram`
  in its own context, and one widened forward (q = 1 + k, per-row writes
  and causal frontiers: K1's full-tile bias) verifies every slot. Greedy
  rows emit exactly the target's greedy tokens for any proposals; sampled
  rows ride along unspeculated.
- `admit_chunk`: chunked admission. A prompt longer than the chunk is
  prefilled `admit_chunk` tokens a step into a staging cache, with the
  pool's decode round between chunks; prompts beyond the largest bucket are
  accepted in this mode.

VideoLLaMA pools (`models/vision_llama.py`, `sample_mode="text"`: answers
are text), as the JAX server threads vision masks (`:110-137`): the video
may be the shared prefix (`prefix_vision_masks`, its codes embedded through
`vte`), or a request may carry its own video inline (`submit(...,
vision_masks=)`); bucketed and chunked admissions pass the request's masks,
decode and verify rounds pass none (all text).

On a mesh (`mesh=`, a `parallel.mesh.Mesh` of more than one rank, the
model built on it: `lwm_tpu/serve.py:88-107, 440-535`) every rank runs this
host loop over the same requests. The slots are split over dp × fsdp
(`slots % (dp·fsdp)` must be 0): a rank holds the cache rows of its batch
shard, [slots/(dp·fsdp), h_kv/tp, T, d], and with sp > 1 and no shared
prefix each slot's sequence is split over sp too (`sp_slot_caches`:
`cache_len % sp == 0`, `lookup_k ≤ 63`, routed writes a token at a time for
a verify block; chunked admissions stage in a cache split the same way).
With a shared prefix the prefix block is split over sp instead and the
slots stay whole. An admission runs on the ranks of the slot's batch shard;
a round on every rank. The ranks of a batch shard compute the same logits:
its first rank (tp and sp 0) picks each token, and one collective a round
(a broadcast an admission) gives every rank the pool's tokens, so every
host loop takes the same decisions. VideoLLaMA pools and int8 weights stay
on one device (ROADMAP A4).
"""

from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from lwm_tpu_torch import checkpoint
from lwm_tpu_torch.models.llama import KVCache, LayerCache
from lwm_tpu_torch.parallel.mesh import mesh_of


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket {buckets[-1]}")


def _padded_masks(vision_masks, n, device):
    """Vision masks padded with False to n, as a [1, n] tensor on `device`,
    or None when there are none."""
    if vision_masks is None:
        return None
    vm = np.zeros(n, bool)
    given = np.asarray(vision_masks, bool).reshape(-1)
    vm[:len(given)] = given
    return torch.from_numpy(vm)[None].to(device)


def prefill_logits(model, cache, prompt, bucket, pos0=0, vision_masks=None):
    """Admission prefill (`lwm_tpu/serve.py:623-673`): run `prompt`, padded
    to `bucket`, through `model` over the batch-1 `cache` (a slot view of
    the pool or a fresh `init_cache(1, T)`), writing its keys at positions
    0.. in place. `pos0`: the shared prefix's length (RoPE positions start
    there); `vision_masks`: the prompt's (a VideoLLaMA's), padded with
    False (`:646`). Returns the fp32 logits [vocab] of the last prompt
    token. The padding rows write junk past the prompt; decode overwrites
    each such position before its mask exposes it."""
    dev = cache.layers[0].k.device
    n = len(prompt)
    ids = torch.zeros((1, bucket), dtype=torch.long)
    ids[0, :n] = torch.as_tensor(np.asarray(prompt, np.int64))
    mask = torch.arange(cache.length, device=dev)[None] < n
    pos = torch.arange(bucket, device=dev)[None] + pos0
    cache.index = 0
    logits = model(ids.to(dev), mask, pos, cache=cache,
                   vision_masks=_padded_masks(vision_masks, bucket, dev))
    return logits[0, n - 1].float()


def _with_config(model, **changes):
    """The same weight tensors (not copies) under another config (and the
    same mesh)."""
    kw = {} if model.mesh is None else dict(mesh=model.mesh)
    return type(model).on_tensors(model.config.replace(**changes), model.state_dict(),
                                  model.dtype, **kw)



def _lookup_proposal(ctx, k, ngram):
    """The k tokens that followed the most recent earlier occurrence of
    ctx's trailing ngram (`lwm_tpu/serve.py:143-163`), padded with ctx's
    last token; None when the tail never recurs."""
    L = ctx.shape[0]
    if L < ngram + 1:
        return None
    tail = ctx[L - ngram:]
    win = np.lib.stride_tricks.sliding_window_view(ctx, ngram)
    hit = np.flatnonzero((win == tail).all(1))
    hit = hit[hit < L - ngram]
    if hit.size == 0:
        return None
    s = int(hit[-1]) + ngram
    prop = ctx[s: s + k].astype(np.int64)
    if prop.shape[0] < k:
        prop = np.concatenate([prop, np.full(k - prop.shape[0], ctx[-1], np.int64)])
    return prop


# ---------------------------------------------------------------- shared prefix

def build_prefix_cache(model, prefix_ids, chunk=2048, prefix_vision_masks=None):
    """Prefill a shared prefix once into a frozen batch-1 KV block
    (`lwm_tpu/serve.py:231-300`): a chunked prefill through a
    `prefix_len=0` clone of `model`, so the block is what the cache layer
    writes (head-major, GQA-narrow, int8 with its scales). A VideoLLaMA's
    `prefix_vision_masks` mark the prefix's VQ codes, padded with False to
    the chunked length, each chunk given its slice (`:274-288`). Returns
    (KVCache of one row, P_store, P_true): P_store is P_true rounded up to
    128 (the rows past P_true are masked out of every read by
    `prefix_tokens`); the cache's `index` is the JAX builder's cache_index
    (the tokens written, P_true rounded up to the chunk).

    Each chunk writes its rows at `cache.index = done` (the JAX builder's
    shared write index). The build cache is as long as the chunked tokens,
    then cut to P_store: a chunk never runs past the cache.

    On a mesh with sp > 1 the block is built in a cache split over sp (each
    chunk's queries split too) and each rank keeps its P_store/sp slice
    (P_store must be a multiple of sp, as JAX requires); a rank holds its
    tp slice of the heads."""
    prefix_ids = np.asarray(prefix_ids, np.int64).reshape(-1)
    P_true = int(prefix_ids.shape[0])
    P_store = -(-P_true // 128) * 128
    cfg = model.config
    mesh = mesh_of(model)
    sp = 1 if mesh is None else mesh.sp
    if P_store % sp:
        raise ValueError(f"prefix storage length {P_store} must be a multiple of sp={sp} "
                         "(prefix builds pad to kernel/mesh multiples)")
    chunk = int(min(chunk, P_store))
    padded = -(-P_true // chunk) * chunk
    builder = _with_config(model, prefix_len=0, prefix_tokens=0, attn_impl="auto",
                           max_sequence_length=max(cfg.max_sequence_length, padded),
                           sp_slot_caches=sp > 1)
    dev = model.wte.weight.device
    length = -(-max(P_store, padded) // sp) * sp
    cache = builder.init_cache(1, length)
    ids = torch.zeros(padded, dtype=torch.long)
    ids[:P_true] = torch.from_numpy(prefix_ids)
    vm = _padded_masks(prefix_vision_masks, padded, dev)
    keys = torch.arange(length, device=dev)[None]
    for done in range(0, padded, chunk):
        cache.index = done
        builder(ids[done:done + chunk].to(dev)[None], keys < done + chunk,
                (torch.arange(chunk, device=dev) + done)[None], cache=cache,
                vision_masks=None if vm is None else vm[:, done:done + chunk])
    if length > P_store or sp > 1:
        n = P_store // sp
        for c in cache.layers:
            for name in ("k", "v", "k_scale", "v_scale"):
                t = getattr(c, name)
                if t is not None:   # a layer at a time: the whole block, cut, this rank's slice
                    if sp > 1:
                        t = mesh.gather_sequence(t.transpose(1, 2)).transpose(1, 2)
                    r = 0 if mesh is None else mesh.sp_rank
                    setattr(c, name, t[:, :, r * n:(r + 1) * n].clone())
    cache.index = padded
    cache.sp = 1
    return cache, P_store, P_true


_LEAVES = {"cached_key": "k", "cached_key_scale": "k_scale", "cached_value": "v",
           "cached_value_scale": "v_scale"}


def _whole_block(t, mesh):
    """A prefix leaf [1, h_kv(/tp), P(/sp), ...] gathered whole."""
    if mesh is None:
        return t
    t = mesh.all_gather(t, "tp", 1)
    return mesh.gather_sequence(t.transpose(1, 2)).transpose(1, 2)


def save_prefix_cache(path, cache, P_store, P_true, mesh=None):
    """Persist a built prefix block (a document index) in the JAX
    package's stream format and tree names (`lwm_tpu/serve.py:203-215`):
    prefix/transformer/h/{i}/attention/{cache_index, cached_key, ...}, then
    prefix_store and prefix_tokens, the leaves in the JAX tree's order. On
    a mesh every rank gathers the whole block, a leaf at a time, and rank 0
    writes it."""
    flat = {}
    for i in sorted(range(len(cache.layers)), key=str):
        c, at = cache.layers[i], ("prefix", "transformer", "h", str(i), "attention")
        flat[at + ("cache_index",)] = np.asarray(cache.index, np.int32)
        for leaf, name in _LEAVES.items():
            if getattr(c, name) is not None:
                flat[at + (leaf,)] = _whole_block(getattr(c, name), mesh)
    flat[("prefix_store",)] = np.asarray(P_store, np.int32)
    flat[("prefix_tokens",)] = np.asarray(P_true, np.int32)
    if mesh is None or mesh.is_rank0:
        checkpoint.save_stream(flat, path)


def load_prefix_cache(path, device, dtype, mesh=None):
    """Inverse of `save_prefix_cache` (and of the JAX one) → (KVCache of one
    row on `device`, P_store, P_true); float leaves cast to `dtype`. On a
    mesh, this rank's slice: its tp heads and, with sp > 1, its P_store/sp
    positions."""
    tree = checkpoint.load_checkpoint(path)
    try:
        h = tree["prefix"]["transformer"]["h"]
        layers = [h[str(i)]["attention"] for i in range(len(h))]
    except KeyError as e:
        raise ValueError(f"{path}: not an unscanned prefix index (missing {e})") from e

    def tensor(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        if mesh is not None:   # this rank's heads and positions
            h, n = t.shape[1] // mesh.tp, t.shape[2] // mesh.sp
            t = t[:, mesh.tp_rank * h:(mesh.tp_rank + 1) * h,
                  mesh.sp_rank * n:(mesh.sp_rank + 1) * n].clone()
        t = t.to(device)
        return t.to(dtype) if t.is_floating_point() and t.dim() == 4 else t   # k, v; not scales

    cache = KVCache([LayerCache(**{name: tensor(a[leaf]) for leaf, name in _LEAVES.items()
                                   if leaf in a}) for a in layers])
    cache.index = int(layers[0]["cache_index"])
    return cache, int(tree["prefix_store"]), int(tree["prefix_tokens"])


# -------------------------------------------------------------------- server

@dataclass
class _Live:
    req_id: int
    emitted: list
    max_new: int
    temperature: float
    prompt: np.ndarray
    on_token: Optional[Callable] = None


@dataclass
class Finished:
    req_id: int
    prompt: np.ndarray
    tokens: np.ndarray          # emitted tokens (stop token included if hit)
    stopped: str                # 'eos' | 'length' | 'cancelled'


class InflightServer:
    """Continuous-batching server over a fixed slot pool.

    model: `LLaMAForCausalLM` (or `VideoLLaMAForCausalLM` with
    sample_mode='text') with config.decode_index='per_row'. Sampling
    draws from a `torch.Generator` on the model's device seeded by `seed`,
    so sampled rows repeat under one seed (they cannot match JAX's RNG;
    greedy rows match the JAX server token for token). The serving modes
    are those of the module note."""

    def __init__(
        self, model, *, slots=8, cache_len=4096, prompt_buckets=(128, 512, 2048),
        stop_tokens=(), seed=0, prefix_ids=None, prefix_chunk=2048, prefix_vision_masks=None,
        prefix_cache_path="", lookup_k=0, lookup_ngram=3, admit_chunk=0, mesh=None,
    ):
        if mesh is not None and mesh.size > 1 and model.mesh is not mesh:
            raise ValueError("the server's mesh must be its model's: build the model on it "
                             "(LLaMAForCausalLM(config, mesh=mesh), or on_tensors with mesh=)")
        mesh = mesh_of(model)
        if mesh is not None and model.takes_vision_masks:
            raise NotImplementedError("VideoLLaMA pools on a mesh come with a later multi-GPU "
                                      "slice (ROADMAP A4): serve them on one device")
        cfg = model.config
        if cfg.decode_index != "per_row":
            raise ValueError(
                "InflightServer needs LLaMAConfig(decode_index='per_row') — "
                "slots decode at different depths in one batch"
            )
        self.vision = model.takes_vision_masks
        if self.vision and cfg.sample_mode != "text":
            raise ValueError(
                "serving VideoLLaMA needs sample_mode='text' (answers are "
                "text; the video rides in the shared prefix — pass "
                "prefix_vision_masks)"
            )
        if not self.vision and prefix_vision_masks is not None:
            raise ValueError("prefix_vision_masks need a VideoLLaMA model")
        # cache rounding as in lwm_tpu/serve.py:405-437: a 1024 multiple,
        # else a 128 multiple when that would outgrow the RoPE table (a
        # prefix model raises the table, so only a plain pool is refused)
        requested = cache_len
        cache_len = -(-cache_len // 1024) * 1024
        loads_index = bool(prefix_cache_path) and os.path.exists(prefix_cache_path)
        has_prefix = loads_index or (prefix_ids is not None and len(prefix_ids) > 0)
        if cache_len > cfg.max_sequence_length:
            cache_len = -(-requested // 128) * 128
        if not has_prefix and cache_len > cfg.max_sequence_length:
            raise ValueError(
                f"cache_len {requested} (rounded to {cache_len}) exceeds the "
                f"model's max_sequence_length {cfg.max_sequence_length}"
            )
        self.device = model.wte.weight.device
        self._pos0 = 0
        prefix = None
        if loads_index:
            # a persisted document index: no build
            prefix, P_store, P_true = load_prefix_cache(prefix_cache_path, self.device,
                                                        model.dtype, mesh)
            if prefix_ids is not None and len(prefix_ids) != P_true:
                raise ValueError(
                    f"prefix cache at {prefix_cache_path} was built for {P_true} tokens, "
                    f"but prefix_ids has {len(prefix_ids)} — stale index?"
                )
        elif has_prefix:
            prefix, P_store, P_true = build_prefix_cache(model, prefix_ids, prefix_chunk,
                                                         prefix_vision_masks)
            if prefix_cache_path:
                save_prefix_cache(prefix_cache_path, prefix, P_store, P_true, mesh)
        if prefix is not None:
            model = _with_config(
                model, prefix_len=P_store, prefix_tokens=P_true,
                max_sequence_length=max(cfg.max_sequence_length, P_true + cache_len),
            )
            self._pos0 = P_true
        self._shards = 1 if mesh is None else mesh.batch
        if slots % self._shards:
            raise ValueError(f"slots={slots} must be a multiple of dp*fsdp={self._shards}")
        if mesh is not None and mesh.sp > 1 and prefix is None:
            # no shared prefix: sp splits each slot's cache (`lwm_tpu/serve.py:
            # 486-515`); the routed write unrolls a verify block a token at a time
            if lookup_k > 63:
                raise ValueError("sp>1 per-slot caches support lookup_k <= 63 (the routed cache "
                                 "write unrolls the 1+k verify block per token)")
            if cache_len % mesh.sp:
                raise ValueError(f"cache_len {cache_len} must divide the sp axis ({mesh.sp}) for "
                                 "sp-sharded slot caches")
            if not model.config.sp_slot_caches:
                model = _with_config(model, sp_slot_caches=True)
        self.mesh = mesh
        self._local = slots // self._shards               # this rank's slots
        self._first = 0 if mesh is None else mesh.batch_rank * self._local
        self._prefix = None if prefix is None else prefix.layers
        self._prefix_np = (np.asarray(prefix_ids, np.int64).reshape(-1)
                           if prefix_ids is not None else np.zeros(0, np.int64))
        self.lookup_k = int(lookup_k)
        self.lookup_ngram = int(lookup_ngram)
        self.admit_chunk = int(admit_chunk)
        self.model = model
        self.slots = slots
        self.cache_len = cache_len
        self.prompt_buckets = tuple(sorted(b for b in prompt_buckets if b <= cache_len))
        self.stop_tokens = set(int(t) for t in stop_tokens)
        self.cache = model.init_cache(self._local, cache_len, prefix=self._prefix)
        self.lengths = np.zeros(slots, np.int64)
        self.tokens = np.zeros(slots, np.int64)   # last emitted, per slot
        self.live: list[Optional[_Live]] = [None] * slots
        self.queue = deque()
        self._pending = {}                          # slot → staged chunked admission
        self.finished: list[Finished] = []
        self._next_id = 0
        self._step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = dict(rounds=0, admitted=0, emitted=0, accepted=0, spec_rows=0,
                          prefill_s=0.0, decode_s=0.0)

    def _pick(self, logits, tau):
        """Greedy where tau == 0, else a sample at temperature tau
        (`lwm_tpu/serve.py:564-571`). logits [n, vocab] fp32, tau [n]."""
        greedy = logits.argmax(-1)
        if not bool((tau > 0).any()):
            return greedy
        probs = torch.softmax(logits / tau.clamp_min(1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        return torch.where(tau > 0, sampled, greedy)

    def _tau(self, temps):
        return torch.tensor(temps, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- host API

    def submit(self, prompt_ids, max_new_tokens, temperature=0.0, on_token=None,
               vision_masks=None):
        """Queue a request; returns its id. Greedy when temperature == 0.
        on_token(req_id, token) streams each kept token in order.
        vision_masks (VideoLLaMA pools): bool a prompt token, True where it
        is a VQ code embedded through `vte`, so a request carries its own
        video inline; the generated tokens are text."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if vision_masks is not None:
            if not self.vision:
                raise ValueError("vision_masks need a VideoLLaMA pool")
            vision_masks = np.asarray(vision_masks, bool).reshape(-1)
            if vision_masks.shape != prompt.shape:
                raise ValueError(
                    f"vision_masks length {vision_masks.shape[0]} != "
                    f"prompt length {prompt.shape[0]}"
                )
        if len(prompt) + max_new_tokens + self.lookup_k > self.cache_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} "
                + (f"+ lookup_k {self.lookup_k} " if self.lookup_k else "")
                + f"exceeds cache_len {self.cache_len}"
            )
        if not (self.admit_chunk and len(prompt) > self.admit_chunk):
            _bucket(len(prompt), self.prompt_buckets)  # validate at submit
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, int(max_new_tokens), float(temperature), on_token,
                           vision_masks))
        return rid

    def _start(self, slot, rid, prompt, max_new, temp, on_token, tok):
        """A request's first token is out: the slot goes live."""
        self.stats["admitted"] += 1
        self.stats["emitted"] += 1
        self.live[slot] = _Live(rid, [tok], max_new, temp, prompt, on_token)
        self._notify(self.live[slot], [tok])
        self.lengths[slot] = len(prompt)
        self.tokens[slot] = tok
        self._retire(slot)  # max_new == 1 or an instant stop token

    def _admit(self):
        for slot in range(self.slots):
            if self.live[slot] is not None or slot in self._pending or not self.queue:
                continue
            rid, prompt, max_new, temp, on_token, vmask = self.queue.popleft()
            if self.admit_chunk and len(prompt) > self.admit_chunk:
                # staged: one admit_chunk piece a step, the decode rounds between
                C = self.admit_chunk
                ids = np.zeros(-(-len(prompt) // C) * C, np.int64)
                ids[:len(prompt)] = prompt
                self._pending[slot] = dict(
                    rid=rid, prompt=prompt, max_new=max_new, temp=temp, on_token=on_token,
                    ids=ids, vm=_padded_masks(vmask, len(ids), self.device), done=0,
                    small=(self.model.init_cache(1, self.cache_len, prefix=self._prefix)
                           if self._mine(slot) else None),
                )
                continue
            bucket = _bucket(len(prompt), self.prompt_buckets)
            t0 = time.perf_counter()
            tok = torch.zeros(1, dtype=torch.long, device=self.device)
            if self._mine(slot):
                logits = prefill_logits(self.model, self.cache.slot(slot - self._first), prompt,
                                        bucket, self._pos0, vmask)
                tok = self._pick(logits[None], self._tau([temp]))
            tok = int(self._share(tok, slot)[0])
            self.stats["prefill_s"] += time.perf_counter() - t0
            self._start(slot, rid, prompt, max_new, temp, on_token, tok)

    def _mine(self, slot):
        """Whether this rank holds `slot`'s cache row."""
        return self._first <= slot < self._first + self._local

    def _picker(self, shard):
        """The rank that picks batch shard `shard`'s tokens: its tp and sp 0."""
        return self.mesh.rank_of(shard // self.mesh.fsdp, shard % self.mesh.fsdp)

    def _share(self, x, slot):
        """x as the picker of `slot`'s batch shard has it, on every rank."""
        if self.mesh is None:
            return x
        return self.mesh.broadcast(x, None, self._picker(slot // self._local))

    def _gather_slots(self, x):
        """x [local slots, ...] → [slots, ...] on every rank: each batch
        shard's rows as its picker has them."""
        if self.mesh is None:
            return x
        every = self.mesh.all_gather(x[None], None, 0)           # [world, local, ...]
        pickers = [self._picker(j) for j in range(self._shards)]
        return every[pickers].reshape(self.slots, *x.shape[1:])

    def _advance_pending(self):
        """One chunk of every staged admission (`lwm_tpu/serve.py:678-785`);
        one that reaches its prompt's end moves into its pool slot and emits
        its first token."""
        C, T, dev = self.admit_chunk, self.cache_len, self.device
        for slot, st in list(self._pending.items()):
            t0 = time.perf_counter()
            done, small, n, vm = st["done"], st["small"], len(st["prompt"]), st["vm"]
            if small is not None:   # the ranks of the slot's batch shard
                small.index = done
                logits = self.model(
                    torch.from_numpy(st["ids"][done:done + C]).to(dev)[None],
                    torch.arange(T, device=dev)[None] < done + C,
                    (torch.arange(C, device=dev) + done + self._pos0)[None], cache=small,
                    vision_masks=None if vm is None else vm[:, done:done + C],
                )
            st["done"] = done + C
            if st["done"] >= n:   # this chunk holds the prompt's last token
                tok = torch.zeros(1, dtype=torch.long, device=dev)
                if small is not None:
                    row = logits[0, n - 1 - done].float()
                    tok = self._pick(row[None], self._tau([st["temp"]]))
                    for big, one in zip(self.cache.layers, small.layers):
                        for name in ("k", "v", "k_scale", "v_scale"):
                            if getattr(big, name) is not None:
                                getattr(big, name)[slot - self._first] = getattr(one, name)[0]
                tok = int(self._share(tok, slot)[0])
                del self._pending[slot]
                self.stats["prefill_s"] += time.perf_counter() - t0
                self._start(slot, st["rid"], st["prompt"], st["max_new"], st["temp"],
                            st["on_token"], tok)
            else:
                self.stats["prefill_s"] += time.perf_counter() - t0

    def _notify(self, live, toks):
        if live.on_token is not None:
            for t in toks:
                live.on_token(live.req_id, int(t))

    def cancel(self, rid):
        """Cancel a queued, staged or live request, finishing it 'cancelled'
        with the tokens already emitted. Returns False if unknown or done."""
        for i, item in enumerate(self.queue):
            if item[0] == rid:
                del self.queue[i]
                self.finished.append(Finished(rid, item[1], np.zeros(0, np.int64), "cancelled"))
                return True
        for slot, st in list(self._pending.items()):
            if st["rid"] == rid:
                del self._pending[slot]
                self.finished.append(
                    Finished(rid, st["prompt"], np.zeros(0, np.int64), "cancelled"))
                return True
        for slot, live in enumerate(self.live):
            if live is not None and live.req_id == rid:
                self.finished.append(
                    Finished(rid, live.prompt, np.asarray(live.emitted, np.int64), "cancelled")
                )
                self._free(slot)
                return True
        return False

    def _free(self, slot):
        self.live[slot] = None
        self.lengths[slot] = 0
        self.tokens[slot] = 0

    def _retire(self, slot):
        """Finish the slot's request if its last token ended it."""
        live = self.live[slot]
        if live is None:
            return
        tok = live.emitted[-1]
        if len(live.emitted) >= live.max_new or tok in self.stop_tokens:
            self.finished.append(Finished(
                req_id=live.req_id, prompt=live.prompt,
                tokens=np.asarray(live.emitted, np.int64),
                stopped="eos" if tok in self.stop_tokens else "length",
            ))
            self._free(slot)

    def step(self):
        """Admit whatever fits, advance staged admissions by a chunk, then
        one decode round for every live slot (a verify round with
        `lookup_k`, which may emit several tokens a slot). Returns the
        requests finished during this step."""
        n_done = len(self.finished)
        self._admit()
        if self._pending:
            self._advance_pending()
        if any(l is not None for l in self.live):
            if self.lookup_k:
                self._spec_round()
            else:
                self._decode_round()
            self._step += 1
        return self.finished[n_done:]

    def _forward(self, toks, width):
        """One forward of `width` tokens a slot at each slot's frontier:
        positions lengths .. lengths + width − 1 (after the prefix), keys
        valid through each row's last position. Returns fp32 logits
        [slots, width, vocab]."""
        dev, T = self.device, self.cache_len
        mine = slice(self._first, self._first + self._local)   # this rank's rows
        lengths = torch.as_tensor(self.lengths[mine], device=dev)
        mask = torch.arange(T, device=dev)[None] <= lengths[:, None] + width - 1
        pos = lengths[:, None] + torch.arange(width, device=dev)[None] + self._pos0
        self.cache.index = int(self.lengths.max())
        return self.model(torch.as_tensor(toks[mine], device=dev), mask, pos,
                          cache=self.cache).float()

    def _decode_round(self):
        """All slots decode one token (`lwm_tpu/serve.py:553-572, 946-971`);
        idle slots ride along at length 0 and their output is dropped."""
        tau = self._tau([l.temperature if l else 0.0 for l in self.live])
        t0 = time.perf_counter()
        logits = self._forward(self.tokens[:, None], 1)
        mine = slice(self._first, self._first + self._local)
        nxt = self._gather_slots(self._pick(logits[:, 0], tau[mine])).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["rounds"] += 1
        for slot, live in enumerate(self.live):
            if live is not None:
                self._emit(slot, [int(nxt[slot])], 0)

    def _spec_round(self):
        """One verify round (`lwm_tpu/serve.py:973-1025`): per-slot lookup
        proposals, one forward of 1 + k tokens a slot, per-slot acceptance;
        a greedy row emits its accepted proposals and the target's next
        token. A row without a proposal repeats its frontier token, which
        is accepted only where it is the greedy token."""
        K = self.lookup_k
        temps = [l.temperature if l else 0.0 for l in self.live]
        toks = np.zeros((self.slots, 1 + K), np.int64)
        toks[:, 0] = self.tokens
        for slot, live in enumerate(self.live):
            if live is None:
                continue
            prop = None
            if live.temperature == 0:
                ctx = np.concatenate([self._prefix_np, live.prompt,
                                      np.asarray(live.emitted, np.int64)])
                prop = _lookup_proposal(ctx, K, self.lookup_ngram)
            toks[slot, 1:] = prop if prop is not None else self.tokens[slot]
        mine = slice(self._first, self._first + self._local)
        tau = self._tau(temps)[mine]
        t0 = time.perf_counter()
        logits = self._forward(toks, 1 + K)
        greedy = logits.argmax(-1)                                  # [S, 1 + K]
        match = (greedy[:, :K] == torch.as_tensor(toks[mine, 1:], device=self.device)).long()
        n_acc = torch.where(tau > 0, 0, match.cumprod(1).sum(1))
        greedy[:, 0] = self._pick(logits[:, 0], tau)     # sampled rows emit their sample
        both = self._gather_slots(torch.cat([greedy, n_acc[:, None]], 1)).cpu().numpy()
        greedy, n_acc = both[:, :-1], both[:, -1]
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["rounds"] += 1
        for slot, live in enumerate(self.live):
            if live is None:
                continue
            kept = min(int(n_acc[slot]) + 1, live.max_new - len(live.emitted))
            new = [int(t) for t in greedy[slot, :kept]]
            for j, t in enumerate(new):        # a stop token ends the row
                if t in self.stop_tokens:
                    new = new[: j + 1]
                    break
            if live.temperature == 0:
                self.stats["spec_rows"] += 1
                self.stats["accepted"] += int(n_acc[slot])
            self._emit(slot, new, K)

    def _emit(self, slot, new, headroom):
        """Append a round's tokens to a live slot, finish it if they end it."""
        live = self.live[slot]
        self.stats["emitted"] += len(new)
        live.emitted.extend(new)
        self._notify(live, new)
        self.lengths[slot] += len(new)
        self.tokens[slot] = new[-1]
        if self.lengths[slot] + 1 + headroom >= self.cache_len:
            live.max_new = len(live.emitted)  # out of cache: finish
        self._retire(slot)

    def run(self):
        """Drive until the queue, the staged admissions and all slots drain;
        returns all finished requests in completion order."""
        while self.busy():
            self.step()
        return self.finished

    def busy(self):
        """Whether a request is queued, staged or live."""
        return bool(self.queue or self._pending or any(l is not None for l in self.live))

    def stats_line(self):
        """One-line host-observed summary (tokens/round, phase walls, lookup
        acceptance when verifying)."""
        s = self.stats
        parts = [
            f"{s['admitted']} reqs",
            f"{s['emitted']} tokens in {s['rounds']} rounds"
            + (f" ({s['emitted'] / s['rounds']:.2f} tok/round)" if s["rounds"] else ""),
            f"prefill {s['prefill_s']:.2f}s",
            f"decode {s['decode_s']:.2f}s",
        ]
        if s["spec_rows"]:
            parts.append(f"lookup acceptance {s['accepted'] / s['spec_rows']:.2f}/{self.lookup_k}")
        return ", ".join(parts)
