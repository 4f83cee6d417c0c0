"""In-flight (continuous) batching over a fixed pool of cache slots.

Counterpart of the plain in-flight path of `lwm_tpu/serve.py`
(`InflightServer`, `:321-1054`): a pool of `slots` cache rows, each at its
own depth; a request is admitted into a free slot the moment one opens, by
a bucketed batch-1 prefill written straight into that slot's cache row; one
decode step then advances every slot at once, with per-row positions and
masks. Greedy rows emit exactly what a batch-1 greedy rollout would.

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

Not ported yet (raise NotImplementedError): shared prefix (`prefix_ids`),
prompt-lookup speculation (`lookup_k`), chunked admission (`admit_chunk`),
meshes, vision prompts.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


def _bucket(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket {buckets[-1]}")


def prefill_logits(model, cache, prompt, bucket):
    """Admission prefill (`lwm_tpu/serve.py:623-673`): run `prompt`, padded
    to `bucket`, through `model` over the batch-1 `cache` (a slot view of
    the pool or a fresh `init_cache(1, T)`), writing its keys at positions
    0.. in place. Returns the fp32 logits [vocab] of the last prompt token.
    The padding rows write junk past the prompt; decode overwrites each
    such position before its mask exposes it."""
    dev = cache.layers[0].k.device
    n = len(prompt)
    ids = torch.zeros((1, bucket), dtype=torch.long)
    ids[0, :n] = torch.as_tensor(np.asarray(prompt, np.int64))
    mask = torch.arange(cache.length, device=dev)[None] < n
    pos = torch.arange(bucket, device=dev)[None]
    cache.index = 0
    logits = model(ids.to(dev), mask, pos, cache=cache)
    return logits[0, n - 1].float()


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

    model: `LLaMAForCausalLM` with config.decode_index='per_row'. Sampling
    draws from a `torch.Generator` on the model's device seeded by `seed`,
    so sampled rows repeat under one seed (they cannot match JAX's RNG;
    greedy rows match the JAX server token for token)."""

    def __init__(
        self, model, *, slots=8, cache_len=4096, prompt_buckets=(128, 512, 2048),
        stop_tokens=(), seed=0, prefix_ids=None, lookup_k=0, admit_chunk=0,
        mesh=None,
    ):
        if prefix_ids is not None or lookup_k or admit_chunk or mesh is not None:
            raise NotImplementedError(
                "the port serves the plain in-flight path: prefix_ids, lookup_k, "
                "admit_chunk and mesh are not ported yet"
            )
        cfg = model.config
        if cfg.decode_index != "per_row":
            raise ValueError(
                "InflightServer needs LLaMAConfig(decode_index='per_row') — "
                "slots decode at different depths in one batch"
            )
        # cache rounding as in lwm_tpu/serve.py:405-420: a 1024 multiple,
        # else a 128 multiple when that would outgrow the RoPE table
        requested = cache_len
        cache_len = -(-cache_len // 1024) * 1024
        if cache_len > cfg.max_sequence_length:
            cache_len = -(-requested // 128) * 128
        if cache_len > cfg.max_sequence_length:
            raise ValueError(
                f"cache_len {requested} (rounded to {cache_len}) exceeds the "
                f"model's max_sequence_length {cfg.max_sequence_length}"
            )
        self.model = model
        self.device = model.wte.weight.device
        self.slots = slots
        self.cache_len = cache_len
        self.prompt_buckets = tuple(sorted(b for b in prompt_buckets if b <= cache_len))
        self.stop_tokens = set(int(t) for t in stop_tokens)
        self.cache = model.init_cache(slots, cache_len)
        self.lengths = np.zeros(slots, np.int64)
        self.tokens = np.zeros(slots, np.int64)   # last emitted, per slot
        self.live: list[Optional[_Live]] = [None] * slots
        self.queue = deque()
        self.finished: list[Finished] = []
        self._next_id = 0
        self._step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = dict(rounds=0, admitted=0, emitted=0, prefill_s=0.0, decode_s=0.0)

    def _pick(self, logits, tau):
        """Greedy where tau == 0, else a sample at temperature tau
        (`lwm_tpu/serve.py:564-571`). logits [n, vocab] fp32, tau [n]."""
        greedy = logits.argmax(-1)
        if not bool((tau > 0).any()):
            return greedy
        probs = torch.softmax(logits / tau.clamp_min(1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        return torch.where(tau > 0, sampled, greedy)

    # ------------------------------------------------------------- host API

    def submit(self, prompt_ids, max_new_tokens, temperature=0.0, on_token=None):
        """Queue a request; returns its id. Greedy when temperature == 0.
        on_token(req_id, token) streams each kept token in order."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        if len(prompt) + max_new_tokens > self.cache_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new_tokens} exceeds cache_len {self.cache_len}"
            )
        _bucket(len(prompt), self.prompt_buckets)  # validate at submit
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, prompt, int(max_new_tokens), float(temperature), on_token))
        return rid

    def _admit(self):
        for slot in range(self.slots):
            if self.live[slot] is not None or not self.queue:
                continue
            rid, prompt, max_new, temp, on_token = self.queue.popleft()
            bucket = _bucket(len(prompt), self.prompt_buckets)
            t0 = time.perf_counter()
            logits = prefill_logits(self.model, self.cache.slot(slot), prompt, bucket)
            tau = torch.tensor([temp], dtype=torch.float32, device=self.device)
            tok = int(self._pick(logits[None], tau)[0])
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["admitted"] += 1
            self.stats["emitted"] += 1
            self.live[slot] = _Live(rid, [tok], max_new, temp, prompt, on_token)
            self._notify(self.live[slot], [tok])
            self.lengths[slot] = len(prompt)
            self.tokens[slot] = tok
            self._retire(slot)  # max_new == 1 or an instant stop token

    def _notify(self, live, toks):
        if live.on_token is not None:
            for t in toks:
                live.on_token(live.req_id, int(t))

    def cancel(self, rid):
        """Cancel a queued or live request, finishing it 'cancelled' with the
        tokens already emitted. Returns False if unknown or done."""
        for i, item in enumerate(self.queue):
            if item[0] == rid:
                del self.queue[i]
                self.finished.append(Finished(rid, item[1], np.zeros(0, np.int64), "cancelled"))
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
        """Admit whatever fits, then one decode round for every live slot.
        Returns the requests finished during this step."""
        n_done = len(self.finished)
        self._admit()
        if any(l is not None for l in self.live):
            self._decode_round()
            self._step += 1
        return self.finished[n_done:]

    def _decode_round(self):
        """All slots decode one token (`lwm_tpu/serve.py:553-572, 946-971`);
        idle slots ride along at length 0 and their output is dropped."""
        dev, T = self.device, self.cache_len
        tau = torch.tensor(
            [l.temperature if l else 0.0 for l in self.live], dtype=torch.float32, device=dev
        )
        t0 = time.perf_counter()
        lengths = torch.as_tensor(self.lengths, device=dev)
        mask = torch.arange(T, device=dev)[None] <= lengths[:, None]
        self.cache.index = int(self.lengths.max())
        logits = self.model(
            torch.as_tensor(self.tokens, device=dev)[:, None], mask, lengths[:, None],
            cache=self.cache,
        )
        nxt = self._pick(logits[:, 0].float(), tau).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["rounds"] += 1
        for slot, live in enumerate(self.live):
            if live is None:
                continue
            tok = int(nxt[slot])
            self.stats["emitted"] += 1
            live.emitted.append(tok)
            self._notify(live, [tok])
            self.lengths[slot] += 1
            self.tokens[slot] = tok
            if self.lengths[slot] + 1 >= self.cache_len:
                live.max_new = len(live.emitted)  # out of cache: finish
            self._retire(slot)

    def run(self):
        """Drive until the queue and all slots drain; returns all finished
        requests in completion order."""
        while self.queue or any(l is not None for l in self.live):
            self.step()
        return self.finished

    def stats_line(self):
        """One-line host-observed summary (tokens/round, phase walls)."""
        s = self.stats
        return ", ".join([
            f"{s['admitted']} reqs",
            f"{s['emitted']} tokens in {s['rounds']} rounds"
            + (f" ({s['emitted'] / s['rounds']:.2f} tok/round)" if s["rounds"] else ""),
            f"prefill {s['prefill_s']:.2f}s",
            f"decode {s['decode_s']:.2f}s",
        ])
