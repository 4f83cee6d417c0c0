"""Speculative decoding: a draft proposes k tokens a round, the target
verifies them in one forward, and every emitted token is the target's own.

Counterpart of `lwm_tpu/speculative.py`. Greedy mode emits, for any draft,
exactly the target's plain greedy tokens; sampling mode (`temperature`) is
rejection-sampling speculative decoding: the draft proposes x ~ p_d, the
target accepts it with probability min(1, p_t(x) / p_d(x)), and a rejection
emits a sample of normalize(max(p_t − p_d, 0)), so each emitted token is
distributed as plain warped sampling from the target (the
speculative-sampling lemma). The warp (temperature, then top-k) applies to
both models' logits alike. `prompt_lookup_generate` is the draft-free
variant: the proposals continue the most recent earlier occurrence of the
trailing n-gram in the sequence itself (a delta distribution in sampling
mode).

What moved from the device to the host: the JAX runner is one jitted
`lax.while_loop`; here each round is a host loop over the models' forwards
(`LLaMAForCausalLM` or a subclass, with `decode_index="shared"`), and the
host reads the round's acceptance length before the next round. The rest
is kept as the reference has it:
- both models are prefilled on the prompt into their own shared-index
  caches of `cache_len` slots (default prompt + new + k + 1 rounded up to
  1024); every forward takes an all-ones mask [b, cache_len] and explicit
  position ids;
- the draft takes k + 1 one-token steps a round (K4 on the card), the last
  only to write its own last proposal into its cache (at full acceptance
  the next round starts past it);
- the target verifies the k + 1 tokens at positions n .. n + k in one
  forward with all k + 1 logits (K1 over the cache, q_offset = the cache
  index);
- n ← n + m + 1 and both caches are rewound to n by setting `KVCache.index`
  (the twin of JAX's `cache_index` leaves): rows past it are stale, and
  every bound that hides them (K1's causal frontier, K4's `kv_len`, the
  mask's frontier) comes from the index;
- batched rows run in lockstep: a round accepts the smallest match length
  of its rows (greedy only; sampling mode is batch 1).

The models hold their own weights, so the JAX functions' `*_params`
arguments are gone; `prng_key` becomes an explicit `torch.Generator` on the
models' device. The port draws its own numbers, so sampled tokens agree
with JAX only where the draw is forced.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class SpecResult:
    sequences: torch.Tensor   # [b, prompt + max_new_tokens] int64
    accepted: int             # draft tokens accepted in all
    steps: int                # verify forwards


def make_warp_fn(temperature: float, top_k: Optional[int]):
    """The warp of both models' logits (`lwm_tpu/speculative.py:103-115`):
    divide by the temperature, then keep the top_k largest (None or 0: no
    truncation), the rest -inf. No top-p."""

    def warp(logits):
        logits = logits / temperature
        if top_k:
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, -float("inf"), logits)
        return logits

    return warp


def accept_and_emit(generator, proposals, d_probs, t_probs):
    """The rejection-sampling rule of one round (`lwm_tpu/speculative.py:
    117-144`). proposals [k]: the draft's tokens for positions 1 .. k;
    d_probs [k, V]: the distributions they were drawn from; t_probs
    [k + 1, V]: the target's at positions 1 .. k + 1. Returns (m, c): m in
    [0, k] the proposals accepted (the first rejection), c the token
    emitted at position m + 1: a draw from the residual max(t − d, 0) after
    a rejection, the target's bonus draw after full acceptance."""
    k = proposals.shape[0]
    idx = torch.arange(k, device=proposals.device)
    p_t = t_probs[idx, proposals]
    p_d = d_probs[idx, proposals]
    u = torch.rand(k, generator=generator, device=proposals.device)
    accept = u * p_d < p_t
    m = int(accept.long().cumprod(0).sum())
    # JAX draws from log(w + 1e-30): an all-zero residual stays drawable
    weights = (t_probs[m] - d_probs[m]).clamp_min(0.0) if m < k else t_probs[k]
    c = torch.multinomial(weights + 1e-30, 1, generator=generator)[0]
    return m, c


def _accept_scatter(sampling, warp, k, generator, n, seq, drafts, logits, d_probs):
    """After the verify (`lwm_tpu/speculative.py:147-181`): the round's
    acceptance m (greedy: the lockstep minimum over rows of each row's
    match length; sampling: `accept_and_emit`), the target's token at m,
    and the m + 1 emitted tokens written into seq at n + 1 .. n + 1 + m.
    Returns (new_tok [b], m)."""
    b = drafts.shape[0]
    if sampling:
        t_probs = torch.softmax(warp(logits[0].float()), -1)
        m, c = accept_and_emit(generator, drafts[0, 1:], d_probs, t_probs)
        t_at_m = c.expand(b)
    else:
        t_next = logits.argmax(-1)               # [b, k + 1]: the target's tokens at n + 1 ..
        match = drafts[:, 1:] == t_next[:, :-1]  # [b, k]
        m = int(match.long().cumprod(1).sum(1).min())   # the prefix every row verified
        t_at_m = t_next[:, m]
    seq[:, n + 1:n + 1 + m] = drafts[:, 1:1 + m]
    seq[:, n + 1 + m] = t_at_m
    return t_at_m, m


def _lookup_proposals(seq, n, tok, k, ngram):
    """Draft-free proposals (`lwm_tpu/speculative.py:184-209`): the k tokens
    that followed the most recent occurrence, strictly before the current
    one, of the trailing n-gram seq[:, n − g + 1 .. n]. A row with no
    occurrence proposes `tok` k times; past the frontier seq holds zeros,
    so an overlong continuation proposes zeros (the verify rejects them)."""
    b, L = seq.shape
    g = ngram
    idx = torch.arange(L, device=seq.device)
    key = seq[:, n - g + 1:n + 1]                                    # [b, g]
    eq = torch.ones((b, L), dtype=torch.bool, device=seq.device)
    for j in range(g):
        eq &= torch.roll(seq, -j, dims=1) == key[:, j:j + 1]
    # an occurrence ends at s + g − 1 ≤ n − 1: the trailing one is excluded
    score = torch.where(eq & (idx[None] <= n - g), idx[None], -1)
    s_best = score.max(1).values                                     # [b]
    at = (s_best[:, None] + g + torch.arange(k, device=seq.device)[None]).clamp(0, L - 1)
    proposals = torch.gather(seq, 1, at)
    return torch.where((s_best >= 0)[:, None], proposals, tok[:, None].expand(b, k))


def _cache_len(prompt, max_new_tokens, k, cache_len):
    """Room for one overshooting round, rounded up to 1024 when not given
    (`lwm_tpu/speculative.py:246-249`)."""
    need = prompt + max_new_tokens + k + 1
    if cache_len is None:
        cache_len = -(-need // 1024) * 1024
    if cache_len < need:
        raise ValueError(f"cache_len {cache_len} < prompt + max_new_tokens + k + 1 = {need}")
    return cache_len


@torch.no_grad()
def _run(target_model, draft_model, ids, max_new_tokens, k, ngram, cache_len, temperature,
         top_k, generator):
    """The round loop of both entry points (the JAX runners
    `make_speculative_fn`, `lwm_tpu/speculative.py:225-360`, and
    `make_prompt_lookup_fn`, `:363-454`); `draft_model` None proposes by
    prompt lookup. ids [b, prompt] → SpecResult."""
    b, prompt = ids.shape
    sampling = temperature is not None
    if sampling and b != 1:
        raise ValueError("sampling mode is batch-1 (lockstep truncation would bias it)")
    if draft_model is None and prompt < ngram:
        raise ValueError(f"prompt {prompt} shorter than the n-gram {ngram}")
    cache_len = _cache_len(prompt, max_new_tokens, k, cache_len)
    models = (target_model,) if draft_model is None else (target_model, draft_model)
    for model in models:
        if model.config.decode_index != "shared":
            raise ValueError("speculative decoding runs on shared-index caches: "
                             "decode_index='shared'")
    warp = make_warp_fn(temperature, top_k) if sampling else None
    vocab = target_model.config.vocab_size
    end = prompt + max_new_tokens
    dev = ids.device

    def pick(logits):
        """The next token of each row from logits [b, V], with its (warped)
        distribution in sampling mode."""
        if not sampling:
            return logits.argmax(-1), None
        probs = torch.softmax(warp(logits.float()), -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0], probs

    # every forward takes an all-ones mask and explicit positions
    # (`_decode_fn`, `lwm_tpu/speculative.py:84-100`)
    ones = torch.ones((b, cache_len), dtype=torch.bool, device=dev)
    caches = [m.init_cache(b, cache_len) for m in models]
    seq = torch.zeros((b, cache_len), dtype=torch.long, device=dev)
    seq[:, :prompt] = ids
    pos = torch.arange(prompt, device=dev).expand(b, prompt)
    # each cache now holds [0, prompt); the target's last logits give the
    # (final) token at `prompt`
    logits = [m(ids, ones, pos, c, logits_tail=1) for m, c in zip(models, caches)][0]
    tok = pick(logits[:, -1])[0]
    seq[:, prompt] = tok
    steps = torch.arange(k + 1, device=dev)
    n, accepted, rounds = prompt, 0, 0
    # invariant: every cache holds [0, n); seq[:, :n + 1] is final
    while n < end:
        drafts = torch.zeros((b, k + 2), dtype=torch.long, device=dev)
        drafts[:, 0] = tok
        if draft_model is None:
            drafts[:, 1:k + 1] = _lookup_proposals(seq, n, tok, k, ngram)
            # a lookup proposal is a delta distribution
            d_probs = (torch.nn.functional.one_hot(drafts[0, 1:k + 1], vocab).float()
                       if sampling else None)
        else:
            # k + 1 draft steps: the last writes the draft's own last
            # proposal into its cache, so that a fully accepted round's
            # successor never reads an unwritten row
            d_probs = torch.zeros((k, vocab), device=dev) if sampling else None
            for j in range(k + 1):
                logits = draft_model(drafts[:, j:j + 1], ones,
                                     torch.full((b, 1), n + j, device=dev), caches[1])
                drafts[:, j + 1], probs = pick(logits[:, -1])
                if sampling and j < k:
                    d_probs[j] = probs[0]
        drafts = drafts[:, :k + 1]
        # one target forward over the k + 1 tokens at n .. n + k, every
        # position's logits kept
        logits = target_model(drafts, ones, (n + steps).expand(b, k + 1), caches[0],
                              logits_tail=0)
        tok, m = _accept_scatter(sampling, warp, k, generator, n, seq, drafts, logits, d_probs)
        n += m + 1
        for cache in caches:   # rewind to [0, n)
            cache.index = n
        accepted += m
        rounds += 1
    return SpecResult(seq[:, :end], accepted, rounds)


def prompt_lookup_generate(target_model, input_ids, max_new_tokens, k=7, ngram=3,
                           cache_len=None, temperature=None, top_k=None, generator=None):
    """Draft-free speculative decoding (`lwm_tpu/speculative.py:457-487`):
    the same contracts as `speculative_generate` (greedy token-exact;
    sampling distribution-exact, batch 1)."""
    return _run(target_model, None, input_ids, max_new_tokens, k, ngram, cache_len,
                temperature, top_k, generator)


def speculative_generate(target_model, draft_model, input_ids, max_new_tokens, k=7,
                         cache_len=None, temperature=None, top_k=None, generator=None):
    """Speculative decoding (`lwm_tpu/speculative.py:490-530`). Greedy by
    default: `sequences` equal plain greedy decoding with the target alone.
    With `temperature` (and `top_k`): rejection-sampling mode, batch 1,
    drawing from `generator`. input_ids [b, prompt] (no padding: rows run
    in lockstep). The two models keep separate caches, so the draft may be
    any architecture (GQA, an int8 cache). Returns a SpecResult."""
    return _run(target_model, draft_model, input_ids, max_new_tokens, k, None, cache_len,
                temperature, top_k, generator)
