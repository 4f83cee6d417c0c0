"""Loss and metric primitives of the train step (`lwm_tpu/utils/losses.py:8-144`).

`cross_entropy_loss_and_accuracy` reads full logits (the default train
step); `fused_lm_cross_entropy` (`--fused_lm_loss`) computes the lm_head
product inside the loss, one rematerialized sequence chunk at a time, so
the [b, s, vocab] logits never exist.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_stats(logits, tokens, valid):
    """Per-row sums of the masked target log-probs and of correct argmaxes,
    from fp32 log-softmax of the logits (any float dtype)."""
    logits = logits.float()
    token_log_prob = F.log_softmax(logits, dim=-1).gather(-1, tokens[..., None])[..., 0]
    token_log_prob = torch.where(valid > 0.0, token_log_prob, 0.0)
    correct = (valid > 0.0) & (logits.argmax(-1) == tokens)
    return token_log_prob.sum(-1), correct.sum(-1).float()


def cross_entropy_loss_and_accuracy(logits, tokens, valid=None, chunk_size=None):
    """Masked mean cross-entropy and accuracy: each row's masked mean, then
    the mean over rows. logits [b, s, vocab]; tokens [b, s] int; valid [b, s]
    (1.0 = counted) or None. With chunk_size dividing s (and below it), the
    sequence goes in chunks whose log-softmax is recomputed in the backward
    (`jax.checkpoint(nothing_saveable)`), so the fp32 logits never exist at
    full length. Returns (loss, accuracy) fp32 scalars."""
    tokens = tokens.long()
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    valid = valid.float()
    valid_text_length = valid.sum(-1).clamp_min(1e-10)
    seq = tokens.shape[1]
    if chunk_size is None or chunk_size >= seq or seq % chunk_size:
        log_prob_sum, correct_sum = _chunk_stats(logits, tokens, valid)
    else:
        log_prob_sum = correct_sum = 0.0
        for i in range(0, seq, chunk_size):
            sl = slice(i, i + chunk_size)
            lp, c = checkpoint(_chunk_stats, logits[:, sl], tokens[:, sl], valid[:, sl],
                               use_reentrant=False)
            log_prob_sum = log_prob_sum + lp
            correct_sum = correct_sum + c
    loss = -(log_prob_sum / valid_text_length).mean()
    accuracy = (correct_sum / valid_text_length).mean()
    return loss, accuracy


def _fused_chunk_stats(hidden, weight, tokens, valid):
    """`_chunk_stats` of the chunk's fp32 logits hidden @ weightᵀ."""
    return _chunk_stats(torch.matmul(hidden.float(), weight.float().t()), tokens, valid)


def fused_lm_cross_entropy(hidden, weight, tokens, valid=None, chunk_size=2048):
    """`cross_entropy_loss_and_accuracy` of the logits hidden @ weightᵀ,
    computed in fp32 one sequence chunk at a time and recomputed in the
    backward (`torch.utils.checkpoint`, the JAX `nothing_saveable` policy),
    so neither pass holds more than one chunk's logits. hidden [b, s, H]
    (any float dtype; the model's ln_f output); weight [vocab, H], the
    lm_head's weight or, when tied, the embedding's; tokens, valid [b, s].
    The chunk is `chunk_size` capped at s, and the whole sequence when it
    does not divide s. Gradients flow to hidden and weight. Returns (loss,
    accuracy) fp32 scalars."""
    tokens = tokens.long()
    b, seq = tokens.shape
    if valid is None:
        valid = torch.ones((b, seq), dtype=torch.float32, device=tokens.device)
    valid = valid.float()
    valid_text_length = valid.sum(-1).clamp_min(1e-10)
    chunk = min(chunk_size, seq)
    if seq % chunk:
        chunk = seq
    log_prob_sum = correct_sum = 0.0
    for i in range(0, seq, chunk):
        sl = slice(i, i + chunk)
        lp, c = checkpoint(_fused_chunk_stats, hidden[:, sl], weight, tokens[:, sl],
                           valid[:, sl], use_reentrant=False)
        log_prob_sum = log_prob_sum + lp
        correct_sum = correct_sum + c
    loss = -(log_prob_sum / valid_text_length).mean()
    accuracy = (correct_sum / valid_text_length).mean()
    return loss, accuracy


def global_norm(tensors):
    """L2 norm over all tensors, summed in fp32 without a full-size temporary."""
    total = None
    for x in tensors:
        v = x.detach().reshape(-1).float()
        sq = torch.dot(v, v)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def average_metrics(metrics):
    """Mean over a list of metric dicts (the eval loop's aggregation)."""
    return {k: torch.stack([torch.as_tensor(m[k]) for m in metrics]).mean() for k in metrics[0]}
