"""Loss and metric primitives of the train step (`lwm_tpu/utils/losses.py:8-144`).

`cross_entropy_loss_and_accuracy` reads full logits (the default train
step); `dual_cross_entropy` is the VideoLLaMA step's pair of them
(`lwm_tpu/train.py:273-296`); `fused_lm_cross_entropy` (`--fused_lm_loss`) computes the lm_head
product inside the loss, one rematerialized sequence chunk at a time, so
the [b, s, vocab] logits never exist.

On a mesh (`mesh`, a `parallel.mesh.Mesh`; each rank holding its rows of
the batch, split over dp × fsdp, and its sp slice of the sequence) each
loss sums a row's target log-probs, correct argmaxes and counted tokens
locally, sums them over the sp ranks, takes each row's mean and sums the
rows over the batch group (dp × fsdp; each tp group counts its rows once):
the value, on every rank, is the one-device mean over all rows. The sums pass their
gradient straight through (`SumOverRanks`), so each rank's backward gives
the gradient of that one value with respect to its own tokens, and the
trainer's sum of the ranks' gradients is the one-device gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) over a process group whose gradient is passed
    through: every rank goes on to compute the same function of the sum, so
    each one's share of the gradient is the sum's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _mean_over_rows(log_prob_sum, correct_sum, valid, mesh=None):
    """(loss, accuracy): each row's masked mean, then the mean over rows,
    over the whole mesh's rows and sequence when `mesh` has several ranks."""
    count = valid.sum(-1)
    if mesh is not None and mesh.sp > 1:
        log_prob_sum, correct_sum, count = SumOverRanks.apply(
            torch.stack([log_prob_sum, correct_sum, count]), mesh.group("sp"))
    count = count.clamp_min(1e-10)
    loss_rows, acc_rows = -(log_prob_sum / count), correct_sum / count
    if mesh is None or mesh.batch == 1:
        return loss_rows.mean(), acc_rows.mean()
    total = SumOverRanks.apply(torch.stack([loss_rows.sum(), acc_rows.sum()]),
                               mesh.group("batch"))
    total = total / (loss_rows.shape[0] * mesh.batch)
    return total[0], total[1]


def _chunk_stats(logits, tokens, valid):
    """Per-row sums of the masked target log-probs and of correct argmaxes,
    from fp32 log-softmax of the logits (any float dtype)."""
    logits = logits.float()
    token_log_prob = F.log_softmax(logits, dim=-1).gather(-1, tokens[..., None])[..., 0]
    token_log_prob = torch.where(valid > 0.0, token_log_prob, 0.0)
    correct = (valid > 0.0) & (logits.argmax(-1) == tokens)
    return token_log_prob.sum(-1), correct.sum(-1).float()


# the most rows the dual loss takes its fp32 log-softmax over at once
DUAL_PIECE_ROWS = 2048


def cross_entropy_loss_and_accuracy(logits, tokens, valid=None, chunk_size=None,
                                    max_piece=None, mesh=None):
    """Masked mean cross-entropy and accuracy: each row's masked mean, then
    the mean over rows. logits [b, s, vocab]; tokens [b, s] int; valid [b, s]
    (1.0 = counted) or None. With chunk_size dividing s (and below it), the
    sequence goes in chunks whose log-softmax is recomputed in the backward
    (`jax.checkpoint(nothing_saveable)`), so the fp32 logits never exist at
    full length; otherwise the whole sequence is one chunk. With
    `max_piece`, the chunks are at most that many rows (the last may be
    shorter): the same values, fewer fp32 rows alive at once. On a `mesh`,
    the mean over its ranks' rows and sequence (module note). Returns
    (loss, accuracy) fp32 scalars."""
    tokens = tokens.long()
    if valid is None:
        valid = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    valid = valid.float()
    seq = tokens.shape[1]
    chunk = seq if chunk_size is None or chunk_size >= seq or seq % chunk_size else chunk_size
    if max_piece is not None:
        chunk = min(chunk, max_piece)
    if chunk == seq:
        log_prob_sum, correct_sum = _chunk_stats(logits, tokens, valid)
    else:
        log_prob_sum = correct_sum = 0.0
        for i in range(0, seq, chunk):
            sl = slice(i, i + chunk)
            lp, c = checkpoint(_chunk_stats, logits[:, sl], tokens[:, sl], valid[:, sl],
                               use_reentrant=False)
            log_prob_sum = log_prob_sum + lp
            correct_sum = correct_sum + c
    return _mean_over_rows(log_prob_sum, correct_sum, valid, mesh)


def dual_cross_entropy(vision_logits, text_logits, tokens, valid, target_vision_masks,
                       chunk_size=None, mesh=None):
    """The vision-text loss 0.5 × (vision CE + text CE): the vision head's
    logits on the targets the vision masks mark (the other targets read as
    0 and are masked out), the text head's on the rest, each a
    `cross_entropy_loss_and_accuracy` with `chunk_size`, any chunk longer
    than DUAL_PIECE_ROWS taken in pieces of that many rows (a whole 32768-row
    sequence of both heads' fp32 log-softmax at once peaked a 7b-width step
    at 66.3 GiB and failed on a fragmented cache; the values are the
    same). tokens, valid, target_vision_masks [b, s]. Returns (loss,
    {"vision_loss", "vision_acc", "text_loss", "text_acc"}), fp32 scalars."""
    vision = target_vision_masks.bool()
    valid = valid.float()
    vision_loss, vision_acc = cross_entropy_loss_and_accuracy(
        vision_logits, torch.where(vision, tokens, 0), valid * vision, chunk_size,
        DUAL_PIECE_ROWS, mesh)
    text_loss, text_acc = cross_entropy_loss_and_accuracy(
        text_logits, torch.where(vision, 0, tokens), valid * ~vision, chunk_size,
        DUAL_PIECE_ROWS, mesh)
    return 0.5 * (vision_loss + text_loss), dict(
        vision_loss=vision_loss, vision_acc=vision_acc, text_loss=text_loss, text_acc=text_acc)


def _fused_chunk_stats(hidden, weight, tokens, valid):
    """`_chunk_stats` of the chunk's fp32 logits hidden @ weightᵀ."""
    return _chunk_stats(torch.matmul(hidden.float(), weight.float().t()), tokens, valid)


def fused_lm_cross_entropy(hidden, weight, tokens, valid=None, chunk_size=2048, mesh=None):
    """`cross_entropy_loss_and_accuracy` of the logits hidden @ weightᵀ,
    computed in fp32 one sequence chunk at a time and recomputed in the
    backward (`torch.utils.checkpoint`, the JAX `nothing_saveable` policy),
    so neither pass holds more than one chunk's logits. hidden [b, s, H]
    (any float dtype; the model's ln_f output); weight [vocab, H], the
    lm_head's weight or, when tied, the embedding's, whole (on a mesh the
    model's `head_weight()`: gathered over tp and the shard group, so every
    tp rank computes the one-device loss of its rows); tokens, valid [b, s].
    The chunk is `chunk_size` capped at s, and the whole sequence when it
    does not divide s. Gradients flow to hidden and weight. On a `mesh`,
    the mean over its ranks' rows and sequence. Returns (loss, accuracy)
    fp32 scalars."""
    tokens = tokens.long()
    b, seq = tokens.shape
    if valid is None:
        valid = torch.ones((b, seq), dtype=torch.float32, device=tokens.device)
    valid = valid.float()
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
    return _mean_over_rows(log_prob_sum, correct_sum, valid, mesh)


def global_norm(tensors, placements=None):
    """L2 norm over all tensors, summed in fp32 without a full-size
    temporary. With `placements` (each tensor's `parallel.fsdp.Placement`
    on a mesh) the tensors are this rank's parts of whole leaves: the
    squares of the parts split over the shard group are summed over it,
    those split over tp over tp, and a leaf held whole counts once, so the
    norm is the whole leaves', on every rank."""
    totals = {}   # (over_tp, over_shard) → this rank's sum of squares
    for i, x in enumerate(tensors):
        v = x.detach().reshape(-1).float()
        pl = None if placements is None else placements[i]
        key = (False, False) if pl is None else (pl.over_tp, pl.over_shard)
        sq = torch.dot(v, v)
        totals[key] = sq if key not in totals else totals[key] + sq
    mesh = None if not placements else placements[0].mesh
    if mesh is None:
        return torch.sqrt(sum(totals.values()))
    keys = [(t, s) for t in (False, True) for s in (False, True)]
    zero = next(iter(totals.values())).new_zeros(())
    sums = torch.stack([totals.get(k, zero) for k in keys])
    over_shard = torch.tensor([s for _, s in keys], device=sums.device)
    over_tp = torch.tensor([t for t, _ in keys], device=sums.device)
    if mesh.shard > 1:
        sums = torch.where(over_shard, mesh.all_reduce(sums, "shard"), sums)
    if mesh.tp > 1:
        sums = torch.where(over_tp, mesh.all_reduce(sums, "tp"), sums)
    return torch.sqrt(sums.sum())


def average_metrics(metrics):
    """Mean over a list of metric dicts (the eval loop's aggregation)."""
    return {k: torch.stack([torch.as_tensor(m[k]) for m in metrics]).mean() for k in metrics[0]}
