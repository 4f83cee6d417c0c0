"""The striped sequence layout (Striped Attention, arXiv:2311.09431): the
port's own copy of `lwm_tpu/ops/striped.py`.

With contiguous sp shards a causal ring is unbalanced: at ring step t an sp
rank either attends over a whole block or skips it. The striped layout gives
sp rank i the positions {i, i + sp, i + 2·sp, …}, so every (rank, step)
pair carries a block about half masked.

Global slot j (the order the batch is fed in) holds the token at position
p(j) = (j // s_local) + (j % s_local)·sp: rank i's local slot r holds
position i + r·sp. The loader permutes tokens, targets and masks once; the
model's position ids carry the true positions, so RoPE and the causal mask
are exact, and the loss, a sum over tokens, is that of the contiguous layout.
"""

from __future__ import annotations

import numpy as np
import torch


def stripe_positions(seq_length: int, sp: int) -> np.ndarray:
    """positions[j] = the token position held at global slot j."""
    if seq_length % sp:
        raise ValueError(f"sequence length {seq_length} is not a multiple of sp {sp}")
    sq_local = seq_length // sp
    j = np.arange(seq_length)
    return (j // sq_local) + (j % sq_local) * sp


def _take(array, idx, axis):
    if isinstance(array, torch.Tensor):
        return torch.index_select(array, axis, torch.as_tensor(idx, device=array.device))
    return np.take(array, idx, axis=axis)


def stripe_permute(array, sp: int, axis: int = -1):
    """A contiguous-position array (numpy or torch) in the striped slot
    order: out[..., j, ...] = array[..., positions[j], ...]."""
    return _take(array, stripe_positions(array.shape[axis], sp), axis)


def stripe_unpermute(array, sp: int, axis: int = -1):
    """The inverse of stripe_permute (slot order → position order)."""
    positions = stripe_positions(array.shape[axis], sp)
    inverse = np.empty_like(positions)
    inverse[positions] = np.arange(len(positions))
    return _take(array, inverse, axis)
