"""Shared-prefix attention for serving: one document prefilled once into a
frozen batch-1 KV block, every slot's cache holding only its own suffix.

Counterpart of `lwm_tpu/ops/prefix.py:38-262`. Softmax over [prefix ++ suffix] is
the merge of the two ranges' flash partials. A decode round reads the
prefix once for the whole pool: every slot's queries fold into the
query-head dim of one batch-1 K4 call ([b, 1, h, d] → [1, 1, h_kv·b·g, d],
kv-head-major), so K4's group becomes b·g (`ops.decode` takes any group).

On a mesh (`decode_with_prefix(..., mesh=)`, `decode_with_prefix_sharded`
of `:150-247`) the prefix block is split over sp: each rank streams its
P/sp slice, the prefix partials merge over sp (`ops.ring.merge_partials`:
a max and a sum of [b, h, 1]-sized stats and of o), and the suffix, whose
slot caches are whole on every sp rank, is computed alike on each. Rows are
this rank's batch shard and heads its tp slice, which need no collective.

Beside the JAX signatures, `decode_prefix_partials` and `decode_with_prefix`
take the prefix's true token count `prefix_tokens` as a host int (on a
mesh, the count within this rank's slice): it is the K4 `kv_len` of the
prefix call (JAX derives it on the device from the mask).
"""

from __future__ import annotations

import torch

from lwm_tpu_torch.ops.decode import flash_decode
from lwm_tpu_torch.ops.reference import MASK_GUARD
from lwm_tpu_torch.ops.ring import merge_partials


def _fold(q, h_kv):
    """[b, 1, h, d] → [1, 1, b·h, d], kv-head-major: folded head
    kvh·(b·g) + row·g + j, which K4's GQA routing (qh // (b·g)) maps back
    to kv head kvh."""
    b, _, h, d = q.shape
    g = h // h_kv
    return q.reshape(b, h_kv, g, d).transpose(0, 1).reshape(1, 1, h_kv * b * g, d)


def _unfold_o(o, b, h_kv, g, d):
    return o.reshape(h_kv, b, g, d).transpose(0, 1).reshape(b, 1, h_kv * g, d)


def _unfold_ml(x, b, h_kv, g):
    return x.reshape(h_kv, b, g).transpose(0, 1).reshape(b, h_kv * g, 1)


def combine_raw_partials(o1, m1, l1, o2, m2, l2):
    """Merge two flash partials in the raw-accumulator convention (o = Σ
    e^{s−m}·v, l = Σ e^{s−m}): o [b, sq, h, d], m and l [b, h, sq], fp32.
    Returns the normalized output [b, sq, h, d] fp32; a range with no valid
    key (m at BIG_NEG) contributes nothing."""
    m_glob = torch.maximum(m1, m2)
    c1 = torch.where(m1 > MASK_GUARD, torch.exp(m1 - m_glob), 0.0)
    c2 = torch.where(m2 > MASK_GUARD, torch.exp(m2 - m_glob), 0.0)
    c1t, c2t = c1.transpose(1, 2)[..., None], c2.transpose(1, 2)[..., None]
    o1 = torch.where(c1t > 0, o1, 0.0)
    o2 = torch.where(c2t > 0, o2, 0.0)
    l_sum = l1 * c1 + l2 * c2
    return (o1 * c1t + o2 * c2t) / l_sum.transpose(1, 2)[..., None]


def _raw(o, m, l):
    """K4's l-normalized o → the raw accumulator the combine takes."""
    return o.float() * l.transpose(1, 2)[..., None], m, l


def decode_prefix_partials(q, pk, pv, prefix_mask, prefix_tokens, pk_scale=None,
                           pv_scale=None):
    """Every slot's query against the shared prefix in one K4 call, the
    prefix read once. q [b, 1, h, d]; pk, pv head-major [1, h_kv, P, d]
    (bf16, or int8 with [1, h_kv, P] scales); prefix_mask bool [P], true
    below `prefix_tokens`. Returns raw partials (o [b, 1, h, d], m, l
    [b, h, 1], fp32)."""
    b, _, h, d = q.shape
    h_kv = pk.shape[1]
    g = h // h_kv
    o, m, l = _raw(*flash_decode(
        _fold(q, h_kv), pk, pv, prefix_mask[None], prefix_tokens, pk_scale, pv_scale,
        return_partials=True,
    ))
    return _unfold_o(o, b, h_kv, g, d), _unfold_ml(m, b, h_kv, g), _unfold_ml(l, b, h_kv, g)


def decode_slot_partials(q, k, v, key_mask, kv_len, k_scale=None, v_scale=None):
    """Raw partials of q [b, 1, h, d] over the per-slot suffix cache
    [b, h_kv, T, d] (key_mask bool [b, T])."""
    return _raw(*flash_decode(q, k, v, key_mask, kv_len, k_scale, v_scale,
                              return_partials=True))


def decode_with_prefix(q, k, v, key_mask, kv_len, pk, pv, prefix_mask, prefix_tokens, *,
                       k_scale=None, v_scale=None, pk_scale=None, pv_scale=None, mesh=None):
    """One decode step over [shared prefix ++ own suffix cache]: two K4
    calls (the suffix, then the folded prefix) and the combine. With `mesh`
    (sp > 1), pk/pv/prefix_mask are this rank's slice of the prefix and
    its partials merge over sp first (`decode_with_prefix_sharded`,
    `lwm_tpu/ops/prefix.py:150-247`). Returns [b, 1, h, d] in q.dtype."""
    o_s, m_s, l_s = decode_slot_partials(q, k, v, key_mask, kv_len, k_scale, v_scale)
    o_p, m_p, l_p = decode_prefix_partials(q, pk, pv, prefix_mask, prefix_tokens,
                                           pk_scale, pv_scale)
    if mesh is not None:
        o_p, m_p, l_p = merge_partials(o_p, m_p, l_p, mesh)
    return combine_raw_partials(o_s, m_s, l_s, o_p, m_p, l_p).to(q.dtype)


def combine_lse(out1, lse1, out2, lse2):
    """Merge two normalized flash outputs by their log-sum-exp (K1 returns
    (out, lse)): out [b, sq, h, d], lse [b, h, sq]. A range whose lse is at
    BIG_NEG (no valid key) contributes nothing. Returns fp32."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.where(lse1 > MASK_GUARD, torch.exp(lse1 - m), 0.0).transpose(1, 2)[..., None]
    w2 = torch.where(lse2 > MASK_GUARD, torch.exp(lse2 - m), 0.0).transpose(1, 2)[..., None]
    return (out1.float() * w1 + out2.float() * w2) / (w1 + w2)
