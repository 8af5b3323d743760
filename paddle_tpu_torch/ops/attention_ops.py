"""Fused multi-head attention op (reference: paddle_tpu
ops/attention_ops.py).

Inputs are the head-merged projections [B, T, H*D]; masking comes from the
``causal`` attr and an optional per-example ``KeyLength`` vector. The heads
are split as strided views, and the whole q·kᵀ → mask → softmax → ·v chain
is the flash attention Function (K2 forward, K3 backward on the card; the
plain versions on the host), with the semantics of the JAX op's default
path, ``reference_attention``: any Tq and Tk, the causal mask aligned
bottom-right, a row with no live key the mean of V, any head dim.
The ring-attention (sequence-parallel) path of the JAX package is not
ported.
"""

import torch

from ..core.registry import op_key, register
from .kernels.flash_attention import flash_attention
from .kernels.random_bits import DropoutApply

_NEG_INF = -1e9


def _split_heads(x, n_head):
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def reference_attention(q, k, v, causal=False, key_length=None,
                        query_length=None, scale=None):
    """Composed attention over [B, H, T, D] (the JAX package's
    reference_attention): causal aligned bottom-right, masked logits at
    -1e9, so a row with no live key gives the mean of V."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum('bhqd,bhkd->bhqk', q * scale, k)
    tq, tk = logits.shape[-2], logits.shape[-1]
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        logits = logits.masked_fill(~mask, _NEG_INF)
    if key_length is not None:
        kmask = torch.arange(tk, device=q.device)[None, :] < \
            key_length.reshape(-1, 1)
        logits = logits.masked_fill(~kmask[:, None, None, :], _NEG_INF)
    out = torch.einsum('bhqk,bhkd->bhqd', torch.softmax(logits, dim=-1), v)
    if query_length is not None:
        qmask = torch.arange(tq, device=q.device)[None, :] < \
            query_length.reshape(-1, 1)
        out = out * qmask[:, None, :, None].to(out.dtype)
    return out


def fused_attention(q3, k3, v3, n_head, causal=False, key_length=None,
                    query_length=None):
    """q3 [B, Tq, H*D], k3 and v3 [B, Tk, H*D] -> [B, Tq, H*D] through
    the flash attention Function, differentiable in q3, k3 and v3 (the
    JAX package's fused_attention without its ring path and dropout)."""
    q, k, v = (_split_heads(x, n_head) for x in (q3, k3, v3))
    if key_length is not None:
        key_length = key_length.reshape(-1)
    out = _merge_heads(flash_attention(q, k, v, causal=causal,
                                       kv_len=key_length))
    if query_length is not None:
        ql = query_length.reshape(-1, 1)
        qmask = torch.arange(out.shape[1], device=out.device)[None, :] < ql
        out = out * qmask.unsqueeze(-1).to(out.dtype)
    return out


@register('fused_attention')
def _fused_attention(ctx):
    def optional(slot):
        return ctx.input(slot) if ctx.has_input(slot) else None

    out = fused_attention(ctx.input('Q'), ctx.input('K'), ctx.input('V'),
                          ctx.attr('n_head', 1),
                          causal=ctx.attr('causal', False),
                          key_length=optional('KeyLength'),
                          query_length=optional('QueryLength'))
    rate = ctx.attr('dropout_rate', 0.0)
    if rate and not ctx.is_test:
        # dropout on the attention output, as the reference op does:
        # where(mask, out / keep, 0), in one fused pass
        out = DropoutApply.apply(out, 'where_div', 1.0 - rate,
                                 op_key(ctx.seed, ctx.op_index),
                                 ctx.step_tensor())
    ctx.set_output('Out', out)
