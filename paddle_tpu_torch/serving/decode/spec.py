"""Speculative decoding: draft proposal and acceptance for DecodeEngine
(reference: paddle_tpu serving/decode/spec.py).

A cheap draft proposes ``k`` tokens per running sequence, and the target
model scores all ``k+1`` positions (the pending token plus the k drafts) in
ONE ``paged_spec_verify`` run: a ragged paged-attention pass over B*(k+1)
single-token rows. Acceptance is the longest-accepted-prefix rule:

    target emits out[j] = sample(logits after consuming tokens[0..j])
    accept draft d_j while d_j == out[j-1]; emit out[0..a] (a accepted
    drafts -> a+1 tokens this step)

Sampling is keyed by (seed, position) (greedy at temp 0), so ``out[j]`` is
a deterministic function of the token prefix and the emitted stream is
token for token the one of plain one-token-a-step decode, for any draft.
A good draft only changes how fast the same tokens appear. K/V written for
rejected positions lies above ``cache_len`` and is overwritten by the next
step's writes before it is read or published.

Drafts are pluggable (anything with ``propose(tokens, k) -> list``). The
built-in ``NgramDraft`` is prompt-lookup decoding plus an n-gram table the
engine teaches online; it costs no device work.

Knob: ``PADDLE_TPU_SPEC_K`` (read per call by ``spec_k_from_env``, never at
import).
"""

import os

__all__ = ['NgramDraft', 'spec_k_from_env', 'accept_drafts']


def spec_k_from_env(default=None):
    """The draft length: an explicit ``default`` (the engine constructor
    arg) wins; otherwise PADDLE_TPU_SPEC_K (0, no speculation, when
    unset)."""
    if default is not None:
        return int(default)
    return int(os.environ.get('PADDLE_TPU_SPEC_K', '0') or '0')


class NgramDraft(object):
    """Prompt-lookup + online n-gram draft, all on the host:

    1. **Learned table**: ``observe()`` (the engine calls it on every
       emitted token) counts which token the target produced after each
       length-``context`` window, over every request the engine served.
       Proposals chain the most frequent continuation.
    2. **Prompt lookup**: where the table has no entry, match the longest
       suffix n-gram (n down to 1) against the sequence's own history and
       propose what followed its most recent occurrence.

    Draft quality only moves the accepted length; acceptance keeps the
    stream. Called only from the engine's worker thread: no locking."""

    def __init__(self, max_ngram=3, context=2, capacity=1 << 16):
        self.max_ngram = max(1, int(max_ngram))
        self.context = max(1, int(context))
        self.capacity = int(capacity)
        self._table = {}    # ctx tuple -> {next_token: count}

    def observe(self, tail):
        """Feed the last ``context + 1`` tokens of a stream after the
        target emits one (older entries of ``tail`` are ignored)."""
        if len(tail) <= self.context:
            return
        ctx = tuple(tail[-self.context - 1:-1])
        nxt = int(tail[-1])
        if len(self._table) >= self.capacity and ctx not in self._table:
            self._table.clear()     # epoch reset keeps memory bounded
        counts = self._table.setdefault(ctx, {})
        counts[nxt] = counts.get(nxt, 0) + 1

    def _best(self, ctx):
        counts = self._table.get(ctx)
        if not counts:
            return None
        # deterministic argmax: highest count, lowest token id on ties
        return min(counts, key=lambda t: (-counts[t], t))

    def _prompt_lookup(self, tokens, k):
        t = len(tokens)
        for n in range(min(self.max_ngram, t - 1), 0, -1):
            suffix = tokens[t - n:]
            # most recent earlier occurrence of the suffix n-gram
            for i in range(t - n - 1, -1, -1):
                if tokens[i:i + n] == suffix:
                    return list(tokens[i + n:i + n + k])
        return []

    def propose(self, tokens, k):
        """Up to ``k`` draft tokens continuing ``tokens`` (the whole
        prompt + generated stream); fewer, or none, when neither the
        table nor the history has a match."""
        if len(tokens) < 2 or k < 1:
            return []
        out = []
        ctx = list(tokens[-self.context:])
        while len(out) < k:
            nxt = self._best(tuple(ctx))
            if nxt is None:
                break
            out.append(int(nxt))
            ctx = (ctx + [int(nxt)])[-self.context:]
        if not out:
            out = self._prompt_lookup(list(tokens), k)[:k]
        return out


def accept_drafts(drafts, verified):
    """Longest-accepted-prefix rule. ``drafts`` are the k proposed tokens;
    ``verified`` the k+1 target samples (``verified[j]``: the target's
    token after the pending token and drafts 1..j). Returns the ``a+1``
    tokens to emit, ``a`` the count of leading drafts that match the
    target's own choices."""
    emit = [int(verified[0])]
    for j, d in enumerate(drafts):
        if int(d) != int(verified[j]):
            break
        emit.append(int(verified[j + 1]))
    return emit
