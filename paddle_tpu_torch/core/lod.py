"""LoD (level-of-detail / ragged sequence) translation (reference:
paddle_tpu core/lod.py; paddle/fluid/framework/lod_tensor.{h,cc}).

In the reference framework variable-length sequences ride a LoD offset
table over a flat tensor. Here, as in the JAX package, a ragged batch is
a dense [batch, max_len, ...] array plus an int length vector; these
helpers convert between the two (and give ported scripts the reference's
create_lod_tensor).

Bucketing: ``bucket_length(n)`` rounds max_len up to a small set of
lengths, so that varying sequence lengths map onto few feed shapes (the
executor keeps one plan, and on the card one CUDA graph, a shape).
"""

import numpy as np

__all__ = ['pad_sequences', 'unpad_sequences', 'create_lod_tensor',
           'lod_to_lengths', 'lengths_to_lod', 'bucket_length']

_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(n, buckets=_BUCKETS):
    for b in buckets:
        if n <= b:
            return b
    return int(n)


def pad_sequences(seqs, pad_value=0, dtype=None, max_len=None,
                  bucketed=False):
    """list of per-example arrays/lists -> (padded [B, T, ...], lengths)."""
    arrs = [np.asarray(s) for s in seqs]
    lengths = np.asarray([a.shape[0] for a in arrs], dtype='int64')
    t = int(lengths.max()) if max_len is None else max_len
    if bucketed:
        t = bucket_length(t)
    tail = arrs[0].shape[1:]
    out_dtype = dtype or arrs[0].dtype
    out = np.full((len(arrs), t) + tail, pad_value, dtype=out_dtype)
    for i, a in enumerate(arrs):
        out[i, :a.shape[0]] = a
    return out, lengths


def unpad_sequences(padded, lengths):
    """Inverse of pad_sequences: -> list of per-example arrays."""
    return [np.asarray(padded[i, :int(n)])
            for i, n in enumerate(np.asarray(lengths))]


def lod_to_lengths(lod):
    """Level-0 LoD offsets [0, 3, 5, ...] -> per-sequence lengths."""
    lod = list(lod)
    return np.asarray([b - a for a, b in zip(lod[:-1], lod[1:])],
                      dtype='int64')


def lengths_to_lod(lengths):
    out = [0]
    for n in np.asarray(lengths).tolist():
        out.append(out[-1] + int(n))
    return out


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Reference-API shim (fluid.create_lod_tensor): flat data + one
    level of sequence lengths -> (padded, lengths) pair."""
    if len(recursive_seq_lens) != 1:
        raise NotImplementedError(
            'LoD translation supports one ragged level; nest arrays '
            'for deeper structures')
    lengths = recursive_seq_lens[0]
    flat = np.asarray(data)
    seqs, ofs = [], 0
    for n in lengths:
        seqs.append(flat[ofs:ofs + n])
        ofs += n
    return pad_sequences(seqs)
