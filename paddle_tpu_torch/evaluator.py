"""Evaluators accumulating metrics across minibatches
(reference: python/paddle/fluid/evaluator.py)."""

import numpy as np

from . import layers

__all__ = ['Accuracy', 'ChunkEvaluator', 'Evaluator']


class Evaluator(object):
    def __init__(self, name=None):
        self._name = name

    def reset(self, executor=None):
        raise NotImplementedError

    def eval(self, executor=None):
        raise NotImplementedError


class Accuracy(Evaluator):
    """Streaming accuracy. Per-batch correct/total come from the graph; the
    running sums live host-side (the reference keeps them as scope vars)."""

    def __init__(self, input, label, k=1, **kwargs):
        super(Accuracy, self).__init__(**kwargs)
        helper_out = layers.accuracy(input=input, label=label, k=k)
        self.metrics = [helper_out]
        self._correct_total = 0
        self._num_total = 0
        self._batch_acc = helper_out

    def reset(self, executor=None):
        self._correct_total = 0
        self._num_total = 0

    def update(self, batch_acc, batch_size):
        self._correct_total += float(np.asarray(batch_acc).reshape(-1)[0]) \
            * batch_size
        self._num_total += batch_size

    def eval(self, executor=None):
        if self._num_total == 0:
            return 0.0
        return self._correct_total / self._num_total


class ChunkEvaluator(Evaluator):
    """Chunk (IOB/IOE/IOBES) precision/recall/F1, computed host-side
    (reference: evaluator.py ChunkEvaluator + chunk_eval_op.cc)."""

    def __init__(self, input=None, label=None, chunk_scheme='IOB',
                 num_chunk_types=None, excluded_chunk_types=None, **kwargs):
        super(ChunkEvaluator, self).__init__(**kwargs)
        self.chunk_scheme = chunk_scheme
        self.num_chunk_types = num_chunk_types
        self.excluded = set(excluded_chunk_types or [])
        self.reset()

    def reset(self, executor=None):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def _extract_chunks(self, tags, seq_len):
        """Decode chunks from tag ids under the configured scheme."""
        scheme = self.chunk_scheme
        n_types = self.num_chunk_types
        chunks = []
        start = None
        cur_type = None
        if scheme == 'IOB':
            tag_kinds = 2  # B, I
        elif scheme == 'IOE':
            tag_kinds = 2  # I, E
        elif scheme == 'IOBES':
            tag_kinds = 4  # B, I, E, S
        else:  # 'plain'
            tag_kinds = 1
        for i in range(seq_len):
            tag = int(tags[i])
            outside = tag == n_types * tag_kinds
            if outside:
                if start is not None:
                    chunks.append((start, i - 1, cur_type))
                    start = None
                continue
            ttype = tag // tag_kinds
            kind = tag % tag_kinds
            if scheme == 'IOB':
                is_begin = kind == 0
                if is_begin or ttype != cur_type:
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start, cur_type = i, ttype
            elif scheme == 'IOE':
                is_end = kind == 1
                if start is None or ttype != cur_type:
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start, cur_type = i, ttype
                if is_end:
                    chunks.append((start, i, cur_type))
                    start = None
            elif scheme == 'IOBES':
                if kind == 3:  # S
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                        start = None
                    chunks.append((i, i, ttype))
                elif kind == 0:  # B
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start, cur_type = i, ttype
                elif kind == 2:  # E
                    if start is not None:
                        chunks.append((start, i, cur_type))
                        start = None
            else:
                if cur_type != ttype:
                    if start is not None:
                        chunks.append((start, i - 1, cur_type))
                    start, cur_type = i, ttype
        if start is not None:
            chunks.append((start, seq_len - 1, cur_type))
        return set(c for c in chunks if c[2] not in self.excluded)

    def update(self, infer_tags, label_tags, lengths):
        infer_tags = np.asarray(infer_tags)
        label_tags = np.asarray(label_tags)
        lengths = np.asarray(lengths).reshape(-1)
        for b in range(infer_tags.shape[0]):
            n = int(lengths[b])
            infer = self._extract_chunks(infer_tags[b], n)
            label = self._extract_chunks(label_tags[b], n)
            self.num_infer_chunks += len(infer)
            self.num_label_chunks += len(label)
            self.num_correct_chunks += len(infer & label)

    def eval(self, executor=None):
        precision = self.num_correct_chunks / self.num_infer_chunks \
            if self.num_infer_chunks else 0.0
        recall = self.num_correct_chunks / self.num_label_chunks \
            if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) \
            if precision + recall else 0.0
        return precision, recall, f1
