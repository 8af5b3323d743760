"""Paged KV-cache pool: host-side bookkeeping for the device page arena
(reference: paddle_tpu serving/decode/kv_pool.py).

The device side is a preallocated arena ``[L, NB, H, bs, D]`` (one fixed
tensor per K and V, living in the engine's scope and updated in place by
the decode ops). This module owns the *map* of that arena: which physical
pages are free, which sequence holds which pages in which logical order
(its block table), and how many owners each page has. Pure host Python.

Reference counting: pages default to one owner; ``fork()`` lets a new
sequence share a prefix's pages, bumping refcounts; ``free`` returns a
page to the free list only when its count hits zero. The free list is
LIFO so recently touched pages are reused first.

Exhaustion is a normal state, not an error: ``alloc`` returns None and the
continuous-batching scheduler reacts by preempting a victim sequence
(freeing its pages, requeueing it) — see scheduler.py.
"""

import threading

__all__ = ['KVPool', 'BlockTable']


class BlockTable(object):
    """One sequence's logical->physical page map."""

    __slots__ = ('block_ids',)

    def __init__(self):
        self.block_ids = []

    def __len__(self):
        return len(self.block_ids)

    def capacity(self, block_size):
        return len(self.block_ids) * block_size


class KVPool(object):
    """Free-list allocator over ``num_blocks`` physical pages of
    ``block_size`` token slots each."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 1 or block_size < 1:
            raise ValueError('KVPool: need num_blocks >= 1 and '
                             'block_size >= 1, got %d / %d'
                             % (num_blocks, block_size))
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._mu = threading.Lock()
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._refs = [0] * self.num_blocks

    def free_blocks(self):
        with self._mu:
            return len(self._free)

    def blocks_for(self, n_tokens):
        """Pages needed to hold n_tokens positions."""
        return max(0, (int(n_tokens) + self.block_size - 1)
                   // self.block_size)

    def alloc(self, n):
        """Claim ``n`` pages (refcount 1 each). Returns the page-id list,
        or None when fewer than ``n`` are free — the caller decides
        whether that means preempt, wait, or reject."""
        n = int(n)
        with self._mu:
            if n > len(self._free):
                return None
            ids = [self._free.pop() for _ in range(n)]
            for i in ids:
                self._refs[i] = 1
            return ids

    def grow(self, table, n_tokens):
        """Ensure ``table`` covers ``n_tokens`` positions, allocating
        pages as needed. True on success; False (table unchanged) when
        the pool cannot supply them."""
        need = self.blocks_for(n_tokens) - len(table.block_ids)
        if need <= 0:
            return True
        ids = self.alloc(need)
        if ids is None:
            return False
        table.block_ids.extend(ids)
        return True

    def incref(self, ids):
        with self._mu:
            for i in ids:
                if self._refs[i] <= 0:
                    raise ValueError('incref of free page %d' % i)
                self._refs[i] += 1

    def free(self, ids):
        """Drop one reference from each page; pages reaching zero return
        to the free list."""
        with self._mu:
            for i in ids:
                if self._refs[i] <= 0:
                    raise ValueError('double free of page %d' % i)
                self._refs[i] -= 1
                if self._refs[i] == 0:
                    self._free.append(i)

    def release(self, table):
        """Free a sequence's whole table."""
        ids, table.block_ids = table.block_ids, []
        self.free(ids)

    def fork(self, table, frozen_tokens=None):
        """A new BlockTable sharing ``table``'s pages. ``frozen_tokens``
        caps sharing at the last *full* page boundary below it: a page
        still being appended to must never be shared. With
        ``frozen_tokens=None`` every page is shared and the CALLER
        promises the donor is frozen."""
        ids = table.block_ids
        if frozen_tokens is not None:
            ids = ids[:int(frozen_tokens) // self.block_size]
        self.incref(ids)
        t = BlockTable()
        t.block_ids = list(ids)
        return t
