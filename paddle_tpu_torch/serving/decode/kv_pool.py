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

Cache integration: the global prefix cache (prefix_cache.py) parks frozen
pages at refcount 1 so later requests can map them instead of prefilling
again. Those pages are reclaimable, not free: ``alloc`` asks the installed
``set_reclaimer`` callback to evict some back into the free list before it
reports exhaustion, so the cache never starves admission.

Allocator pressure is observable (``observe``): free pages, occupancy,
the largest contiguous free run and the fragmentation gauges, and the
``decode.alloc_stall_seconds`` histogram, a sample for every alloc that
found a shortfall.
"""

import threading
import time

from ... import observe as _obs

__all__ = ['KVPool', 'BlockTable']

# The fragmentation gauges need a sort over the free list, so _publish
# refreshes them only every Nth alloc/free; direct largest_free_run() /
# fragmentation() reads always recompute (and publish) them.
_FRAG_PUBLISH_EVERY = 64


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
        self._reclaimer = None
        self._frag_seq = 0
        self._publish()

    def set_reclaimer(self, fn):
        """Install ``fn(n) -> freed_count``, asked by ``alloc`` when fewer
        than ``n`` pages are free. The prefix cache installs its evictor
        here; ``fn`` is called OUTSIDE the pool lock (it frees pages
        through ``free``, which takes it)."""
        self._reclaimer = fn

    # ------------------------------------------------------------ stats
    def free_blocks(self):
        with self._mu:
            return len(self._free)

    def used_blocks(self):
        with self._mu:
            return self.num_blocks - len(self._free)

    def occupancy(self):
        with self._mu:
            return 1.0 - len(self._free) / float(self.num_blocks)

    def largest_free_run(self):
        """Length of the longest run of CONTIGUOUS free page ids. Pages
        are position-independent through block tables, so allocations
        succeed anyway, but a high free count beside a short run shows
        allocator churn. Reading it refreshes the gauges."""
        with self._mu:
            run = self._largest_run_locked()
            self._publish_frag_locked(run)
            return run

    def _largest_run_locked(self):
        if not self._free:
            return 0
        ids = sorted(self._free)
        best = run = 1
        for prev, cur in zip(ids, ids[1:]):
            run = run + 1 if cur == prev + 1 else 1
            best = max(best, run)
        return best

    def fragmentation(self):
        """1 - largest_free_run / free pages (0.0: one contiguous run or
        no free page). Refreshes the gauges like largest_free_run."""
        with self._mu:
            free = len(self._free)
            run = self._largest_run_locked()
            self._publish_frag_locked(run)
            return 1.0 - run / float(free) if free else 0.0

    def _publish_frag_locked(self, run):
        if _obs.enabled():
            free = len(self._free)
            _obs.set_gauge('decode.kv_largest_free_run', run)
            _obs.set_gauge('decode.kv_fragmentation',
                           1.0 - run / float(free) if free else 0.0)

    def _publish(self):
        if _obs.enabled():
            free = len(self._free)
            _obs.set_gauge('decode.kv_blocks_free', free)
            _obs.set_gauge('decode.kv_free_pages', free)
            _obs.set_gauge('decode.kv_blocks_total', self.num_blocks)
            _obs.set_gauge('decode.kv_block_occupancy',
                           1.0 - free / float(self.num_blocks))
            # the largest run is a sort: every Nth publish only
            self._frag_seq += 1
            if self._frag_seq % _FRAG_PUBLISH_EVERY == 1:
                self._publish_frag_locked(self._largest_run_locked())

    def blocks_for(self, n_tokens):
        """Pages needed to hold n_tokens positions."""
        return max(0, (int(n_tokens) + self.block_size - 1)
                   // self.block_size)

    def refcount(self, page_id):
        with self._mu:
            return self._refs[page_id]

    def alloc(self, n):
        """Claim ``n`` pages (refcount 1 each). Returns the page-id list,
        or None when fewer than ``n`` are free and the reclaimer (if any)
        cannot evict enough — the caller decides whether that means
        preempt, wait, or reject. An alloc that found a shortfall records
        the time from it to the answer in ``decode.alloc_stall_seconds``."""
        n = int(n)
        t0 = None
        while True:
            with self._mu:
                if n <= len(self._free):
                    ids = [self._free.pop() for _ in range(n)]
                    for i in ids:
                        self._refs[i] = 1
                    self._publish()
                    self._record_stall(t0)
                    return ids
                short = n - len(self._free)
            if t0 is None:
                t0 = time.perf_counter()
            if self._reclaimer is None or self._reclaimer(short) <= 0:
                self._record_stall(t0)
                return None

    def _record_stall(self, t0):
        if t0 is not None and _obs.enabled():
            _obs.record('decode.alloc_stall_seconds',
                        time.perf_counter() - t0)

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
            self._publish()

    def release(self, table):
        """Free a sequence's whole table."""
        ids, table.block_ids = table.block_ids, []
        self.free(ids)

    def fork(self, table, frozen_tokens=None):
        """A new BlockTable sharing ``table``'s pages. ``frozen_tokens``
        caps sharing at the last *full* page boundary below it: a page
        still being appended to (the donor's partial last page) must never
        be shared, or the donor's next write would land inside the child's
        view. With ``frozen_tokens=None`` every page is shared and the
        CALLER promises the donor is frozen."""
        ids = table.block_ids
        if frozen_tokens is not None:
            ids = ids[:int(frozen_tokens) // self.block_size]
        self.incref(ids)
        t = BlockTable()
        t.block_ids = list(ids)
        return t
