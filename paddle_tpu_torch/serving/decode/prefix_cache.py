"""Global radix prefix cache over the paged KV arena (reference:
paddle_tpu serving/decode/prefix_cache.py).

A radix tree (a trie at page granularity) keyed by token chains: each node
is one FULL page of ``block_size`` tokens and maps to the physical page of
the KV pool that holds the K/V of exactly those tokens in that prefix
context. Attention is causal, so a page's K/V is a pure function of the
token chain from the root: a request whose prompt starts with the same
chain maps the same physical pages and skips prefill for the shared span.

Lifecycle of a cached page:

- **publish**: when a sequence's ``cache_len`` crosses a page boundary the
  page is frozen (all its slots written; appends go to the next page). The
  engine publishes it: the trie gains a node and the cache takes one pool
  reference, so the page outlives the sequence.
- **match**: at admission the scheduler walks the trie with the request's
  prefill prefix. Matching stops at the last full page boundary STRICTLY
  below the prefix end (at least one token always prefills: the next-token
  sample needs a forward pass; a partial page is never shared). Matched
  pages are increfed into the request's block table; prefill runs only on
  the uncached suffix.
- **evict**: a cached page whose refcount is 1 (the cache its sole owner)
  is reclaimable. The cache is the pool's reclaimer, so allocation
  pressure evicts leaf pages back into the free list, lowest priority
  class first and least recently used within it, before the scheduler
  preempts anyone.

The device arenas are written in place, so a published page must never be
a write target: prefill writes only positions >= the matched span, decode
and verify only positions >= ``cache_len``, and both lie in the sequence's
own unpublished pages.

Locks nest scheduler -> cache -> pool, never the other way round: the
pool calls ``reclaim`` only after it released its own lock, and the cache
takes the pool's lock (incref, free, refcount) while holding its own.

All state is host-side Python under one lock; the device sees only block
tables that happen to share page ids.

Knob: ``PADDLE_TPU_PREFIX_CACHE=1|0`` (read per call by
``prefix_cache_enabled``, never at import).
"""

import itertools
import os
import threading

from ... import observe as _obs
from ..tenancy import PRIORITIES, priority_rank

__all__ = ['PrefixCache', 'prefix_cache_enabled']


def prefix_cache_enabled(default=None):
    """The prefix-cache knob: an explicit ``default`` (the engine
    constructor arg) wins; otherwise PADDLE_TPU_PREFIX_CACHE (off when
    unset)."""
    if default is not None:
        return bool(default)
    return os.environ.get('PADDLE_TPU_PREFIX_CACHE', '0') \
        not in ('0', 'false', 'False', '')


class _Node(object):
    """One full page of the tree. ``key`` is the page's token tuple (the
    edge label from the parent); the chain of keys from the root is the
    token prefix the page's K/V encodes. ``prio`` / ``tenant`` record the
    most protected (lowest-rank) class that ever published the page: the
    eviction order's first key."""

    __slots__ = ('key', 'page_id', 'parent', 'children', 'last_used',
                 'prio', 'tenant')

    def __init__(self, key, page_id, parent, tick, prio=1,
                 tenant='default'):
        self.key = key
        self.page_id = page_id
        self.parent = parent
        self.children = {}
        self.last_used = tick
        self.prio = prio
        self.tenant = tenant


class PrefixCache(object):
    """Radix index of frozen KV pages, keyed by token chains at page
    granularity. Thread-safe; installs itself as ``pool``'s reclaimer."""

    def __init__(self, pool):
        self.pool = pool
        self.block_size = pool.block_size
        self._root = _Node(None, None, None, 0)
        self._pages = 0
        self._mu = threading.Lock()
        self._tick = itertools.count(1)
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0
        pool.set_reclaimer(self.reclaim)

    # ------------------------------------------------------------- stats
    def cached_pages(self):
        with self._mu:
            return self._pages

    def hit_rate(self):
        with self._mu:
            n = self.hits + self.misses
            return self.hits / float(n) if n else 0.0

    def _publish_gauges(self):
        if _obs.enabled():
            _obs.set_gauge('decode.prefix_cache_pages', self._pages)

    # ------------------------------------------------------------- match
    def _walk(self, tokens, max_pages):
        """Page ids of the cached chain that covers ``tokens``' first
        pages, at most ``max_pages``; refreshes the chain's LRU tick.
        Caller holds the lock."""
        bs = self.block_size
        matched = []
        node = self._root
        tick = next(self._tick)
        for p in range(max_pages):
            child = node.children.get(tuple(tokens[p * bs:(p + 1) * bs]))
            if child is None:
                break
            child.last_used = tick
            matched.append(child.page_id)
            node = child
        return matched

    def match(self, tokens, table):
        """Map every cached page of ``tokens``' chain into the empty
        ``table`` (refcounts bumped: pinned against eviction until the
        sequence releases them). Returns the tokens covered: a multiple of
        block_size, at most the last full page boundary strictly below
        len(tokens), so at least one token remains to prefill."""
        assert not table.block_ids, 'match() needs an empty block table'
        max_pages = max(0, (len(tokens) - 1) // self.block_size)
        with self._mu:
            matched = self._walk(tokens, max_pages)
            if matched:
                self.pool.incref(matched)
                table.block_ids.extend(matched)
                self.hits += 1
                self.tokens_reused += len(matched) * self.block_size
            else:
                self.misses += 1
        n = len(matched) * self.block_size
        if _obs.enabled():
            _obs.inc('decode.prefix_cache_lookups_total',
                     outcome='hit' if matched else 'miss')
            if n:
                _obs.inc('decode.prefix_tokens_reused_total', n)
        return n

    def acquire(self, tokens):
        """Pin the longest cached chain over ``tokens``' FULL pages (all of
        them: no prefill follows, so no token is held back) and return
        ``(page_ids, covered_tokens)`` with one reference taken on every
        page (the caller releases with ``pool.free(page_ids)``)."""
        with self._mu:
            matched = self._walk(tokens, len(tokens) // self.block_size)
            if matched:
                self.pool.incref(matched)
        return matched, len(matched) * self.block_size

    def unmatch(self, table, matched_tokens):
        """Roll back a ``match`` whose admission failed: drop the
        sequence's references on the shared pages (the cache's own keeps
        them resident and evictable)."""
        n_pages = int(matched_tokens) // self.block_size
        ids, table.block_ids = table.block_ids[:n_pages], []
        if ids:
            self.pool.free(ids)

    # ----------------------------------------------------------- publish
    def publish(self, tokens, table, upto_tokens, tenant=None,
                priority=None):
        """Publish every FULL page of ``table`` below ``upto_tokens`` (the
        sequence's materialized KV length). A page whose chain is not yet
        cached becomes a node and the cache takes one pool reference; a
        chain already cached under another physical page is kept (the
        sequence's twin page stays private). A page shared across classes
        keeps the most protected class it was published under. Returns the
        number of newly published pages."""
        rank = priority_rank(priority)
        bs = self.block_size
        n_full = min(int(upto_tokens) // bs, len(table.block_ids))
        added = 0
        with self._mu:
            node = self._root
            tick = next(self._tick)
            for p in range(n_full):
                key = tuple(tokens[p * bs:(p + 1) * bs])
                child = node.children.get(key)
                if child is None:
                    page = table.block_ids[p]
                    self.pool.incref([page])
                    child = _Node(key, page, node, tick, prio=rank,
                                  tenant=tenant or 'default')
                    node.children[key] = child
                    self._pages += 1
                    added += 1
                elif rank < child.prio:
                    child.prio = rank
                    child.tenant = tenant or 'default'
                child.last_used = tick
                node = child
            self._publish_gauges()
        if added and _obs.enabled():
            _obs.inc('decode.prefix_pages_published_total', added)
        return added

    # ------------------------------------------------------------- evict
    def _evictable_leaves(self):
        """Leaves whose page only the cache owns (refcount 1), lowest
        priority class first, oldest touched within the class. Interior
        nodes become leaves as their children go, so repeated calls drain
        whole chains."""
        out = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            kids = list(node.children.values())
            if node is not self._root and not kids and \
                    self.pool.refcount(node.page_id) == 1:
                out.append(node)
            stack.extend(kids)
        out.sort(key=lambda n: (-n.prio, n.last_used))
        return out

    def _drop(self, node):
        del node.parent.children[node.key]
        self._pages -= 1
        self.evictions += 1
        self.pool.free([node.page_id])
        return node.tenant, node.prio

    def reclaim(self, n):
        """Evict up to ``n`` refcount-1 cached pages back to the pool's
        free list; returns how many were freed. The pool calls it (outside
        its lock) before it reports exhaustion."""
        freed = 0
        evicted = {}                 # (tenant, priority rank) -> pages
        with self._mu:
            while freed < n:
                leaves = self._evictable_leaves()
                if not leaves:
                    break
                for node in leaves:
                    k = self._drop(node)
                    evicted[k] = evicted.get(k, 0) + 1
                    freed += 1
                    if freed >= n:
                        break
            self._publish_gauges()
        if freed and _obs.enabled():
            _obs.inc('decode.prefix_evictions_total', freed)
            for (tenant, rank), pages in evicted.items():
                _obs.inc('tenant.evicted_pages', pages, tenant=tenant,
                         priority=PRIORITIES[rank])
            _obs.flight_event('prefix_cache_evict', pages=freed,
                              cached_pages=self._pages)
        return freed

    def clear(self):
        """Drop the cache's reference on every cached page (engine
        shutdown): pages with no other owner return to the free list."""
        with self._mu:
            stack = [self._root]
            nodes = []
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node is not self._root:
                    nodes.append(node)
            for node in nodes:
                self.pool.free([node.page_id])
            self._root.children.clear()
            self._pages = 0
            self._publish_gauges()
