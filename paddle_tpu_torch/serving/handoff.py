"""KV page handoff between prefill and decode replicas (reference:
paddle_tpu serving/handoff.py; the same packet format, so a packet written
by either package installs in the other).

The disaggregated fleet splits serving by phase: a request prefills on a
prefill replica and decodes on a decode replica, so its KV pages cross
replicas. This module is that wire:

- **export** (:func:`export_packet`): after prefill, the sequence's frozen
  FULL pages sit in the prefill replica's prefix cache (published the
  moment ``cache_len`` crosses each page boundary). Export pins the chain
  (``PrefixCache.acquire``: one pool reference a page, so eviction cannot
  take a page mid-read), reads every arena's pages through the engine's
  reused staging buffers (``DecodeEngine.read_pages``: one gather on the
  device a chunk, copied out under the arena lock, so concurrent exports
  each own their tensors), wraps them in a :class:`KVPacket`, and
  releases the pins.
- **install** (:func:`install_packet`): the decode replica first walks its
  OWN prefix cache with the packet's token chain: pages it already caches
  (a shared system prompt handed off earlier, or its own traffic) are
  deduplicated, never written again. Only the uncovered tail is allocated
  from the decode pool (page by page under pressure), written into the
  arenas in place (``DecodeEngine.write_pages``, between two steps, under
  the arena lock: no captured graph is invalidated) and published. The
  request's ``submit`` on the decode replica then matches the chain like
  any cache hit and prefills only the uncached suffix.

Wire form (``to_bytes``): ``PTKV``, a little-endian u32 header length,
the header JSON (sorted keys: format version, the token chain, the
geometry and dtype contract, the arena names, each arena's name, dtype,
shape and logical sharding spec, optionally a sha1 and a request trace),
then each arena's raw bytes in name order. bfloat16 travels as its 2-byte
payload and float8_e4m3fn as its 1-byte payload under their own names
(``io._to_numpy``); ``from_bytes`` sizes each field from the stored
numpy view of its dtype name (``io.stored_numpy_dtype``, never
``np.dtype('float8_e4m3fn')``) and restores the dtype from the name. Quantized arenas ship their
fp32 scale pages in the same packet; a packet whose dtype differs from the
destination's raises :class:`KVDtypeMismatchError` (the wire never
converts).

Env knob (read per call): ``PADDLE_TPU_HANDOFF_VERIFY`` stamps a sha1 of
the payload into the header (``1``); unset or ``0``, no stamp (the
reference's socket transport, which stamps by default, comes with the RPC
layer). ``from_bytes`` checks the sha1 of every stamped packet, whatever
the env says.

The cross-host transport (``serving.rpc``'s ``RemoteReplica``, duck-typed
on ``export_packet_bytes`` / ``install_packet_bytes``) waits for the
fleet's RPC layer (ROADMAP Queue 1 item 10): :func:`handoff` refuses such
a replica with NotImplementedError.
"""

import hashlib
import json
import os
import struct
import time

import numpy as np

from .. import observe as _obs
from ..io import _from_numpy, _to_numpy, spec_to_json, stored_numpy_dtype
from ..observe import reqtrace as _reqtrace
from .decode.kv_pool import BlockTable
from .decode.model import kv_page_bytes

__all__ = ['KVPacket', 'HandoffError', 'KVDtypeMismatchError',
           'KVGeometryError', 'export_packet', 'install_packet', 'handoff',
           'packet_wire_bytes', 'handoff_verify_enabled']

_MAGIC = b'PTKV'
_VERSION = 1


class HandoffError(RuntimeError):
    """Base class of KV handoff failures (typed, so the phase router fails
    the request instead of hanging it)."""


class KVDtypeMismatchError(HandoffError):
    """Packet arena dtype != destination arena dtype. Refusing is the
    contract: converting would break the handoff's bit-identity."""


class KVGeometryError(HandoffError):
    """Packet page geometry (layers, heads, head dims, block size) or arena
    set does not match the destination arenas."""


def handoff_verify_enabled():
    """PADDLE_TPU_HANDOFF_VERIFY, read per call: unset, empty, ``0`` or
    ``false`` is off, any other value on."""
    raw = os.environ.get('PADDLE_TPU_HANDOFF_VERIFY') or '0'
    return raw not in ('0', 'false', 'False')


def _nbytes(t):
    return t.numel() * t.element_size()


class KVPacket(object):
    """One sequence's frozen KV pages on the wire.

    ``header`` is a JSON-safe dict: format version, the token chain the
    pages encode (n_pages * block_size tokens), the geometry and dtype
    contract, the arena names, and per-arena logical sharding specs.
    ``arrays`` maps arena name -> CPU tensor [L, n_pages, ...] of the
    arena's dtype (scales included for quantized arenas)."""

    __slots__ = ('header', 'arrays')

    def __init__(self, header, arrays):
        self.header = header
        self.arrays = arrays

    @property
    def tokens(self):
        return self.header['tokens']

    @property
    def n_pages(self):
        return self.header['n_pages']

    @property
    def kv_dtype(self):
        return self.header['kv_dtype']

    def wire_bytes(self):
        """Payload bytes this packet moves (header excluded)."""
        return sum(_nbytes(t) for t in self.arrays.values())

    # ------------------------------------------------------------ wire
    def to_bytes(self):
        """MAGIC + u32 header length + header JSON + each arena's raw
        bytes in name order; the payload's sha1 is stamped when
        handoff_verify_enabled()."""
        blobs, arenas = [], []
        for name in sorted(self.arrays):
            raw, dtype_name = _to_numpy(self.arrays[name])
            arenas.append({'name': name, 'dtype': dtype_name,
                           'shape': list(raw.shape),
                           'spec': self.header.get('specs', {})
                           .get(name, [])})
            blobs.append(np.ascontiguousarray(raw).tobytes())
        header = dict(self.header, arenas=arenas)
        if handoff_verify_enabled():
            sha = hashlib.sha1()
            for b in blobs:
                sha.update(b)
            header['sha1'] = sha.hexdigest()
        hj = json.dumps(header, sort_keys=True).encode()
        return b''.join([_MAGIC, struct.pack('<I', len(hj)), hj] + blobs)

    @classmethod
    def from_bytes(cls, data):
        if data[:4] != _MAGIC:
            raise HandoffError('not a KV handoff packet (bad magic)')
        (hlen,) = struct.unpack('<I', data[4:8])
        header = json.loads(bytes(data[8:8 + hlen]).decode())
        if header.get('version') != _VERSION:
            raise HandoffError('KV packet version %r (this build reads %d)'
                               % (header.get('version'), _VERSION))
        off = payload_start = 8 + hlen
        arrays = {}
        for ent in header['arenas']:
            dtype_name = ent['dtype']
            try:
                # numpy of the card's machine has no float8 dtype: the
                # stored view sizes the field
                base = stored_numpy_dtype(dtype_name)
            except TypeError:
                raise HandoffError('KV packet arena %r has dtype %r, which '
                                   'this build cannot read'
                                   % (ent['name'], dtype_name))
            shape = tuple(ent['shape'])
            n = int(np.prod(shape, dtype=np.int64)) * base.itemsize
            if off + n > len(data):
                raise HandoffError('KV packet truncated: arena %r needs %d '
                                   'bytes at %d of %d' % (ent['name'], n,
                                                          off, len(data)))
            # a copy: the packet's tensors own their memory
            raw = np.frombuffer(data, dtype=np.uint8, count=n,
                                offset=off).copy()
            arrays[ent['name']] = _from_numpy(
                raw.view(base).reshape(shape), dtype_name)
            off += n
        if header.get('sha1'):
            # a stamped packet is ALWAYS checked on receive: the knob gates
            # whether the writer stamps, never whether the reader checks
            sha = hashlib.sha1(data[payload_start:off]).hexdigest()
            if sha != header['sha1']:
                raise HandoffError('KV packet payload corrupt: sha1 %s != '
                                   'recorded %s' % (sha, header['sha1']))
        return cls(header, arrays)


def packet_wire_bytes(spec, n_pages, block_size, kv_dtype='float32'):
    """Payload bytes of an ``n_pages`` handoff at ``kv_dtype``, computed
    from the shapes (model.kv_page_bytes a page)."""
    return kv_page_bytes(spec, block_size, kv_dtype) * int(n_pages)


def _geometry_header(engine):
    geo = engine.kv_geometry()
    out = {k: geo[k] for k in ('n_layer', 'n_head', 'd_key', 'd_value',
                               'block_size', 'kv_dtype')}
    out['arena_names'] = sorted(geo['arena_names'])
    return out


def _check_geometry(engine, header):
    """Destination contract, checked BEFORE any page is allocated: a dtype
    mismatch gets its own typed error; layers, heads, head dims, block
    size and the arena-name set are geometry."""
    geo = _geometry_header(engine)
    if header['kv_dtype'] != geo['kv_dtype']:
        raise KVDtypeMismatchError(
            'KV packet carries %s pages but the destination arena is %s — '
            'a handoff never converts dtypes; re-export from a '
            'matching-dtype replica' % (header['kv_dtype'],
                                        geo['kv_dtype']))
    bad = {k: (header.get(k), geo[k]) for k in
           ('n_layer', 'n_head', 'd_key', 'd_value', 'block_size')
           if header.get(k) != geo[k]}
    if bad:
        raise KVGeometryError(
            'KV packet geometry does not match the destination arenas: %s'
            % ', '.join('%s packet=%r dest=%r' % (k, p, d)
                        for k, (p, d) in sorted(bad.items())))
    pk_names = sorted(header.get('arena_names') or [])
    if pk_names != geo['arena_names']:
        raise KVGeometryError(
            'KV packet arena set does not match the destination: '
            'packet=%r dest=%r' % (pk_names, geo['arena_names']))


# ----------------------------------------------------------- export
def export_packet(engine, tokens):
    """The frozen full pages covering ``tokens``' prefix, out of
    ``engine``'s arenas, as a :class:`KVPacket` over the longest cached
    chain (fewer pages than ``len(tokens) // block_size`` if eviction
    raced us: the receiver prefills a longer suffix, its tokens
    unchanged), or None when nothing is cached. Needs
    ``prefix_cache=True`` on the engine."""
    if engine.prefix_cache is None:
        raise HandoffError('export_packet needs prefix_cache=True on the '
                           'prefill engine (frozen pages live in the cache '
                           'between prefill and export)')
    t0 = time.perf_counter()
    tokens = [int(t) for t in tokens]
    page_ids, covered = engine.prefix_cache.acquire(tokens)
    if not page_ids:
        _obs.inc('handoff.empty_exports_total')
        return None
    try:
        arrays = engine.read_pages(page_ids)
    finally:
        engine.pool.free(page_ids)
    header = dict(_geometry_header(engine), version=_VERSION,
                  tokens=tokens[:covered], n_pages=len(page_ids),
                  specs={name: spec_to_json(spec) for name, spec
                         in engine.arena_specs().items()})
    pkt = KVPacket(header, arrays)
    if _obs.enabled():
        _obs.record('handoff.export_seconds', time.perf_counter() - t0)
        _obs.inc('handoff.pages_exported_total', len(page_ids))
    return pkt


# ----------------------------------------------------------- install
def install_packet(engine, packet):
    """Install ``packet``'s pages into ``engine``'s arenas and register the
    chain in its prefix cache. Returns ``(covered_tokens, installed_pages,
    dedup_pages)``.

    The chain is first walked against the destination cache: resident
    pages are reused as they are; only the uncovered tail is allocated
    (page by page, front first, when the pool cannot give it at once),
    written and published. A tail the pool cannot supply is dropped: the
    request prefills a longer suffix, its tokens unchanged. Every page
    reference taken here is released on every path, errors included. A
    packet whose header carries a ``trace`` (the exporter's reqtrace wire
    form) gets its install recorded as a stage of that trace."""
    if engine.prefix_cache is None:
        raise HandoffError('install_packet needs prefix_cache=True on the '
                           'decode engine (handed-off pages are registered '
                           'in, and matched from, its prefix cache)')
    _check_geometry(engine, packet.header)
    t0 = time.perf_counter()
    tokens = [int(t) for t in packet.tokens]
    cache, pool = engine.prefix_cache, engine.pool
    n_pages = packet.n_pages

    # 1. dedup: how much of the chain does this replica already hold?
    have_ids, _ = cache.acquire(tokens)
    have = len(have_ids)
    tail = n_pages - have
    new_ids = []
    try:
        if tail > 0:
            new_ids = pool.alloc(tail)
            if new_ids is None:
                # page pressure: install what fits, front first (a
                # shorter chain is still a win)
                new_ids = []
                for _ in range(tail):
                    one = pool.alloc(1)
                    if one is None:
                        break
                    new_ids.extend(one)
            if new_ids:
                # 2. the tail pages into every arena, in place
                sl = slice(have, have + len(new_ids))
                engine.write_pages(new_ids, {
                    name: t[:, sl] for name, t in packet.arrays.items()})
        # 3. publish the chain (reused head + installed tail) so admission
        # matches it; publish dedups a node at a time
        table = BlockTable()
        table.block_ids = list(have_ids) + list(new_ids)
        chain_tokens = tokens[:len(table.block_ids) * engine.block_size]
        cache.publish(chain_tokens, table, len(chain_tokens))
    finally:
        # 4. drop OUR references (the acquire pins and the fresh allocs):
        # after a publish the cache's own keep the chain resident and
        # evictable; after an error this is what keeps a failed handoff
        # from leaking pages
        ours = list(have_ids) + list(new_ids)
        if ours:
            pool.free(ours)
    installed = len(new_ids)
    covered_tokens = len(chain_tokens)
    ctx = _reqtrace.from_wire(packet.header.get('trace'))
    if ctx is not None:
        ctx.stage('kv_install', t0, time.perf_counter(), pages=installed,
                  dedup=have, covered_tokens=covered_tokens)
    if _obs.enabled():
        _obs.record('handoff.install_seconds', time.perf_counter() - t0)
        _obs.inc('handoff.pages_installed_total', installed)
        if have:
            _obs.inc('handoff.pages_deduped_total', have)
        if n_pages - have - installed > 0:
            _obs.inc('handoff.pages_dropped_total',
                     n_pages - have - installed)
    return covered_tokens, installed, have


def handoff(src_engine, dst_engine, tokens, ctx=None):
    """The whole hop: export from ``src_engine``, round-trip through the
    wire form, install into ``dst_engine``. Returns the
    covered token count (0 when nothing was cached to ship). One
    ``kv_handoff`` flight event and the ``handoff.*`` metrics a call.
    ``ctx`` (the request's reqtrace context) rides in the packet header,
    so the install is recorded under the same trace id."""
    for eng, what in ((src_engine, 'export_packet_bytes'),
                      (dst_engine, 'install_packet_bytes')):
        if callable(getattr(eng, what, None)):
            raise NotImplementedError(
                'handoff to or from a remote replica (%s) is not ported to '
                'paddle_tpu_torch: it comes with serving/rpc.py (ROADMAP '
                'Queue 1 item 10)' % what)
    t0 = time.perf_counter()
    pkt = export_packet(src_engine, tokens)
    if pkt is None:
        return 0
    if ctx is not None:
        pkt.header['trace'] = ctx.to_wire()
    wire = pkt.wire_bytes()
    pkt = KVPacket.from_bytes(pkt.to_bytes())
    covered, installed, dedup = install_packet(dst_engine, pkt)
    dt = time.perf_counter() - t0
    if _obs.enabled():
        _obs.inc('handoff.count_total')
        _obs.inc('handoff.bytes_total', wire)
        _obs.record('handoff.seconds', dt)
    _obs.flight_event('kv_handoff', pages=pkt.n_pages, installed=installed,
                      dedup=dedup, covered_tokens=covered, bytes=wire,
                      kv_dtype=pkt.kv_dtype, transport='inproc',
                      seconds=round(dt, 6))
    return covered
