"""Content fingerprinting for host-side caches (plans, programs, beams).

A copy of ``fftvis_tpu/core/hashing.py`` (the tests hold its digests and keys
to the original's) with two additions:

- :func:`beam_fingerprint` dispatches on the port's own beam classes;
- an array memoized as frozen is hashed afresh once it is writeable again
  (the original keeps its frozen digest, so a table unfrozen and changed in
  place would hit stale);

and the port-only :class:`LRUCache`, which counts its hits and misses.
"""

from __future__ import annotations

import hashlib
import weakref
import zlib

import numpy as np

# Identity-memoized array digests. A simulate() sweep passes the SAME flux /
# position arrays every call; re-SHA1ing a catalog-sized array each time was
# ~40% of the steady-state host wall. The memo keys on object identity
# (weakref-guarded against id reuse) and re-checks content each call with
# CRC32 plus a uint64 wraparound sum (a single CRC32 would make a
# digest-preserving mutation a ~2^-32 event, and these caches gate
# simulation correctness). The sum is a single memory-bandwidth numpy pass.
_DIGEST_MEMO: dict[int, tuple] = {}
# SHA1 runs ~0.5 GB/s; the CRC+sum revalidation pair ~4 GB/s. Above 64 KB
# the memo + revalidate path wins even for a single reuse, and the engine
# re-hashes its inputs every simulate() call (plan key, program key, input
# cache), so mid-size host arrays (per-time rotation matrices, masks,
# culled coordinate blocks) are worth memoizing too.
_MEMO_MIN_BYTES = 1 << 16

# Consistent-inputs window: inside one engine simulate() call the same user
# arrays are hashed several times (plan key, program key, input cache); the
# caller is single-threaded and does not mutate its inputs MID-call, so each
# array needs content revalidation at most once per window. Outside any
# window every lookup revalidates (the conservative default).
_WINDOW_DEPTH = 0
_WINDOW_ID = 0


class consistent_inputs:
    """Context manager: revalidate each memoized array at most once inside.

    Only enter around code that cannot mutate the hashed arrays midway
    (e.g. one engine ``simulate()`` call). Reentrant; nested windows share
    the outermost window's id.
    """

    def __enter__(self):
        global _WINDOW_DEPTH, _WINDOW_ID
        if _WINDOW_DEPTH == 0:
            _WINDOW_ID += 1
        _WINDOW_DEPTH += 1
        return self

    def __exit__(self, *exc):
        global _WINDOW_DEPTH
        _WINDOW_DEPTH -= 1
        return False


def _content_check(buf) -> tuple:
    """Cheap ~2^-64 content check: (CRC32, uint64 wraparound sum).

    ``buf`` is a C-contiguous ndarray. The sum covers the 8-byte-aligned
    prefix (one numpy pass at memory bandwidth); the CRC covers every
    byte including any tail.
    """
    crc = zlib.crc32(buf)
    n8 = (buf.nbytes // 8) * 8
    if n8:
        # buf.data is a memoryview in dtype-sized items; cast to a byte
        # view before slicing the 8-byte-aligned prefix (an item-sliced
        # view of e.g. an odd-count float32 array is not a multiple of 8
        # bytes and frombuffer(uint64) would raise).
        mv = memoryview(buf.data).cast("B")
        s = int(
            np.frombuffer(mv[:n8], dtype=np.uint64).sum(dtype=np.uint64)
        )
    else:  # pragma: no cover - sub-8-byte arrays never reach the memo
        s = 0
    return (crc, s)


def _immutable_owner(arr: np.ndarray) -> bool:
    """True when no alias of ``arr`` can mutate its buffer: the array is
    non-writeable and so is whatever owns its memory. Framework-owned
    tables (prepared beam grids) are frozen at construction so their
    digests need no per-call content revalidation."""
    if arr.flags.writeable:
        return False
    base = arr.base
    return base is None or (isinstance(base, np.ndarray) and not base.flags.writeable)


def _array_digest(arr: np.ndarray) -> bytes:
    c = arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)
    # dtype.str is a C-level attribute; str(dtype) costs ~14 us per call in
    # Python and cache keys hash hundreds of small arrays per simulate().
    meta = (arr.shape, arr.dtype.str)
    # Frozen (immutable-owner) arrays are memoized at ANY size: their
    # content can never change, so even a tiny axis/coordinate array is
    # worth a one-time digest (beam fingerprints re-hash them every call).
    frozen = _immutable_owner(arr)
    small = arr.nbytes < _MEMO_MIN_BYTES and not frozen
    crc = None
    if not small:
        ent = _DIGEST_MEMO.get(id(arr))
        if ent is not None and ent[0]() is arr and ent[2] == meta:
            if ent[1] is None:  # stored as immutable-owner: content frozen
                if frozen:
                    return ent[3]
                # Writeable again since: no content check was kept, so the
                # digest is taken afresh below.
            elif _WINDOW_DEPTH > 0 and ent[4] == _WINDOW_ID:
                return ent[3]  # already revalidated inside this window
            else:
                crc = _content_check(c)
                if ent[1] == crc:
                    if _WINDOW_DEPTH > 0:
                        _DIGEST_MEMO[id(arr)] = ent[:4] + (_WINDOW_ID,)
                    return ent[3]
    h = hashlib.sha1()
    h.update(arr.dtype.str.encode())
    h.update(str(arr.shape).encode())
    h.update(c)  # zero-copy: hashlib consumes the buffer protocol directly
    digest = h.digest()
    if not small:
        if frozen:
            crc = None  # content can never change: skip future revalidation
        elif crc is None:
            crc = _content_check(c)
        try:
            ref = weakref.ref(
                arr, lambda _r, _i=id(arr): _DIGEST_MEMO.pop(_i, None)
            )
            _DIGEST_MEMO[id(arr)] = (
                ref, crc, meta, digest,
                _WINDOW_ID if _WINDOW_DEPTH > 0 else -1,
            )
        except TypeError:  # pragma: no cover - non-weakref-able subclass
            pass
    return digest


def cache_get_lru(cache: dict, key):
    """dict-as-LRU lookup: a hit moves the key to the back.

    Every bounded cache evicts from the FRONT of its dict
    (``cache.pop(next(iter(cache)))``); plain ``dict.get`` makes that FIFO,
    which thrashes when a steady-state working set exceeds the limit (N+1
    round-robin keys against an N-slot FIFO miss every lookup). Moving hits
    to the back turns the same eviction into LRU.
    """
    hit = cache.get(key)
    if hit is not None:
        cache.pop(key)
        cache[key] = hit
    return hit


def hash_parts(parts) -> str:
    """SHA1 over a nested structure of scalars/strings/arrays/tuples/dicts."""
    h = hashlib.sha1()

    def feed(obj):
        if obj is None or isinstance(obj, (str, int, float, bool, bytes)):
            h.update(repr(obj).encode())
        elif isinstance(obj, np.ndarray):
            h.update(_array_digest(obj))
        elif isinstance(obj, (tuple, list)):
            h.update(b"(")
            for item in obj:
                feed(item)
            h.update(b")")
        elif isinstance(obj, dict):
            for k in sorted(obj, key=repr):
                feed(k)
                feed(obj[k])
        else:
            h.update(repr(obj).encode())

    feed(parts)
    return h.hexdigest()


def beam_fingerprint(bi) -> tuple:
    """Static description of a beam object (any of this package's kinds)."""
    from ..beams.analytic import AnalyticBeam
    from ..beams.gridded import GriddedBeam
    from ..beams.interface import BeamInterface, PowerBeam

    if isinstance(bi, BeamInterface):
        return ("iface", bi.beam_type, beam_fingerprint(bi.beam))
    if isinstance(bi, PowerBeam):
        return ("power", bi.use_feed, beam_fingerprint(bi.base))
    if isinstance(bi, GriddedBeam):
        return (
            "grid",
            bi.beam_type,
            None if bi.feeds is None else tuple(bi.feeds),
            bi.data_array,
            bi.axis1_array,
            bi.axis2_array,
            bi.freq_array,
        )
    if isinstance(bi, AnalyticBeam):
        return (
            type(bi).__name__,
            tuple(
                sorted(
                    (k, v)
                    for k, v in vars(bi).items()
                    if isinstance(v, (int, float, str, bool, type(None)))
                )
            ),
        )
    return ("other", repr(bi))


class LRUCache:
    """A bounded content-keyed cache with LRU eviction (:func:`cache_get_lru`)
    and counts of its lookups: ``hits`` and ``misses`` since the last
    :meth:`clear`. ``limit`` may be raised while in use."""

    def __init__(self, limit: int):
        self.limit = limit
        self.entries: dict = {}
        self.hits = 0
        self.misses = 0

    def get(self, key):
        hit = cache_get_lru(self.entries, key)
        if hit is None:
            self.misses += 1
        else:
            self.hits += 1
        return hit

    def put(self, key, value):
        while len(self.entries) >= self.limit:
            self.entries.pop(next(iter(self.entries)))
        self.entries[key] = value
        return value

    def get_or_build(self, key, build):
        """The entry of ``key``, or ``build()`` stored under it."""
        hit = self.get(key)
        return hit if hit is not None else self.put(key, build())

    def clear(self) -> None:
        self.entries.clear()
        self.hits = self.misses = 0
