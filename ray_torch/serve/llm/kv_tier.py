"""Tiered KV cache: the port's copy of ``ray_tpu/serve/llm/kv_tier.py``.

Prefix pages the allocator evicts under pool pressure are spilled, host
side, into this store instead of dying, and a prompt that returns with the
same chain restores them into the pool and prefills only its suffix:

- **shm tier**: spilled page chains are kept, one blob per spill batch
  (``[L, Hkv, pages, page, D]`` per k/v, or per-page codec payloads), in an
  in-process dict with the reference's accounting. The reference puts the
  blob into the node's shared-memory object plane and indexes its pages in
  the control plane for other replicas; the port has no runtime yet, so it
  keeps the single-replica store the reference degrades to outside a
  cluster (no cluster index, remote fetch, prefetch hints or warm start).
- **disk tier**: a bounded local directory backs shm under pressure: the
  LRU shm blob demotes to disk instead of dying.

Both caps are byte caps enforced at put time; eviction within a tier is
LRU; every entry carries a TTL. All failure paths degrade: a failed spill
leaves eviction a plain free, a failed restore is a plain cache miss.

Pages are stored ENCODED (kv_codec.py) when the store runs with a codec:
put() encodes each page outside every lock, and the byte caps and LRU
demotion account encoded bytes. The read path accepts both the raw blob
layout and the encoded one. Host pages are numpy arrays; a bf16 pool's
pages are its 16-bit words, and ``dtype="bfloat16"`` tags their payloads.

Restore is chunked and pipelined (:class:`ChainStream`): open_stream()
plans the chain's sources once and a background worker fetches
chunk_pages at a time, the landed-but-unconsumed buffer bounded by
window_bytes, while the consumer (the engine loop) takes, decodes and
injects pages as they land, and cuts a stream that stalls past its
per-chunk budget. A fault costs one chunk and a partial restore, not a
whole-chain miss.

Concurrency: ``self._lock`` guards only in-memory bookkeeping, never I/O.
Disk writes (demotion) and reads run on snapshots taken under the lock.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Callable, Optional

import numpy as np

from ray_torch.serve.llm import kv_codec

logger = logging.getLogger(__name__)

def _now() -> float:
    return time.time()


class KVTierStore:
    """Local spill store (shm + disk tiers).

    One instance per engine. All device work stays in the engine — this
    class only ever sees host numpy blobs. Thread-safe; the engine loop
    is the only writer, stats/CLI readers may probe concurrently.

    ``dtype`` is the payload tag of the host arrays ``put()`` takes:
    ``"bfloat16"`` for a bf16 pool's 16-bit words (kv_codec.py), None for
    arrays whose numpy dtype names them.
    """

    def __init__(self, max_bytes: int, disk_dir: Optional[str],
                 disk_max_bytes: int, ttl_s: float, page_size: int,
                 codec: str = "none", dtype: Optional[str] = None):
        if codec not in kv_codec.MODES:
            raise ValueError(f"unknown KV codec {codec!r}")
        self.max_bytes = int(max_bytes)
        self.disk_dir = disk_dir
        self.disk_max_bytes = int(disk_max_bytes)
        self.ttl_s = float(ttl_s)
        self.page_size = int(page_size)
        self.codec = str(codec)
        # payload dtype tag of the pages put() is given: "bfloat16" when
        # they are a bf16 pool's 16-bit words, else their numpy dtype
        self.dtype = dtype
        self._lock = threading.Lock()
        # blob_id -> record; OrderedDict is the shm-tier LRU (disk-tier
        # records stay members but carry tier="disk")
        self._blobs: OrderedDict[str, dict] = OrderedDict()
        self._by_digest: dict[str, tuple[str, int]] = {}  # digest -> (blob, off)
        # byte gauges per tier, encoded (caps/LRU currency) + raw (what
        # the bytes decode back to — the capacity-multiplier numerator)
        self._shm_bytes = 0
        self._disk_bytes = 0
        self._shm_raw = 0
        self._disk_raw = 0
        self.counters = {"put_blobs": 0, "put_pages": 0, "demoted_blobs": 0,
                         "dropped_blobs": 0, "expired_blobs": 0,
                         "local_hits": 0,
                         "put_bytes_raw": 0, "put_bytes_enc": 0}
        # codec cost samples (bounded rings -> p50 in stats()); appended
        # per put/fetch, one per-page-averaged sample each
        self._enc_ms: deque = deque(maxlen=256)
        self._dec_ms: deque = deque(maxlen=256)
        # live restore streams: registered at open_stream, removed by the
        # stream's own worker exit — close() aborts whatever is left
        self._streams: set = set()
        # test seam: fn(chunk_idx) invoked before each stream chunk
        # fetch; raising fails that chunk (-> partial restore downstream)
        self._chunk_fault: Optional[Callable[[int], None]] = None
    # ---- spill ----------------------------------------------------------
    def put(self, k_np: np.ndarray, v_np: np.ndarray,
            digests: list[str], tokens: list[int]) -> int:
        """Store one spilled chain batch. ``k_np``/``v_np`` are host
        arrays shaped [L, Hkv, n, page, D]; ``digests[i]``/``tokens[i]``
        are page i's chain digest (hex) and its cumulative token length.
        Returns how many pages were registered (0 when the batch doesn't
        fit the shm cap at all). With a codec configured the pages are
        encoded HERE — outside every lock, through the BATCH codec entry
        point (kv_codec.encode_pages: one relayout / cast / quant / byte-
        plane transpose for the whole spill batch) into per-page payloads
        a chunked restore can still decode independently — and all caps
        and LRU accounting run on encoded bytes."""
        raw_nbytes = int(k_np.nbytes) + int(v_np.nbytes)
        if not digests:
            return 0
        n = len(digests)
        if self.codec == "none":
            blob = {"k": k_np, "v": v_np, "page_size": self.page_size,
                    "digests": list(digests), "tokens": list(tokens)}
            nbytes = raw_nbytes
            sizes = [raw_nbytes // n] * n
            enc_ms = None
        else:
            t0 = time.perf_counter()
            pages = kv_codec.encode_pages(k_np, v_np, self.codec,
                                          dtype=self.dtype)
            enc_ms = (time.perf_counter() - t0) * 1e3 / n
            sizes = [kv_codec.encoded_nbytes(ek) + kv_codec.encoded_nbytes(ev)
                     for ek, ev in pages]
            nbytes = sum(sizes)
            blob = {"codec": self.codec, "page_size": self.page_size,
                    "digests": list(digests), "tokens": list(tokens),
                    "pages": pages}
        if nbytes > self.max_bytes:
            return 0
        bid = uuid.uuid4().hex[:16]
        rec = {"id": bid, "nbytes": nbytes, "raw": raw_nbytes,
               "sizes": sizes, "tier": "shm", "ts": _now(),
               "digests": list(digests), "tokens": list(tokens),
               "data": blob, "path": None}
        with self._lock:
            self._expire_locked()
        # demotion does disk I/O, so it runs its own lock/unlock cycles
        self._make_room(nbytes)
        with self._lock:
            self._blobs[bid] = rec
            self._shm_bytes += nbytes
            self._shm_raw += raw_nbytes
            for i, d in enumerate(digests):
                self._by_digest[d] = (bid, i)
            self.counters["put_blobs"] += 1
            self.counters["put_pages"] += n
            self.counters["put_bytes_raw"] += raw_nbytes
            self.counters["put_bytes_enc"] += nbytes
            if enc_ms is not None:
                self._enc_ms.append(enc_ms)
        return n

    # ---- tier maintenance ------------------------------------------------
    def _expire_locked(self) -> None:
        if self.ttl_s <= 0:
            return
        cutoff = _now() - self.ttl_s
        dead = [b for b, r in self._blobs.items() if r["ts"] < cutoff]
        for bid in dead:
            self._drop_locked(bid, reason="expired")

    def _make_room(self, nbytes: int) -> None:
        """Demote (or drop) LRU shm blobs until ``nbytes`` fits the shm
        cap. The disk write is staged OUTSIDE the lock — the victim is
        marked "demoting" so concurrent callers skip it, and the tier
        flip (accounting) happens under the lock only
        once the bytes are safely on disk. When nothing is demotable the
        caller inserts over-cap, same best-effort as a failed demotion
        (the engine loop is the only writer)."""
        while True:
            with self._lock:
                if self._shm_bytes + nbytes <= self.max_bytes:
                    return
                oldest = next((b for b, r in self._blobs.items()
                               if r["tier"] == "shm"
                               and not r.get("demoting")), None)
                if oldest is None:
                    return
                rec = self._blobs[oldest]
                if (self.disk_dir is None
                        or rec["nbytes"] > self.disk_max_bytes):
                    self._drop_locked(oldest, reason="dropped")
                    continue
                rec["demoting"] = True
                handle = {"data": rec["data"], "path": rec["path"]}
            path: Optional[str] = None
            try:
                blob = self._load_handle(handle)
                os.makedirs(self.disk_dir, exist_ok=True)
                path = os.path.join(self.disk_dir, rec["id"] + ".kvt")
                with open(path, "wb") as f:
                    pickle.dump(blob, f)
            except Exception:
                logger.warning("kv-tier: demotion to disk failed; dropping",
                               exc_info=True)
                path = None
            with self._lock:
                rec.pop("demoting", None)
                live = rec["id"] in self._blobs
                if live and path is not None:
                    while self._disk_bytes + rec["nbytes"] \
                            > self.disk_max_bytes:
                        victim = next((b for b, r in self._blobs.items()
                                       if r["tier"] == "disk"), None)
                        if victim is None:
                            break
                        self._drop_locked(victim, reason="dropped")
                    rec.update(tier="disk", path=path, data=None)
                    self._shm_bytes -= rec["nbytes"]
                    self._disk_bytes += rec["nbytes"]
                    self._shm_raw -= rec["raw"]
                    self._disk_raw += rec["raw"]
                    self.counters["demoted_blobs"] += 1
                    path = None
                elif live:
                    self._drop_locked(rec["id"], reason="dropped")
            if path is not None:
                # blob was dropped while we wrote: the file is an orphan
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _drop_locked(self, bid: str, reason: str) -> None:
        rec = self._blobs.pop(bid, None)
        if rec is None:
            return
        if rec["tier"] == "shm":
            self._shm_bytes -= rec["nbytes"]
            self._shm_raw -= rec["raw"]
        else:
            self._disk_bytes -= rec["nbytes"]
            self._disk_raw -= rec["raw"]
            if rec["path"]:
                try:
                    os.unlink(rec["path"])
                except OSError:
                    pass
        for d in rec["digests"]:
            if self._by_digest.get(d, (None,))[0] == bid:
                del self._by_digest[d]
        self.counters["%s_blobs" % reason] += 1

    def _load_handle(self, handle: dict) -> dict:
        """Materialize a blob from a snapshot taken under the lock. Runs
        WITHOUT the lock — disk reads must never serialize other store
        users."""
        if handle["data"] is not None:
            return handle["data"]
        with open(handle["path"], "rb") as f:
            return pickle.load(f)

    @staticmethod
    def _blob_pages(blobs: dict, run: list) -> list:
        """Decoded ``(k, v)`` [L, Hkv, 1, page, D] pages for every
        ``(blob-id, off)`` in ``run``, from either blob layout. Every
        encoded payload in the run decodes through ONE
        :func:`kv_codec.decode_pages` call (vectorized un-shuffle /
        dequant across the whole restore run) while raw blobs
        slice directly; order is preserved."""
        out: list = [None] * len(run)
        enc_k, enc_v, enc_at = [], [], []
        for j, (bid, off) in enumerate(run):
            blob = blobs[bid]
            pages = blob.get("pages")
            if pages is not None:
                ek, ev = pages[off]
                enc_k.append(ek)
                enc_v.append(ev)
                enc_at.append(j)
            else:
                out[j] = (blob["k"][:, :, off:off + 1],
                          blob["v"][:, :, off:off + 1])
        if enc_at:
            for j, k, v in zip(enc_at, kv_codec.decode_pages(enc_k),
                               kv_codec.decode_pages(enc_v)):
                out[j] = (k, v)
        return out

    def _note_decode(self, ms_per_page: float) -> None:
        with self._lock:
            self._dec_ms.append(ms_per_page)

    # ---- restore ---------------------------------------------------------
    def fetch_chain(self, digests: list[str], start: int):
        """Longest restorable run of chain pages beginning at ``start``.

        ``digests`` are the prompt's full-page chain digests (hex),
        position 0 first. Returns ``(t, k_np, v_np)`` with the arrays
        shaped [L, Hkv, t, page, D], or ``(0, None, None)``."""
        run: list[tuple[str, int]] = []
        handles: dict[str, dict] = {}
        with self._lock:
            self._expire_locked()
            i = start
            while i < len(digests):
                loc = self._by_digest.get(digests[i])
                if loc is None:
                    break
                run.append(loc)
                i += 1
            # touch for LRU recency and snapshot each blob's load handle
            # under the lock; the actual disk loads happen below,
            # lock released
            for bid, _off in run:
                if bid not in handles:
                    self._blobs.move_to_end(bid)
                    rec = self._blobs[bid]
                    handles[bid] = {"data": rec["data"],
                                    "path": rec["path"]}
        if run:
            try:
                blobs = {bid: self._load_handle(h)
                         for bid, h in handles.items()}
                t0 = time.perf_counter()
                pairs = self._blob_pages(blobs, run)
                dec_ms = (time.perf_counter() - t0) * 1e3 / len(run)
                with self._lock:
                    self.counters["local_hits"] += len(run)
                    if any("pages" in b for b in blobs.values()):
                        self._dec_ms.append(dec_ms)
                return (len(run), np.concatenate([k for k, _ in pairs],
                                                 axis=2),
                        np.concatenate([v for _, v in pairs], axis=2))
            except Exception:
                # the blob moved (dropped, file gone) between snapshot
                # and load: a miss
                logger.debug("kv-tier: local chain load failed",
                             exc_info=True)
        return 0, None, None

    # ---- streaming restore (see ChainStream) -----------------------------
    def open_stream(self, digests: list[str], start: int, *,
                    chunk_pages: int = 8,
                    window_bytes: int = 8 * 1024 * 1024,
                    on_ready=None) -> "ChainStream":
        """Begin a pipelined chunked restore of ``digests[start:]``.
        Returns immediately — planning and all fetches run on the
        stream's worker; the caller polls
        ``take()``/``exhausted``. ``on_ready`` fires (from the worker)
        whenever new pages land or the stream ends."""
        s = ChainStream(self, digests, start, chunk_pages=chunk_pages,
                        window_bytes=window_bytes, on_ready=on_ready)
        with self._lock:
            self._streams.add(s)
        s._start()
        return s

    def _stream_exit(self, s: "ChainStream") -> None:
        with self._lock:
            self._streams.discard(s)

    # ---- observability / lifecycle --------------------------------------
    def stats(self) -> dict:
        with self._lock:
            shm = sum(1 for r in self._blobs.values() if r["tier"] == "shm")
            enc = sorted(self._enc_ms)
            dec = sorted(self._dec_ms)
            pr = self.counters["put_bytes_raw"]
            pe = self.counters["put_bytes_enc"]
            return {**self.counters,
                    "shm_bytes": self._shm_bytes,
                    "disk_bytes": self._disk_bytes,
                    "shm_bytes_raw": self._shm_raw,
                    "disk_bytes_raw": self._disk_raw,
                    "codec": self.codec,
                    # cumulative raw/encoded put ratio == the effective
                    # capacity multiplier every tier byte cap gains
                    "codec_ratio": round(pr / pe, 3) if pe else 0.0,
                    "encode_ms_p50": round(enc[len(enc) // 2], 3)
                    if enc else 0.0,
                    "decode_ms_p50": round(dec[len(dec) // 2], 3)
                    if dec else 0.0,
                    "blobs_shm": shm,
                    "blobs_disk": len(self._blobs) - shm,
                    "indexed_pages": len(self._by_digest),
                    "streams": len(self._streams)}

    def close(self) -> None:
        """Abort the live restore streams and drop every blob (clean
        engine shutdown)."""
        with self._lock:
            streams = list(self._streams)
        for s in streams:
            s.abort()   # wakes parked workers; they exit on their own
        with self._lock:
            for bid in list(self._blobs):
                self._drop_locked(bid, reason="dropped")


class ChainStream:
    """One pipelined chunked restore (see KVTierStore.open_stream).

    A background worker plans the chain's page sources once — the tier
    walk under the store lock, load handles snapshotted — and fetches
    ``chunk_pages`` pages at a time in chain order.

    Bounds: the landed-but-untaken buffer is capped by ``window_bytes``
    (backpressure parks the worker; the buffer never grows past the
    window). A chunk failure ends the
    stream at that chunk boundary; pages already landed stay takeable,
    which is what turns a mid-chain fault into a PARTIAL restore
    downstream.

    Thread model: one daemon worker per stream. ``take()``/``abort()``
    are consumer-side (the engine loop). Store-lock work is bounded
    bookkeeping only; loads and codec work run outside both the store
    lock and the stream condition.
    """

    def __init__(self, store: KVTierStore, digests: list[str], start: int,
                 *, chunk_pages: int, window_bytes: int, on_ready=None):
        self._store = store
        self._digests = list(digests)
        self._first = int(start)
        self._chunk_pages = max(1, int(chunk_pages))
        self._window_bytes = max(1, int(window_bytes))
        self._on_ready = on_ready
        self._cond = threading.Condition()
        # landed, untaken pages: (payload_k, payload_v, encoded?, wire
        # bytes) in chain order; byte-bounded by _window_wait
        self._ready: deque = deque()
        self._ready_bytes = 0
        self._aborted = False
        self._worker_done = False
        self.failed = False
        self.error: Optional[str] = None
        self.planned: Optional[int] = None  # pages the plan covers
        self.landed = 0                     # pages fetched by the worker
        self.taken = 0                      # pages handed to take()
        self.wire_bytes = 0                 # encoded bytes fetched
        self.last_progress = time.monotonic()

    def _start(self) -> None:
        threading.Thread(target=self._run, daemon=True,
                         name="kv-tier-stream").start()

    # ---- consumer side ---------------------------------------------------
    def take(self, max_pages: Optional[int] = None):
        """Pop landed pages in chain order and decode them. Returns
        ``(pairs, wire_bytes, decode_ms)``: decoded (k, v) page arrays,
        their wire footprint, and the codec time spent HERE — on the
        consumer's thread, deliberately, so decode overlaps the worker's
        next chunk fetch and stays off the store lock."""
        grabbed = []
        with self._cond:
            while self._ready and (max_pages is None
                                   or len(grabbed) < max_pages):
                item = self._ready.popleft()
                self._ready_bytes -= item[3]
                grabbed.append(item)
            if grabbed:
                self.taken += len(grabbed)
                self._cond.notify_all()   # window space freed
        if not grabbed:
            return [], 0, 0.0
        t0 = time.perf_counter()
        # batch-decode every encoded page in the chunk through ONE
        # kv_codec.decode_pages call (vectorized un-shuffle / dequant);
        # raw pages pass through untouched, order preserved
        pairs: list = [None] * len(grabbed)
        enc_k, enc_v, enc_at = [], [], []
        wire = 0
        for j, (pk, pv, enc, nb) in enumerate(grabbed):
            if enc:
                enc_k.append(pk)
                enc_v.append(pv)
                enc_at.append(j)
            else:
                pairs[j] = (pk, pv)
            wire += nb
        n_enc = len(enc_at)
        if enc_at:
            for j, k, v in zip(enc_at, kv_codec.decode_pages(enc_k),
                               kv_codec.decode_pages(enc_v)):
                pairs[j] = (k, v)
        dec_ms = (time.perf_counter() - t0) * 1e3
        if n_enc:
            self._store._note_decode(dec_ms / n_enc)
        return pairs, wire, dec_ms

    @property
    def exhausted(self) -> bool:
        """Nothing more will land AND everything landed was taken — the
        consumer's cue to finalize (full or partial) and move on."""
        with self._cond:
            return (self._worker_done or self._aborted) \
                and not self._ready

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()

    # ---- worker side -----------------------------------------------------
    def _run(self) -> None:
        st = self._store
        try:
            plan = self._plan()
        except Exception as e:  # noqa: BLE001 — restore degrades to miss
            self._finish(failed=True, error=repr(e))
            return
        with self._cond:
            self.planned = len(plan)
            self.last_progress = time.monotonic()
        blobs: dict = {}   # source blob cache, one load/get per blob
        for ci in range(0, len(plan), self._chunk_pages):
            chunk = plan[ci:ci + self._chunk_pages]
            if not self._window_wait():
                break
            try:
                fault = st._chunk_fault
                if fault is not None:
                    fault(ci // self._chunk_pages)
                items = self._fetch_chunk(chunk, blobs)
            except Exception as e:  # noqa: BLE001 — chunk -> partial
                self._finish(failed=True, error=repr(e))
                return
            with self._cond:
                if self._aborted:
                    break
                self._ready.extend(items)
                self._ready_bytes += sum(it[3] for it in items)
                self.landed += len(items)
                self.wire_bytes += sum(it[3] for it in items)
                self.last_progress = time.monotonic()
                self._cond.notify_all()
            if items:
                with st._lock:
                    st.counters["local_hits"] += len(items)
            self._notify_ready()
        self._finish()

    def _finish(self, failed: bool = False,
                error: Optional[str] = None) -> None:
        if failed:
            logger.debug("kv-tier: stream ended at a chunk fault: %s",
                         error)
        with self._cond:
            self.failed = self.failed or failed
            if error and not self.error:
                self.error = error
            self._worker_done = True
            self.last_progress = time.monotonic()
            self._cond.notify_all()
        self._store._stream_exit(self)
        self._notify_ready()

    def _notify_ready(self) -> None:
        if self._on_ready is not None:
            try:
                self._on_ready()
            except Exception:  # noqa: BLE001 — wake is best-effort
                pass

    def _window_wait(self) -> bool:
        """Park until the landed-but-untaken bytes fit the window.
        False = aborted, or the consumer stopped taking for 60s (an
        abandoned stream must not pin its worker forever)."""
        deadline = time.monotonic() + 60.0
        with self._cond:
            while self._ready_bytes >= self._window_bytes:
                if self._aborted or time.monotonic() > deadline:
                    self._aborted = True
                    return False
                self.last_progress = time.monotonic()
                self._cond.wait(timeout=0.5)
            return not self._aborted

    def _plan(self) -> list[tuple]:
        """Ordered per-page sources, contiguous from the stream's first
        page: ``(blob-id, off, load handle)``."""
        st = self._store
        digs = self._digests
        plan: list[tuple] = []
        with st._lock:
            st._expire_locked()
            for d in digs[self._first:]:
                loc = st._by_digest.get(d)
                if loc is None:
                    break
                bid, off = loc
                st._blobs.move_to_end(bid)
                rec = st._blobs[bid]
                plan.append((bid, off, {"data": rec["data"],
                                        "path": rec["path"]}))
        return plan

    def _fetch_chunk(self, chunk: list[tuple], blobs: dict) -> list:
        """Load one chunk's pages (outside every lock). Each distinct
        source blob is loaded once per stream and cached in ``blobs``
        (bounded by the chain's source-blob count)."""
        items = []
        for bid, off, handle in chunk:
            if bid not in blobs:
                blobs[bid] = self._store._load_handle(handle)
            blob = blobs[bid]
            pages = blob.get("pages")
            if pages is not None:
                ek, ev = pages[off]
                wire = kv_codec.encoded_nbytes(ek) \
                    + kv_codec.encoded_nbytes(ev)
                items.append((ek, ev, True, wire))
            else:
                pk = blob["k"][:, :, off:off + 1]
                pv = blob["v"][:, :, off:off + 1]
                items.append((pk, pv, False,
                              int(pk.nbytes) + int(pv.nbytes)))
        return items
