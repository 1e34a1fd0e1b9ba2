"""Keep-alive HTTP transport for the serve mesh (the port's copy of
``hpnn_tpu/serve/mesh/transport.py``).

Without it every mesh RPC would open a fresh TCP connection: the worker
dispatch path would pay connect + slow-start per batch, the health loop
per poll, the fleet collector per page.
Communication-layer studies of distributed DNN stacks (Awan et al.,
arXiv:1810.11112) put connection management squarely in the tail-latency
budget -- so the mesh now speaks through ONE transport:

* **connection pool** -- ``request()`` draws from a process-global pool
  of keep-alive connections keyed by ``host:port``
  (``HPNN_MESH_KEEPALIVE=0`` restores fresh-per-call).  Idle sockets
  are liveness-checked at acquire (a peer that closed while we were
  idle is detected by a zero-byte peek, not by a failed RPC) and
  retired after ``HPNN_MESH_KEEPALIVE_IDLE_S`` unused; at most
  ``HPNN_MESH_POOL_SIZE`` idle sockets are kept per peer.  The port
  sets ``TCP_NODELAY`` on its client sockets: ``http.client`` writes a
  request's headers and its body in two sends, and with Nagle's
  algorithm the body's last partial segment can wait for the peer's
  delayed ACK of the headers (measured on an H100 host: 6-9% lower p50
  a keep-alive RPC with it; ``nodelay=False`` is that comparison's
  other side).
* **stale-connection retry** -- a REUSED socket that dies before the
  status line arrives (``RemoteDisconnected``/reset/broken pipe at
  send: the classic keep-alive race against the peer's idle timeout)
  is retried ONCE on a fresh connection.  A failure after response
  bytes arrived, or on a fresh connection, propagates -- those are real
  transport errors the mesh's failover machinery must see.
* **fault injection** -- every request consults :mod:`chaos`
  (``HPNN_FAULT``), which is what makes the failover/retry/backoff
  paths deterministic to test: the chaos layer injects its faults
  HERE, below every caller.
* **backoff** -- :class:`Backoff` is the shared jittered-exponential
  schedule (worker heartbeat re-registration, blob re-fetch): bounded,
  deadline-aware at the call sites, and jittered so a hundred workers
  losing one router do not re-register in lockstep.
* **blob fetch** -- :func:`fetch_blob` pulls a content-addressed weight
  blob (``GET /v1/mesh/blob/<sha256>``) with bounded retries and
  VERIFIES the sha256 before handing the bytes over -- a worker never
  loads weights that do not hash to what the router announced.

``TRANSPORT_ERRORS`` lives here (re-exported by :mod:`backend` for
compatibility): the tuple of exception types that mean "the peer is
gone/unreachable" as opposed to "the peer answered and said no".
"""

from __future__ import annotations

import hashlib
import http.client
import os
import random
import socket
import threading
import time
from collections import deque

from ...utils.env import env_float, env_int
from . import chaos

# transport-level failures that mean "this peer is gone/unreachable"
# (retry elsewhere / back off), as opposed to an HTTP reply that means
# "the peer answered and said no" (propagate)
TRANSPORT_ERRORS = (ConnectionError, http.client.HTTPException,
                    socket.timeout, TimeoutError, OSError)

# a REUSED keep-alive socket failing before any response byte: the peer
# closed it while idle -- retry once on a fresh connection (the request
# either never left or never reached an intact peer; mesh RPCs are
# idempotent regardless, see backend.py)
_STALE_ERRORS = (http.client.RemoteDisconnected, ConnectionResetError,
                 BrokenPipeError, ConnectionAbortedError)


def split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


def _sock_alive(sock) -> bool:
    """A zero-byte peek on an IDLE socket: readable + empty means the
    peer sent FIN while we were away -- retire it before an RPC trips
    over the corpse."""
    import select

    try:
        readable, _, _ = select.select([sock], [], [], 0)
        if not readable:
            return True  # nothing pending: still open
        return sock.recv(1, socket.MSG_PEEK) != b""
    except OSError:
        return False


class _NoDelayConnection(http.client.HTTPConnection):
    """An ``HTTPConnection`` whose socket has ``TCP_NODELAY`` set."""

    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class ConnectionPool:
    """Keep-alive ``http.client`` connections keyed by peer address.

    Thread-safe; concurrency above the idle cap simply creates fresh
    connections (and pools the first ``max_idle`` back).  The pool never
    blocks waiting for a socket."""

    def __init__(self, max_idle: int | None = None,
                 idle_timeout_s: float | None = None,
                 enabled: bool | None = None,
                 nodelay: bool = True):
        self.max_idle = (max_idle if max_idle is not None
                         else env_int("HPNN_MESH_POOL_SIZE", 8))
        self.idle_timeout_s = (
            idle_timeout_s if idle_timeout_s is not None
            else env_float("HPNN_MESH_KEEPALIVE_IDLE_S", 30.0))
        self.enabled = (enabled if enabled is not None
                        else env_int("HPNN_MESH_KEEPALIVE", 1) != 0)
        self.nodelay = bool(nodelay)
        self._idle: dict[str, deque] = {}   # addr -> (conn, t_mono)
        self._lock = threading.Lock()
        self.reused_total = 0
        self.fresh_total = 0
        self.retired_total = 0

    def acquire(self, addr: str, timeout_s: float,
                fresh: bool = False
                ) -> tuple[http.client.HTTPConnection, bool]:
        """A connection to ``addr`` with its timeout set: (conn,
        reused).  Reused connections were liveness-peeked;
        ``fresh=True`` bypasses the idle bucket entirely (the
        stale-retry path must never draw a SECOND pooled corpse)."""
        now = time.monotonic()
        while self.enabled and not fresh:
            with self._lock:
                bucket = self._idle.get(addr)
                entry = bucket.popleft() if bucket else None
            if entry is None:
                break
            conn, t_idle = entry
            if (now - t_idle > self.idle_timeout_s
                    or conn.sock is None
                    or not _sock_alive(conn.sock)):
                with self._lock:
                    self.retired_total += 1
                conn.close()
                continue
            conn.timeout = timeout_s
            conn.sock.settimeout(timeout_s)
            with self._lock:
                self.reused_total += 1
            return conn, True
        host, port = split_addr(addr)
        with self._lock:
            self.fresh_total += 1
        cls = (_NoDelayConnection if self.nodelay
               else http.client.HTTPConnection)
        return cls(host, port, timeout=timeout_s), False

    def release(self, addr: str, conn) -> None:
        """Return a connection whose response was FULLY read."""
        if not self.enabled or conn.sock is None:
            conn.close()
            return
        with self._lock:
            bucket = self._idle.setdefault(addr, deque())
            if len(bucket) < self.max_idle:
                bucket.append((conn, time.monotonic()))
                return
        conn.close()

    def discard(self, conn) -> None:
        conn.close()

    def stats(self) -> dict:
        with self._lock:
            idle = sum(len(b) for b in self._idle.values())
            reused, fresh = self.reused_total, self.fresh_total
            retired = self.retired_total
        total = reused + fresh
        return {"enabled": self.enabled,
                "reused_total": reused,
                "fresh_total": fresh,
                "retired_total": retired,
                "idle": idle,
                "reuse_ratio": round(reused / total, 4)
                if total else 0.0}

    def close(self) -> None:
        with self._lock:
            buckets = list(self._idle.values())
            self._idle.clear()
        for b in buckets:
            for conn, _t in b:
                conn.close()


_default_pool: ConnectionPool | None = None
_default_pool_lock = threading.Lock()


def default_pool() -> ConnectionPool:
    global _default_pool
    if _default_pool is None:
        with _default_pool_lock:
            if _default_pool is None:
                _default_pool = ConnectionPool()
    return _default_pool


def request(addr: str, method: str, path: str,
            body: bytes | None = None,
            headers: dict | None = None,
            timeout_s: float = 10.0,
            pool: ConnectionPool | None = None
            ) -> tuple[int, bytes, dict]:
    """One mesh RPC through the keep-alive pool (+ chaos): returns
    (status, raw body bytes, response headers).  Transport failures
    raise (``TRANSPORT_ERRORS``); any HTTP status returns."""
    pool = pool or default_pool()
    rule = chaos.pick(path)
    if rule is not None:
        if rule.kind == "latency":
            time.sleep(rule.ms / 1e3)
        elif rule.kind == "reset":
            raise ConnectionResetError(
                "chaos: injected connection reset (pre-send)")
        elif rule.kind == "http":
            raw = (b'{"error": "chaos: injected HTTP %d", '
                   b'"reason": "chaos"}' % rule.code)
            return rule.code, raw, {}
    h = dict(headers or {})
    last_exc: Exception | None = None
    for attempt in (0, 1):
        conn, reused = pool.acquire(addr, timeout_s,
                                    fresh=attempt > 0)
        try:
            conn.request(method, path, body=body, headers=h)
            resp = conn.getresponse()
            raw = resp.read()
        except _STALE_ERRORS as exc:
            pool.discard(conn)
            if reused and attempt == 0:
                # keep-alive race: the peer idled this socket out under
                # us before the status line -- one fresh-connection retry
                last_exc = exc
                continue
            raise
        except BaseException:
            pool.discard(conn)
            raise
        if rule is not None and rule.kind in ("reset-after", "timeout",
                                              "truncate"):
            # post-send faults: the peer DID process the request; the
            # failure is losing the answer.  The socket's framing is a
            # lie from here on, so never pool it.
            pool.discard(conn)
            if rule.kind == "reset-after":
                raise ConnectionResetError(
                    "chaos: injected reset after request sent")
            if rule.kind == "timeout":
                raise socket.timeout(
                    "chaos: injected timeout during response read")
            if rule.kind == "truncate":
                raise http.client.IncompleteRead(
                    raw[:len(raw) // 2], len(raw) - len(raw) // 2)
        resp_headers = dict(resp.getheaders())
        if resp.will_close:
            pool.discard(conn)
        else:
            pool.release(addr, conn)
        return resp.status, raw, resp_headers
    raise last_exc  # pragma: no cover - loop always returns or raises


class Backoff:
    """Jittered exponential backoff: ``base * factor^n`` capped at
    ``cap``, each delay multiplied by ``1 ± jitter`` so a fleet of
    retriers decorrelates.  Callers sleep; this only does arithmetic."""

    def __init__(self, base_s: float = 0.5, cap_s: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.25,
                 rng: random.Random | None = None):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self._rng = rng or random.Random()
        self._n = 0

    @property
    def failures(self) -> int:
        return self._n

    def next_delay(self) -> float:
        d = min(self.cap_s, self.base_s * (self.factor ** self._n))
        self._n += 1
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def reset(self) -> None:
        self._n = 0


class BlobError(Exception):
    """A content-addressed blob could not be fetched or failed its
    sha256/size verification."""


_HASH_CHUNK = 1 << 20  # hash in bounded 1 MiB pieces, never one buffer


def _sha256_hex(data) -> str:
    """Chunked sha256 of a fetched body: the hasher consumes bounded
    memoryview slices -- the same streaming loop the file re-verify
    uses, so neither path feeds it one giant buffer."""
    h = hashlib.sha256()
    view = memoryview(data)
    for off in range(0, len(view), _HASH_CHUNK):
        h.update(view[off:off + _HASH_CHUNK])
    return h.hexdigest()


def verify_blob_file(path: str, sha256: str,
                     size: int | None = None) -> bool:
    """Streaming re-verify of an already-landed blob: the size check
    runs FIRST (one stat -- a truncated file short-circuits before any
    hashing), then the sha256 streams in bounded chunks instead of a
    whole-file read."""
    try:
        if size is not None and os.path.getsize(path) != int(size):
            return False
        h = hashlib.sha256()
        with open(path, "rb") as fp:
            while True:
                piece = fp.read(_HASH_CHUNK)
                if not piece:
                    break
                h.update(piece)
    except OSError:
        return False
    return h.hexdigest() == sha256


# per-sha single-flight: concurrent reload broadcasts for
# one generation must download each blob ONCE per host -- the first
# caller fetches, later callers wait on its event and re-verify the
# landed file.  Keyed by dest path, so distinct blob dirs (tests, two
# agents in one process) never serialize on each other.
_sf_lock = threading.Lock()
_sf_events: dict[str, threading.Event] = {}

_PEER_TIMEOUT_S = 5.0  # one peer try never eats the whole deadline


def fetch_blob(addr: str, sha256: str, size: int | None,
               dest_dir: str, timeout_s: float = 15.0,
               headers: dict | None = None,
               attempts: int = 3) -> str:
    """Pull ``GET /v1/mesh/blob/<sha256>`` from ``addr``, VERIFY the
    bytes hash to ``sha256`` (and match ``size`` when given), and
    atomically write them to ``dest_dir/<sha256>.opt``.  Returns the
    local path.  Retries transport failures/5xx with jittered backoff,
    bounded by ``attempts`` and the ``timeout_s`` deadline; raises
    :class:`BlobError` when the blob cannot be landed.

    Content addressing makes this idempotent: a file already present
    under the right name is re-verified and reused, so concurrent
    reload broadcasts for one generation fetch once."""
    path, _src, _misses = fetch_blob_from(
        addr, sha256, size, dest_dir, timeout_s=timeout_s,
        headers=headers, attempts=attempts)
    return path


def fetch_blob_from(addr: str, sha256: str, size: int | None,
                    dest_dir: str, peers: tuple | list = (),
                    timeout_s: float = 15.0,
                    headers: dict | None = None,
                    attempts: int = 3,
                    rng: random.Random | None = None
                    ) -> tuple[str, str, int]:
    """Multi-source blob fetch: try the hinted ``peers``
    (jittered order, one bounded try each) before falling back to
    ``addr`` -- the router, the always-correct origin -- so a reload
    broadcast's bytes fan out peer-to-peer instead of serializing on
    one NIC.  A peer that 404s (has not landed the blob yet), fails at
    the transport layer, or serves bytes that do not hash to ``sha256``
    (a poisoned peer: NEVER loadable) just advances to the next source.

    Returns ``(path, source, peer_misses)``: the landed file, the
    address that served the bytes (``"cache"`` when the file was
    already present and re-verified), and how many peer tries failed.

    Per-sha single-flight: concurrent calls for one dest download once
    -- the leader fetches, the rest wait and re-verify the landed
    file."""
    if not sha256 or not all(c in "0123456789abcdef"
                             for c in sha256.lower()):
        raise BlobError(f"bad sha256 {sha256!r}")
    sha256 = sha256.lower()
    dest = os.path.join(dest_dir, f"{sha256}.opt")
    deadline = time.monotonic() + timeout_s
    while True:
        if verify_blob_file(dest, sha256, size):
            return dest, "cache", 0
        with _sf_lock:
            ev = _sf_events.get(dest)
            if ev is None:
                _sf_events[dest] = ev = threading.Event()
                break  # leader: this call performs the download
        # a concurrent fetch of this blob is in flight on this host:
        # wait for it, then re-verify what it landed (followers never
        # open a second download)
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise BlobError(f"blob {sha256}: timed out waiting for a "
                            "concurrent fetch")
        ev.wait(remaining)
        # loop: either the landed file verifies, or the leader failed
        # and this caller takes leadership on the next pass
    try:
        return _fetch_multi(addr, sha256, size, dest, dest_dir,
                            peers, deadline, headers, attempts, rng)
    finally:
        with _sf_lock:
            _sf_events.pop(dest, None)
        ev.set()


def _land_blob(dest_dir: str, dest: str, raw: bytes) -> None:
    from ...io.atomic import atomic_write_bytes

    os.makedirs(dest_dir, exist_ok=True)
    atomic_write_bytes(dest, raw)


def _fetch_multi(addr: str, sha256: str, size: int | None, dest: str,
                 dest_dir: str, peers, deadline: float,
                 headers: dict | None, attempts: int,
                 rng: random.Random | None) -> tuple[str, str, int]:
    path = f"/v1/mesh/blob/{sha256}"
    misses = 0
    order = [p for p in peers if p and p != addr]
    (rng or random).shuffle(order)
    for peer in order:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            status, raw, _ = request(
                peer, "GET", path, headers=headers,
                timeout_s=min(remaining, _PEER_TIMEOUT_S))
        except TRANSPORT_ERRORS:
            misses += 1
            continue
        if status != 200:
            # peer miss: it has not landed this blob (or refused);
            # unlike the router's 404 this is not authoritative
            misses += 1
            continue
        if size is not None and len(raw) != int(size):
            misses += 1
            continue
        if _sha256_hex(raw) != sha256:
            # a poisoned peer serving wrong bytes: rejected by the
            # hash, never swapped in -- try the next source
            misses += 1
            continue
        _land_blob(dest_dir, dest, raw)
        return dest, peer, misses
    # router fallback: the always-correct origin, with the
    # bounded-retry semantics unchanged
    backoff = Backoff(base_s=0.2, cap_s=5.0)
    last = "no attempt made"
    for i in range(max(1, attempts)):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        if i:
            delay = min(backoff.next_delay(), max(0.0, remaining))
            time.sleep(delay)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
        try:
            status, raw, _ = request(
                addr, "GET", path,
                headers=headers, timeout_s=remaining)
        except TRANSPORT_ERRORS as exc:
            last = f"{type(exc).__name__}: {exc}"
            continue
        if status != 200:
            last = f"HTTP {status}"
            if status == 404:
                # the router does not have it; retrying cannot help
                raise BlobError(
                    f"blob {sha256} not found on {addr}")
            continue
        actual = _sha256_hex(raw)
        if actual != sha256:
            # corruption in flight (or a lying peer): retryable, but
            # NEVER loadable
            last = f"sha256 mismatch (got {actual[:12]}...)"
            continue
        if size is not None and len(raw) != int(size):
            last = f"size mismatch ({len(raw)} != {size})"
            continue
        _land_blob(dest_dir, dest, raw)
        return dest, addr, misses
    raise BlobError(f"blob {sha256} from {addr}: giving up after "
                    f"{attempts} attempt(s) ({last})")
