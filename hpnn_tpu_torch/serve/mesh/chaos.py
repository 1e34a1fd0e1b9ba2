"""Deterministic fault injection for the mesh HTTP plumbing.

The mesh's resilience story -- standby takeover, retry-once-elsewhere,
heartbeat backoff, blob re-fetch -- is exactly the code that never runs
in a healthy test environment.  This module makes those paths
*testable*: every mesh RPC (worker dispatch, heartbeat, health poll,
blob fetch, fleet scrape -- everything that goes through
``mesh.transport.request``) consults a process-global rule table and,
on a DETERMINISTIC schedule, injects one of the failure modes a real
fleet produces:

  ========== ==========================================================
  reset       ``ConnectionResetError`` before the request is sent (the
              peer is gone; nothing reached it)
  reset-after the request IS sent and processed, then the connection
              resets before the response is read -- the case that makes
              "retry-once is safe only because inference is idempotent"
              a testable claim instead of a hope
  timeout     ``socket.timeout`` during the response read (peer hung
              after accepting the request)
  truncate    ``http.client.IncompleteRead`` mid-body (proxy died, TCP
              segment lost at the worst moment)
  http        a fabricated 5xx reply (the peer answered and said no);
              never reaches the network
  latency     an injected delay before the request proceeds normally
  ========== ==========================================================

**IO fault domain**: the same deterministic schedules drive
DISK failures under every durable write -- ``io/atomic.py`` and the
checkpoint bundle writer consult :func:`pick_io` with the destination
path, so the snapshot-retry / verified-resume / last-good-fallback
machinery is testable without a real failing disk:

  ========== ==========================================================
  enospc      the write raises ``OSError(ENOSPC)`` (disk full)
  eio         the write raises ``OSError(EIO)`` (generic IO error)
  torn        only the first half of the payload reaches the file,
              SILENTLY -- the torn-page/partial-write crash artifact
              that only content verification can catch
  bitflip     one deterministic bit of the payload is flipped before
              the write -- silent media corruption
  latency     an injected delay before the write proceeds normally
  ========== ==========================================================

Spec grammar (``HPNN_FAULT`` env var, or :func:`configure`)::

    spec  := rule (';' rule)*
    rule  := kind ['@' substr] [':' key '=' val (',' key '=' val)*]
    kind  := reset | reset-after | timeout | truncate | http | latency
             | enospc | eio | torn | bitflip
    keys  := domain=D   mesh (default: the HTTP plumbing) or io (durable
                        writes through io.atomic / the snapshot writer;
                        ``@substr`` then matches the FILE path).  The
                        enospc/eio/torn/bitflip kinds are io-only;
                        reset/timeout/truncate/http are mesh-only
             side=S     client (default: injected in mesh.transport
                        below every outgoing RPC) or server (injected
                        in the worker's OWN response path -- fabricated
                        5xx, half-written responses, latency, aborted
                        connections -- before any handler runs)
             after=N    skip the first N matching calls
             every=N    then fire on every Nth matching call (default 1)
             times=N    fire at most N times total (default unlimited)
             gap_ms=F   never fire within F ms of this rule's previous
                        injection (paces faults under load so recovery
                        machinery gets its window; time-based, so
                        schedules using it are paced rather than
                        call-exact)
             p=F        fire with probability F from the rule's SEEDED
                        stream (deterministic given call order)
             seed=N     the rule's RNG seed (default 0)
             ms=F       latency: injected delay in milliseconds
             code=N     http: fabricated status (default 503)

``@substr`` restricts a rule to requests whose path contains the
substring (e.g. ``reset@/infer:every=7``); rules are tried in spec
order and at most ONE fires per request.  Counters are process-global,
so ``after``/``every``/``times`` schedules are exact -- a test that
says ``truncate@/infer:times=1`` gets exactly one truncated body and
can assert what the retry machinery did about it.

Zero cost when off: an unset ``HPNN_FAULT`` parses once to an empty
table and every later :func:`pick` is a single attribute check.
"""

from __future__ import annotations

import random
import threading

from ...utils.nn_log import nn_dbg, nn_warn

KINDS = ("reset", "reset-after", "timeout", "truncate", "http",
         "latency")
# io-domain kinds (disk faults under io.atomic / the snapshot writer)
IO_KINDS = ("enospc", "eio", "torn", "bitflip", "latency")

_INT_KEYS = ("after", "every", "times", "seed", "code")
_FLOAT_KEYS = ("p", "ms", "gap_ms")
_STR_KEYS = ("side", "domain")
SIDES = ("client", "server")
DOMAINS = ("mesh", "io")


class FaultRule:
    """One parsed rule + its live schedule state."""

    __slots__ = ("kind", "match", "after", "every", "times", "p",
                 "seed", "ms", "code", "gap_ms", "side", "domain",
                 "calls", "fired", "_rng", "_t_last_fire")

    def __init__(self, kind: str, match: str | None = None,
                 after: int = 0, every: int = 1, times: int = 0,
                 p: float = 1.0, seed: int = 0, ms: float = 100.0,
                 code: int = 503, gap_ms: float = 0.0,
                 side: str = "client", domain: str | None = None):
        if domain is None:
            # the io-only kinds imply their domain, so a spec like
            # "enospc@state.npz" works without an explicit domain=io
            domain = "io" if kind in IO_KINDS and kind not in KINDS \
                else "mesh"
        if domain not in DOMAINS:
            raise ValueError(f"domain must be one of "
                             f"{', '.join(DOMAINS)}: {domain!r}")
        valid = IO_KINDS if domain == "io" else KINDS
        if kind not in valid:
            raise ValueError(f"unknown fault kind {kind!r} for domain "
                             f"{domain} (one of {', '.join(valid)})")
        if every < 1:
            raise ValueError("every must be >= 1")
        if not 0.0 <= p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        if side not in SIDES:
            raise ValueError(f"side must be one of {', '.join(SIDES)}: "
                             f"{side!r}")
        self.domain = domain
        self.kind = kind
        self.match = match or None
        self.after = int(after)
        self.every = int(every)
        self.times = int(times)      # 0 = unlimited
        self.p = float(p)
        self.seed = int(seed)
        self.ms = float(ms)
        self.code = int(code)
        self.gap_ms = float(gap_ms)
        self.side = side
        self.calls = 0               # matching calls seen
        self.fired = 0               # injections performed
        self._rng = random.Random(self.seed)
        self._t_last_fire: float | None = None

    def should_fire(self, path: str) -> bool:
        """Advance this rule's schedule for one matching call.  Caller
        holds the module lock."""
        if self.match is not None and self.match not in path:
            return False
        if self.times and self.fired >= self.times:
            return False
        self.calls += 1
        if self.calls <= self.after:
            return False
        if (self.calls - self.after - 1) % self.every != 0:
            return False
        if self.gap_ms:
            import time

            now = time.monotonic()
            if (self._t_last_fire is not None
                    and (now - self._t_last_fire) * 1e3 < self.gap_ms):
                return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        if self.gap_ms:
            self._t_last_fire = now
        self.fired += 1
        return True

    def to_dict(self) -> dict:
        return {"kind": self.kind, "match": self.match,
                "after": self.after, "every": self.every,
                "times": self.times, "gap_ms": self.gap_ms,
                "p": self.p, "seed": self.seed, "side": self.side,
                "domain": self.domain,
                "calls": self.calls, "fired": self.fired}


def parse_spec(spec: str) -> list[FaultRule]:
    """Parse a fault spec (grammar in the module doc); raises
    ValueError on anything malformed."""
    rules: list[FaultRule] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, args = part.partition(":")
        kind, _, match = head.partition("@")
        kw: dict = {}
        if args:
            for item in args.split(","):
                key, eq, val = item.strip().partition("=")
                if not eq:
                    raise ValueError(
                        f"bad fault option {item!r} (want key=value)")
                if key in _INT_KEYS:
                    kw[key] = int(val)
                elif key in _FLOAT_KEYS:
                    kw[key] = float(val)
                elif key in _STR_KEYS:
                    kw[key] = val.strip()
                else:
                    raise ValueError(f"unknown fault option {key!r}")
        rules.append(FaultRule(kind.strip(), match.strip() or None,
                               **kw))
    return rules


# --- process-global rule table ----------------------------------------------

_lock = threading.Lock()
_rules: list[FaultRule] | None = None   # None = env not consulted yet
_armed = False


def configure(spec: str | None) -> list[FaultRule]:
    """Install a fault spec programmatically (tests, the chaos bench);
    ``None``/empty disarms.  Returns the parsed rules."""
    global _rules, _armed
    rules = parse_spec(spec) if spec else []
    with _lock:
        _rules = rules
        _armed = bool(rules)
    if rules:
        nn_dbg(f"chaos: armed with {len(rules)} rule(s): "
               + "; ".join(r.kind + (f"@{r.match}" if r.match else "")
                           for r in rules) + "\n")
    return rules


def reset() -> None:
    """Disarm and forget (the env is re-consulted on next use)."""
    global _rules, _armed
    with _lock:
        _rules = None
        _armed = False


def _configure_from_env() -> None:
    import os

    spec = os.environ.get("HPNN_FAULT", "")
    try:
        configure(spec)
    except ValueError as exc:
        # a typo'd knob must degrade to "no chaos", never kill a server
        nn_warn(f"chaos: ignoring malformed HPNN_FAULT ({exc})\n")
        configure(None)


def pick(path: str, side: str = "client") -> FaultRule | None:
    """The injection hook: the first rule of the given ``side`` whose
    schedule fires for this request path, or None.  At most one rule
    fires per call.  ``side="client"`` is the transport layer
    (mesh.transport.request, below every mesh RPC); ``side="server"``
    is the worker's OWN response path (serve.server) -- a rule only sees, and only advances its schedule on,
    calls from its own side."""
    if _rules is None:
        # first use: consult the env (racing parsers are idempotent)
        _configure_from_env()
    if not _armed:
        return None
    with _lock:
        for rule in _rules or ():
            if rule.domain != "mesh" or rule.side != side:
                continue
            if rule.should_fire(path):
                nn_dbg(f"chaos: injecting {rule.kind} on {path} "
                       f"({side}-side, fired {rule.fired})\n")
                return rule
    return None


def pick_io(path: str) -> FaultRule | None:
    """The io-domain injection hook: the first ``domain=io`` rule whose
    schedule fires for this FILE path, or None.  Consulted by
    ``io.atomic`` and the checkpoint bundle writer below every durable
    write; same zero-cost-off contract as :func:`pick`."""
    if _rules is None:
        _configure_from_env()
    if not _armed:
        return None
    with _lock:
        for rule in _rules or ():
            if rule.domain != "io":
                continue
            if rule.should_fire(path):
                nn_dbg(f"chaos: injecting {rule.kind} on {path} "
                       f"(io-domain, fired {rule.fired})\n")
                return rule
    return None


def apply_io_fault(rule: FaultRule, path: str, data: bytes) -> bytes:
    """Apply one fired io-domain rule to a pending write of ``data`` at
    ``path``: raise for enospc/eio, sleep for latency, and return the
    (possibly corrupted) payload the writer should actually put on
    disk -- ``torn`` drops the second half, ``bitflip`` flips one
    deterministic bit (position keyed by the rule's seed + fire
    count, so schedules are exactly reproducible)."""
    import errno
    import time

    if rule.kind == "enospc":
        raise OSError(errno.ENOSPC,
                      f"chaos: injected ENOSPC writing {path}")
    if rule.kind == "eio":
        raise OSError(errno.EIO, f"chaos: injected EIO writing {path}")
    if rule.kind == "latency":
        time.sleep(rule.ms / 1e3)
        return data
    if rule.kind == "torn":
        return data[:len(data) // 2]
    if rule.kind == "bitflip":
        if not data:
            return data
        pos = (rule.seed * 2654435761 + rule.fired) % (len(data) * 8)
        buf = bytearray(data)
        buf[pos // 8] ^= 1 << (pos % 8)
        return bytes(buf)
    return data  # pragma: no cover - exhaustive over IO_KINDS


def stats() -> dict:
    """Injection accounting (the chaos bench row reads this)."""
    with _lock:
        rules = list(_rules or ())
    return {"armed": _armed,
            "injected_total": sum(r.fired for r in rules),
            "rules": [r.to_dict() for r in rules]}
