"""Offline trace-analytics tool over any span spool (the port of
``hpnn_tpu/obs/tool.py``)::

    python -m hpnn_tpu_torch.obs.tool index    --span-dir D
    python -m hpnn_tpu_torch.obs.tool search   --span-dir D [--kernel K]
        [--trace ID] [--min-ms F] [--status S] [--since T] [--until T]
        [--limit N]
    python -m hpnn_tpu_torch.obs.tool critical --span-dir D [--kernel K]
        [--window S] [--limit N]
    python -m hpnn_tpu_torch.obs.tool timeline --span-dir D [--since T]
        [--until T] [--limit N]

True post-mortem: the fleet can be GONE.  ``search``, ``critical`` and
``timeline`` run the SAME code the live endpoints run over the same
directory, so their stdout is byte-identical to the corresponding
``GET /v1/debug/trace/search`` / ``.../critical`` / ``...?timeline=1``
response bodies -- an incident review six weeks later reproduces
exactly what the on-call saw.  ``index`` builds (or repairs) every
finalized segment's sidecar up front, so the first interactive query
doesn't pay the back-fill.  It touches no device.

Exit codes: 0 on success (including an empty result), 2 on a bad
query, 1 when the span dir is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--span-dir", required=True, metavar="DIR",
                    help="the --span-dir a serve_nn/train run spooled "
                    "spans into (rotated segments + open spools)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hpnn_tpu_torch.obs.tool",
        description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_index = sub.add_parser(
        "index", help="build/repair every finalized segment's sidecar")
    _add_common(p_index)

    p_search = sub.add_parser(
        "search", help="per-trace summaries from the sidecar indexes")
    _add_common(p_search)
    p_search.add_argument("--kernel", default=None)
    p_search.add_argument("--trace", default=None)
    p_search.add_argument("--min-ms", default=None)
    p_search.add_argument("--status", default=None)
    p_search.add_argument("--since", default=None)
    p_search.add_argument("--until", default=None)
    p_search.add_argument("--limit", default=None)

    p_crit = sub.add_parser(
        "critical", help="aggregated critical-path phase attribution")
    _add_common(p_crit)
    p_crit.add_argument("--kernel", default=None)
    p_crit.add_argument("--window", default=None,
                        help="only traces starting in the trailing "
                        "WINDOW seconds (default: all)")
    p_crit.add_argument("--limit", default=None,
                        help="newest-N traces analyzed (default "
                        "HPNN_TRACE_CRITICAL_TRACES)")

    p_tl = sub.add_parser(
        "timeline", help="the merged incident timeline (NDJSON)")
    _add_common(p_tl)
    p_tl.add_argument("--since", default=None)
    p_tl.add_argument("--until", default=None)
    p_tl.add_argument("--limit", default=None)

    args = ap.parse_args(argv)
    span_dir = args.span_dir
    if not os.path.isdir(span_dir):
        sys.stderr.write(f"span dir not found: {span_dir}\n")
        return 1

    from . import analyze
    from . import index as trace_index
    from .export import list_segments, read_spool

    try:
        if args.cmd == "index":
            built = repaired = spans = 0
            trace_ids: set = set()
            segs = list_segments(span_dir)
            for seg in segs:
                had = trace_index.load_index(seg) is not None
                stale = (not had
                         and os.path.exists(trace_index.index_path(seg)))
                idx = trace_index.ensure_index(seg)
                if idx is None:
                    continue
                if not had:
                    if stale:
                        repaired += 1
                    else:
                        built += 1
                # unique ids: a trace routinely spans segments
                trace_ids.update(idx["traces"])
                spans += sum(t.get("spans", 0)
                             for t in idx["traces"].values())
            sys.stdout.write(json.dumps(
                {"span_dir": os.path.abspath(span_dir),
                 "segments": len(segs), "built": built,
                 "repaired": repaired, "traces": len(trace_ids),
                 "spans": spans}) + "\n")
            return 0
        if args.cmd == "search":
            payload = trace_index.search(span_dir, {
                "kernel": args.kernel, "trace": args.trace,
                "min_ms": args.min_ms, "status": args.status,
                "since": args.since, "until": args.until,
                "limit": args.limit})
            sys.stdout.write(json.dumps(payload) + "\n")
            return 0
        if args.cmd == "critical":
            payload = analyze.critical_from_dir(
                span_dir, kernel=args.kernel,
                window_s=float(args.window)
                if args.window is not None else None,
                limit=int(args.limit)
                if args.limit is not None else None)
            sys.stdout.write(json.dumps(payload) + "\n")
            return 0
        # timeline
        entries = analyze.build_timeline(
            read_spool(span_dir),
            since=float(args.since) if args.since is not None else None,
            until=float(args.until) if args.until is not None else None,
            limit=int(args.limit) if args.limit is not None else None)
        sys.stdout.write(analyze.render_timeline(entries))
        return 0
    except (TypeError, ValueError) as exc:
        sys.stderr.write(f"bad query: {exc}\n")
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
