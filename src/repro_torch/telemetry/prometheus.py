"""Prometheus text-format exporter — stdlib only, no client library.

Three pieces:

* :func:`render_prometheus` — serialize an :class:`InMemorySink` into
  Prometheus text exposition format 0.0.4 (counters with ``_total``,
  gauges, histograms as the classic cumulative ``le`` bucket ladder plus
  ``_sum``/``_count``).
* :func:`parse_prometheus` — a minimal parser for the same format, used
  by the CI smoke to assert a scrape round-trips (``scrape -> parse ->
  expected families present``).
* :class:`MetricsExporter` — a daemon-threaded stdlib ``http.server``
  serving ``GET /metrics``; ``port=0`` binds an ephemeral port
  (``exporter.port`` reports the real one).  ``dump()`` renders without
  HTTP for tests.
"""
from __future__ import annotations

import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from repro_torch.telemetry.sinks import InMemorySink

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# coarse exported bucket ladder (seconds): fine internal buckets collapse
# onto this so a scrape stays small while p50/p99 queries stay useful
DEFAULT_EDGES = (1e-5, 1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                 5e-2, 1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 60.0)

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _clean(name: str) -> str:
    return _NAME_OK.sub("_", name)


def _fmt_labels(lk) -> str:
    if not lk:
        return ""
    inner = ",".join(f'{_clean(k)}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
                     for k, v in lk)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(sink: InMemorySink, *, prefix: str = "repro",
                      edges=DEFAULT_EDGES) -> str:
    """Serialize the sink's aggregates as Prometheus text format."""
    lines: List[str] = []
    pfx = _clean(prefix) + "_" if prefix else ""

    by_name: Dict[str, list] = {}
    for (name, lk), v in sorted(sink.counters.items()):
        by_name.setdefault(name, []).append((lk, v))
    for name, rows in by_name.items():
        full = pfx + _clean(name)
        if not full.endswith("_total"):
            full += "_total"
        lines.append(f"# TYPE {full} counter")
        for lk, v in rows:
            lines.append(f"{full}{_fmt_labels(lk)} {_fmt_value(v)}")

    by_name = {}
    for (name, lk), v in sorted(sink.gauges.items()):
        by_name.setdefault(name, []).append((lk, v))
    for name, rows in by_name.items():
        full = pfx + _clean(name)
        lines.append(f"# TYPE {full} gauge")
        for lk, v in rows:
            lines.append(f"{full}{_fmt_labels(lk)} {_fmt_value(v)}")

    by_name = {}
    for (name, lk), h in sorted(sink.histograms.items()):
        by_name.setdefault(name, []).append((lk, h))
    for name, rows in by_name.items():
        full = pfx + _clean(name)
        lines.append(f"# TYPE {full} histogram")
        for lk, h in rows:
            for edge in edges:
                cum = h.cumulative_le(edge)
                le = dict(lk)
                le["le"] = _fmt_value(edge)
                lines.append(f"{full}_bucket{_fmt_labels(tuple(sorted(le.items())))} {cum}")
            inf = dict(lk)
            inf["le"] = "+Inf"
            lines.append(f"{full}_bucket{_fmt_labels(tuple(sorted(inf.items())))} {h.n}")
            lines.append(f"{full}_sum{_fmt_labels(lk)} {_fmt_value(h.sum)}")
            lines.append(f"{full}_count{_fmt_labels(lk)} {h.n}")

    return "\n".join(lines) + "\n"


_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r'\s+(?P<value>[^\s]+)\s*$')
_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:\\.|[^"\\])*)"')


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float]:
    """Parse text exposition format into {(name, labels): value}.

    Minimal but strict on sample lines: a non-comment line that fails to
    parse raises ValueError (the CI smoke uses this to assert the
    exporter emits valid format).  Returns type metadata separately via
    :func:`parse_prometheus_types` if needed.
    """
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"unparseable Prometheus sample line: {raw!r}")
        labels = tuple(sorted(
            (k, v.replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL.findall(m.group("labels") or "")))
        val_s = m.group("value")
        if val_s == "+Inf":
            val = math.inf
        elif val_s == "-Inf":
            val = -math.inf
        else:
            val = float(val_s)
        out[(m.group("name"), labels)] = val
    return out


def metric_names(parsed) -> set:
    return {name for name, _ in parsed}


class MetricsExporter:
    """``GET /metrics`` over stdlib ``http.server`` (daemon thread)."""

    def __init__(self, sink: InMemorySink, *, port: int = 0,
                 host: str = "127.0.0.1", prefix: str = "repro"):
        self.sink = sink
        self.prefix = prefix
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):           # noqa: N802 (stdlib API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = exporter.dump().encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="telemetry-exporter")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def dump(self) -> str:
        """Render the current scrape body without HTTP (for tests)."""
        return render_prometheus(self.sink, prefix=self.prefix)

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
