"""Wire telemetry: the shared ``OP_METRICS`` / ``OP_TRACE`` opcode pair.

Port of ``repro/obsv/teleserve.py``, over the port's own registry and
recorder (:data:`repro_torch.obsv.metrics.REGISTRY`,
:data:`repro_torch.obsv.trace.TRACE`).  The JSON layout is the JAX
package's, so a JAX scraper reads a port endpoint and the reverse.

Server side — :func:`handle_telemetry` answers both opcodes.  Every TCP
plane calls it first in its dispatch (the telemetry body is just the
opcode byte, which plane-specific parsers would reject), so one scraper
speaks to embed shards, the fedsvc coordinator and the bare
:func:`serve_telemetry` listener a worker process runs.

Client side — :class:`TelemetryClient` scrapes one endpoint and
measures the monotonic-clock offset per RPC: the response carries the
server's ``perf_counter`` reading at build time, and the client brackets
the RPC with its own clock, estimating::

    offset ≈ (t_send + t_recv) / 2  −  t_server

:func:`scrape_all` + :func:`merge_scrapes` turn a whole deployment's
per-process rings into one Perfetto timeline.

Frame layout (the :mod:`repro_torch.exchange.wire` framing)::

    request   uint8 opcode (OP_METRICS 14 | OP_TRACE 15)
    response  uint8 status | UTF-8 JSON payload
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
from typing import Optional

from repro_torch.exchange import wire

from . import metrics, trace

_perf = time.perf_counter


# -- server side --------------------------------------------------------------

def build_metrics_body() -> bytes:
    return bytes([wire.PT_OP_METRICS])


def build_trace_body() -> bytes:
    return bytes([wire.PT_OP_TRACE])


def handle_telemetry(body: bytes) -> Optional[bytes]:
    """Answer a telemetry request; ``None`` for any other opcode (the
    caller falls through to its plane-specific dispatch).  Safe to call
    on arbitrary bytes — it only ever inspects ``body[0]``."""
    if not body:
        return None
    op = body[0]
    if op == wire.PT_OP_METRICS:
        payload = {"process": trace.TRACE.process,
                   "pid": os.getpid(),
                   "t_mono": _perf(),
                   "metrics": metrics.REGISTRY.snapshot()}
        return wire.build_ok(json.dumps(payload).encode())
    if op == wire.PT_OP_TRACE:
        snap = trace.TRACE.snapshot()         # includes t_mono handshake
        return wire.build_ok(json.dumps(snap).encode())
    return None


# -- client side --------------------------------------------------------------

@dataclasses.dataclass
class EndpointTelemetry:
    """One scraped endpoint: identity, aligned clock, and both dumps."""
    label: str                 # caller-assigned endpoint label
    process: str               # the endpoint's self-reported process name
    pid: int
    offset_s: float            # add to endpoint timestamps → scraper clock
    metrics: dict              # registry snapshot
    trace: dict                # trace snapshot (raw endpoint clock)


class TelemetryClient:
    """Blocking scraper for one telemetry-speaking endpoint."""

    def __init__(self, addr, *, connect_timeout: float = 5.0):
        from repro_torch.exchange.socket_transport import parse_address
        self.addr = parse_address(addr)
        self.connect_timeout = connect_timeout
        self._sock: socket.socket | None = None

    def _rpc(self, body: bytes) -> tuple[dict, float]:
        """→ (decoded JSON payload, clock offset estimate)."""
        if self._sock is None:
            self._sock = socket.create_connection(
                self.addr, timeout=self.connect_timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        t_send = _perf()
        wire.send_frame(self._sock, body)
        resp = wire.recv_frame(self._sock)
        t_recv = _perf()
        if resp is None:
            raise ConnectionError("telemetry endpoint closed connection")
        payload = json.loads(bytes(wire.parse_response(resp)).decode())
        offset = (t_send + t_recv) / 2 - float(payload.get("t_mono", 0.0))
        return payload, offset

    def metrics(self) -> tuple[dict, float]:
        return self._rpc(build_metrics_body())

    def trace(self) -> tuple[dict, float]:
        return self._rpc(build_trace_body())

    def scrape(self, label: str | None = None) -> EndpointTelemetry:
        m, off_m = self.metrics()
        t, off_t = self.trace()
        return EndpointTelemetry(
            label=label or f"{self.addr[0]}:{self.addr[1]}",
            process=str(t.get("process", "proc")),
            pid=int(t.get("pid", 0)),
            # two independent handshakes; average halves the jitter
            offset_s=(off_m + off_t) / 2,
            metrics=m.get("metrics", {}),
            trace=t)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def scrape_all(endpoints: list[tuple[str, object]]
               ) -> list[EndpointTelemetry]:
    """Scrape ``[(label, addr), …]`` sequentially on one scraper clock."""
    out = []
    for label, addr in endpoints:
        with TelemetryClient(addr) as c:
            out.append(c.scrape(label))
    return out


def merge_scrapes(scrapes: list[EndpointTelemetry]) -> tuple[dict, str]:
    """→ (one Chrome trace over all endpoints, one metrics table).

    Trace timestamps are offset-aligned onto the scraper's clock; the
    metrics table is a flat ``process metric value`` text block grouped
    by endpoint label."""
    trace_doc = trace.merge_snapshots([s.trace for s in scrapes],
                                      [s.offset_s for s in scrapes])
    lines = []
    for s in scrapes:
        lines.append(f"# {s.label} [{s.process} pid={s.pid} "
                     f"offset={s.offset_s:+.6f}s]")
        for name, val in sorted(s.metrics.items()):
            if isinstance(val, dict):      # histogram: count/mean line
                cnt = val.get("count", 0)
                mean = val.get("sum", 0.0) / cnt if cnt else 0.0
                lines.append(f"{name} count={cnt} mean={mean:.6g}")
            else:
                lines.append(f"{name} {val:.9g}"
                             if isinstance(val, float)
                             else f"{name} {val}")
    return trace_doc, "\n".join(lines)


# -- telemetry-only listener --------------------------------------------------

class TelemetryServerHandle:
    def __init__(self, sock: socket.socket, stop: threading.Event,
                 thread: threading.Thread):
        self._sock = sock
        self._stop = stop
        self._thread = thread
        self.host, self.port = sock.getsockname()[:2]

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _telemetry_client_loop(conn: socket.socket,
                           stop: threading.Event) -> None:
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while not stop.is_set():
            body = wire.recv_frame(conn)
            if body is None:
                break
            resp = handle_telemetry(body)
            if resp is None:
                resp = wire.build_err(
                    f"telemetry-only endpoint: unknown opcode "
                    f"{body[0] if body else '∅'}")
            wire.send_frame(conn, resp)
    except (ConnectionError, OSError):
        pass
    finally:
        try:
            conn.close()
        except OSError:
            pass


def serve_telemetry(*, host: str = "127.0.0.1",
                    port: int = 0) -> TelemetryServerHandle:
    """Minimal listener answering ONLY the telemetry opcodes — how a
    fedsvc *worker* (a pure client otherwise) becomes scrapeable
    (``repro_torch.launch.fed_worker --obs-port``)."""
    stop = threading.Event()
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen(16)

    def accept_loop() -> None:
        listener.settimeout(0.2)
        while not stop.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=_telemetry_client_loop,
                             args=(conn, stop), daemon=True).start()
        try:
            listener.close()
        except OSError:
            pass

    t = threading.Thread(target=accept_loop, daemon=True)
    t.start()
    return TelemetryServerHandle(listener, stop, t)
