"""Threaded TCP scoring frontend over a ServingPlane.

Port of ``repro/gnnserve/frontend.py``, speaking its frames
(:mod:`repro_torch.gnnserve.wire`).  It mirrors
``repro_torch.launch.embed_server``'s topology (one accept loop, one
thread per connection, a lock around shared state) plus one *driver*
thread that continuously steps the shard batchers.  Connection handlers
only enqueue queries and wait on a condition variable for their request
ids to complete, so queries from concurrent connections coalesce into
the same forward batches: that is the continuous-batching contract.

All device work (the plane's forwards and its cache refreshes) runs on
the driver thread; a handler touches only the host-side queues, results
and counters.  Every request first goes through
:func:`repro_torch.obsv.teleserve.handle_telemetry`, so the frontend
answers the telemetry scrape on its data port.  Its counter is
``pt_gnnserve.predict_rpcs``, and SSTATS carries the ``pt_gnnserve.``
slice of the metrics registry (the JAX modules own ``gnnserve.*``).

Tests use :func:`serve_in_thread`; the CLI lives in
``repro_torch.launch.gnn_serve``.
"""

from __future__ import annotations

import socket
import threading

import numpy as np

from repro_torch.obsv import teleserve
from repro_torch.obsv.metrics import REGISTRY
from repro_torch.obsv.trace import TRACE

from . import wire
from .engine import ServingPlane

_PREDICTS = REGISTRY.counter("pt_gnnserve.predict_rpcs")


class _FrontState:
    def __init__(self, plane: ServingPlane, *, poll_s: float = 0.005):
        self.plane = plane                     # guarded-by: self.cond
        self.poll_s = poll_s
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)
        self.stop = threading.Event()
        self.results: dict[int, object] = {}   # guarded-by: self.cond
        # (results maps rid -> ServedResult; cond shares self.lock)

    # -- driver --------------------------------------------------------------

    def drive(self) -> None:
        """Step the batchers whenever work is queued; park otherwise."""
        while not self.stop.is_set():
            with self.cond:
                if not self.plane.pending():
                    self.cond.wait(self.poll_s)
                    continue
                done = self.plane.step()
                if done:
                    for r in done:
                        self.results[r.rid] = r
                    self.cond.notify_all()

    # -- per-connection dispatch ---------------------------------------------

    def handle(self, body: bytes) -> bytes:
        telemetry = teleserve.handle_telemetry(body)
        if telemetry is not None:
            return telemetry
        try:
            op, req = wire.parse_serve_request(body)
        except Exception as e:
            return wire.build_err(f"bad request: {type(e).__name__}: {e}")
        try:
            if op == wire.PT_OP_PREDICT:
                _PREDICTS.inc()
                with TRACE.span("gnnserve.predict",
                                args={"n": len(req["vids"])}):
                    return self._handle_predict(req)
            if op == wire.PT_OP_SSTATS:
                # the plane's own counts plus the pt_gnnserve.* slice of
                # the process metrics registry: one source feeds both
                # SSTATS and the telemetry scrape
                with self.lock:
                    stats = self.plane.stats()
                    stats["metrics"] = REGISTRY.snapshot("pt_gnnserve.")
                    return wire.build_ok(wire.build_stats_payload(stats))
            if op == wire.PT_OP_EMBED_SHUTDOWN:
                self.stop.set()
                with self.cond:
                    self.cond.notify_all()
                return wire.build_ok()
            return wire.build_err(f"unknown opcode {op}")
        except Exception as e:
            return wire.build_err(f"{type(e).__name__}: {e}")

    def _handle_predict(self, req: dict) -> bytes:
        vids = np.asarray(req["vids"], np.int64)
        thr = np.asarray(req["thresholds"], np.float32)
        with self.cond:
            rids = [self.plane.submit(int(v), float(t))
                    for v, t in zip(vids, thr)]
            self.cond.notify_all()          # wake the driver
            want = set(rids)
            while not want.issubset(self.results.keys()):
                if self.stop.is_set():
                    return wire.build_err("server shutting down")
                self.cond.wait(0.05)
            res = [self.results.pop(r) for r in rids]
        return wire.build_ok(wire.build_predict_payload(
            np.array([r.pred for r in res], np.int32),
            np.array([r.conf for r in res], np.float32),
            np.array([r.depth for r in res], np.int32)))


class GnnServeHandle:
    def __init__(self, state: _FrontState, sock: socket.socket,
                 threads: list[threading.Thread]):
        self._state = state
        self._sock = sock
        self._threads = threads
        self.host, self.port = sock.getsockname()[:2]

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    @property
    def plane(self) -> ServingPlane:
        return self._state.plane

    @property
    def stopped(self) -> bool:
        """True once a shutdown frame (or :meth:`stop`) ended serving."""
        return self._state.stop.is_set()

    def stop(self, timeout: float = 5.0) -> None:
        self._state.stop.set()
        with self._state.cond:
            self._state.cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _client_loop(conn: socket.socket, state: _FrontState) -> None:
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while not state.stop.is_set():
            body = wire.recv_frame(conn)
            if body is None:
                break
            wire.send_frame(conn, state.handle(body))
    except (ConnectionError, OSError):
        pass
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _accept_loop(listener: socket.socket, state: _FrontState) -> None:
    listener.settimeout(0.2)
    threads: list[threading.Thread] = []
    while not state.stop.is_set():
        try:
            conn, _ = listener.accept()
        except socket.timeout:
            continue
        except OSError:
            break
        t = threading.Thread(target=_client_loop, args=(conn, state),
                             daemon=True)
        t.start()
        threads.append(t)
    try:
        listener.close()
    except OSError:
        pass
    for t in threads:
        t.join(0.5)


def serve_in_thread(plane: ServingPlane, *, host: str = "127.0.0.1",
                    port: int = 0) -> GnnServeHandle:
    """Start the frontend (driver + accept loop) on background threads;
    ephemeral port by default.  The plane's forwards run on the driver
    thread, on the device its engines were built for."""
    state = _FrontState(plane)
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen(64)
    driver = threading.Thread(target=state.drive, daemon=True)
    driver.start()
    acceptor = threading.Thread(target=_accept_loop, args=(listener, state),
                                daemon=True)
    acceptor.start()
    return GnnServeHandle(state, listener, [driver, acceptor])


class GnnServeClient:
    """Blocking client for the scoring frontend (one pooled socket); it
    queries a port or a JAX frontend alike."""

    def __init__(self, addr, *, connect_timeout: float = 5.0):
        from repro_torch.exchange.socket_transport import parse_address
        self.addr = parse_address(addr)
        self.connect_timeout = connect_timeout
        self._sock: socket.socket | None = None

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                self.addr, timeout=self.connect_timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock.settimeout(None)
        return self._sock

    def _rpc(self, body: bytes):
        sock = self._conn()
        wire.send_frame(sock, body)
        resp = wire.recv_frame(sock)
        if resp is None:
            raise ConnectionError("serving frontend closed connection")
        return wire.parse_response(resp)

    def predict(self, vids, thresholds=None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """→ (preds, confidences, exit depths) for global vertex ids."""
        vids = np.asarray(vids, np.int64)
        if thresholds is None:
            thresholds = np.ones(len(vids), np.float32)
        payload = self._rpc(wire.build_predict(
            vids, np.asarray(thresholds, np.float32)))
        return wire.parse_predict_payload(payload)

    def stats(self) -> dict:
        return wire.parse_stats_payload(self._rpc(wire.build_sstats()))

    def shutdown(self) -> None:
        try:
            self._rpc(wire.build_shutdown())
        except (ConnectionError, OSError, RuntimeError):
            pass
        self.close()

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
