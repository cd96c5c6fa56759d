"""Threaded TCP embedding server — one listener per shard.

Port of ``repro/launch/embed_server.py``: a process that owns one
:class:`~repro_torch.core.embedding_server.EmbeddingServer` table set on
``device`` and serves ``register`` / ``write`` / ``gather`` /
``vgather`` over the length-prefixed protocol of
:mod:`repro_torch.exchange.wire`, the JAX server's bytes.  Codec
payloads (fp32 / fp16 / int8+scales) travel as the bytes the analytic
:class:`NetworkModel` charges for.

The tables live on the device, so an int8 write is the fused decode +
scatter (``write_quantized``) of the frame's blocks, each copied to the
device once, and an int8 gather is the fused gather + encode
(``gather_quantized``) of the resident table, each layer block copied
to the host once: the JAX server's ``--device-tables`` path.  The flag
is accepted for command-line parity; the port's tables are always on
``device``.

Topology: run S listeners (one per shard) and point
:class:`repro_torch.exchange.socket_transport.TcpTransport` (or the JAX
package's) at all of them.

Concurrency: one accept loop + one thread per connection; requests on a
connection are answered in arrival order, and a lock serialises the
store, under which all device work of a request runs.

CLI (one shard)::

    python -m repro_torch.launch.embed_server --port 7040 \\
        --num-layers 3 --hidden 32 [--device cpu]

Tests use :func:`serve_in_thread`, which binds an ephemeral port and
returns a stoppable handle.
"""

from __future__ import annotations

import argparse
import socket
import threading

from repro_torch.core.embedding_server import EmbeddingServer
from repro_torch.exchange import wire
from repro_torch.exchange.codec import get_codec
from repro_torch.obsv import teleserve
from repro_torch.obsv.metrics import REGISTRY
from repro_torch.obsv.trace import TRACE

_REQS = REGISTRY.counter("pt_embed.requests")
_OP_SPAN = {wire.PT_OP_REGISTER: "embed.register",
            wire.PT_OP_WRITE: "embed.write",
            wire.PT_OP_GATHER: "embed.gather",
            wire.PT_OP_VGATHER: "embed.vgather",
            wire.PT_OP_EMBED_STATS: "embed.stats"}


class _ServerState:
    """Shared state of one listener: the tables + their lock."""

    def __init__(self, num_layers: int, hidden: int, *, device: str):
        self.store = EmbeddingServer(num_layers, hidden,    # guarded-by: self.lock
                                     device=device)
        self.lock = threading.Lock()
        self.stop = threading.Event()

    def handle(self, body) -> bytes:
        """One request body → one response body (never raises)."""
        telemetry = teleserve.handle_telemetry(body)
        if telemetry is not None:
            return telemetry
        try:
            op, req = wire.parse_request(body)
        except Exception as e:                              # malformed frame
            return wire.build_err(f"bad request: {type(e).__name__}: {e}")
        _REQS.inc()
        # bounded: every value in _OP_SPAN is a literal span name
        with TRACE.span(_OP_SPAN.get(op, "embed.op")):  # repro-lint: disable=TL001
            return self._dispatch(op, req)

    def _dispatch(self, op: int, req: dict) -> bytes:
        try:
            if op == wire.PT_OP_REGISTER:
                with self.lock:
                    self.store.register(req["global_ids"])
                return wire.build_ok()
            if op == wire.PT_OP_WRITE:
                return self._handle_write(req)
            if op == wire.PT_OP_GATHER:
                return self._handle_gather(req)
            if op == wire.PT_OP_VGATHER:
                return self._handle_vgather(req)
            if op == wire.PT_OP_EMBED_STATS:
                with self.lock:
                    st = self.store
                    payload = wire.build_stats_payload(
                        st.L, st.hidden,
                        st.num_embeddings_stored // (st.L - 1),
                        st.memory_bytes())
                return wire.build_ok(payload)
            if op == wire.PT_OP_EMBED_SHUTDOWN:
                self.stop.set()
                return wire.build_ok()
            return wire.build_err(f"unknown opcode {op}")
        except Exception as e:
            return wire.build_err(f"{type(e).__name__}: {e}")

    def _handle_write(self, req: dict) -> bytes:
        codec, gids = req["codec"], req["global_ids"]
        with self.lock:
            st = self.store
            n, hidden, blocks = len(gids), st.hidden, req["num_blocks"]
            if blocks != st.L - 1:
                return wire.build_err(
                    f"write carries {blocks} layer blocks, server "
                    f"stores {st.L - 1}")
            size = wire.payload_nbytes(codec, n, hidden)
            buf = req["payload"]
            if len(buf) != size * blocks:
                return wire.build_err(
                    f"write payload is {len(buf)} B, expected "
                    f"{size * blocks} B ({blocks}×{size})")
            payloads = [wire.decode_block(codec,
                                          buf[l * size:(l + 1) * size],
                                          n, hidden, st.device)
                        for l in range(blocks)]
            if codec == "int8":
                # the wire form straight into the fused decode + scatter
                st.write_quantized(gids, payloads)
            else:
                cdc = get_codec(codec)
                st.write(gids, [cdc.decode(p) for p in payloads])
        return wire.build_ok()

    def _handle_gather(self, req: dict) -> bytes:
        codec, gids = req["codec"], req["global_ids"]
        with self.lock:
            if codec == "int8":
                # fused gather + encode on the resident table
                payloads = self.store.gather_quantized(gids, req["layers"])
            else:
                cdc = get_codec(codec)
                payloads = [cdc.encode(r) for r in
                            self.store.gather(gids, req["layers"])]
            blocks = [wire.encode_block(codec, p) for p in payloads]
        return wire.build_ok(b"".join(blocks))

    def _handle_vgather(self, req: dict) -> bytes:
        codec, gids = req["codec"], req["global_ids"]
        cdc = get_codec(codec)
        with self.lock:
            ver, _stale, vals = self.store.gather_if_stale(
                gids, req["have_versions"], req["layers"])
            blocks = [wire.encode_block(codec, cdc.encode(r)) for r in vals]
        return wire.build_ok(ver.tobytes() + b"".join(blocks))


class EmbedServerHandle:
    """A running listener: address for clients, ``stop()`` for teardown."""

    def __init__(self, state: _ServerState, sock: socket.socket,
                 thread: threading.Thread):
        self._state = state
        self._sock = sock
        self._thread = thread
        self.host, self.port = sock.getsockname()[:2]

    @property
    def address(self) -> tuple[str, int]:
        return (self.host, self.port)

    @property
    def store(self) -> EmbeddingServer:
        return self._state.store

    def stop(self, timeout: float = 5.0) -> None:
        self._state.stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def _client_loop(conn: socket.socket, state: _ServerState) -> None:
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while not state.stop.is_set():
            body = wire.recv_frame(conn)
            if body is None:
                break
            wire.send_frame(conn, state.handle(body))
    except (ConnectionError, OSError):
        pass                                      # client went away
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _accept_loop(listener: socket.socket, state: _ServerState) -> None:
    listener.settimeout(0.2)                      # poll the stop flag
    threads: list[threading.Thread] = []
    while not state.stop.is_set():
        try:
            conn, _ = listener.accept()
        except socket.timeout:
            continue
        except OSError:
            break                                 # listener closed
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


def serve_in_thread(num_layers: int, hidden: int, *,
                    host: str = "127.0.0.1", port: int = 0,
                    device: str = "cuda") -> EmbedServerHandle:
    """Start one shard listener on a background thread (ephemeral port
    by default), its tables on ``device``, and return its handle."""
    state = _ServerState(num_layers, hidden, device=device)
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen(64)
    thread = threading.Thread(target=_accept_loop, args=(listener, state),
                              daemon=True)
    thread.start()
    return EmbedServerHandle(state, listener, thread)


def serve(num_layers: int, hidden: int, *, host: str = "127.0.0.1",
          port: int = 7040, device: str = "cuda") -> None:
    """Blocking single-shard server (the CLI entry point)."""
    handle = serve_in_thread(num_layers, hidden, host=host, port=port,
                             device=device)
    TRACE.set_process(f"embed_server:{handle.port}")
    print(f"embed_server listening on {handle.host}:{handle.port} "
          f"(L={num_layers}, hidden={hidden}, device {device})", flush=True)
    try:
        while not handle._state.stop.is_set():
            handle._state.stop.wait(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        handle.stop()


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="TCP embedding-server shard (repro_torch.exchange wire "
                    "protocol)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7040)
    ap.add_argument("--num-layers", type=int, default=3,
                    help="GNN depth L; the server stores L-1 tables")
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--device-tables", action="store_true",
                    help="accepted for parity with the JAX launcher: the "
                         "tables always live on --device, and int8 "
                         "gathers and writes always take the fused kernels")
    ap.add_argument("--device", default="cuda",
                    help="where the tables live (cuda | cpu)")
    args = ap.parse_args(argv)
    serve(args.num_layers, args.hidden, host=args.host, port=args.port,
          device=args.device)


if __name__ == "__main__":
    main()
