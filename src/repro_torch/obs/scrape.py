"""Dependency-free localhost HTTP scrape endpoint.

A minimal asyncio HTTP/1.0 server exposing:

- ``GET /metrics``   — Prometheus text exposition from a registry
- ``GET /telemetry`` — JSON (e.g. ``Supervisor.telemetry()``)

It shares the event loop of whatever started it (the ingest server or a
worker process), binds to localhost only (the telemetry plane is not the
patient transport — no auth, so it must never leave the host), and
serves each request on its own connection.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Callable, Dict, Optional

__all__ = ["ScrapeServer", "http_get"]


class ScrapeServer:
    def __init__(
        self,
        metrics: Any,
        telemetry_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.metrics = metrics
        self.telemetry_fn = telemetry_fn
        self.host = host
        self.port = port          # 0 → ephemeral; real port set by start()
        self._server: Optional[asyncio.AbstractServer] = None
        self.requests_total = 0

    async def start(self) -> "ScrapeServer":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _respond(self, path: str):
        if path.startswith("/metrics"):
            return 200, "text/plain; version=0.0.4", self.metrics.render_prometheus()
        if path.startswith("/telemetry"):
            doc = self.telemetry_fn() if self.telemetry_fn is not None else {}
            return 200, "application/json", json.dumps(doc)
        return 404, "text/plain", "not found\n"

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await reader.readline()
            parts = request.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            # drain headers until the blank line
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
            self.requests_total += 1
            status, ctype, body = self._respond(path)
            payload = body.encode()
            reason = {200: "OK", 404: "Not Found"}.get(status, "OK")
            head = (
                f"HTTP/1.0 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                "Connection: close\r\n\r\n"
            )
            writer.write(head.encode() + payload)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass


async def http_get(host: str, port: int, path: str,
                   timeout: float = 5.0) -> str:
    """Tiny scrape client (tests + CI smoke): returns the response body."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {path} HTTP/1.0\r\nHost: {host}\r\n\r\n".encode())
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout=timeout)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0].split()
    if len(status) < 2 or status[1] != b"200":
        raise RuntimeError(f"scrape failed: {head.decode('latin-1', 'replace')!r}")
    return body.decode()
