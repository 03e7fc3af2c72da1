"""Minimal asyncio HTTP/1.1 server for the scoring service.

Port of the JAX package's ``serving/httpd.py``, stdlib only (asyncio
streams): keep-alive, content-length bodies, JSON in and out, JSON errors,
a 413 for a header block over 64 KiB or a body over 32 MiB, 501 for a
chunked body, 404 / 405 for an unknown path / method, 400 for a bad request
line or JSON body, and percent-decoded query parameters. TLS is terminated
in front of the service, not here.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple
from urllib.parse import unquote_plus

__all__ = ["HttpServer", "JsonResponse", "HttpError"]

log = logging.getLogger(__name__)

_MAX_BODY = 32 * 1024 * 1024
_MAX_HEADER = 64 * 1024

# handler(body_json, query) -> (status, payload)
Handler = Callable[[Any, Dict[str, str]], Awaitable[Tuple[int, Any]]]

_REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            409: "Conflict",
            413: "Payload Too Large", 421: "Misdirected Request",
            422: "Unprocessable Entity",
            500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable"}


class HttpError(Exception):
    def __init__(self, status: int, detail: Any):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class JsonResponse:
    @staticmethod
    def encode(status: int, payload: Any, keep_alive: bool,
               content_type: str = "application/json") -> bytes:
        if content_type == "application/json":
            body = json.dumps(payload).encode()
        else:
            body = str(payload).encode()
        reason = _REASONS.get(status, "Unknown")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n"
        )
        return head.encode() + body


class HttpServer:
    """Route table + asyncio server. Routes are (METHOD, path) exact-match."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 drain_grace_s: float = 5.0):
        self.host = host
        self.port = port
        self.drain_grace_s = drain_grace_s
        self._routes: Dict[Tuple[str, str], Handler] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        # task -> True while parked waiting for the next request (idle)
        self._conns: Dict[Any, bool] = {}
        self._closing = False

    def route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method.upper(), path)] = handler

    async def start(self) -> None:
        # limit > _MAX_HEADER so readuntil can see an oversized header block
        # and we answer 413 instead of tripping the reader's own limit
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=2 * _MAX_HEADER)
        # resolve the ephemeral port
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Cancel only IDLE keep-alive handlers (parked waiting for the
            # next request): on py3.12 wait_closed() waits for every
            # connection handler, so a parked client would otherwise hang
            # shutdown forever. Handlers mid-request finish their response
            # first and then exit via the _closing flag.
            self._closing = True
            for task, idle in list(self._conns.items()):
                if idle:
                    task.cancel()
            try:
                await asyncio.wait_for(self._server.wait_closed(),
                                       timeout=self.drain_grace_s)
            except asyncio.TimeoutError:
                # grace expired: a handler is stuck mid-request (e.g. a
                # slow-loris body that never arrives) — cancel everything
                for task in list(self._conns):
                    task.cancel()
                await self._server.wait_closed()
            self._server = None
            self._closing = False

    # ------------------------------------------------------------- protocol
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns[task] = True
        try:
            while True:
                keep_alive = await self._handle_one(reader, writer, task)
                if not keep_alive or self._closing:
                    break
                if task is not None:
                    self._conns[task] = True     # parked until next request
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
        except Exception:                        # noqa: BLE001
            log.exception("connection handler error")
        finally:
            if task is not None:
                self._conns.pop(task, None)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:                    # noqa: BLE001
                pass

    async def _handle_one(self, reader, writer, task=None) -> bool:
        try:
            header_blob = await reader.readuntil(b"\r\n\r\n")
        except asyncio.LimitOverrunError:
            await self._respond(writer, 413, {"detail": "headers too large"},
                                False)
            return False
        if task is not None:
            self._conns[task] = False            # busy: request in flight
        if len(header_blob) > _MAX_HEADER:
            await self._respond(writer, 413, {"detail": "headers too large"},
                                False)
            return False
        head_lines = header_blob.decode("latin-1").split("\r\n")
        try:
            method, target, _version = head_lines[0].split(" ", 2)
        except ValueError:
            await self._respond(writer, 400, {"detail": "bad request line"},
                                False)
            return False
        headers = {}
        for line in head_lines[1:]:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()

        keep_alive = headers.get("connection", "keep-alive").lower() != "close"
        if "transfer-encoding" in headers:
            # chunked bodies are out of scope; reject rather than misparse
            # the chunk stream as the next request on this connection
            await self._respond(
                writer, 501, {"detail": "transfer-encoding not supported"},
                False)
            return False
        try:
            length = int(headers.get("content-length", "0") or 0)
        except ValueError:
            await self._respond(writer, 400,
                                {"detail": "bad content-length"}, False)
            return False
        if length < 0 or length > _MAX_BODY:
            status, msg = ((413, "body too large") if length > 0
                           else (400, "bad content-length"))
            await self._respond(writer, status, {"detail": msg}, False)
            return False
        raw = await reader.readexactly(length) if length else b""

        path, _, query_str = target.partition("?")
        query: Dict[str, str] = {}
        for pair in query_str.split("&"):
            if "=" in pair:
                k, _, v = pair.partition("=")
                query[unquote_plus(k)] = unquote_plus(v)

        handler = self._routes.get((method.upper(), path))
        if handler is None:
            known_paths = {p for _, p in self._routes}
            status = 405 if path in known_paths else 404
            await self._respond(
                writer, status, {"detail": f"no route {method} {path}"},
                keep_alive)
            return keep_alive

        body: Any = None
        if raw:
            try:
                body = json.loads(raw)
            except json.JSONDecodeError:
                await self._respond(
                    writer, 400, {"detail": "invalid JSON body"}, keep_alive)
                return keep_alive
        try:
            status, payload = await handler(body, query)
        except HttpError as e:
            status, payload = e.status, {"detail": e.detail}
        except Exception:                        # noqa: BLE001
            log.exception("handler error for %s %s", method, path)
            status, payload = 500, {"detail": "internal error"}
        content_type = "application/json"
        if isinstance(payload, str):
            content_type = "text/plain; version=0.0.4"  # Prometheus text
        await self._respond(writer, status, payload, keep_alive, content_type)
        return keep_alive

    @staticmethod
    async def _respond(writer, status, payload, keep_alive,
                       content_type="application/json") -> None:
        writer.write(JsonResponse.encode(status, payload, keep_alive,
                                         content_type))
        await writer.drain()
