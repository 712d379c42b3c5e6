"""WebSocket progress fan-out (port of ``apex_studio_tpu/server/ws.py``).

Counterpart of the reference's ``api/ws_manager.py`` (WebSocketManager +
RayWebSocketBridge): per-job update stream with the wire protocol
``{progress, message, status, metadata}`` where status derives from
metadata.status (queued | processing | preview | complete | error | canceled).
Updates merge into a cached "latest" so preview fields survive later progress
events; noisy "processing" updates are coalesced keep-latest.
"""

from __future__ import annotations

import asyncio
import logging
import math
from typing import Any, Dict, Optional, Set

logger = logging.getLogger("apex.ws")

_TERMINAL = ("complete", "error", "canceled")
_MAX_STR = 4096


def _sanitize(value: Any, depth: int = 0) -> Any:
    """Keep payloads JSON-safe and bounded (reference ws_manager.py:140)."""
    if depth > 6:
        return "…"
    if isinstance(value, dict):
        return {str(k)[:256]: _sanitize(v, depth + 1) for k, v in list(value.items())[:64]}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v, depth + 1) for v in list(value)[:256]]
    if isinstance(value, str):
        return value if len(value) <= _MAX_STR else value[:_MAX_STR] + "…"
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, (int, bool)) or value is None:
        return value
    return str(value)[:_MAX_STR]


class WebSocketManager:
    def __init__(self):
        self._latest: Dict[str, Dict[str, Any]] = {}
        self._queues: Dict[str, Set[asyncio.Queue]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._prev_loops: list = []

    def bind_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        # Multiple apps can share this process-wide singleton (tests, embedded
        # servers); keep a stack so unbinding restores the previous live loop.
        if self._loop is not None and not self._loop.is_closed() \
                and self._loop is not loop:
            self._prev_loops.append(self._loop)
        self._loop = loop

    def unbind_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        if self._loop is loop:
            while self._prev_loops:
                prev = self._prev_loops.pop()
                if not prev.is_closed():
                    self._loop = prev
                    return
            self._loop = None

    # -- producer side (called from worker threads) ---------------------------------

    def send_update(
        self,
        job_id: str,
        progress: Optional[float],
        message: str = "",
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        metadata = _sanitize(metadata or {})
        status = metadata.get("status", "processing")
        update = {
            "progress": progress,
            "message": message,
            "status": status,
            "metadata": metadata,
        }
        # Merge into latest so preview fields survive subsequent progress events.
        latest = dict(self._latest.get(job_id, {}))
        merged_meta = dict(latest.get("metadata", {}))
        merged_meta.update(metadata)
        latest.update(update)
        latest["metadata"] = merged_meta
        self._latest[job_id] = latest

        # A stale binding (closed loop from a torn-down embedded app) must
        # never take down job submission — drop the push, keep `_latest`.
        if self._loop is not None and not self._loop.is_closed():
            try:
                self._loop.call_soon_threadsafe(self._enqueue, job_id, update)
            except RuntimeError:  # closed between the check and the call
                pass

    def _enqueue(self, job_id: str, update: Dict[str, Any]) -> None:
        for q in self._queues.get(job_id, ()):  # one queue per subscriber
            # Coalesce: drop queued plain-processing updates for the newest.
            if update["status"] == "processing":
                try:
                    while q.qsize() > 0:
                        head = q._queue[0]  # type: ignore[attr-defined]
                        if head.get("status") != "processing":
                            break
                        q.get_nowait()
                except Exception:
                    pass
            try:
                q.put_nowait(update)
            except asyncio.QueueFull:
                pass

    # -- consumer side (socket handlers) ----------------------------------------------

    def latest(self, job_id: str) -> Optional[Dict[str, Any]]:
        return self._latest.get(job_id)

    def subscribe(self, job_id: str) -> asyncio.Queue:
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        self._queues.setdefault(job_id, set()).add(q)
        return q

    def unsubscribe(self, job_id: str, q: asyncio.Queue) -> None:
        subs = self._queues.get(job_id)
        if subs is not None:
            subs.discard(q)
            if not subs:
                self._queues.pop(job_id, None)

    @staticmethod
    def is_terminal(update: Dict[str, Any]) -> bool:
        return update.get("status") in _TERMINAL


ws_manager = WebSocketManager()
