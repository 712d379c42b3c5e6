"""Progress-reporting contract shared by every stage of the engine.

The wire protocol (reference: ``src/api/ws_manager.py`` + ``src/utils/progress.py``)
is a stream of ``{progress, message, metadata}`` updates where ``progress`` is a
float in [0, 1] or None and ``metadata.status`` drives the client state machine
(queued | processing | preview | complete | error).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger("apex.progress")

ProgressCallback = Callable[[Optional[float], str, Dict[str, Any]], None]


def safe_emit_progress(
    callback: Optional[ProgressCallback],
    progress: Optional[float],
    message: str = "",
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Emit progress, never letting a callback error kill the pipeline."""
    if callback is None:
        return
    try:
        callback(progress, message, metadata or {})
    except Exception:  # noqa: BLE001 — progress must never break inference
        logger.exception("progress callback raised; continuing")


def make_mapped_progress(
    callback: Optional[ProgressCallback],
    start: float,
    end: float,
) -> Optional[ProgressCallback]:
    """Return a callback that linearly maps [0,1] progress into [start,end].

    Used to compose stage-local progress (e.g. the denoise loop) into the
    job-global progress bar.
    """
    if callback is None:
        return None
    span = end - start

    def mapped(
        p: Optional[float], message: str = "", metadata: Optional[Dict[str, Any]] = None
    ) -> None:
        gp = None if p is None else start + span * max(0.0, min(1.0, p))
        safe_emit_progress(callback, gp, message, metadata or {})

    return mapped


class ProgressReporter:
    """Small convenience wrapper binding a callback to a stage name."""

    def __init__(self, callback: Optional[ProgressCallback], stage: str = ""):
        self.callback = callback
        self.stage = stage

    def __call__(
        self,
        progress: Optional[float],
        message: str = "",
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        md = dict(metadata or {})
        if self.stage and "stage" not in md:
            md["stage"] = self.stage
        safe_emit_progress(self.callback, progress, message, md)

    def sub(self, start: float, end: float, stage: str = "") -> "ProgressReporter":
        return ProgressReporter(
            make_mapped_progress(self.callback, start, end), stage or self.stage
        )
