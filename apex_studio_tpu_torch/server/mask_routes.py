"""Mask routers (/mask/create, /mask/track) — port of
``apex_studio_tpu/server/mask_routes.py``, reference api/mask.py:418,584.

The segmenter is the port's ``mask/segment.py``: the SAM2 predictor on the
server's ``device`` (``None`` is the card) where a checkpoint is configured
or on disk, else GrabCut on the host; a SAM2 failure raises (ROADMAP
"Departures"). Tracking propagates the first mask by optical flow, as the
JAX routes do.

`create` is synchronous (sub-second); `track` runs as a job streaming
per-frame contours over /ws/job/{id}, with cancellation like the reference's
/mask/track/cancel/{id}.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import uuid
from typing import Any, Dict, Set

import numpy as np
from aiohttp import web

from apex_studio_tpu_torch.server.jobs import Job, JobCancelled, JobExecutor, JobStore
from apex_studio_tpu_torch.server.ws import ws_manager

logger = logging.getLogger("apex.server.mask")

# Tracking-request ids with a pending cancel — the reference's CANCEL_TRACKING
# set (api/mask.py:36); /mask/track/cancel/{id} populates it and the shapes
# stream checks it per frame.
CANCEL_TRACKING: Set[str] = set()


class _StopTracking(Exception):
    """Propagation passed the requested frame bound."""


class _TrackingCancelled(Exception):
    """User cancelled via /mask/track/cancel/{id}."""


def _load_frame(path: str, frame_number: int | None):
    from apex_studio_tpu_torch.preprocess.base import load_frames

    is_video = not path.lower().endswith((".png", ".jpg", ".jpeg", ".webp", ".bmp"))
    if is_video:
        frames = load_frames(path, max_frames=(frame_number or 0) + 1)
        return frames[min(frame_number or 0, len(frames) - 1)], is_video
    return load_frames(path)[0], is_video


def _run_track_job(job: Job, body: Dict[str, Any], device: Any = None) -> Dict[str, Any]:
    from apex_studio_tpu_torch.mask.segment import mask_from_points, mask_to_contours, track_mask
    from apex_studio_tpu_torch.preprocess.base import load_frames

    frames = load_frames(body["input_path"], max_frames=body.get("max_frames"))
    start = int(body.get("frame_number", 0))
    image = frames[min(start, len(frames) - 1)]
    initial = mask_from_points(
        image,
        body.get("points") or [],
        body.get("point_labels"),
        body.get("box"),
        tool=body.get("tool", "touch"),
        device=device,
    )

    def progress(p, message, metadata=None):
        if job.cancel_event.is_set():
            raise JobCancelled(job.job_id)
        ws_manager.send_update(job.job_id, p, message, metadata or {})

    masks = track_mask(
        frames, initial, start_frame=start,
        direction=body.get("direction", "forward"),
        progress_callback=progress,
    )
    per_frame = {
        int(idx): mask_to_contours(m) for idx, m in sorted(masks.items())
    }
    ws_manager.send_update(
        job.job_id, 1.0, "Tracking complete",
        {"status": "complete", "frames": list(per_frame)},
    )
    job.result = {"contours_by_frame": per_frame}
    return job.result


def add_mask_routes(app: web.Application, store: JobStore, executor: JobExecutor, device: Any = None) -> None:
    async def create(req: web.Request) -> web.Response:
        from apex_studio_tpu_torch.mask.segment import mask_from_points, mask_to_contours

        body = await req.json()
        if not body.get("input_path"):
            return web.json_response({"detail": "input_path required"}, status=400)
        try:
            image, is_video = _load_frame(body["input_path"], body.get("frame_number"))
        except (FileNotFoundError, ValueError) as e:
            return web.json_response({"detail": str(e)}, status=404)
        if is_video and body.get("frame_number") is None:
            return web.json_response(
                {"detail": "frame_number is required for video inputs"}, status=400
            )
        if not body.get("points") and not body.get("box"):
            return web.json_response(
                {"status": "error", "message": "Provide points or box"}, status=400
            )
        mask = mask_from_points(
            image,
            body.get("points") or [],
            body.get("point_labels"),
            body.get("box"),
            tool=body.get("tool", "touch"),
            device=device,
        )
        return web.json_response(
            {
                "status": "success",
                "contours": mask_to_contours(mask),
                "input_path": body["input_path"],
                "frame_number": body.get("frame_number"),
                "tool": body.get("tool", "touch"),
                "message": "mask created",
            }
        )

    async def track(req: web.Request) -> web.Response:
        body = await req.json()
        if not body.get("input_path"):
            return web.json_response({"detail": "input_path required"}, status=400)
        job_id = body.get("job_id") or str(uuid.uuid4())
        try:
            job = store.register(job_id, "mask_track", "processor", {})
        except ValueError as e:
            return web.json_response({"detail": str(e)}, status=409)
        ws_manager.send_update(job_id, 0.0, "Queued", {"status": "queued"})
        executor.submit(job, lambda j: _run_track_job(j, body, device))
        return web.json_response({"job_id": job_id, "status": "queued"})

    async def track_cancel(req: web.Request) -> web.Response:
        job_id = req.match_info["job_id"]
        ok = store.cancel(job_id)
        CANCEL_TRACKING.add(job_id)  # also stops an in-flight shapes stream
        return web.json_response({"job_id": job_id, "canceled": ok})

    async def track_shapes(req: web.Request) -> web.StreamResponse:
        """POST /mask/track/shapes — reference api/mask.py:888.

        Streams NDJSON lines ``{"frame_number": int, "shapeBounds": dict|null}``
        while the anchor mask propagates across [frame_start, frame_end];
        terminal lines are ``{"status": "cancelled"}`` / ``{"status": "error"}``.
        """
        body = await req.json()
        input_path = body.get("input_path")
        if not input_path:
            return web.json_response({"detail": "input_path required"}, status=400)
        if input_path.lower().endswith((".png", ".jpg", ".jpeg", ".webp", ".bmp")):
            return web.json_response(
                {"detail": "Shape tracking only supports video inputs"}, status=400)
        if body.get("frame_start") is None or body.get("frame_end") is None:
            return web.json_response(
                {"detail": "frame_start and frame_end are required"}, status=400)
        frame_start = int(body["frame_start"])
        frame_end = int(body["frame_end"])
        direction = body.get("direction") or (
            "forward" if frame_end >= frame_start else "backward")
        if direction == "forward" and frame_end < frame_start:
            return web.json_response(
                {"detail": "For forward tracking, frame_end must be >= frame_start"},
                status=400)
        if direction == "backward" and frame_end > frame_start:
            return web.json_response(
                {"detail": "For backward tracking, frame_end must be <= frame_start"},
                status=400)
        if not (body.get("tool") or body.get("points") or body.get("box")):
            # no persistent SAM2 state server-side: the seed must ride along
            return web.json_response(
                {"detail": "Shape tracking state is missing. Pass seed inputs "
                           "(tool/points/box) to /mask/track/shapes."},
                status=409)
        anchor = int(body.get("anchor_frame", frame_start))
        shape_type = body.get("shape_type")
        rid = str(body.get("id") or uuid.uuid4())
        CANCEL_TRACKING.discard(rid)

        resp = web.StreamResponse(
            headers={"Content-Type": "application/x-ndjson"})
        await resp.prepare(req)
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def emit(item) -> None:
            loop.call_soon_threadsafe(queue.put_nowait, item)

        def worker() -> None:
            from apex_studio_tpu_torch.mask.segment import (
                mask_from_points,
                mask_to_contours,
                shape_bounds_from_contours,
                track_mask,
            )
            from apex_studio_tpu_torch.preprocess.base import load_frames

            try:
                lo = min(frame_start, frame_end, anchor)
                hi = max(frame_start, frame_end, anchor)
                max_frames = body.get("max_frames")
                n_load = hi + 1 if max_frames is None else min(hi + 1, int(max_frames))
                frames = load_frames(input_path, max_frames=n_load)
                a = min(anchor, len(frames) - 1)
                initial = mask_from_points(
                    frames[a], body.get("points") or [],
                    body.get("point_labels"), body.get("box"),
                    tool=body.get("tool", "touch"), device=device)

                def bounds_of(mask):
                    return shape_bounds_from_contours(
                        mask_to_contours(mask), shape_type)

                emit({"frame_number": a, "shapeBounds": bounds_of(initial)})

                def on_frame(idx, mask):
                    if rid in CANCEL_TRACKING:
                        raise _TrackingCancelled(rid)
                    if idx < lo:
                        raise _StopTracking()
                    if idx <= hi:
                        emit({"frame_number": idx, "shapeBounds": bounds_of(mask)})

                try:
                    track_mask(frames, initial, start_frame=a,
                               direction=direction, frame_callback=on_frame)
                except _StopTracking:
                    pass
                emit(None)
            except _TrackingCancelled:
                emit({"status": "cancelled"})
                emit(None)
            except Exception as e:  # noqa: BLE001 — reported on the stream
                logger.exception("Streaming error in track_shapes")
                emit({"status": "error", "error": str(e)})
                emit(None)
            finally:
                CANCEL_TRACKING.discard(rid)

        threading.Thread(target=worker, daemon=True,
                         name=f"track-shapes-{rid}").start()
        while True:
            item = await queue.get()
            if item is None:
                break
            await resp.write((json.dumps(item) + "\n").encode())
        await resp.write_eof()
        return resp

    async def track_result(req: web.Request) -> web.Response:
        job = store.get(req.match_info["job_id"])
        if job is None:
            return web.json_response({"detail": "job not found"}, status=404)
        return web.json_response({"job_id": job.job_id, "status": job.status,
                                  "result": job.result, "error": job.error})

    app.add_routes(
        [
            web.post("/mask/create", create),
            web.post("/mask/track", track),
            web.post("/mask/track/shapes", track_shapes),
            web.post("/mask/track/cancel/{job_id}", track_cancel),
            web.get("/mask/track/result/{job_id}", track_result),
        ]
    )
