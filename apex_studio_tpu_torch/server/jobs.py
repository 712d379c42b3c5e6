"""Fail-closed job store + single-device executor (port of
``apex_studio_tpu/server/jobs.py``).

Counterpart of the reference's Ray-based job plumbing (``api/job_store.py:49``
``UnifiedJobStoreActor`` + one ``EngineRunner`` actor per device): a process
owns the card, so jobs execute on a dedicated worker thread (device work
releases the GIL) with the same fail-closed semantics — a job_id must be
registered before it can run, and unknown job_ids refuse to execute.

Departures:
- ``JobCancelled`` derives from ``BaseException``, as ``asyncio.CancelledError``
  does: the engines call progress through ``safe_emit_progress``, whose
  ``except Exception`` would swallow it, so in the JAX package a running job
  cannot be cancelled and runs on to ``complete``.
- The OOM purge matches ``torch.OutOfMemoryError`` by its type name and hands
  the pooled engines' memory back to the card (``free_device_memory``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("apex.jobs")

JOB_CATEGORIES = ("engine", "download", "processor", "other")


class JobCancelled(BaseException):
    """Raised from a job's progress callback once the job is cancelled."""


@dataclass
class Job:
    job_id: str
    job_type: str
    category: str
    meta: Dict[str, Any] = field(default_factory=dict)
    status: str = "queued"  # queued | running | complete | error | canceled
    result: Any = None
    result_path: Optional[str] = None
    error: Optional[str] = None
    created_at: float = field(default_factory=time.time)
    finished_at: Optional[float] = None
    cancel_event: threading.Event = field(default_factory=threading.Event)

    def public(self) -> Dict[str, Any]:
        return {
            "job_id": self.job_id,
            "status": self.status,
            "type": self.job_type,
            "category": self.category,
            "result_path": self.result_path,
            "error": self.error,
            "meta": self.meta,
        }


class JobStore:
    def __init__(self):
        self._jobs: Dict[str, Job] = {}
        self._lock = threading.Lock()

    def register(self, job_id: Optional[str], job_type: str, category: str = "engine",
                 meta: Optional[Dict[str, Any]] = None) -> Job:
        job_id = job_id or str(uuid.uuid4())
        with self._lock:
            if job_id in self._jobs and self._jobs[job_id].status in ("queued", "running"):
                raise ValueError(f"job {job_id} already active")
            job = Job(job_id=job_id, job_type=job_type, category=category, meta=meta or {})
            self._jobs[job_id] = job
        return job

    def get(self, job_id: str) -> Optional[Job]:
        return self._jobs.get(job_id)

    def require(self, job_id: str) -> Job:
        """Fail-closed: executing an unregistered job id is an error."""
        job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"untracked job_id {job_id!r} refused")
        return job

    def status(self, job_id: str) -> Dict[str, Any]:
        job = self._jobs.get(job_id)
        if job is None:
            return {"job_id": job_id, "status": "not_found"}
        return job.public()

    def list(self) -> List[Job]:
        return list(self._jobs.values())

    def cancel(self, job_id: str) -> bool:
        job = self._jobs.get(job_id)
        if job is None:
            return False
        job.cancel_event.set()
        if job.status == "queued":
            job.status = "canceled"
            job.finished_at = time.time()
        return True


class JobExecutor:
    """Serial worker bound to the card. FIFO like the reference's per-device
    EngineRunner actor."""

    def __init__(self, store: JobStore, workers: int = 1):
        self.store = store
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True, name=f"apex-exec-{i}")
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    def submit(self, job: Job, fn: Callable[[Job], Any]) -> None:
        self.store.require(job.job_id)  # fail closed
        self._queue.put((job, fn))

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            job, fn = item
            if job.cancel_event.is_set():
                job.status = "canceled"
                job.finished_at = time.time()
                continue
            job.status = "running"
            try:
                job.result = fn(job)
                job.status = "complete"
            except JobCancelled:
                job.status = "canceled"
            except Exception as e:  # noqa: BLE001 — job errors must not kill the worker
                job.status = "error"
                job.error = f"{type(e).__name__}: {e}"
                job.meta["traceback"] = traceback.format_exc()
                # Device allocator failures must not poison later jobs: purge
                # warm engines so their memory is released (the reference kills
                # and recreates the Ray actor, ray_tasks.py:309).
                if "OutOfMemory" in type(e).__name__:
                    from apex_studio_tpu_torch.server.warm_pool import free_device_memory

                    try:
                        free_device_memory()
                        job.meta["warm_pool_purged"] = True
                    except Exception:  # noqa: BLE001 — the worker must survive a dead context
                        logger.exception("freeing device memory after %s failed", job.job_id)
            finally:
                job.finished_at = time.time()

    def shutdown(self) -> None:
        for _ in self._threads:
            self._queue.put(None)
