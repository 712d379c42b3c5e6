"""HTTP/WS server — the wire surface the Electron editor speaks (port of
``apex_studio_tpu/server/app.py``: the same routes, methods, bodies and status
codes, serving the port's engines).

Counterpart of the reference's FastAPI app (``api/main.py:159``) on aiohttp
(the environment ships no fastapi/uvicorn; aiohttp serves HTTP + RFC6455 WS
from one event loop, and the heavy work all happens on the executor thread
anyway). Routes preserved verbatim (SURVEY.md Appendix B):

  /health /ready /shutdown
  /engine/run /engine/status/{id} /engine/result/{id} /engine/cancel/{id}
  /ws/job/{job_id}
  /manifest/list[...] /manifest/{id} /manifest/types /manifest/categories
  /jobs/status/{id} /jobs/cancel/{id}     /ray/jobs (queue UI catalog)
  /system/memory /system/free-memory      /config/*
  /files?path= /files/exists              /files/engine_results/* (static)

Departures from the JAX app:
- ``create_app(..., device=None)``: ``device`` goes to every engine the runner
  or the warm pool builds and to every learned postprocessor. ``None`` is the
  card (``resolve_device`` raises without one, so an engine job then ends in
  that error); nothing falls back to the CPU. Tests pass ``"cpu"``.
- No XLA compile cache and no device mesh: the JAX app sets both up inside
  ``try/except``, so no response depends on them (one card; multi-GPU is
  ROADMAP Queue 1 item 9).
- ``/system/memory`` lists the CUDA devices from ``torch.cuda`` under the JAX
  keys (``id``, ``platform`` = ``"gpu"``, ``kind``, ``bytes_in_use``,
  ``bytes_limit``).
- ``/system/free-memory`` also runs the garbage collector and
  ``torch.cuda.empty_cache()``, so the pooled engines' memory goes back to the
  card (``warm_pool.free_device_memory``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import sys
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

from aiohttp import WSMsgType, web

from apex_studio_tpu_torch.manifest.resolver import ManifestResolver, default_resolver
from apex_studio_tpu_torch.server.jobs import JobExecutor, JobStore
from apex_studio_tpu_torch.server.runner import engine_results_dir, run_engine_job
from apex_studio_tpu_torch.server.ws import ws_manager
from apex_studio_tpu_torch.utils import config_store
from apex_studio_tpu_torch.utils.defaults import DEFAULT_HOST, DEFAULT_PORT, ensure_dirs

logger = logging.getLogger("apex.server")

READY = {"ok": False}


def json_response(data: Any, status: int = 200) -> web.Response:
    return web.json_response(data, status=status, dumps=lambda d: json.dumps(d, default=str))


def error(status: int, detail: str) -> web.Response:
    return web.json_response({"detail": detail}, status=status)


# --------------------------------------------------------------------------------
# Handlers
# --------------------------------------------------------------------------------


async def health(_req: web.Request) -> web.Response:
    return json_response({"status": "ok"})


async def ready(_req: web.Request) -> web.Response:
    return json_response({"ready": READY["ok"]})


async def shutdown(req: web.Request) -> web.Response:
    async def _stop():
        await asyncio.sleep(0.2)
        os.kill(os.getpid(), signal.SIGINT)

    asyncio.create_task(_stop())
    return json_response({"status": "shutting_down"})


def _enrich_manifest(resolver: ManifestResolver, info) -> Dict[str, Any]:
    import yaml

    doc = yaml.safe_load(Path(info.path).read_text()) or {}
    md = doc.get("metadata") or {}
    spec = doc.get("spec") or {}
    enriched = dict(doc)
    enriched.update(
        {
            "id": info.manifest_id,
            "name": info.name,
            "model": md.get("model", ""),
            "model_type": spec.get("model_type") or spec.get("modelType"),
            "engine": info.engine,
            "full_path": str(info.path),
            "relative_path": str(info.path),
            "category": info.category,
            "compute_compatible": True,
        }
    )
    # Downloaded flags per component variant.
    from apex_studio_tpu_torch.utils.defaults import get_components_path

    root = get_components_path()
    for comp in (spec.get("components") or []):
        mp = comp.get("model_path")
        if isinstance(mp, list):
            for variant in mp:
                if isinstance(variant, dict) and variant.get("path"):
                    variant["is_downloaded"] = (root / variant["path"]).exists()
    return enriched


def make_manifest_handlers(resolver: ManifestResolver):
    async def list_all(_req: web.Request) -> web.Response:
        return json_response(
            [_enrich_manifest(resolver, i) for i in resolver.list()]
        )

    async def list_by_model(req: web.Request) -> web.Response:
        model = req.match_info["model"]
        out = [
            e
            for e in (_enrich_manifest(resolver, i) for i in resolver.list())
            if e.get("model") == model
        ]
        if not out:
            return error(404, f"No manifests found for model: {model}")
        return json_response(out)

    async def list_by_type(req: web.Request) -> web.Response:
        mt = req.match_info["model_type"]
        out = []
        for i in resolver.list():
            e = _enrich_manifest(resolver, i)
            emt = e.get("model_type")
            if emt == mt or (isinstance(emt, list) and mt in emt):
                out.append(e)
        if not out:
            return error(404, f"No manifests found for model_type: {mt}")
        return json_response(out)

    async def get_types(_req: web.Request) -> web.Response:
        seen = {}
        for i in resolver.list():
            if i.model_type:
                seen.setdefault(i.model_type, {"model_type": i.model_type, "count": 0})
                seen[i.model_type]["count"] += 1
        return json_response(list(seen.values()))

    async def get_categories(_req: web.Request) -> web.Response:
        seen = {}
        for i in resolver.list():
            if i.category:
                seen.setdefault(i.category, {"category": i.category, "count": 0})
                seen[i.category]["count"] += 1
        return json_response(list(seen.values()))

    async def get_one(req: web.Request) -> web.Response:
        manifest_id = req.match_info["manifest_id"]
        info = resolver.get(manifest_id)
        if info is None:
            return error(404, f"Manifest not found: {manifest_id}")
        return json_response(_enrich_manifest(resolver, info))

    # -- LoRA CRUD on manifest YAMLs (reference api/manifest.py:776-1199) -------

    def _load_doc(manifest_id: str):
        import yaml

        info = resolver.get(manifest_id)
        if info is None:
            return None, None
        path = Path(info.path)
        return path, (yaml.safe_load(path.read_text()) or {})

    def _save_doc(path: Path, doc: Dict[str, Any]) -> None:
        import yaml

        path.write_text(yaml.safe_dump(doc, sort_keys=False))
        resolver.refresh()

    def _normalize_lora(entry: Any) -> Dict[str, Any]:
        return {"source": entry} if isinstance(entry, str) else dict(entry)

    async def lora_add(req: web.Request) -> web.Response:
        body = await req.json()
        mid = body.get("manifest_id")
        path, doc = _load_doc(mid or "")
        if doc is None:
            return error(404, f"Manifest not found: {mid}")
        entry = {
            k: body[k]
            for k in ("source", "path", "url", "scale", "name", "label", "verified")
            if body.get(k) is not None
        }
        if not any(k in entry for k in ("source", "path", "url")):
            return error(400, "LoRA entry requires source, path or url")
        spec = doc.setdefault("spec", {})
        loras = spec.setdefault("loras", [])
        loras.append(entry)
        _save_doc(path, doc)
        return json_response({"manifest_id": mid, "loras": loras})

    async def lora_scale(req: web.Request) -> web.Response:
        body = await req.json()
        mid, idx = body.get("manifest_id"), int(body.get("lora_index", -1))
        try:
            scale = float(body.get("scale"))
        except (TypeError, ValueError):
            return error(400, "scale must be a number")
        scale = max(0.0, min(1.0, scale))  # clamp like the reference (:1013)
        path, doc = _load_doc(mid or "")
        if doc is None:
            return error(404, f"Manifest not found: {mid}")
        loras = (doc.get("spec") or {}).get("loras") or []
        if not (0 <= idx < len(loras)):
            return error(400, f"lora_index out of range: {idx}")
        entry = _normalize_lora(loras[idx])
        entry["scale"] = scale
        loras[idx] = entry
        doc["spec"]["loras"] = loras
        _save_doc(path, doc)
        return json_response({"manifest_id": mid, "lora_index": idx, "scale": scale})

    async def lora_name(req: web.Request) -> web.Response:
        body = await req.json()
        mid, idx = body.get("manifest_id"), int(body.get("lora_index", -1))
        name = str(body.get("name") or "").strip()
        if not name:
            return error(400, "name is required")
        path, doc = _load_doc(mid or "")
        if doc is None:
            return error(404, f"Manifest not found: {mid}")
        loras = (doc.get("spec") or {}).get("loras") or []
        if not (0 <= idx < len(loras)):
            return error(400, f"lora_index out of range: {idx}")
        entry = _normalize_lora(loras[idx])
        entry["name"] = name
        entry["label"] = name
        loras[idx] = entry
        doc["spec"]["loras"] = loras
        _save_doc(path, doc)
        return json_response({"manifest_id": mid, "lora_index": idx, "name": name})

    async def lora_delete(req: web.Request) -> web.Response:
        body = await req.json()
        mid, idx = body.get("manifest_id"), int(body.get("lora_index", -1))
        path, doc = _load_doc(mid or "")
        if doc is None:
            return error(404, f"Manifest not found: {mid}")
        loras = (doc.get("spec") or {}).get("loras") or []
        if not (0 <= idx < len(loras)):
            return error(400, f"lora_index out of range: {idx}")
        removed = loras.pop(idx)
        doc["spec"]["loras"] = loras
        _save_doc(path, doc)
        return json_response({"manifest_id": mid, "removed": removed, "loras": loras})

    return (list_all, list_by_model, list_by_type, get_types, get_categories,
            get_one, lora_add, lora_scale, lora_name, lora_delete)


def make_engine_handlers(store: JobStore, executor: JobExecutor, resolver: ManifestResolver,
                         device: Any = None):
    async def run(req: web.Request) -> web.Response:
        try:
            body = await req.json()
        except Exception:
            return error(400, "invalid JSON body")
        manifest_id = body.get("manifest_id")
        yaml_path = body.get("yaml_path")
        if yaml_path:
            manifest_path = yaml_path if Path(yaml_path).exists() else None
            if manifest_path is None:
                return error(404, f"YAML not found: {yaml_path}")
        elif manifest_id:
            manifest_path = resolver.resolve(manifest_id)
            if manifest_path is None:
                return error(404, f"Manifest not found: {manifest_id}")
        else:
            return error(400, "Provide either manifest_id or yaml_path")

        job_id = body.get("job_id") or str(uuid.uuid4())
        try:
            job = store.register(job_id, "engine", "engine", {"manifest_path": manifest_path})
        except ValueError as e:
            return error(409, str(e))
        ws_manager.send_update(job_id, 0.0, "Queued", {"status": "queued"})
        executor.submit(
            job,
            lambda j: run_engine_job(
                j,
                manifest_path,
                body.get("inputs") or {},
                body.get("selected_components") or {},
                body.get("folder_uuid"),
                device,
            ),
        )
        return json_response(
            {"job_id": job_id, "status": "queued", "message": "Engine job created"}
        )

    async def status(req: web.Request) -> web.Response:
        return json_response(store.status(req.match_info["job_id"]))

    async def result(req: web.Request) -> web.Response:
        job = store.get(req.match_info["job_id"])
        if job is None:
            return error(404, "job not found")
        out_type = (job.result or {}).get("type") if isinstance(job.result, dict) else None
        if out_type is None and job.result_path:
            # Non-dict results still report a faithful type from the artifact.
            suffix = Path(job.result_path).suffix.lower()
            out_type = {".png": "image", ".jpg": "image", ".mp4": "video",
                        ".npy": "latents"}.get(suffix)
        return json_response(
            {
                "job_id": job.job_id,
                "status": job.status,
                "result_path": job.result_path,
                "type": out_type,
                "error": job.error,
            }
        )

    async def cancel(req: web.Request) -> web.Response:
        ok = store.cancel(req.match_info["job_id"])
        return json_response({"job_id": req.match_info["job_id"], "canceled": ok})

    return run, status, result, cancel


async def ws_job(req: web.Request) -> web.WebSocketResponse:
    job_id = req.match_info["job_id"]
    ws = web.WebSocketResponse(heartbeat=30)
    await ws.prepare(req)
    queue = ws_manager.subscribe(job_id)
    try:
        latest = ws_manager.latest(job_id)
        if latest is not None:
            await ws.send_json(latest)
            if ws_manager.is_terminal(latest):
                return ws

        async def pump():
            while True:
                update = await queue.get()
                await ws.send_json(update)
                if ws_manager.is_terminal(update):
                    return

        pump_task = asyncio.create_task(pump())
        async for msg in ws:
            if msg.type == WSMsgType.TEXT and msg.data == "ping":
                await ws.send_str("pong")
            elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                break
            if pump_task.done():
                break
        pump_task.cancel()
    finally:
        ws_manager.unsubscribe(job_id, queue)
    return ws


def make_job_handlers(store: JobStore):
    async def jobs_status(req: web.Request) -> web.Response:
        return json_response(store.status(req.match_info["job_id"]))

    async def jobs_cancel(req: web.Request) -> web.Response:
        ok = store.cancel(req.match_info["job_id"])
        return json_response({"job_id": req.match_info["job_id"], "canceled": ok})

    async def ray_jobs(_req: web.Request) -> web.Response:
        # Queue-UI catalog (reference api/ray.py:76 shape).
        jobs = {}
        for job in store.list():
            latest = ws_manager.latest(job.job_id) or {}
            jobs[job.job_id] = {
                "job_id": job.job_id,
                "status": job.status,
                "category": job.category,
                "latest": latest,
                "progress": latest.get("progress"),
            }
        return json_response({"jobs": jobs})

    async def ray_job(req: web.Request) -> web.Response:
        job = store.get(req.match_info["job_id"])
        if job is None:
            return error(404, "job not found")
        latest = ws_manager.latest(job.job_id) or {}
        return json_response(
            {"job_id": job.job_id, "status": job.status, "category": job.category,
             "latest": latest, "progress": latest.get("progress")}
        )

    async def ray_cancel(req: web.Request) -> web.Response:
        ok = store.cancel(req.match_info["job_id"])
        return json_response({"job_id": req.match_info["job_id"], "canceled": ok})

    async def ray_cancel_all(_req: web.Request) -> web.Response:
        n = 0
        for job in store.list():
            if job.status in ("queued", "running") and store.cancel(job.job_id):
                n += 1
        return json_response({"canceled": n})

    return jobs_status, jobs_cancel, ray_jobs, ray_job, ray_cancel, ray_cancel_all


async def system_memory(_req: web.Request) -> web.Response:
    import psutil
    import torch

    from apex_studio_tpu_torch.mask.segment import mask_backend_status

    vm = psutil.virtual_memory()
    payload = {
        "ram": {"total": vm.total, "available": vm.available, "percent": vm.percent},
        "devices": [],
        "mask_backend": mask_backend_status(),
    }
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            payload["devices"].append(
                {
                    "id": i,
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": torch.cuda.memory_allocated(i),
                    "bytes_limit": torch.cuda.mem_get_info(i)[1],
                }
            )
    return json_response(payload)


async def system_step_trace(req: web.Request) -> web.Response:
    """Per-stage wall-clock/memory records (env-gated APEX_STEP_TRACE=1 — the
    reference's step_mem tracer, src/utils/step_mem.py:274, surfaced over
    HTTP). DELETE-style clearing via ?clear=1."""
    from apex_studio_tpu_torch.utils import profiling

    if req.query.get("clear"):
        profiling.clear()
    return json_response({"enabled": profiling.enabled(),
                          "records": profiling.records()})


async def system_free_memory(_req: web.Request) -> web.Response:
    from apex_studio_tpu_torch.server.warm_pool import free_device_memory

    free_device_memory()
    return json_response({"status": "ok"})


# Simple key-value config endpoints over the persisted store (reference
# api/config.py exposes ~30; these cover the editor's settings panel).
_CONFIG_KEYS = {
    "home-dir": "home_dir",
    "cache-path": "cache_path",
    "components-path": "components_path",
    "config-path": "config_path",
    "lora-path": "lora_path",
    "preprocessor-path": "preprocessor_path",
    "postprocessor-path": "postprocessor_path",
    "hf-token": "hf_token",
    "civitai-api-key": "civitai_api_key",
    "mask-model": "mask_model",
    "enable-image-render-steps": "enable_image_render_steps",
    "enable-video-render-steps": "enable_video_render_steps",
    "enable-fast-download": "enable_fast_download",
    "torch-device": "device",
    "memory": "memory_settings",
    "auto-update": "auto_update",
}


async def config_get(req: web.Request) -> web.Response:
    key = req.match_info["key"]
    if key == "hostname":
        import socket

        return json_response({"hostname": socket.gethostname()})
    if key == "path-sizes":
        from apex_studio_tpu_torch.utils import defaults

        def du(p: Path) -> int:
            return sum(f.stat().st_size for f in p.rglob("*") if f.is_file()) if p.is_dir() else 0

        return json_response(
            {
                "components": du(defaults.get_components_path()),
                "loras": du(defaults.get_lora_path()),
                "cache": du(defaults.get_cache_path()),
                "results": du(defaults.get_results_path()),
            }
        )
    cfg_key = _CONFIG_KEYS.get(key)
    if cfg_key is None:
        return error(404, f"unknown config key {key}")
    return json_response({"key": key, "value": config_store.get_config_value(cfg_key)})


async def config_set(req: web.Request) -> web.Response:
    key = req.match_info["key"]
    cfg_key = _CONFIG_KEYS.get(key)
    if cfg_key is None:
        return error(404, f"unknown config key {key}")
    body = await req.json()
    value = body.get("value", body.get(cfg_key))
    config_store.set_config_value(cfg_key, value)
    return json_response({"key": key, "value": value})


def _allowed_file_roots() -> List[Path]:
    """File serving is confined to managed roots (reference api/files.py:84
    serves only registered directories — never arbitrary absolute paths)."""
    from apex_studio_tpu_torch.utils.defaults import get_results_path, home_dir

    roots = [get_results_path(), home_dir() / "ingest"]
    extra = os.environ.get("APEX_EXTRA_FILE_ROOTS", "")
    roots += [Path(p) for p in extra.split(os.pathsep) if p]
    return roots


def _confine(path: str) -> Optional[Path]:
    try:
        p = Path(path).resolve()
    except OSError:
        return None
    for root in _allowed_file_roots():
        try:
            if p.is_relative_to(root.resolve()):
                return p
        except OSError:
            continue
    return None


async def files_get(req: web.Request) -> web.Response:
    path = req.query.get("path")
    if not path:
        return error(400, "path query param required")
    p = _confine(path)
    if p is None:
        return error(403, "path outside managed roots")
    if not p.exists():
        return error(404, f"not found: {path}")
    if p.is_dir():
        return json_response({"path": str(p), "files": sorted(f.name for f in p.iterdir())})
    return web.FileResponse(p)


async def files_exists(req: web.Request) -> web.Response:
    path = req.query.get("path", "")
    p = _confine(path)
    return json_response({"path": path, "exists": bool(p is not None and p.exists())})


async def files_ingest(req: web.Request) -> web.Response:
    """Copy an arbitrary local file into managed storage and return the
    managed path (reference api/files.py:179) — the only sanctioned way to
    bring external files into the served tree."""
    import shutil
    import uuid as _uuid

    from apex_studio_tpu_torch.utils.defaults import home_dir

    body = await req.json()
    src = Path(str(body.get("path") or ""))
    if not src.is_file():
        return error(404, f"not found: {src}")
    dest_dir = home_dir() / "ingest" / _uuid.uuid4().hex[:8]
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / src.name
    shutil.copy2(src, dest)
    return json_response({"path": str(dest)})


def _start_parent_watchdog() -> None:
    """Exit when the spawning (Electron) parent dies so the server never
    lingers holding the chip (reference api/main.py:39). Enabled by
    APEX_PARENT_PID; on POSIX also auto-detects re-parenting to init."""
    import threading

    pid_env = os.environ.get("APEX_PARENT_PID")
    if not pid_env:
        return
    try:
        parent = int(pid_env)
    except ValueError:
        return

    def watch():
        import time as _t

        while True:
            try:
                os.kill(parent, 0)
            except OSError:
                logging.getLogger("apex.server").warning(
                    "parent pid %s gone — shutting down", parent
                )
                os._exit(0)
            _t.sleep(2.0)

    threading.Thread(target=watch, daemon=True, name="apex-parent-watchdog").start()


# --------------------------------------------------------------------------------
# App factory
# --------------------------------------------------------------------------------


def create_app(
    store: Optional[JobStore] = None,
    executor: Optional[JobExecutor] = None,
    resolver: Optional[ManifestResolver] = None,
    device: Any = None,
) -> web.Application:
    ensure_dirs()
    store = store or JobStore()
    executor = executor or JobExecutor(store)
    resolver = resolver or default_resolver()

    app = web.Application(client_max_size=256 * 1024 * 1024)
    app["store"], app["executor"], app["resolver"] = store, executor, resolver

    (list_all, list_by_model, list_by_type, get_types, get_categories, get_one,
     lora_add, lora_scale, lora_name, lora_delete) = make_manifest_handlers(resolver)
    run, status, result, cancel = make_engine_handlers(store, executor, resolver, device)
    jobs_status, jobs_cancel, ray_jobs, ray_job, ray_cancel, ray_cancel_all = (
        make_job_handlers(store)
    )

    app.add_routes(
        [
            web.get("/health", health),
            web.get("/ready", ready),
            web.post("/shutdown", shutdown),
            web.post("/engine/run", run),
            web.get("/engine/status/{job_id}", status),
            web.get("/engine/result/{job_id}", result),
            web.post("/engine/cancel/{job_id}", cancel),
            web.get("/ws/job/{job_id}", ws_job),
            web.get("/manifest/list", list_all),
            web.get("/manifest/list/model/{model}", list_by_model),
            web.get("/manifest/list/type/{model_type}", list_by_type),
            web.get("/manifest/types", get_types),
            web.get("/manifest/categories", get_categories),
            web.post("/manifest/lora", lora_add),
            web.post("/manifest/lora/scale", lora_scale),
            web.post("/manifest/lora/name", lora_name),
            web.delete("/manifest/lora", lora_delete),
            web.get("/manifest/{manifest_id}", get_one),
            web.get("/jobs/status/{job_id}", jobs_status),
            web.post("/jobs/cancel/{job_id}", jobs_cancel),
            web.get("/ray/jobs", ray_jobs),
            web.get("/ray/jobs/{job_id}", ray_job),
            web.post("/ray/jobs/{job_id}/cancel", ray_cancel),
            web.post("/ray/jobs/cancel_all", ray_cancel_all),
            web.get("/system/memory", system_memory),
            web.get("/system/step-trace", system_step_trace),
            web.post("/system/free-memory", system_free_memory),
            web.get("/config/{key}", config_get),
            web.post("/config/{key}", config_set),
            web.get("/files", files_get),
            web.get("/files/exists", files_exists),
            web.post("/files/ingest", files_ingest),
        ]
    )
    from apex_studio_tpu_torch.server.mask_routes import add_mask_routes
    from apex_studio_tpu_torch.server.processing_routes import add_processing_routes
    from apex_studio_tpu_torch.utils.defaults import get_results_path

    add_processing_routes(app, store, executor, device)
    add_mask_routes(app, store, executor)

    app.router.add_static("/files/engine_results", engine_results_dir(), show_index=False)
    for kind in ("preprocessor", "postprocessor"):
        d = get_results_path() / f"{kind}_results"
        d.mkdir(parents=True, exist_ok=True)
        app.router.add_static(f"/files/{kind}_results", d, show_index=False)

    async def on_startup(app: web.Application) -> None:
        ws_manager.bind_loop(asyncio.get_running_loop())
        _start_parent_watchdog()
        READY["ok"] = True

    async def on_cleanup(app: web.Application) -> None:
        app["executor"].shutdown()
        ws_manager.unbind_loop(asyncio.get_running_loop())

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    # CORS for the editor (reference enables allow-all).
    @web.middleware
    async def cors(request: web.Request, handler):
        if request.method == "OPTIONS":
            resp = web.Response()
        else:
            resp = await handler(request)
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Methods"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = "*"
        return resp

    app.middlewares.append(cors)

    if os.environ.get("APEX_DISABLE_STABILITY", "0") not in ("1", "true"):
        from apex_studio_tpu_torch.server.stability import install_stability_middleware

        install_stability_middleware(app)
    return app


def serve(host: str = DEFAULT_HOST, port: int = DEFAULT_PORT) -> None:
    """Serve on the card (an engine job raises without one)."""
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    web.run_app(create_app(), host=host, port=port)


if __name__ == "__main__":
    serve()
