"""Preprocessor / postprocessor / download / components routers (port of
``apex_studio_tpu/server/processing_routes.py``).

Wire-compatible with the reference routers (api/preprocessor.py:235,
api/postprocessor.py:36, api/download.py:189, api/components.py:34): jobs go
through the same store/executor and stream progress over /ws/job/{id}.

No preprocessor is ported yet: ``/preprocessor/list`` answers ``[]`` (the JAX
route hides manifests without an implementation too) and a run ends its job
with the registry's ``KeyError``. Learned postprocessors run on ``device``
(``None`` is the card).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from aiohttp import web

from apex_studio_tpu_torch.server.jobs import Job, JobCancelled, JobExecutor, JobStore
from apex_studio_tpu_torch.server.ws import ws_manager
from apex_studio_tpu_torch.utils.defaults import (
    get_components_path,
    get_lora_path,
    get_preprocessor_models_path,
    get_results_path,
)
from apex_studio_tpu_torch.utils.media import save_image, save_video

logger = logging.getLogger("apex.server.processing")

# request signature -> most recently created job_id; used only by
# /download/resolve to re-surface in-flight download jobs for the editor's
# download panel (reference api/download.py:28-30).
_request_key_to_job_id: Dict[str, str] = {}


def _normalize_item_type(item_type: str) -> str:
    t = (item_type or "").strip().lower()
    if t not in {"component", "lora", "preprocessor"}:
        raise ValueError("item_type must be one of: component, lora, preprocessor")
    return t


def _default_save_dir_for(item_type: str) -> Path:
    if item_type == "component":
        return get_components_path()
    if item_type == "lora":
        return get_lora_path()
    return get_preprocessor_models_path()


def _canonical_source(source: Union[str, List[str]]) -> Union[str, List[str]]:
    if isinstance(source, list):
        return sorted(str(s).strip() for s in source)
    return str(source).strip()


def _request_key(item_type: str, source: Union[str, List[str]],
                 save_path: Optional[str]) -> str:
    canonical = {
        "item_type": _normalize_item_type(item_type),
        "source": _canonical_source(source),
        "save_path": os.path.abspath(save_path) if save_path else None,
    }
    return json.dumps(canonical, sort_keys=True, separators=(",", ":"))


def _new_unique_job_id(store: JobStore, preferred: Optional[str] = None) -> str:
    candidate = (preferred or "").strip() or str(uuid.uuid4())
    while store.get(candidate) is not None or ws_manager.latest(candidate) is not None:
        candidate = str(uuid.uuid4())
    return candidate


def _already_downloaded(item_type: str, source: Union[str, List[str]],
                        save_path: Optional[str]) -> Tuple[bool, str]:
    """(downloaded, base_dir) — mirrors reference api/download.py:84."""
    from apex_studio_tpu_torch.downloads.api import is_downloaded

    itype = _normalize_item_type(item_type)
    base_dir = Path(save_path) if save_path else _default_save_dir_for(itype)
    base_dir.mkdir(parents=True, exist_ok=True)
    if itype == "preprocessor" and isinstance(source, str):
        # preprocessor ids resolve to model files under the preprocessor dir
        if (base_dir / source).exists() or any(base_dir.glob(f"{source}.*")):
            return True, str(base_dir)
    sources = [source] if isinstance(source, str) else list(source)
    for s in sources:
        s = str(s)
        if s.startswith(("http://", "https://")):
            # URL downloads land at base_dir/<basename> (see _run_download_job)
            name = s.split("/")[-1].split("?")[0]
            if not (base_dir / name).exists():
                return False, str(base_dir)
        elif not is_downloaded(s, base_dir):
            return False, str(base_dir)
    return bool(sources), str(base_dir)


def _resolve_one(store: JobStore, item_type: str, source: Union[str, List[str]],
                 save_path: Optional[str]) -> Dict[str, Any]:
    req_key = _request_key(item_type, source, save_path)
    job_id = _request_key_to_job_id.get(req_key) or _new_unique_job_id(store)
    downloaded, base_dir = _already_downloaded(item_type, source, save_path)
    exists = False
    running = False
    info = store.get(job_id)
    if info is not None:
        exists = True
        running = info.status in {"running", "queued"}
    elif ws_manager.latest(job_id) is not None:
        exists = True
    return {
        "job_id": job_id,
        "exists": exists,
        "running": running,
        "downloaded": downloaded,
        "bucket": _normalize_item_type(item_type),
        "save_dir": base_dir,
        "source": source,
    }


def _results_dir(kind: str, job_id: str) -> Path:
    d = get_results_path() / f"{kind}_results" / job_id
    d.mkdir(parents=True, exist_ok=True)
    return d


def _progress(job: Job):
    def cb(p, message, metadata=None):
        if job.cancel_event.is_set():
            raise JobCancelled(job.job_id)
        ws_manager.send_update(job.job_id, p, message, metadata or {})

    return cb


def _run_preprocessor_job(job: Job, body: Dict[str, Any]) -> Dict[str, Any]:
    from apex_studio_tpu_torch.preprocess.base import load_frames, run_preprocessor

    name = body.get("preprocessor_name") or body.get("name")
    frames = load_frames(body["input_path"], max_frames=body.get("max_frames"))
    out = run_preprocessor(name, frames, body.get("params") or {}, _progress(job))
    out_dir = _results_dir("preprocessor", job.job_id)
    if len(out) == 1:
        path = save_image(out[0], out_dir / f"{name}.png")
        out_type = "image"
    else:
        path = save_video(out, out_dir / f"{name}.mp4", fps=float(body.get("fps", 16)))
        out_type = "video"
    job.result_path = str(path)
    ws_manager.send_update(
        job.job_id, 1.0, "Complete",
        {"status": "complete", "result_path": str(path), "type": out_type},
    )
    return {"result_path": str(path), "type": out_type}


def _run_interpolate_job(job: Job, body: Dict[str, Any], device: Any = None) -> Dict[str, Any]:
    from apex_studio_tpu_torch.postprocess.base import run_postprocessor
    from apex_studio_tpu_torch.preprocess.base import load_frames

    frames = load_frames(body["input_path"])
    multiplier = int(body.get("multiplier", 2))
    out = run_postprocessor(
        body.get("name", "frame_interpolation"),
        frames,
        {"multiplier": multiplier},
        _progress(job),
        device=device,
    )
    fps = float(body.get("fps", 16)) * multiplier
    out_dir = _results_dir("postprocessor", job.job_id)
    path = save_video(out, out_dir / "interpolated.mp4", fps=fps)
    job.result_path = str(path)
    ws_manager.send_update(
        job.job_id, 1.0, "Complete",
        {"status": "complete", "result_path": str(path), "type": "video", "fps": fps},
    )
    return {"result_path": str(path), "type": "video"}


def _run_download_job(job: Job, body: Dict[str, Any]) -> Dict[str, Any]:
    from apex_studio_tpu_torch.downloads.api import (
        download_component,
        download_file,
        download_lora,
    )

    cb = _progress(job)

    def file_progress(done: int, total: int):
        p = done / total if total and total > 0 else None
        cb(p, f"downloaded {done >> 20} MiB")

    item_type = body.get("item_type")
    base_dir = (Path(body["save_path"]) if body.get("save_path")
                else _default_save_dir_for(item_type) if item_type
                else get_components_path())
    results = []
    paths = body.get("paths") or ([body["path"]] if body.get("path") else [])
    if not paths and body.get("source"):
        src = body["source"]
        paths = [src] if isinstance(src, str) else list(src)
    for i, repo_path in enumerate(paths):
        if item_type == "lora" and not repo_path.startswith(("http://", "https://")):
            path = download_lora(repo_path, base_dir, progress_cb=file_progress)
        elif repo_path.startswith(("http://", "https://")):
            dest = base_dir / repo_path.split("/")[-1].split("?")[0]
            path = download_file(repo_path, dest, progress_cb=file_progress)
        else:
            path = download_component(repo_path, progress_cb=file_progress)
        results.append(str(path))
    ws_manager.send_update(
        job.job_id, 1.0, "Complete", {"status": "complete", "paths": results}
    )
    return {"paths": results}


def add_processing_routes(app: web.Application, store: JobStore, executor: JobExecutor,
                          device: Any = None) -> None:
    def submit(category: str, runner, body: Dict[str, Any]) -> web.Response:
        job_id = body.get("job_id") or str(uuid.uuid4())
        try:
            job = store.register(job_id, category, category, {})
        except ValueError as e:
            return web.json_response({"detail": str(e)}, status=409)
        ws_manager.send_update(job_id, 0.0, "Queued", {"status": "queued"})
        executor.submit(job, lambda j: runner(j, body))
        return web.json_response({"job_id": job_id, "status": "queued"})

    async def preprocessor_run(req: web.Request) -> web.Response:
        body = await req.json()
        if not body.get("preprocessor_name") and not body.get("name"):
            return web.json_response({"detail": "preprocessor_name required"}, status=400)
        if not body.get("input_path"):
            return web.json_response({"detail": "input_path required"}, status=400)
        return submit("processor", _run_preprocessor_job, body)

    async def preprocessor_list(_req: web.Request) -> web.Response:
        from apex_studio_tpu_torch.preprocess.base import preprocessor_registry
        from apex_studio_tpu_torch.preprocess.manifests import load_preprocessor_manifests

        manifests = load_preprocessor_manifests()
        # The catalog is the union of manifest ids and registry names: the
        # reference's panel lists its YAML registry (api/preprocessor.py:251
        # "available = [p['id'] for p in list_preprocessors(...)]"), and
        # alias ids (open_pose, pidi, unimatch, ...) resolve through the
        # registry at run time without a primary registration.
        names = list(preprocessor_registry.names())
        names += [n for n in manifests if n not in names]
        out = []
        for name in names:
            try:
                cls = preprocessor_registry.get(name)
            except KeyError:
                continue  # manifest without implementation: hide
            entry = {"name": name, "params": getattr(cls, "params_schema", {})}
            m = manifests.get(name)
            if m:  # editor display metadata (reference manifest/preprocessor/*.yml)
                entry.update({
                    "display_name": m.get("display_name", name),
                    "category": m.get("category", ""),
                    "description": m.get("description", ""),
                    "parameters": m.get("parameters", []),
                })
                if m.get("availability"):
                    entry["availability"] = m["availability"]
            out.append(entry)
        return web.json_response(out)

    async def frame_interpolate(req: web.Request) -> web.Response:
        body = await req.json()
        if not body.get("input_path"):
            return web.json_response({"detail": "input_path required"}, status=400)
        return submit("processor", lambda j, b: _run_interpolate_job(j, b, device), body)

    async def download(req: web.Request) -> web.Response:
        body = await req.json()
        if not (body.get("path") or body.get("paths") or body.get("source")):
            return web.json_response({"detail": "path(s) or source required"}, status=400)
        resp = submit("download", _run_download_job, body)
        if body.get("item_type") and body.get("source") is not None and resp.status == 200:
            try:
                req_key = _request_key(body["item_type"], body["source"],
                                       body.get("save_path"))
                _request_key_to_job_id[req_key] = json.loads(resp.text)["job_id"]
            except ValueError:
                pass
        return resp

    async def download_resolve(req: web.Request) -> web.Response:
        """POST /download/resolve — reference api/download.py:316."""
        body = await req.json()
        try:
            return web.json_response(
                _resolve_one(store, body.get("item_type", ""),
                             body.get("source", ""), body.get("save_path")))
        except ValueError as e:
            return web.json_response({"detail": str(e)}, status=400)
        except Exception as e:  # mirror reference's 500 wrap
            return web.json_response(
                {"detail": f"Failed to resolve job id: {e}"}, status=500)

    async def download_resolve_batch(req: web.Request) -> web.Response:
        """POST /download/resolve/batch — reference api/download.py:375."""
        body = await req.json()
        try:
            results = [
                _resolve_one(store, body.get("item_type", ""), src,
                             body.get("save_path"))
                for src in (body.get("sources") or [])
            ]
            return web.json_response({"results": results})
        except ValueError as e:
            return web.json_response({"detail": str(e)}, status=400)
        except Exception as e:
            return web.json_response(
                {"detail": f"Failed to resolve batch job ids: {e}"}, status=500)

    async def download_status(req: web.Request) -> web.Response:
        """GET /download/status/{job_id} — reference api/download.py:358."""
        return web.json_response(store.status(req.match_info["job_id"]))

    async def download_cancel(req: web.Request) -> web.Response:
        """POST /download/cancel/{job_id} — reference api/download.py:364."""
        job_id = req.match_info["job_id"]
        if store.cancel(job_id):
            return web.json_response({"job_id": job_id, "status": "cancelled",
                                      "message": "cancel requested"})
        return web.json_response({"detail": "Job not found"}, status=404)

    async def download_delete(req: web.Request) -> web.Response:
        """DELETE /download/delete — reference api/download.py:420.

        Deletes a downloaded file/dir, constrained to known download roots;
        prunes empty parents; clears the request-key -> job_id mapping for the
        matching item_type+source.
        """
        body = await req.json()
        path = body.get("path")
        if not path:
            return web.json_response({"detail": "path required"}, status=400)
        try:
            allowed_bases: List[Path] = []
            if body.get("item_type"):
                itype = _normalize_item_type(body["item_type"])
                base = (Path(body["save_path"]) if body.get("save_path")
                        else _default_save_dir_for(itype))
                allowed_bases.append(base.resolve())
            else:
                allowed_bases = [get_components_path().resolve(),
                                 get_lora_path().resolve(),
                                 get_preprocessor_models_path().resolve()]
        except ValueError as e:
            return web.json_response({"detail": str(e)}, status=400)

        target = Path(path)
        target = ((allowed_bases[0] / target) if not target.is_absolute()
                  else target).resolve()
        containing = next((b for b in allowed_bases
                           if target == b or target.is_relative_to(b)), None)
        if containing is None or target == containing:
            return web.json_response(
                {"detail": "path must be within an allowed download directory"},
                status=400)
        if not target.exists():
            return web.json_response({"detail": "Path not found"}, status=404)
        if target.is_dir():
            shutil.rmtree(target)
        else:
            target.unlink()
        # prune empty parents up to (not including) the containing base
        current = target.parent
        while current != containing and current.is_dir():
            try:
                if any(current.iterdir()):
                    break
                nxt = current.parent
                current.rmdir()
                current = nxt
            except OSError:
                break

        removed_mapping = False
        if body.get("item_type") and body.get("source") is not None:
            norm_type = _normalize_item_type(body["item_type"])
            norm_source = _canonical_source(body["source"])
            for key in [k for k in _request_key_to_job_id
                        if json.loads(k).get("item_type") == norm_type
                        and json.loads(k).get("source") == norm_source]:
                del _request_key_to_job_id[key]
                removed_mapping = True
        return web.json_response({"path": str(target), "status": "deleted",
                                  "removed_mapping": removed_mapping,
                                  "unmarked": removed_mapping})

    async def components_download(req: web.Request) -> web.Response:
        return await download(req)

    async def components_delete(req: web.Request) -> web.Response:
        body = await req.json()
        rel = body.get("path")
        if not rel:
            return web.json_response({"detail": "path required"}, status=400)
        target = (get_components_path() / rel).resolve()
        if not str(target).startswith(str(get_components_path().resolve())):
            return web.json_response({"detail": "path escapes components dir"}, status=400)
        if target.is_file():
            target.unlink()
        elif target.is_dir():
            shutil.rmtree(target)
        else:
            return web.json_response({"detail": "not found"}, status=404)
        return web.json_response({"deleted": rel})

    app.add_routes(
        [
            web.post("/preprocessor/run", preprocessor_run),
            web.get("/preprocessor/list", preprocessor_list),
            web.post("/postprocessor/frame-interpolate", frame_interpolate),
            web.post("/download", download),
            web.post("/download/resolve", download_resolve),
            web.post("/download/resolve/batch", download_resolve_batch),
            web.get("/download/status/{job_id}", download_status),
            web.post("/download/cancel/{job_id}", download_cancel),
            web.delete("/download/delete", download_delete),
            web.post("/components/download", components_download),
            web.delete("/components/delete", components_delete),
        ]
    )
