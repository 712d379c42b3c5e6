"""The port's HTTP/WS server (``apex_studio_tpu_torch/server``) on the CPU.

Each app runs behind aiohttp's test server on a private event loop and is
driven synchronously; every app gets ``device="cpu"``, a resolver over its
own manifest directory and a home directory set with ``monkeypatch`` (the
fixtures are named apart from conftest's session ``server``, which would set
``APEX_HOME_DIR`` for its whole worker). The port's ``ws_manager``, warm pool
and download-request map are reset around each test.

The tiny engine is the ZImage manifest of tests/test_engine_zimage.py in
fp32, its tokenizer saved as ``tokenizer.json`` where the manifest names it.

- The cases of the JAX server tests (test_server.py, test_server_hardening.py,
  test_server_processing.py, test_download_routes.py, the stability part of
  test_stability_and_cache.py and test_step_mem.py) against the port. No
  preprocessor is ported, so ``/preprocessor/list`` answers [] and a run ends
  its job with the registry's ``KeyError``; a running job's cancel ends it
  ``canceled`` (the JAX job runs on to ``complete``).
- Held against the JAX package: the route tables; one scripted sequence of
  non-engine requests through both apps (status codes and JSON bodies equal
  once ids, paths and times are normalised; the JAX preprocessor registry
  cut to the names the port registers and its SAM2 lookup answering "none
  configured"); the resolver's
  ids over ``manifests/``; and one ``/engine/run`` of the tiny engine through
  each server, the JAX engine's weights carried into the port's and each
  engine in its server's warm pool under the runner's key: PNGs within one
  uint8 step, the same WS update sequence (status, message, progress) and
  preview count, the same ``model_inputs.json``.
"""

import asyncio
import copy
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from apex_studio_tpu_torch.manifest.resolver import ManifestResolver
from apex_studio_tpu_torch.server import app as port_app
from apex_studio_tpu_torch.server import processing_routes as port_processing
from apex_studio_tpu_torch.server.jobs import JobExecutor, JobStore
from apex_studio_tpu_torch.server.runner import engine_results_dir, replay_run
from apex_studio_tpu_torch.server.warm_pool import make_pool_key, warm_pool
from apex_studio_tpu_torch.server.ws import ws_manager
from apex_studio_tpu_torch.utils.defaults import get_components_path, get_lora_path
from tests.test_engine_zimage import TINY_MANIFEST, make_tokenizer

REPO = Path(__file__).resolve().parent.parent
TERMINAL = ("complete", "error", "canceled")
TOKENIZER = "tiny-tok"
CRUD = {
    "api_version": "apex/v1",
    "kind": "Model",
    "metadata": {"id": "crud-test", "name": "CRUD Test", "version": "1.0.0"},
    "spec": {"engine": "zimage", "model_type": "t2i", "engine_type": "jax",
             "components": [], "loras": ["some/lora.safetensors"]},
}
JOB = {"prompt": "hello world", "height": 32, "width": 32, "num_inference_steps": 2, "seed": 3}


def tiny_doc() -> dict:
    doc = copy.deepcopy(TINY_MANIFEST)
    for comp in doc["spec"]["components"]:
        if comp["type"] != "scheduler":
            comp["precision"] = "fp32"
        if comp["type"] == "text_encoder":
            comp["tokenizer_name"] = TOKENIZER
    return doc


def write_manifests(root: Path) -> Path:
    (root / "image").mkdir(parents=True)
    (root / "image" / "zimage-tiny.yml").write_text(yaml.safe_dump(tiny_doc()))
    (root / "image" / "crud.yml").write_text(yaml.safe_dump(CRUD))
    return root


def save_tokenizer() -> None:
    """The tiny tokenizer where the manifest's ``tokenizer_name`` points, under
    the current home's components."""
    path = get_components_path() / TOKENIZER / "tokenizer.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    make_tokenizer().save(str(path))


def reset_port_state() -> None:
    ws_manager._latest.clear()
    ws_manager._queues.clear()
    warm_pool.discard()
    port_processing._request_key_to_job_id.clear()


class Served:
    """An app behind aiohttp's test server on a private event loop."""

    def __init__(self, app: web.Application):
        self.app = app
        self.loop = asyncio.new_event_loop()

        async def start():
            client = TestClient(TestServer(app))
            await client.start_server()
            return client

        self.client = self.loop.run_until_complete(start())

    def call(self, method: str, path: str, **kw):
        """(status, JSON body or raw bytes) of one request."""
        async def go():
            resp = await self.client.request(method, path, **kw)
            if resp.content_type == "application/json":
                return resp.status, await resp.json()
            return resp.status, await resp.read()

        return self.loop.run_until_complete(go())

    def wait(self, job_id: str, timeout: float = 120.0) -> dict:
        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.call("GET", f"/jobs/status/{job_id}")[1]
            if st["status"] in TERMINAL:
                return st
            self.loop.run_until_complete(asyncio.sleep(0.05))
        raise TimeoutError(f"job {job_id} did not finish")

    def ws(self, job_id: str, timeout: float = 120.0) -> list:
        """WS messages of a job up to its terminal one."""
        async def go():
            out = []
            async with self.client.ws_connect(f"/ws/job/{job_id}") as sock:
                while not out or out[-1]["status"] not in TERMINAL:
                    out.append(await sock.receive_json(timeout=timeout))
            return out

        return self.loop.run_until_complete(go())

    def close(self) -> None:
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


@pytest.fixture()
def port_home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("APEX_HOME_DIR", str(home))
    for var in ("APEX_MANIFEST_PATHS", "APEX_SYNTHETIC_WEIGHTS", "APEX_STEP_TRACE", "APEX_RESULTS_PATH",
                "APEX_COMPONENTS_PATH", "APEX_LORA_PATH", "APEX_CACHE_PATH", "APEX_CONFIG_PATH",
                "APEX_PREPROCESSOR_MODELS_PATH", "APEX_SAM2_PATH", "APEX_EXTRA_FILE_ROOTS",
                "APEX_DISABLE_WARM_WEIGHTS", "APEX_PARENT_PID"):
        monkeypatch.delenv(var, raising=False)
    reset_port_state()
    save_tokenizer()
    yield home
    reset_port_state()


@pytest.fixture()
def port_manifests(tmp_path):
    return write_manifests(tmp_path / "manifests")


@pytest.fixture()
def port_server(port_home, port_manifests):
    served = Served(port_app.create_app(resolver=ManifestResolver(search_paths=[port_manifests]),
                                        device="cpu"))
    yield served
    served.close()


def run_job(served: Served, inputs: dict, **body) -> str:
    status, out = served.call("POST", "/engine/run", json={"manifest_id": "zimage-tiny-test",
                                                           "inputs": inputs, **body})
    assert status == 200, out
    assert out["status"] == "queued"
    return out["job_id"]


# -- test_server.py ---------------------------------------------------------------------------------


class TestHTTPSurface:
    def test_health_ready(self, port_server):
        assert port_server.call("GET", "/health")[1]["status"] == "ok"
        assert port_server.call("GET", "/ready")[1]["ready"] is True

    def test_manifest_list(self, port_server):
        out = port_server.call("GET", "/manifest/list")[1]
        assert {m["id"] for m in out} == {"zimage-tiny-test", "crud-test"}
        tiny = next(m for m in out if m["id"] == "zimage-tiny-test")
        assert tiny["engine"] == "zimage" and tiny["compute_compatible"] is True

    def test_manifest_get(self, port_server):
        assert port_server.call("GET", "/manifest/zimage-tiny-test")[1]["metadata"]["name"] == "ZImage Tiny"

    def test_manifest_404(self, port_server):
        assert port_server.call("GET", "/manifest/nope")[0] == 404

    def test_manifest_types(self, port_server):
        assert any(t["model_type"] == "t2i" for t in port_server.call("GET", "/manifest/types")[1])

    def test_system_memory(self, port_server):
        out = port_server.call("GET", "/system/memory")[1]
        assert out["ram"]["total"] > 0
        assert out["devices"] == []  # no card here
        assert out["mask_backend"]["backend"] == "classical"

    def test_config_roundtrip(self, port_server):
        port_server.call("POST", "/config/hf-token", json={"value": "tok123"})
        assert port_server.call("GET", "/config/hf-token")[1]["value"] == "tok123"

    def test_engine_run_requires_manifest(self, port_server):
        assert port_server.call("POST", "/engine/run", json={"inputs": {}})[0] == 400

    def test_engine_run_unknown_manifest(self, port_server):
        assert port_server.call("POST", "/engine/run", json={"manifest_id": "missing", "inputs": {}})[0] == 404


class TestEngineJobFlow:
    def test_full_job_with_ws_progress(self, port_server):
        job_id = run_job(port_server, JOB)
        updates = port_server.ws(job_id)
        final = updates[-1]
        assert final["status"] == "complete", final
        assert final["progress"] == 1.0
        assert final["metadata"]["preview_url"].startswith("/files/engine_results/")
        assert port_server.wait(job_id)["status"] == "complete"
        res = port_server.call("GET", f"/engine/result/{job_id}")[1]
        assert res["result_path"].endswith("output.png") and res["type"] == "image"
        status, png = port_server.call("GET", final["metadata"]["preview_url"])
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        frame = np.asarray(Image.open(res["result_path"]))
        assert frame.shape == (32, 32, 3) and frame.dtype == np.uint8

    def test_ws_late_subscriber_gets_cached_final(self, port_server):
        job_id = run_job(port_server, dict(JOB, num_inference_steps=1, seed=1))
        port_server.wait(job_id)
        assert port_server.ws(job_id)[0]["status"] == "complete"

    def test_job_catalog(self, port_server):
        job_id = run_job(port_server, dict(JOB, num_inference_steps=1))
        port_server.wait(job_id)
        jobs = port_server.call("GET", "/ray/jobs")[1]["jobs"]
        assert jobs[job_id]["category"] == "engine" and jobs[job_id]["status"] == "complete"

    def test_cancel_queued_job(self, port_server, monkeypatch):
        """A job cancelled while another runs never starts; one cancelled after
        its first step message ends ``canceled`` at the next progress call.
        The first job waits at its first step until it is cancelled, so the
        order is fixed."""
        store = port_server.app["store"]
        send = ws_manager.send_update

        def hold_at_first_step(job_id, progress, message="", metadata=None):
            send(job_id, progress, message, metadata)
            if message.startswith("Denoising step 1/"):
                assert store.get(job_id).cancel_event.wait(30)

        monkeypatch.setattr(ws_manager, "send_update", hold_at_first_step)
        running = run_job(port_server, dict(JOB, num_inference_steps=8))
        queued = run_job(port_server, JOB)
        deadline = time.time() + 60
        while (ws_manager.latest(running) or {}).get("message", "") != "Denoising step 1/8":
            assert time.time() < deadline
            port_server.loop.run_until_complete(asyncio.sleep(0.02))
        assert port_server.call("POST", f"/engine/cancel/{queued}")[1]["canceled"] is True
        assert port_server.call("GET", f"/engine/status/{queued}")[1]["status"] == "canceled"
        assert port_server.call("POST", f"/engine/cancel/{running}")[1]["canceled"] is True
        assert port_server.wait(running)["status"] == "canceled"
        assert ws_manager.latest(running)["status"] == "canceled"
        monkeypatch.setattr(ws_manager, "send_update", send)
        after = run_job(port_server, JOB)  # the pooled engine serves on
        assert port_server.wait(after)["status"] == "complete"

    def test_missing_card_ends_the_job_with_the_device_error(self, port_home, port_manifests):
        """``device=None`` is the card: without one, the engine request ends
        with ``resolve_device``'s error, and nothing runs on the CPU."""
        served = Served(port_app.create_app(resolver=ManifestResolver(search_paths=[port_manifests])))
        try:
            st = served.wait(run_job(served, JOB))
        finally:
            served.close()
        assert st["status"] == "error"
        assert st["error"].startswith("RuntimeError: CUDA is not available")


class TestRunPersistence:
    def test_run_config_persisted_and_replayable(self, port_server):
        job_id = run_job(port_server, dict(JOB, prompt="golden", seed=42, return_latents=True))
        assert port_server.wait(job_id)["status"] == "complete"
        run_dir = engine_results_dir() / job_id
        cfg = json.loads((run_dir / "model_inputs.json").read_text())
        assert cfg["job_id"] == job_id and cfg["inputs"]["seed"] == 42
        _, result = replay_run(run_dir, device="cpu")
        np.testing.assert_allclose(result.numpy(), np.load(run_dir / "latents.npy"), atol=1e-6)


# -- test_server_hardening.py -------------------------------------------------------------------------


class TestFilesConfinement:
    def test_outside_roots_forbidden(self, port_server):
        assert port_server.call("GET", "/files", params={"path": "/etc/passwd"})[0] == 403
        assert port_server.call("GET", "/files/exists", params={"path": "/etc/passwd"})[1]["exists"] is False

    def test_results_root_served(self, port_server):
        p = engine_results_dir() / "t-hardening" / "x.txt"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("ok")
        assert port_server.call("GET", "/files", params={"path": str(p)}) == (200, b"ok")

    def test_ingest_copies_into_managed_root(self, port_server, tmp_path):
        src = tmp_path / "outside.bin"
        src.write_bytes(b"abc")
        status, out = port_server.call("POST", "/files/ingest", json={"path": str(src)})
        assert status == 200
        assert port_server.call("GET", "/files", params={"path": out["path"]}) == (200, b"abc")


class TestManifestLoraCrud:
    def test_add_scale_name_delete(self, port_server, port_manifests):
        status, out = port_server.call("POST", "/manifest/lora", json={
            "manifest_id": "crud-test", "source": "hf:org/repo/l.safetensors", "scale": 0.8, "name": "mylora"})
        assert status == 200 and len(out["loras"]) == 2
        status, out = port_server.call("POST", "/manifest/lora/scale", json={
            "manifest_id": "crud-test", "lora_index": 0, "scale": 2.5})
        assert status == 200 and out["scale"] == 1.0  # clamped
        assert port_server.call("POST", "/manifest/lora/name", json={
            "manifest_id": "crud-test", "lora_index": 0, "name": "renamed"})[0] == 200
        loras = yaml.safe_load((port_manifests / "image" / "crud.yml").read_text())["spec"]["loras"]
        assert loras[0]["name"] == "renamed" and loras[0]["scale"] == 1.0
        assert port_server.call("DELETE", "/manifest/lora",
                                json={"manifest_id": "crud-test", "lora_index": 1})[0] == 200
        assert len(yaml.safe_load((port_manifests / "image" / "crud.yml").read_text())["spec"]["loras"]) == 1

    def test_bad_index_rejected(self, port_server):
        assert port_server.call("POST", "/manifest/lora/scale", json={
            "manifest_id": "crud-test", "lora_index": 99, "scale": 0.5})[0] == 400


def test_civitai_air_and_url_resolution(monkeypatch):
    from apex_studio_tpu_torch.downloads.api import resolve_civitai_url

    monkeypatch.delenv("APEX_CIVITAI_TOKEN", raising=False)
    monkeypatch.setenv("APEX_CONFIG_PATH", "/nonexistent/config.json")
    assert resolve_civitai_url("urn:air:sdxl:lora:civitai:328553@368189") == \
        "https://civitai.com/api/download/models/368189"
    assert "download/models/42" in resolve_civitai_url("https://civitai.com/models/7?modelVersionId=42")
    monkeypatch.setenv("APEX_CIVITAI_TOKEN", "sekret")
    assert "token=sekret" in resolve_civitai_url("urn:air:sd1:lora:civitai:1@2")
    with pytest.raises(ValueError):
        resolve_civitai_url("https://civitai.com/models/7")


def test_oom_error_purges_warm_pool(port_home):
    warm_pool.release("k1", object())
    store = JobStore()
    ex = JobExecutor(store)
    job = store.register("oom-job", "engine")

    def boom(_j):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    ex.submit(job, boom)
    for _ in range(200):
        if job.finished_at is not None:
            break
        time.sleep(0.05)
    ex.shutdown()
    assert job.status == "error" and job.error.startswith("OutOfMemoryError")
    assert job.meta.get("warm_pool_purged") is True
    assert warm_pool.stats()["entries"] == 0


def test_parent_watchdog_exits_when_parent_dies(monkeypatch):
    """The watchdog of a server whose parent (here a short-lived process)
    dies exits the process; ``os._exit`` is intercepted."""
    parent = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(0.3)"])
    exited = threading.Event()

    def fake_exit(code):
        exited.set()
        raise SystemExit(code)  # ends the watchdog's thread

    monkeypatch.setenv("APEX_PARENT_PID", str(parent.pid))
    monkeypatch.setattr(port_app.os, "_exit", fake_exit)
    port_app._start_parent_watchdog()
    try:
        assert not exited.wait(0.1)  # the parent still lives
        parent.wait(10)  # reaped, so signal 0 to its pid fails
        assert exited.wait(10), "the watchdog did not fire"
    finally:
        parent.kill()


# -- test_server_processing.py --------------------------------------------------------------------------


@pytest.fixture()
def sample_image(tmp_path):
    p = tmp_path / "input.png"
    arr = np.zeros((64, 64, 3), np.uint8)
    arr[20:44, 20:44] = 255
    Image.fromarray(arr).save(p)
    return p


@pytest.fixture()
def sample_video(tmp_path):
    from apex_studio_tpu_torch.utils.media import save_video

    frames = []
    for i in range(4):
        f = np.zeros((64, 64, 3), np.uint8)
        f[20:40, 10 + i * 5:30 + i * 5] = 255
        frames.append(f)
    return save_video(frames, tmp_path / "input.mp4", fps=8)


class TestPreprocessorRoutes:
    def test_list_is_empty(self, port_server):
        """The list holds the ported preprocessors (and manifest ids that
        resolve to them) and nothing else (it was empty before any was
        ported): manifests without an implementation stay hidden, as the JAX
        route hides them."""
        from apex_studio_tpu_torch.preprocess import preprocessor_registry

        status, out = port_server.call("GET", "/preprocessor/list")
        names = [e["name"] for e in out]
        assert status == 200 and names[:len(preprocessor_registry.names())] == preprocessor_registry.names()
        assert all(name in preprocessor_registry for name in names)
        assert {"canny", "tile_simple", "depth_anything_v2", "openpose"} <= {e["name"] for e in out}
        # the line, edge, normal and LeReS depth preprocessors, ``pidi`` by
        # its manifest (an alias of pidinet)
        assert {"hed", "scribble_hed", "pidi", "pidinet", "teed", "lineart_realistic", "lineart_anime",
                "scribble_anime", "manga_line", "mlsd", "normalbae", "dsine", "leres"} <= {e["name"] for e in out}

    def test_run_ends_with_the_registry_key_error(self, port_server, sample_image):
        status, out = port_server.call("POST", "/preprocessor/run", json={
            "preprocessor_name": "dwpose", "input_path": str(sample_image)})
        assert status == 200, out
        st = port_server.wait(out["job_id"])
        assert st["status"] == "error"
        assert st["error"].startswith("KeyError: \"preprocessor: no entry named 'dwpose'")

    def test_missing_params_rejected(self, port_server):
        assert port_server.call("POST", "/preprocessor/run", json={"input_path": "/x.png"})[0] == 400


class TestPostprocessorRoutes:
    def test_frame_interpolate(self, port_server, sample_video):
        status, out = port_server.call("POST", "/postprocessor/frame-interpolate", json={
            "input_path": str(sample_video), "multiplier": 2, "fps": 8})
        assert status == 200, out
        st = port_server.wait(out["job_id"])
        assert st["status"] == "complete", st
        assert st["result_path"].endswith("interpolated.mp4")
        from apex_studio_tpu_torch.preprocess.base import load_frames

        assert len(load_frames(st["result_path"])) == 7


class TestComponentRoutes:
    def test_delete_refuses_escape(self, port_server):
        assert port_server.call("DELETE", "/components/delete", json={"path": "../../etc/passwd"})[0] == 400

    def test_delete_missing_404(self, port_server):
        assert port_server.call("DELETE", "/components/delete", json={"path": "nope/x.bin"})[0] == 404


def test_step_trace_endpoint(port_server, monkeypatch):
    from apex_studio_tpu_torch.utils import profiling

    monkeypatch.setenv("APEX_STEP_TRACE", "1")
    profiling.clear()
    with profiling.step_trace("unit-test-stage"):
        pass
    body = port_server.call("GET", "/system/step-trace")[1]
    assert body["enabled"] is True
    assert [r["name"] for r in body["records"]] == ["unit-test-stage"]
    port_server.call("GET", "/system/step-trace?clear=1")
    assert port_server.call("GET", "/system/step-trace")[1]["records"] == []


def test_engine_run_is_step_traced(port_server, monkeypatch):
    from apex_studio_tpu_torch.utils import profiling

    monkeypatch.setenv("APEX_STEP_TRACE", "1")
    profiling.clear()
    job_id = run_job(port_server, dict(JOB, num_inference_steps=1))
    assert port_server.wait(job_id)["status"] == "complete"
    acquire, run = port_server.call("GET", "/system/step-trace")[1]["records"]
    assert (acquire["name"], run["name"]) == ("engine.acquire", "engine.run")
    assert acquire["job_id"] == run["job_id"] == job_id and run["wall_s"] > 0
    assert run["devices"] == []  # no card here


# -- test_download_routes.py ---------------------------------------------------------------------------


class TestDownloadResolve:
    def test_resolve_unknown_source(self, port_server):
        status, out = port_server.call("POST", "/download/resolve", json={
            "item_type": "component", "source": "org/repo/model.safetensors"})
        assert status == 200
        assert out["bucket"] == "component" and out["job_id"]
        assert (out["downloaded"], out["exists"], out["running"]) == (False, False, False)

    def test_resolve_detects_downloaded_component(self, port_server):
        comp = get_components_path() / "org" / "repo"
        comp.mkdir(parents=True, exist_ok=True)
        (comp / "weights.safetensors").write_bytes(b"x" * 8)
        out = port_server.call("POST", "/download/resolve", json={
            "item_type": "component", "source": "org/repo/weights.safetensors"})[1]
        assert out["downloaded"] is True and out["save_dir"] == str(get_components_path())

    def test_resolve_invalid_item_type(self, port_server):
        assert port_server.call("POST", "/download/resolve",
                                json={"item_type": "weights", "source": "x"})[0] == 400

    def test_resolve_batch(self, port_server):
        comp = get_components_path() / "batch"
        comp.mkdir(parents=True, exist_ok=True)
        (comp / "a.bin").write_bytes(b"a")
        results = port_server.call("POST", "/download/resolve/batch", json={
            "item_type": "component", "sources": ["batch/a.bin", "batch/missing.bin"]})[1]["results"]
        assert [r["downloaded"] for r in results] == [True, False]
        assert results[0]["source"] == "batch/a.bin"

    def test_resolve_reuses_job_id_from_post_download(self, port_server):
        comp = get_components_path() / "org2"
        comp.mkdir(parents=True, exist_ok=True)
        (comp / "cached.bin").write_bytes(b"c")  # the job fetches nothing: already present
        body = {"item_type": "component", "source": "org2/cached.bin"}
        status, out = port_server.call("POST", "/download", json=body)
        assert status == 200
        again = port_server.call("POST", "/download/resolve", json=body)[1]
        assert again["job_id"] == out["job_id"] and again["exists"] is True
        assert port_server.wait(out["job_id"])["status"] == "complete"

    def test_status_route(self, port_server):
        assert port_server.call("GET", "/download/status/not-a-job")[1]["status"] == "not_found"

    def test_cancel_route_404_for_unknown(self, port_server):
        assert port_server.call("POST", "/download/cancel/nope")[0] == 404


class TestDownloadDelete:
    def test_delete_file_and_prune_parents(self, port_server):
        target = get_components_path() / "del" / "nested" / "file.bin"
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(b"zz")
        status, out = port_server.call("DELETE", "/download/delete", json={
            "item_type": "component", "path": "del/nested/file.bin", "source": "del/nested/file.bin"})
        assert status == 200 and out["status"] == "deleted"
        assert not target.exists() and not target.parent.exists() and get_components_path().exists()

    def test_delete_directory(self, port_server):
        d = get_lora_path() / "somepack"
        d.mkdir(parents=True, exist_ok=True)
        (d / "w.safetensors").write_bytes(b"y")
        assert port_server.call("DELETE", "/download/delete", json={"item_type": "lora", "path": "somepack"})[0] == 200
        assert not d.exists()

    def test_delete_refuses_escape(self, port_server, tmp_path):
        outside = tmp_path / "victim.txt"
        outside.write_text("keep me")
        assert port_server.call("DELETE", "/download/delete", json={
            "item_type": "component", "path": str(outside)})[0] == 400
        assert outside.exists()

    def test_delete_refuses_root(self, port_server):
        assert port_server.call("DELETE", "/download/delete", json={"item_type": "component", "path": "."})[0] == 400

    def test_delete_404_missing(self, port_server):
        assert port_server.call("DELETE", "/download/delete", json={
            "item_type": "component", "path": "no/such/thing.bin"})[0] == 404


# -- test_stability_and_cache.py (stability) -----------------------------------------------------------


class TestTokenBucket:
    def test_burst_then_limit(self):
        from apex_studio_tpu_torch.server.stability import TokenBucket

        b = TokenBucket(rate=0.0, burst=3)
        assert [b.allow() for _ in range(4)] == [True, True, True, False]

    def test_refill(self):
        from apex_studio_tpu_torch.server.stability import TokenBucket

        b = TokenBucket(rate=1000.0, burst=1)
        assert b.allow() and not b.allow()
        time.sleep(0.01)
        assert b.allow()


class TestStabilityMiddleware:
    def test_rate_limit_429(self):
        from apex_studio_tpu_torch.server.stability import install_stability_middleware

        app = web.Application()

        async def ok(_):
            return web.json_response({"ok": True})

        app.router.add_get("/x", ok)
        install_stability_middleware(app, rate=0.0, burst=2)
        served = Served(app)
        try:
            codes = [served.call("GET", "/x")[0] for _ in range(4)]
        finally:
            served.close()
        assert codes == [200, 200, 429, 429]


# -- test_step_mem.py ----------------------------------------------------------------------------------


class TestStepMem:
    def test_snapshot_contents_and_print(self):
        import io

        from apex_studio_tpu_torch.utils.step_mem import step_mem

        keep = torch.ones(64, 128)  # noqa: F841 live tensor
        buf = io.StringIO()
        snap = step_mem("unit test", top=100000, file=buf, pause=False)
        text = buf.getvalue()
        assert "[step_mem] unit test" in text and "host rss=" in text
        assert snap["host"]["rss"] is None or snap["host"]["rss"] > 0
        assert snap["devices"] == []  # no card here
        assert "(64, 128)" in {r["shape"] for r in snap["arrays"]}

    def test_grouping_collapses_identical_tensors(self):
        from apex_studio_tpu_torch.utils.step_mem import collect_live_tensors

        keep = [torch.zeros(32, 32) + i for i in range(4)]  # noqa: F841
        row = next(r for r in collect_live_tensors(top=100000) if r["shape"] == "(32, 32)")
        assert row["count"] >= 4 and row["nbytes"] >= 4 * 32 * 32 * 4 and row["dtype"] == "float32"


# -- held against the JAX package --------------------------------------------------------------------------


def route_table(app) -> set:
    return {(r.method, r.resource.canonical) for r in app.router.routes()}


def jax_app(resolver_paths):
    from apex_studio_tpu.manifest.resolver import ManifestResolver as JaxResolver
    from apex_studio_tpu.server.app import create_app as jax_create_app

    return jax_create_app(resolver=JaxResolver(search_paths=resolver_paths))


@pytest.fixture()
def jax_side(monkeypatch):
    """The JAX package's module state that the comparisons touch: its SAM2
    lookup answers "none configured" (nothing is fetched), its preprocessor
    registry holds the names the port registers, its WS cache, warm pool and
    download-request map are reset."""
    from apex_studio_tpu.mask import predictor as jax_predictor
    from apex_studio_tpu.preprocess.base import preprocessor_registry as jax_preprocessors
    from apex_studio_tpu.server import processing_routes as jax_processing
    from apex_studio_tpu.server.warm_pool import warm_pool as jax_pool
    from apex_studio_tpu.server.ws import ws_manager as jax_ws

    monkeypatch.setattr(jax_predictor, "get_sam2_predictor", lambda: None)
    from apex_studio_tpu_torch.preprocess import preprocessor_registry as port_preprocessors

    monkeypatch.setattr(jax_preprocessors, "_entries",
                        {k: v for k, v in jax_preprocessors._entries.items() if k in port_preprocessors})

    def reset():
        jax_ws._latest.clear()
        jax_ws._queues.clear()
        jax_pool.discard()
        jax_processing._request_key_to_job_id.clear()

    reset()
    yield jax_ws
    reset()


def test_route_table_equals_the_jax_app(port_home, port_manifests, jax_side):
    port = port_app.create_app(resolver=ManifestResolver(search_paths=[port_manifests]), device="cpu")
    ref = jax_app([port_manifests])
    for app in (port, ref):
        app["executor"].shutdown()
    assert route_table(port) == route_table(ref)
    assert len(route_table(port)) > 60


def test_resolver_ids_equal_the_jax_resolver():
    from apex_studio_tpu.manifest.resolver import ManifestResolver as JaxResolver

    roots = [REPO / "manifests"]
    port, ref = ManifestResolver(search_paths=roots), JaxResolver(search_paths=roots)
    rows = lambda r: [i.summary() for i in r.list()]  # noqa: E731
    assert rows(port) == rows(ref) and len(rows(port)) > 50
    for info in ref.list():
        for key in (info.manifest_id, info.slug, f"{info.engine}/{info.model_type}/{info.slug}:latest"):
            assert port.resolve(key) == ref.resolve(key), key
    assert port.resolve("zimage-turbo") == str((REPO / "manifests" / "image" / "zimage-turbo.yml").resolve())


UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")


def scripted_sequence(served: Served, media: Path) -> list:
    """Non-engine requests in a fixed order: (method, path, status, body)."""
    image = media / "mask_input.png"
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 30, (96, 160, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:96, :160]
    arr[(yy - 48) ** 2 + (xx - 60) ** 2 <= 20 ** 2] = [200, 80, 80]
    Image.fromarray(arr).save(image)
    outside = media / "outside.bin"
    outside.write_bytes(b"abc")
    comp = get_components_path() / "org2"
    comp.mkdir(parents=True, exist_ok=True)
    (comp / "cached.bin").write_bytes(b"c")
    steps = [
        ("GET", "/health", {}), ("GET", "/ready", {}),
        ("GET", "/manifest/list", {}), ("GET", "/manifest/zimage-tiny-test", {}),
        ("GET", "/manifest/nope", {}), ("GET", "/manifest/types", {}), ("GET", "/manifest/categories", {}),
        ("GET", "/manifest/list/type/t2i", {}), ("GET", "/manifest/list/type/nope", {}),
        ("GET", "/manifest/list/model/nope", {}),
        ("POST", "/manifest/lora", {"json": {"manifest_id": "crud-test", "source": "org/repo/l.safetensors",
                                             "scale": 0.8, "name": "mylora"}}),
        ("POST", "/manifest/lora", {"json": {"manifest_id": "crud-test"}}),
        ("POST", "/manifest/lora/scale", {"json": {"manifest_id": "crud-test", "lora_index": 0, "scale": 2.5}}),
        ("POST", "/manifest/lora/scale", {"json": {"manifest_id": "crud-test", "lora_index": 9, "scale": 0.5}}),
        ("POST", "/manifest/lora/scale", {"json": {"manifest_id": "crud-test", "lora_index": 0, "scale": "x"}}),
        ("POST", "/manifest/lora/name", {"json": {"manifest_id": "crud-test", "lora_index": 1, "name": "renamed"}}),
        ("POST", "/manifest/lora/name", {"json": {"manifest_id": "crud-test", "lora_index": 1}}),
        ("DELETE", "/manifest/lora", {"json": {"manifest_id": "crud-test", "lora_index": 0}}),
        ("DELETE", "/manifest/lora", {"json": {"manifest_id": "nope", "lora_index": 0}}),
        ("GET", "/manifest/crud-test", {}),
        ("POST", "/config/hf-token", {"json": {"value": "tok123"}}), ("GET", "/config/hf-token", {}),
        ("GET", "/config/nope", {}), ("GET", "/config/path-sizes", {}),
        ("GET", "/files", {"params": {"path": "/etc/passwd"}}), ("GET", "/files", {}),
        ("GET", "/files/exists", {"params": {"path": "/etc/passwd"}}),
        ("POST", "/files/ingest", {"json": {"path": str(outside)}}),
        ("POST", "/files/ingest", {"json": {"path": str(media / "missing.bin")}}),
        ("GET", "/jobs/status/nope", {}), ("POST", "/jobs/cancel/nope", {}), ("GET", "/ray/jobs/nope", {}),
        ("POST", "/ray/jobs/cancel_all", {}), ("POST", "/engine/cancel/nope", {}),
        ("GET", "/engine/result/nope", {}),
        ("POST", "/engine/run", {"json": {"inputs": {}}}),
        ("POST", "/engine/run", {"json": {"manifest_id": "missing"}}),
        ("POST", "/engine/run", {"json": {"yaml_path": str(media / "missing.yml")}}),
        ("GET", "/preprocessor/list", {}),
        ("POST", "/preprocessor/run", {"json": {"input_path": "/x.png"}}),
        ("POST", "/preprocessor/run", {"json": {"preprocessor_name": "canny", "input_path": str(image),
                                                "job_id": "pre-1"}}),
        ("POST", "/postprocessor/frame-interpolate", {"json": {}}),
        ("POST", "/download/resolve", {"json": {"item_type": "component", "source": "org/repo/m.safetensors"}}),
        ("POST", "/download/resolve", {"json": {"item_type": "weights", "source": "x"}}),
        ("POST", "/download/resolve/batch", {"json": {"item_type": "component",
                                                      "sources": ["org2/cached.bin", "org2/missing.bin"]}}),
        ("POST", "/download", {"json": {"item_type": "component", "source": "org2/cached.bin",
                                        "job_id": "dl-1"}}),
        ("POST", "/download", {"json": {}}),
        ("GET", "/download/status/nope", {}), ("POST", "/download/cancel/nope", {}),
        ("DELETE", "/download/delete", {"json": {"item_type": "component", "path": "."}}),
        ("DELETE", "/download/delete", {"json": {"item_type": "component", "path": "no/such.bin"}}),
        ("DELETE", "/components/delete", {"json": {"path": "../../etc/passwd"}}),
        ("DELETE", "/components/delete", {"json": {"path": "nope/x.bin"}}),
        ("POST", "/mask/create", {"json": {"input_path": str(image), "points": [{"x": 60, "y": 48}]}}),
        ("POST", "/mask/create", {"json": {"input_path": str(image),
                                           "box": {"x1": 35, "y1": 22, "x2": 85, "y2": 74}, "tool": "shape"}}),
        ("POST", "/mask/create", {"json": {"input_path": str(image)}}),
        ("POST", "/mask/create", {"json": {}}),
        ("GET", "/mask/track/result/nope", {}),
        ("GET", "/system/step-trace", {}),
    ]
    out = []
    for method, path, kw in steps:
        status, body = served.call(method, path, **kw)
        out.append((method, path, status, body))
        if path == "/files/ingest" and status == 200:  # the ingested file through /files
            out.append(("GET", "/files", *served.call("GET", "/files", params={"path": body["path"]})))
    for job_id in ("pre-1", "dl-1"):
        st = served.wait(job_id)
        st["meta"].pop("traceback", None)
        out.append(("GET", f"/jobs/status/{job_id}", 200, st))
    return out


def normalise(value, home: Path, manifests: Path, media: Path):
    text = json.dumps(value, default=lambda b: b.decode(errors="replace"))
    for root, name in ((home, "<HOME>"), (manifests, "<MANIFESTS>"), (media, "<MEDIA>")):
        text = text.replace(str(root.resolve()), name).replace(str(root), name)
    text = UUID.sub("<ID>", text)
    text = re.sub(r"ingest/[0-9a-f]{8}/", "ingest/<ID>/", text)
    return json.loads(text)


def test_scripted_sequence_matches_the_jax_app(tmp_path, monkeypatch, port_home, jax_side):
    """The same requests through both apps give the same codes and bodies. The
    apps run one after the other, each with its own home, manifest copy and
    media directory."""
    from apex_studio_tpu.utils import profiling as jax_profiling
    from apex_studio_tpu_torch.utils import profiling

    jax_profiling.clear()
    profiling.clear()
    runs = {}
    for side in ("jax", "port"):
        home, manifests, media = (tmp_path / side / d for d in ("home", "manifests", "media"))
        monkeypatch.setenv("APEX_HOME_DIR", str(home))
        write_manifests(manifests)
        media.mkdir()
        save_tokenizer()
        app = (jax_app([manifests]) if side == "jax" else
               port_app.create_app(resolver=ManifestResolver(search_paths=[manifests]), device="cpu"))
        served = Served(app)
        try:
            runs[side] = normalise(scripted_sequence(served, media), home, manifests, media)
        finally:
            served.close()
    assert len(runs["port"]) == len(runs["jax"])
    for port, ref in zip(runs["port"], runs["jax"]):
        assert port == ref
    statuses = {(m, p): s for m, p, s, _ in runs["port"]}
    assert statuses[("GET", "/preprocessor/list")] == 200 and statuses[("POST", "/mask/create")] == 400
    assert runs["port"][-2][3]["status"] == "complete"
    mask = next(body for _, path, _, body in runs["port"] if path == "/mask/create")
    assert mask["status"] == "success" and len(mask["contours"][0]) >= 6


@pytest.fixture()
def served_pair(tmp_path, monkeypatch, port_home, jax_side):
    """A JAX server and a port server over one manifest directory, each with
    its own home; the JAX engine built once with seeded weights, its weights
    carried into the port's engine, each engine in its server's warm pool
    under the runner's key."""
    from apex_studio_tpu.engine.registry import UniversalEngine as JaxUniversalEngine
    from apex_studio_tpu.server.warm_pool import make_pool_key as jax_pool_key
    from apex_studio_tpu.server.warm_pool import warm_pool as jax_pool
    from apex_studio_tpu_torch.engine import UniversalEngine
    from apex_studio_tpu_torch.loaders.from_jax import load_from_jax
    from tests.torch_port_helpers import fast_jax_engine, jax_params

    manifests = write_manifests(tmp_path / "manifests")
    homes = {side: tmp_path / f"home_{side}" for side in ("jax", "port")}
    servers, engines = {}, {}
    for side in ("jax", "port"):
        monkeypatch.setenv("APEX_HOME_DIR", str(homes[side]))
        save_tokenizer()
        if side == "jax":
            resolver_path = ManifestResolver(search_paths=[manifests]).resolve("zimage-tiny-test")
            engine = fast_jax_engine(JaxUniversalEngine(resolver_path))
            jax_pool.release(jax_pool_key(resolver_path, {}), engine)
            servers[side] = Served(jax_app([manifests]))
        else:
            app = port_app.create_app(resolver=ManifestResolver(search_paths=[manifests]), device="cpu")
            engine = UniversalEngine(resolver_path, device="cpu")
            warm_pool.release(make_pool_key(resolver_path, {}), engine)
            servers[side] = Served(app)
        for ctype in ("vae", "transformer", "text_encoder"):
            engine.load_component_by_type(ctype)
        engines[side] = engine
    ref, port = engines["jax"], engines["port"]
    for name in ("vae", "transformer"):
        load_from_jax(getattr(port, name), jax_params(getattr(ref, name)))
    load_from_jax(port.text_encoder._ensure_model(), jax_params(ref.text_encoder._ensure_model()))
    yield servers, homes
    for served in servers.values():
        served.close()


def test_served_request_matches_the_jax_server(served_pair, monkeypatch, jax_side):
    """One /engine/run of the tiny engine at 9 steps (two previews) through
    each server: the PNGs within one uint8 step, the same update sequence and
    preview count, the same persisted run config."""
    servers, homes = served_pair
    sends = {}
    for side, manager in (("jax", jax_side), ("port", ws_manager)):
        log, send = [], manager.send_update

        def recording(job_id, progress, message="", metadata=None, _log=log, _send=send):
            _log.append(((metadata or {}).get("status", "processing"), message, progress))
            _send(job_id, progress, message, metadata)

        sends[side] = log
        monkeypatch.setattr(manager, "send_update", recording)
    inputs = {"prompt": "hello world", "height": 40, "width": 44, "num_inference_steps": 9, "seed": 7}
    finals, frames, configs = {}, {}, {}
    for side in ("jax", "port"):
        monkeypatch.setenv("APEX_HOME_DIR", str(homes[side]))
        served = servers[side]
        job_id = run_job(served, inputs, job_id="served-1")
        finals[side] = served.ws(job_id)[-1]
        st = served.wait(job_id)
        assert st["status"] == "complete", st
        run_dir = Path(st["result_path"]).parent
        frames[side] = np.asarray(Image.open(st["result_path"])).astype(int)
        configs[side] = json.loads((run_dir / "model_inputs.json").read_text())
        assert sorted(p.name for p in run_dir.glob("preview_*.png")) == ["preview_0000.png", "preview_0001.png"]
    assert sends["port"] == sends["jax"]
    assert [m for s, m, _ in sends["port"] if s == "preview"] == ["Preview at step 2", "Preview at step 5"]
    assert sends["port"][-1][0] == "complete" and sends["port"][0] == ("queued", "Queued", 0.0)
    stable = lambda m: (m["status"], m["progress"], m["message"], m["metadata"]["preview_url"],  # noqa: E731
                        m["metadata"]["type"])
    assert stable(finals["port"]) == stable(finals["jax"])
    assert stable(finals["port"]) == ("complete", 1.0, "Complete", "/files/engine_results/served-1/output.png",
                                      "image")
    assert frames["port"].shape == frames["jax"].shape == (40, 44, 3)
    assert np.abs(frames["port"] - frames["jax"]).max() <= 1
    assert configs["port"] == configs["jax"]
