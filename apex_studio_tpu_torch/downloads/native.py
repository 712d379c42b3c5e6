"""ctypes binding + lazy build of the native downloader (port of
``apex_studio_tpu/downloads/native.py``; ``native/apex_download.cpp`` is a
copy of the JAX package's source).

The .so is compiled on first use (g++ is part of the image; no binary is
committed) and cached under the APEX home dir. Falls back cleanly when the
toolchain or libcurl is unavailable — callers check ``native_available()``.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

logger = logging.getLogger("apex.downloads.native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_SRC = Path(__file__).parent / "native" / "apex_download.cpp"


def _so_path() -> Path:
    from apex_studio_tpu_torch.utils.defaults import get_cache_path

    return get_cache_path() / "native" / "libapexdl.so"


def _build() -> Optional[Path]:
    so = _so_path()
    if so.exists() and so.stat().st_mtime >= _SRC.stat().st_mtime:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-o", str(so), str(_SRC), "-ldl", "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return so
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, FileNotFoundError) as e:
        stderr = getattr(e, "stderr", b"")
        logger.warning("native downloader build failed: %s %s", e, stderr[:400])
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _build()
        if so is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        lib.apex_probe.restype = ctypes.c_int64
        lib.apex_probe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.apex_download.restype = ctypes.c_int
        lib.apex_download.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def probe(url: str, headers: str = "") -> int:
    lib = _load()
    if lib is None:
        return -2
    accepts = ctypes.c_int(0)
    return int(lib.apex_probe(url.encode(), headers.encode(), ctypes.byref(accepts)))


def download(
    url: str,
    dest: Path,
    connections: int = 4,
    headers: str = "",
    progress_cb: Optional[Callable[[int, int], None]] = None,
    poll_interval: float = 0.25,
) -> None:
    """Multi-connection ranged download; raises RuntimeError on failure."""
    import time

    lib = _load()
    if lib is None:
        raise RuntimeError("native downloader unavailable")

    progress = (ctypes.c_int64 * 2)(0, -1)
    err = ctypes.create_string_buffer(512)
    result = {"status": None}

    def run():
        result["status"] = lib.apex_download(
            url.encode(), str(dest).encode(), connections, headers.encode(),
            progress, err, len(err),
        )

    t = threading.Thread(target=run, daemon=True)
    t.start()
    while t.is_alive():
        if progress_cb:
            progress_cb(int(progress[0]), int(progress[1]))
        time.sleep(poll_interval)
    t.join()
    if progress_cb:
        progress_cb(int(progress[0]), int(progress[1]))
    if result["status"] != 0:
        raise RuntimeError(
            f"native download failed ({result['status']}): {err.value.decode(errors='replace')}"
        )
