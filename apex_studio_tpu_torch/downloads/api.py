"""Download orchestration (port of ``apex_studio_tpu/downloads/api.py``,
counterpart of mixins/download_mixin.py, 2.8k LoC).

Source classification → fetch → validation, with the native multi-connection
downloader as the fast path (the reference's Rust extension role) and a
threaded-requests fallback. HF repo paths resolve through huggingface_hub URL
construction so manifests' ``org/repo/path`` components download directly.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Callable, Dict, Optional

logger = logging.getLogger("apex.downloads")

ProgressCb = Optional[Callable[[int, int], None]]

_HF_BASE = "https://huggingface.co"


def hf_url(repo_and_path: str, revision: str = "main") -> str:
    """'org/repo/sub/file.safetensors' → resolve URL (first two parts = repo)."""
    parts = repo_and_path.split("/")
    if len(parts) < 3:
        raise ValueError(f"not a repo file path: {repo_and_path}")
    repo = "/".join(parts[:2])
    path = "/".join(parts[2:])
    return f"{_HF_BASE}/{repo}/resolve/{revision}/{path}"


def _auth_headers() -> str:
    from apex_studio_tpu_torch.utils.config_store import get_config_value

    token = os.environ.get("HF_TOKEN") or get_config_value("hf_token")
    return f"Authorization: Bearer {token}" if token else ""


def _fallback_download(url: str, dest: Path, headers: str, progress_cb: ProgressCb,
                       chunk: int = 1 << 20) -> None:
    import requests

    hdrs: Dict[str, str] = {}
    if headers:
        for line in headers.splitlines():
            if ":" in line:
                k, v = line.split(":", 1)
                hdrs[k.strip()] = v.strip()
    with requests.get(url, headers=hdrs, stream=True, timeout=60, allow_redirects=True) as r:
        r.raise_for_status()
        total = int(r.headers.get("Content-Length", -1))
        done = 0
        tmp = dest.with_suffix(dest.suffix + ".part")
        with open(tmp, "wb") as f:
            for block in r.iter_content(chunk):
                f.write(block)
                done += len(block)
                if progress_cb:
                    progress_cb(done, total)
        os.replace(tmp, dest)


def validate_file(path: Path) -> None:
    """Reject HTML error pages masquerading as weights (download_mixin.py:1200)
    and check the safetensors magic for .safetensors files (:1226)."""
    head = path.open("rb").read(512)
    lowered = head[:256].lstrip().lower()
    if lowered.startswith((b"<!doctype", b"<html")):
        raise ValueError(f"{path}: got an HTML page instead of a weights file")
    if path.suffix == ".safetensors":
        import struct

        if len(head) < 9:
            raise ValueError(f"{path}: truncated safetensors")
        n = struct.unpack("<Q", head[:8])[0]
        if n == 0 or n > 200 * 1024 * 1024 or head[8:9] != b"{":
            raise ValueError(f"{path}: invalid safetensors header")
    if path.suffix == ".gguf" and head[:4] != b"GGUF":
        raise ValueError(f"{path}: invalid GGUF magic")


def resolve_source_url(source: str) -> str:
    """Normalize every supported source scheme to a fetchable https URL
    (reference download_mixin.py: GCS :525, S3 :699, Azure :809, GDrive
    :1583, plus Civitai via resolve_civitai_url).

    - ``gs://bucket/key``       → GCS public JSON-API media URL
    - ``s3://bucket/key``       → virtual-hosted S3 URL (region from
                                   APEX_S3_REGION / AWS_REGION when set)
    - ``az://account/ctr/key``  → Azure Blob URL (SAS from APEX_AZURE_SAS)
    - Google Drive share links  → uc?export=download&id=… direct form
    - Civitai URNs/pages        → API download URL
    - ``org/repo/path``         → HF resolve URL
    - http(s)                   → passthrough
    """
    import re

    s = source.strip()
    if s.startswith("gs://"):
        bucket, _, key = s[len("gs://"):].partition("/")
        from urllib.parse import quote

        return (f"https://storage.googleapis.com/storage/v1/b/{bucket}/o/"
                f"{quote(key, safe='')}?alt=media")
    if s.startswith("s3://"):
        bucket, _, key = s[len("s3://"):].partition("/")
        region = os.environ.get("APEX_S3_REGION") or os.environ.get("AWS_REGION")
        host = (f"{bucket}.s3.{region}.amazonaws.com" if region
                else f"{bucket}.s3.amazonaws.com")
        return f"https://{host}/{key}"
    if s.startswith("az://"):
        account, _, rest = s[len("az://"):].partition("/")
        sas = os.environ.get("APEX_AZURE_SAS", "")
        sep = ("?" + sas.lstrip("?")) if sas else ""
        return f"https://{account}.blob.core.windows.net/{rest}{sep}"
    m = re.search(r"drive\.google\.com/(?:file/d/([\w-]+)|open\?id=([\w-]+)"
                  r"|uc\?(?:export=download&)?id=([\w-]+))", s)
    if m:
        file_id = next(g for g in m.groups() if g)
        return f"https://drive.google.com/uc?export=download&id={file_id}&confirm=t"
    if s.startswith("urn:air:") or "civitai.com" in s:
        return resolve_civitai_url(s)
    if s.startswith(("http://", "https://")):
        return s
    return hf_url(s)


def download_file(
    url_or_repo_path: str,
    dest: Path,
    connections: int = 4,
    progress_cb: ProgressCb = None,
    validate: bool = True,
) -> Path:
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    url = resolve_source_url(url_or_repo_path)
    headers = _auth_headers()
    from apex_studio_tpu_torch.downloads import native

    use_native = native.native_available() and os.environ.get(
        "APEX_DISABLE_NATIVE_DOWNLOAD", "0"
    ) not in ("1", "true")
    if use_native:
        try:
            native.download(url, dest, connections=connections, headers=headers,
                            progress_cb=progress_cb)
        except RuntimeError as e:
            logger.warning("native download failed (%s); falling back", e)
            _fallback_download(url, dest, headers, progress_cb)
    else:
        _fallback_download(url, dest, headers, progress_cb)
    if validate:
        validate_file(dest)
    return dest


def is_downloaded(repo_path: str, root: Optional[Path] = None) -> bool:
    from apex_studio_tpu_torch.utils.defaults import get_components_path

    root = root or get_components_path()
    return (root / repo_path).exists()


def download_component(
    repo_path: str,
    root: Optional[Path] = None,
    connections: int = 4,
    progress_cb: ProgressCb = None,
) -> Path:
    """Fetch a manifest component file into the components tree."""
    from apex_studio_tpu_torch.utils.defaults import get_components_path

    root = root or get_components_path()
    dest = root / repo_path
    if dest.exists():
        return dest
    return download_file(repo_path, dest, connections=connections, progress_cb=progress_cb)


def download_lora(source: str, root: Path, progress_cb: ProgressCb = None) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    if source.startswith("urn:air:") or "civitai.com" in source:
        source = resolve_civitai_url(source)
    name = source.rstrip("/").split("/")[-1].split("?")[0] or "lora.safetensors"
    if not name.endswith(".safetensors"):
        name += ".safetensors"
    dest = root / name
    if dest.exists():
        return dest
    return download_file(source, dest, progress_cb=progress_cb)


def resolve_civitai_url(source: str) -> str:
    """Civitai AIR URNs and model-page URLs → direct download URLs
    (reference lora/manager.py:156 resolves these before fetching).

    Forms handled:
      urn:air:<ecosystem>:<type>:civitai:<modelId>@<versionId>
      https://civitai.com/models/<id>?modelVersionId=<vid>
      https://civitai.com/api/download/models/<vid> (passthrough)
    A Civitai API token from APEX_CIVITAI_TOKEN (or the config store key
    ``civitai_token``) rides along as a query parameter.
    """
    import re

    url = source
    m = re.match(r"^urn:air:[^:]+:[^:]+:civitai:(\d+)@(\d+)$", source.strip())
    if m:
        url = f"https://civitai.com/api/download/models/{m.group(2)}"
    elif "civitai.com/models/" in source:
        vm = re.search(r"[?&]modelVersionId=(\d+)", source)
        if vm:
            url = f"https://civitai.com/api/download/models/{vm.group(1)}"
        else:
            raise ValueError(
                "civitai model-page URL without modelVersionId — pick a version"
            )
    token = os.environ.get("APEX_CIVITAI_TOKEN")
    if not token:
        try:
            from apex_studio_tpu_torch.utils.config_store import get_config_value

            token = get_config_value("civitai_token")
        except Exception:  # noqa: BLE001
            token = None
    if token and "civitai.com" in url:
        sep = "&" if "?" in url else "?"
        url = f"{url}{sep}token={token}"
    return url
