"""apex-engine CLI of the port (port of ``apex_studio_tpu/cli.py``, the
counterpart of src/__main__.py in the reference, on click).

Commands: start | stop | dev | internal-serve | status | version; run as
``python3 -m apex_studio_tpu_torch.cli <command>``. `start` daemonizes
internal-serve and waits for /ready; `stop` posts /shutdown. The server runs
its engines on the card (an engine job raises without one).

Departures: `start` spawns ``internal-serve``, the name click gives the
command (the JAX CLI spawns ``internal_serve``, which click 7 and later do not
recognise), with the package's parent directory on ``PYTHONPATH``; the HTTP
calls use ``urllib`` instead of ``requests``. `bundle`, `publish`,
`check-updates` and `update` need ``distribution.py`` and are not ported yet.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from typing import Any, Optional

import click

from apex_studio_tpu_torch import __version__
from apex_studio_tpu_torch.utils.defaults import DEFAULT_HOST, DEFAULT_PORT, home_dir


def _pid_file() -> Path:
    return home_dir() / "apex-engine.pid"


def _base_url(host: str, port: int) -> str:
    return f"http://{host}:{port}"


def _http(url: str, method: str = "GET", timeout: float = 2.0) -> Optional[Any]:
    """The JSON body of a 2xx answer, or None when nothing answers."""
    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read() or b"null")
    except (urllib.error.URLError, OSError, ValueError):
        return None


@click.group()
def cli() -> None:
    """apex-engine: the Apex Studio inference server on an NVIDIA card."""


@cli.command()
def version() -> None:
    click.echo(__version__)


@cli.command()
@click.option("--host", default=DEFAULT_HOST)
@click.option("--port", default=DEFAULT_PORT, type=int)
def internal_serve(host: str, port: int) -> None:
    """Run the server in the foreground (what `start` spawns)."""
    from apex_studio_tpu_torch.server.app import serve

    serve(host=host, port=port)


@cli.command()
@click.option("--host", default=DEFAULT_HOST)
@click.option("--port", default=DEFAULT_PORT, type=int)
@click.option("--timeout", default=120.0, type=float, help="seconds to wait for /ready")
def start(host: str, port: int, timeout: float) -> None:
    """Start the server as a background process and wait until ready."""
    url = _base_url(host, port)
    if _http(url + "/health") is not None:
        click.echo(f"already running at {url}")
        return

    log_path = home_dir() / "apex-engine.log"
    log_path.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent.parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "apex_studio_tpu_torch.cli", "internal-serve",
             "--host", host, "--port", str(port)],
            stdout=log,
            stderr=log,
            env=env,
            start_new_session=True,
        )
    _pid_file().parent.mkdir(parents=True, exist_ok=True)
    _pid_file().write_text(str(proc.pid))

    deadline = time.time() + timeout
    while time.time() < deadline:
        body = _http(url + "/ready")
        if isinstance(body, dict) and body.get("ready"):
            click.echo(f"ready at {url} (pid {proc.pid})")
            return
        if proc.poll() is not None:
            raise click.ClickException(
                f"server exited early (code {proc.returncode}); see {log_path}"
            )
        time.sleep(0.5)
    raise click.ClickException(f"server did not become ready within {timeout}s")


@cli.command()
@click.option("--host", default=DEFAULT_HOST)
@click.option("--port", default=DEFAULT_PORT, type=int)
def stop(host: str, port: int) -> None:
    if _http(_base_url(host, port) + "/shutdown", method="POST", timeout=5) is not None:
        click.echo("shutdown requested")
        return
    pid_file = _pid_file()
    if pid_file.exists():
        pid = int(pid_file.read_text())
        try:
            os.kill(pid, signal.SIGTERM)
            click.echo(f"killed pid {pid}")
        except ProcessLookupError:
            click.echo("not running")
        pid_file.unlink(missing_ok=True)
    else:
        click.echo("not running")


@cli.command()
@click.option("--host", default=DEFAULT_HOST)
@click.option("--port", default=DEFAULT_PORT, type=int)
def status(host: str, port: int) -> None:
    body = _http(_base_url(host, port) + "/ready")
    click.echo(json.dumps(body if body is not None else {"ready": False, "running": False}))


@cli.command()
@click.option("--host", default=DEFAULT_HOST)
@click.option("--port", default=DEFAULT_PORT, type=int)
def dev(host: str, port: int) -> None:
    """Foreground serve with debug logging."""
    import logging

    logging.basicConfig(level=logging.DEBUG)
    from apex_studio_tpu_torch.server.app import serve

    serve(host=host, port=port)


if __name__ == "__main__":
    cli()
