"""The port's CLI (``apex_studio_tpu_torch/cli.py``) on the CPU: ``version``
through click's runner, and ``start`` / ``status`` / ``stop`` against a server
subprocess on an ephemeral port, its home in a temporary directory. No engine
runs: the server answers ``/ready`` and ``/system/memory`` without a card."""

import json
import os
import socket
import time
import urllib.request

import pytest
from click.testing import CliRunner

from apex_studio_tpu_torch import __version__
from apex_studio_tpu_torch.cli import cli


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def exited(pid: int) -> bool:
    """The server has exited (and, being this process's child when click's
    runner ran ``start`` here, is reaped)."""
    try:
        return os.waitpid(pid, os.WNOHANG)[0] == pid
    except ChildProcessError:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        return False


def test_version():
    out = CliRunner().invoke(cli, ["version"])
    assert out.exit_code == 0 and out.output.strip() == __version__


def test_commands_are_the_served_ones():
    assert sorted(cli.commands) == ["dev", "internal-serve", "start", "status", "stop", "version"]


@pytest.fixture()
def cli_home(tmp_path, monkeypatch):
    monkeypatch.setenv("APEX_HOME_DIR", str(tmp_path / "home"))
    monkeypatch.delenv("APEX_MANIFEST_PATHS", raising=False)
    return tmp_path / "home"


def test_start_status_stop(cli_home):
    runner, port = CliRunner(), str(free_port())
    status = lambda: json.loads(runner.invoke(cli, ["status", "--port", port]).output)  # noqa: E731
    assert status() == {"ready": False, "running": False}
    out = runner.invoke(cli, ["start", "--port", port, "--timeout", "60"])
    pid = int((cli_home / "apex-engine.pid").read_text())
    try:
        assert out.exit_code == 0, (out.output, (cli_home / "apex-engine.log").read_text())
        assert out.output.startswith(f"ready at http://127.0.0.1:{port} (pid {pid})")
        assert status() == {"ready": True}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/system/memory", timeout=10) as r:
            memory = json.loads(r.read())
        assert memory["ram"]["total"] > 0 and memory["devices"] == []
        again = runner.invoke(cli, ["start", "--port", port])
        assert again.output.strip() == f"already running at http://127.0.0.1:{port}"
        assert runner.invoke(cli, ["stop", "--port", port]).output.strip() == "shutdown requested"
        deadline = time.time() + 30
        while not exited(pid):
            assert time.time() < deadline, "the server did not exit after /shutdown"
            time.sleep(0.1)
    finally:
        if not exited(pid):
            os.kill(pid, 9)
            os.waitpid(pid, 0)
    assert status() == {"ready": False, "running": False}
    assert runner.invoke(cli, ["stop", "--port", port]).output.strip() == "not running"
    assert not (cli_home / "apex-engine.pid").exists()
