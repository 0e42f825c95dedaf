"""The port's environment diagnostics (reve_tpu_torch.doctor) on the
CPU: without CUDA it fails, honestly, on what needs the card (the
accelerator, the kernels' build, the mini pipeline on cuda:0) and passes
the probes that do not (the native core and mux, codecs, the model
registry); its hang watchdog exits 2 as reve_tpu's does
(tests/test_doctor.py).  The card's smoke runs it where every required
probe passes."""

import json
import os
import subprocess
import sys

import torch

from reve_tpu_torch import doctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_PROBES = ("native core", "native mp4/mkv mux", "codecs",
              "model registry")


def test_doctor_without_cuda_fails_the_accelerator(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = doctor.main(["--json"])
    out = capsys.readouterr().out
    data = json.loads(out.strip().splitlines()[-1])
    assert rc == 1 and data["ok"] is False
    status = {p["probe"]: p["status"] for p in data["probes"]}
    assert list(status) == ["accelerator", "kernel build", "native core",
                            "native mp4/mkv mux", "codecs",
                            "model registry", "mini pipeline e2e"]
    assert status["accelerator"] == status["kernel build"] == \
        status["mini pipeline e2e"] == "fail"
    assert all(status[p] == "ok" for p in CPU_PROBES), status
    required = {p["probe"]: p["required"] for p in data["probes"]}
    assert not required["codecs"] and not required["model registry"]
    assert " [x] accelerator: RuntimeError: no CUDA device" in out


def test_mini_pipeline_probe_runs_the_cli_job(monkeypatch):
    """The mini pipeline's job (reve_tpu's 4-frame x2 y4m job through the
    CLI) passes where the CLI runs: here on the CPU."""
    from reve_tpu_torch import cli

    argv = []
    real = cli.run

    def on_cpu(a):
        argv.extend(a)
        return real(a, device="cpu")

    monkeypatch.setattr(cli, "run", on_cpu)
    assert "4-frame x2" in doctor._mini_pipeline()
    assert argv[argv.index("-s") + 1] == "2" and "--allow-random-init" in argv


def test_doctor_watchdog_reports_wedged_stack():
    """A wedged accelerator stack (device init blocking forever in native
    code) produces an honest diagnostic and JSON line and exits 2."""
    code = """
import time
from reve_tpu_torch import doctor
doctor._cuda_devices = lambda: time.sleep(3600)
raise SystemExit(doctor.main(["--json", "--timeout", "2"]))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60, cwd=REPO)
    assert r.returncode == 2, (r.stdout, r.stderr)
    assert "accelerator stack wedged" in r.stdout
    data = json.loads(r.stdout.strip().splitlines()[-1])
    assert data["ok"] is False
    assert data["probes"][-1]["probe"] == "watchdog"


def test_module_entry_point_exits_1_without_cuda():
    r = subprocess.run([sys.executable, "-m", "reve_tpu_torch.doctor",
                        "--json", "--timeout", "120"], capture_output=True,
                       text=True, timeout=180, cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is False
    assert "FAILURES above" in r.stderr
    r = subprocess.run([sys.executable, "-m", "reve_tpu_torch.doctor",
                        "--timeout"], capture_output=True, text=True,
                       timeout=60, cwd=REPO)
    assert r.returncode == 1 and "--timeout needs" in r.stderr
