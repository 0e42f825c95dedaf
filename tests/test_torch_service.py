"""The port's web service (reve_tpu_torch.service) against reve_tpu's, on
the CPU, in tests/test_service.py's scenarios.

  * config, logger and the suffix rule: the reference's values and files
    (the port's own config directory);
  * every route of reve_tpu/service/server.py on both servers, each with
    the same fake engine: the same status codes and JSON (keys, and the
    values that do not name a package's paths);
  * the Host, Origin and bearer-token checks and the --browse-root jail:
    the same status codes;
  * a job through POST /api/jobs on the port's CPU engine whose output
    bytes equal the port's CLI job on the same input and settings;
  * jobs on fake engines: progress, cancel (queued and running), a
    resubmit resuming from committed parts with the saved dtype,
    int8_calib, tta and io_backend, the engine-factory arity rules, the
    progressive parts and the output download;
  * the refusals: a model or scale mismatch, a workspace without the
    port's backend stamp, a workspace started with --weights, a second
    owner of the workspace.
"""

import fractions
import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from reve_tpu.service import config as jconfig
from reve_tpu.service import jobs as jjobs
from reve_tpu.service import server as jserver
from reve_tpu_torch import cli
from reve_tpu_torch.io import reader, writer
from reve_tpu_torch.models import registry
from reve_tpu_torch.pipeline import state as state_mod
from reve_tpu_torch.pipeline.planner import plan_segments
from reve_tpu_torch.service import config as config_mod
from reve_tpu_torch.service import server as server_mod
from reve_tpu_torch.service.jobs import JobManager, replace_file_suffix
from reve_tpu_torch.service.logger import ServiceLogger
from reve_tpu_torch.version import __version__

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def config_home(tmp_path, monkeypatch):
    """Both packages' config files and logs under this test's directory."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    monkeypatch.setenv("REVE_TPU_MODELS_DIR", os.path.join(REPO, "models"))
    return tmp_path / "xdg"


# -- config, logger, suffix --------------------------------------------------

@pytest.mark.parametrize("path,factor,ext,want", [
    ("/a/b/video.mkv", 2, "mp4", "/a/b/video_upscaled-2x.mp4"),
    ("/a/my video.mp4", 4, "mkv", "/a/my video_upscaled-4x.mkv"),
    ("/a/video", 3, "mp4", "/a/video_upscaled-3x.mp4"),
])
def test_suffix_rule(path, factor, ext, want):
    assert replace_file_suffix(path, factor, ext) == want == \
        jjobs.replace_file_suffix(path, factor, ext)


def test_config_roundtrip_and_keys(tmp_path):
    path = str(tmp_path / "cfg.json")
    cfg = config_mod.ServiceConfig(application_logs=True, default_scale=3)
    config_mod.save(cfg, path)
    assert config_mod.load(path) == cfg
    jcfg = jconfig.ServiceConfig(application_logs=True, default_scale=3)
    assert json.load(open(path)) == jcfg.to_json()
    assert jconfig.load(path).to_json() == cfg.to_json()


@pytest.mark.parametrize("content", ["{broken json",
                                     '{"default-upscale-type": "nope"}',
                                     '{"crf": "high"}', '{"default-scale": 7}'])
def test_config_regenerates_on_invalid(content, tmp_path):
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        f.write(content)
    assert config_mod.load(path) == config_mod.ServiceConfig()
    with open(path) as f:
        assert json.load(f) == config_mod.ServiceConfig().to_json()


def test_save_invalid_raises(tmp_path):
    with pytest.raises(ValueError):
        config_mod.save(config_mod.ServiceConfig(default_scale=7),
                        str(tmp_path / "x.json"))


def test_config_path_is_the_ports_own(config_home):
    assert config_mod.config_path() == os.path.join(
        str(config_home), "reve-tpu-torch", "reve-tpu-config.json")
    assert config_mod.config_path() != jconfig.config_path()
    assert os.path.basename(config_mod.config_path()) == \
        os.path.basename(jconfig.config_path())


def test_valid_models_are_the_references_and_the_registry_serves_them():
    assert config_mod.VALID_MODELS == jconfig.VALID_MODELS
    names = {name for name, _ in registry.list_models()}
    for m in config_mod.VALID_MODELS:
        registry.parse_model_name(m)
        assert m in names


def test_logger_gated(tmp_path):
    log_path = str(tmp_path / "log.txt")
    off = ServiceLogger(config_mod.ServiceConfig(application_logs=False),
                        path=log_path)
    assert off.write("hidden") is False and not os.path.exists(log_path)
    on = ServiceLogger(config_mod.ServiceConfig(application_logs=True),
                       path=log_path)
    assert on.write("hello") is True
    content = open(log_path).read()
    assert "hello" in content and "#####" in content
    assert on.tail(2).splitlines()[-1] == "hello"
    assert ServiceLogger(config_mod.ServiceConfig()).path.startswith(
        config_mod.config_dir())


# -- both servers ------------------------------------------------------------

class FakeEngine:
    batch_size = 3
    scale = 2

    def submit(self, frames):
        out = np.repeat(np.repeat(frames, 2, axis=1), 2, axis=2)

        class _P:
            def result(self):
                return out

        return _P()


def _serve(mod, manager_cls, cfg, **kw):
    mkw = {"device": "cpu"} if manager_cls is JobManager else {}
    manager = manager_cls(cfg, engine_factory=lambda m, s: FakeEngine(),
                          io_backend="y4m", **mkw)
    srv = mod.make_server("127.0.0.1", 0, cfg=cfg, manager=manager, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, manager, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture
def servers(tmp_path):
    """{"ref": url, "port": url}: reve_tpu's server and the port's, each
    on a fake engine, token "sekrit" where `tokened` and a jail at
    tmp_path / "jail"."""
    made = []

    def start(tokened=False):
        urls = {}
        for side, mod, mcls, ccls in (
                ("ref", jserver, jjobs.JobManager, jconfig.ServiceConfig),
                ("port", server_mod, JobManager, config_mod.ServiceConfig)):
            kw = dict(token="sekrit", browse_root=str(tmp_path / "jail")) \
                if tokened else {}
            srv, manager, url = _serve(mod, mcls, ccls(segment_size=5), **kw)
            made.append((srv, manager))
            urls[side] = url
        return urls

    yield start
    for srv, manager in made:
        srv.shutdown()
        srv.server_close()
        manager.shutdown()


def _req(url, method="GET", headers=None, data=None):
    """(status, parsed JSON or text, content type)."""
    req = urllib.request.Request(url, method=method, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, body, ctype = r.status, r.read(), r.headers.get(
                "Content-Type")
    except urllib.error.HTTPError as e:
        code, body, ctype = e.code, e.read(), e.headers.get("Content-Type")
    if ctype == "application/json":
        return code, json.loads(body or b"{}"), ctype
    return code, body.decode("utf-8", "replace"), ctype


def _page(html):
    """The single-page UI but its About card, which names the package."""
    at = html.index("<section id=about")
    return html[:at] + html[html.index("</section>", at):]


def _keys(v):
    """The shape of a JSON value: dict keys (recursively), list items."""
    if isinstance(v, dict):
        return {k: _keys(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_keys(x) for x in v]
    return type(v).__name__


#: (method, path, body, compare): "equal" compares the JSON, "keys" its
#: shape only (a value names the package's own paths), "text" a page
ROUTES = {
    "index": ("GET", "/", None, "text"),
    "index_html": ("GET", "/index.html", None, "text"),
    "version": ("GET", "/api/version", None, "equal"),
    "config": ("GET", "/api/config", None, "equal"),
    "models": ("GET", "/api/models", None, "equal"),
    "jobs": ("GET", "/api/jobs", None, "equal"),
    "job_missing": ("GET", "/api/jobs/999", None, "equal"),
    "job_bad_id": ("GET", "/api/jobs/abc", None, "equal"),
    "job_parts_missing": ("GET", "/api/jobs/999/parts", None, "equal"),
    "job_output_missing": ("GET", "/api/jobs/999/output", None, "equal"),
    "log": ("GET", "/api/log?lines=5", None, "keys"),
    "metrics": ("GET", "/api/metrics", None, "text"),
    "metrics_alias": ("GET", "/metrics", None, "text"),
    "browse": ("GET", "/api/browse?dir={tmp}/clips", None, "equal"),
    "browse_missing": ("GET", "/api/browse?dir={tmp}/nope", None, "equal"),
    "not_found": ("GET", "/nope", None, "equal"),
    "suffix": ("POST", "/api/suffix", {"path": "/x/v.mp4", "factor": 3},
               "equal"),
    "config_invalid": ("POST", "/api/config", {"default-scale": 7},
                       "equal"),
    "config_partial": ("POST", "/api/config", {"crf": 20}, "equal"),
    "log_write": ("POST", "/api/log", {"message": "hi"}, "equal"),
    "job_no_input": ("POST", "/api/jobs", {"input": "/nope.mp4"}, "equal"),
    "job_bad_json": ("POST", "/api/jobs", b"{not json", "equal"),
    "job_bad_dtype": ("POST", "/api/jobs", {"input": "{tmp}/clips/a.y4m",
                                            "dtype": "float16"}, "equal"),
    "job_bad_calib": ("POST", "/api/jobs", {"input": "{tmp}/clips/a.y4m",
                                            "int8_calib": "q9"}, "equal"),
    "job_bad_tta": ("POST", "/api/jobs", {"input": "{tmp}/clips/a.y4m",
                                          "tta": "yes"}, "equal"),
    "post_not_found": ("POST", "/nope", {}, "equal"),
    "cancel_unknown": ("DELETE", "/api/jobs/9999", None, "equal"),
    "cancel_bad_id": ("DELETE", "/api/jobs/abc", None, "equal"),
    "delete_not_found": ("DELETE", "/nope", None, "equal"),
}


def _clip(path, frames=6, w=32, h=24, step=10):
    with writer.Y4MWriter(path, w, h, fractions.Fraction(24)) as wr:
        for i in range(frames):
            wr.write(np.full((h, w, 3), 30 + i * step, np.uint8))
    return path


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_reve_tpu(route, servers, tmp_path):
    (tmp_path / "clips").mkdir()
    _clip(str(tmp_path / "clips" / "a.y4m"), frames=1)
    (tmp_path / "clips" / "notes.txt").write_text("x")
    method, path, body, compare = ROUTES[route]
    path = path.replace("{tmp}", str(tmp_path))
    if isinstance(body, dict):
        body = json.dumps({k: v.replace("{tmp}", str(tmp_path))
                           if isinstance(v, str) else v
                           for k, v in body.items()}).encode()
    got = {side: _req(url + path, method, data=body,
                      headers={"Content-Type": "application/json"})
           for side, url in servers().items()}
    (code, ref, ctype), (pcode, port, pctype) = got["ref"], got["port"]
    assert (pcode, pctype) == (code, ctype)
    if compare == "equal":
        assert port == ref
    elif compare == "keys":
        assert _keys(port) == _keys(ref)
    elif route.startswith("index"):
        assert _page(port) == _page(ref)
        for needle in ("Settings", "Log", "About", "Browse",
                       "drop file paths", "Upscale all", "api/browse",
                       "api/config", "reve-tpu", "PyTorch/CUDA port"):
            assert needle in port
    else:
        assert port == ref
    if route == "version":
        assert port == {"version": __version__}


#: (headers, method, path, body, want status) on a plain server
GUARDS = {
    "host_rebinding_get": ({"Host": "evil.example:8321"}, "GET",
                           "/api/jobs", None, 403),
    "host_rebinding_post": ({"Host": "evil.example",
                             "Content-Type": "application/json"}, "POST",
                            "/api/config", b"{}", 403),
    "loopback_host": ({}, "GET", "/api/version", None, 200),
    "cross_site_origin": ({"Origin": "http://evil.example"}, "POST",
                          "/api/suffix", b'{"path": "/x/v.mp4"}', 403),
    "same_origin": ({"Origin": "http://127.0.0.1:999"}, "POST",
                    "/api/suffix", b'{"path": "/x/v.mp4"}', 200),
    "origin_on_get": ({"Origin": "http://evil.example"}, "GET", "/api/jobs",
                      None, 200),
    "null_origin": ({"Origin": "null"}, "POST", "/api/suffix",
                    b'{"path": "/x/v.mp4"}', 403),
}
#: the same on a server with token "sekrit" and a browse jail
TOKEN_GUARDS = {
    "no_token": ({}, "/api/jobs", 401),
    "wrong_token": ({"Authorization": "Bearer wrong"}, "/api/jobs", 401),
    "bearer_token": ({"Authorization": "Bearer sekrit"}, "/api/jobs", 200),
    "query_token": ({}, "/api/jobs?token=sekrit", 200),
    "page_needs_no_token": ({}, "/", 200),
    "metrics_alias_no_token": ({}, "/metrics", 401),
    "metrics_alias_token": ({"Authorization": "Bearer sekrit"}, "/metrics",
                            200),
    "jail_root": ({"Authorization": "Bearer sekrit"},
                  "/api/browse?dir={jail}", 200),
    "jail_default": ({"Authorization": "Bearer sekrit"}, "/api/browse",
                     200),
    "jail_dot": ({"Authorization": "Bearer sekrit"}, "/api/browse?dir=.",
                 200),
    "jail_escape": ({"Authorization": "Bearer sekrit"},
                    "/api/browse?dir=/etc", 403),
    "jail_traversal": ({"Authorization": "Bearer sekrit"},
                       "/api/browse?dir={jail}/sub/../..", 403),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_host_and_origin_checks_match_reve_tpu(case, servers):
    headers, method, path, body, want = GUARDS[case]
    for side, url in servers().items():
        code, out, _ = _req(url + path, method, headers=dict(headers),
                            data=body)
        assert code == want, (side, out)
        if want == 403:
            assert ("Host" if "host" in case else "Origin") in out["error"]


@pytest.mark.parametrize("case", sorted(TOKEN_GUARDS))
def test_token_and_browse_jail_match_reve_tpu(case, servers, tmp_path):
    jail = tmp_path / "jail"
    (jail / "sub").mkdir(parents=True)
    (jail / "clip.mp4").write_bytes(b"x")
    headers, path, want = TOKEN_GUARDS[case]
    path = path.replace("{jail}", str(jail))
    outs = {}
    for side, url in servers(tokened=True).items():
        code, outs[side], ctype = _req(url + path, headers=dict(headers))
        assert code == want, (side, outs[side])
        if ctype == "text/html":
            outs[side] = _page(outs[side])
    assert outs["port"] == outs["ref"]
    if case.startswith("jail") and want == 200:
        assert outs["port"]["dir"] == os.path.realpath(str(jail))
        assert outs["port"]["parent"] is None
        assert {e["name"] for e in outs["port"]["entries"]} == {
            "sub", "clip.mp4"}


def test_wildcard_bind_accepts_machine_hostname():
    cfg = config_mod.ServiceConfig(segment_size=5)
    manager = JobManager(cfg, engine_factory=lambda m, s: FakeEngine(),
                         io_backend="y4m", device="cpu")
    srv = server_mod.make_server("0.0.0.0", 0, cfg=cfg, manager=manager)
    try:
        allowed = srv.RequestHandlerClass.allowed_hosts
        assert socket.gethostname().lower() in allowed
        assert "localhost" in allowed and "evil.example" not in allowed
    finally:
        srv.server_close()
        manager.shutdown()


# -- jobs --------------------------------------------------------------------

def _get(url):
    code, body, _ = _req(url)
    assert code == 200, body
    return body


def _post(url, data):
    code, body, _ = _req(url, "POST", data=json.dumps(data).encode(),
                         headers={"Content-Type": "application/json"})
    assert code == 201, body
    return body


def _wait_http(base, job_id, until=("done", "error", "cancelled"),
               timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        j = _get(f"{base}/api/jobs/{job_id}")
        if j["status"] in until:
            return j
        time.sleep(0.05)
    raise AssertionError(f"job {job_id} still {j['status']}")


def _wait(job, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline and job.status not in ("done", "error",
                                                        "cancelled"):
        time.sleep(0.05)
    return job


def test_job_through_post_equals_the_ports_cli_job(tmp_path, monkeypatch):
    """A job through POST /api/jobs on the port's engine (the default
    factory on the CPU) writes the bytes of the port's CLI job on the
    same input and settings: x4, float32, segments of 3, y4m."""
    monkeypatch.chdir(REPO)
    rs = np.random.RandomState(0)
    inp = str(tmp_path / "in.y4m")
    with writer.Y4MWriter(inp, 32, 24, fractions.Fraction(24)) as wr:
        for _ in range(6):
            wr.write(rs.randint(0, 256, (24, 32, 3)).astype(np.uint8))
    out_cli = str(tmp_path / "cli.y4m")
    assert cli.run(["-i", inp, "-s", "4", out_cli, "--io-backend", "y4m",
                    "-S", "3", "--dtype", "float32", "--yes"],
                   device="cpu") == 0
    cfg = config_mod.ServiceConfig(segment_size=3)
    manager = JobManager(cfg, io_backend="y4m", device="cpu")
    srv = server_mod.make_server("127.0.0.1", 0, cfg=cfg, manager=manager)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        out = str(tmp_path / "svc.y4m")
        job = _post(base + "/api/jobs", {"input": inp, "scale": 4,
                                         "output": out,
                                         "dtype": "float32"})
        j = _wait_http(base, job["id"])
        assert j["status"] == "done", j["error"]
        assert j["result"]["dtype"] == "float32"
        assert j["progress"]["encode"]["done"] == 6
        assert open(out, "rb").read() == open(out_cli, "rb").read()
        assert not os.path.exists(out + ".revework")
        # a second job of the same settings reuses the cached engine
        job2 = _post(base + "/api/jobs", {"input": inp, "scale": 4,
                                          "output": str(tmp_path / "b.y4m"),
                                          "dtype": "float32"})
        assert _wait_http(base, job2["id"])["status"] == "done"
        assert len(manager._engines) == 1
        code, text, _ = _req(base + "/api/metrics")
        assert code == 200 and 'reve_jobs_total{status="done"} 2' in text
        assert "reve_frames_encoded_total 12" in text
    finally:
        srv.shutdown()
        srv.server_close()
        manager.shutdown()


def test_job_end_to_end_json_matches_reve_tpu(servers, tmp_path):
    """One fake-engine job on each server: the same job JSON shape, and
    the reference test's progress."""
    urls = servers()
    inp = _clip(str(tmp_path / "in.y4m"), frames=12)
    shapes = {}
    for s, base in urls.items():
        out = str(tmp_path / f"out_{s}.y4m")
        job = _post(base + "/api/jobs", {"input": inp, "scale": 2,
                                         "output": out})
        assert job["status"] in ("queued", "running")
        j = _wait_http(base, job["id"])
        assert j["status"] == "done", j["error"]
        assert j["progress"]["encode"]["done"] == 12
        assert j["progress"]["x_realtime"] > 0
        rd = reader.Y4MReader(out)
        assert (rd.width, rd.height, rd.frame_count()) == (64, 48, 12)
        j["result"].pop("dtype", None)  # the port's report names its path
        shapes[s] = _keys(j)
    assert shapes["port"] == shapes["ref"]
    # each server's output file is downloadable, byte for byte
    for s, base in urls.items():
        data = urllib.request.urlopen(base + "/api/jobs/1/output",
                                      timeout=30).read()
        assert data == open(str(tmp_path / f"out_{s}.y4m"), "rb").read()


def test_cancel_queued_and_batch_of_three(tmp_path, servers):
    base = servers()["port"]
    inp = _clip(str(tmp_path / "q.y4m"), frames=60, step=0)
    j1 = _post(base + "/api/jobs", {"input": inp, "scale": 2,
                                    "output": str(tmp_path / "o1.y4m")})
    j2 = _post(base + "/api/jobs", {"input": inp, "scale": 2,
                                    "output": str(tmp_path / "o2.y4m")})
    code, body, _ = _req(base + f"/api/jobs/{j2['id']}", "DELETE")
    assert code == 200 and body == {"cancelled": j2["id"]}
    assert _wait_http(base, j2["id"])["status"] == "cancelled"
    assert _wait_http(base, j1["id"])["status"] == "done"
    jobs = [_post(base + "/api/jobs", {"input": _clip(
        str(tmp_path / f"b{k}.y4m")), "scale": 2,
        "output": str(tmp_path / f"ob{k}.y4m")}) for k in range(3)]
    for j in jobs:
        done = _wait_http(base, j["id"])
        assert done["status"] == "done" and \
            done["progress"]["encode"]["done"] == 6
    code, text, _ = _req(base + "/api/metrics")
    assert 'reve_jobs_total{status="done"} 4' in text
    assert 'reve_jobs_total{status="cancelled"} 1' in text


class CountingEngine(FakeEngine):
    """A fake engine that counts frames and can be slowed."""

    def __init__(self, delay=0.0):
        self.frames_seen = 0
        self.delay = delay

    def submit(self, frames):
        self.frames_seen += len(frames)
        time.sleep(self.delay)
        return super().submit(frames)


def test_cancel_running_then_resubmit_resumes_from_parts(tmp_path):
    """A running job cancelled through DELETE keeps its committed parts;
    resubmitted, it resumes from them and the output is whole; its parts
    stream while it runs."""
    inp = _clip(str(tmp_path / "in.y4m"), frames=30, step=5)
    eng = CountingEngine(delay=0.15)
    cfg = config_mod.ServiceConfig(segment_size=5)
    manager = JobManager(cfg, engine_factory=lambda m, s: eng,
                         io_backend="y4m", device="cpu")
    srv = server_mod.make_server("127.0.0.1", 0, cfg=cfg, manager=manager)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    out = str(tmp_path / "o.y4m")
    try:
        job = _post(base + "/api/jobs", {"input": inp, "scale": 2,
                                         "output": out})
        deadline = time.time() + 60
        parts = []
        while time.time() < deadline and not parts:
            parts = _get(base + f"/api/jobs/{job['id']}/parts")["parts"]
            time.sleep(0.05)
        assert parts, "no part committed while running"
        data = urllib.request.urlopen(
            base + f"/api/jobs/{job['id']}/parts/{parts[0]['index']}",
            timeout=30).read()
        assert data.startswith(b"YUV4MPEG2")
        code, body, _ = _req(base + f"/api/jobs/{job['id']}", "DELETE")
        assert code == 200
        assert _wait_http(base, job["id"])["status"] == "cancelled"
        code, _, _ = _req(base + f"/api/jobs/{job['id']}/output")
        assert code == 409
        committed = len(state_mod.Workspace(out + ".revework")
                        .completed_parts(".y4m"))
        assert 1 <= committed < 6
        seen = eng.frames_seen
        eng.delay = 0.0
        again = _post(base + "/api/jobs", {"input": inp, "scale": 2,
                                           "output": out})
        assert _wait_http(base, again["id"])["status"] == "done"
        assert reader.Y4MReader(out).frame_count() == 30
        # only the segments not committed were run again
        assert eng.frames_seen - seen <= 30 - 5 * committed + 5
    finally:
        srv.shutdown()
        srv.server_close()
        manager.shutdown()


def _plant(out, *, frames=12, opts=None, model="realesr-animevideov3",
           scale=2):
    """An interrupted workspace for `out` with segment 0 (5 frames)
    committed as a y4m part (10-bit, as the port's parts are); `opts` its
    saved settings."""
    ws = state_mod.Workspace(out + ".revework")
    ws.create()
    st = state_mod.JobState(
        input_path=out + ".in.y4m", output_path=out, scale=scale,
        segment_size=5, frame_count=frames, fps_num=24, fps_den=1,
        width=32, height=24, pending=plan_segments(frames, 5), model=model,
        opts=dict(opts or {}))
    st.plan = list(st.pending)
    with writer.Y4MWriter(ws.part_tmp_path(0, ".y4m"), 64, 48,
                          fractions.Fraction(24), bits=10) as wr:
        for i in range(5):
            up = np.full((24, 32, 3), 30 + i * 10, np.uint8)
            wr.write(np.repeat(np.repeat(up, 2, axis=0), 2, axis=1))
    ws.commit_part(0, ".y4m")
    ws.save(st)
    return st


PORT_OPTS = {"backend": "reve_tpu_torch", "dtype": "int8",
             "int8_calib": "p99.9", "tta": False, "io_backend": "y4m",
             "weights": None, "weights_wdn": None, "denoise": None,
             "allow_random_init": True}


def test_resubmit_restores_the_saved_settings(tmp_path):
    """Resubmitted with defaults and through a manager set to another io
    backend, a job resumes with its saved dtype, int8_calib, tta and
    io_backend, and runs only the segments not committed."""
    out = str(tmp_path / "out.y4m")
    st = _plant(out, opts=dict(PORT_OPTS, tta=True))
    _clip(st.input_path, frames=12)
    seen, engines = [], []

    def factory(m, s, dtype, calib, tta):
        seen.append((dtype, calib, tta))
        engines.append(CountingEngine())
        return engines[-1]

    manager = JobManager(config_mod.ServiceConfig(segment_size=5),
                         engine_factory=factory, io_backend=None,
                         device="cpu")
    try:
        job = _wait(manager.submit(st.input_path, 2, output_path=out))
        assert job.status == "done", job.error
        assert seen == [("int8", "p99.9", True)]
        assert (job.dtype, job.int8_calib, job.tta, job.part_ext) == \
            ("int8", "p99.9", True, ".y4m")
        assert reader.Y4MReader(out).frame_count() == 12
        assert engines[0].frames_seen == 7
    finally:
        manager.shutdown()


def _factory_calls(factory, submits, tmp_path):
    """Run each submit's kwargs through one manager on `factory`; returns
    the finished jobs."""
    tmp_path.mkdir()
    inp = _clip(str(tmp_path / "in.y4m"))
    manager = JobManager(config_mod.ServiceConfig(segment_size=5),
                         engine_factory=factory, io_backend="y4m",
                         device="cpu")
    try:
        return [_wait(manager.submit(inp, scale=2, output_path=str(
            tmp_path / f"o{i}.y4m"), **kw)) for i, kw in enumerate(submits)]
    finally:
        manager.shutdown()


def test_engine_factory_arities(tmp_path):
    """The longest argument prefix a factory binds; a shorter factory
    errors a job whose setting it cannot take (no silent default run)
    and still serves the defaults."""
    seen = []

    def f5(m, s, d, c, t):
        seen.append(("f5", d, c, t))
        return FakeEngine()

    def f3(m, s, d):
        seen.append(("f3", d))
        return FakeEngine()

    def varargs(*a):
        seen.append(("varargs",) + a)
        return FakeEngine()

    def full(extra, m, s, d, c):
        seen.append((extra, d, c))
        return FakeEngine()

    jobs = _factory_calls(f5, [{"tta": True}, {"dtype": "int8",
                                               "int8_calib": "max"}],
                          tmp_path / "a")
    assert [j.status for j in jobs] == ["done", "done"]
    jobs = _factory_calls(f3, [{"dtype": "int8", "int8_calib": "max"},
                               {"dtype": "int8"}, {"tta": True}],
                          tmp_path / "b")
    assert [j.status for j in jobs] == ["error", "done", "error"]
    assert "int8_calib" in jobs[0].error and "tta" in jobs[2].error
    jobs = _factory_calls(lambda m, s: FakeEngine(),
                          [{"dtype": "float32"}, {}], tmp_path / "c")
    assert [j.status for j in jobs] == ["error", "done"]
    assert "dtype" in jobs[0].error
    jobs = _factory_calls(varargs, [{"dtype": "int8"}], tmp_path / "d")
    jobs += _factory_calls(functools.partial(full, "x"), [{"dtype": "int8"}],
                           tmp_path / "e")
    assert [j.status for j in jobs] == ["done", "done"]
    assert seen == [
        ("f5", "bfloat16", "p99.9", True), ("f5", "int8", "max", False),
        ("f3", "int8"),
        ("varargs", "realesr-animevideov3", 2, "int8", "p99.9", False),
        ("x", "int8", "p99.9")]


@pytest.mark.parametrize("kw,match", [
    ({"dtype": "float16"}, "dtype"), ({"int8_calib": "q9"}, "int8_calib"),
    ({"int8_calib": "p101"}, "int8_calib"), ({"tta": "yes"}, "tta")])
def test_submit_refuses_bad_settings(kw, match, tmp_path):
    manager = JobManager(config_mod.ServiceConfig(),
                         engine_factory=lambda m, s: FakeEngine(),
                         device="cpu")
    try:
        with pytest.raises(ValueError, match=match):
            manager.submit(str(tmp_path / "x.y4m"), 2, **kw)
    finally:
        manager.shutdown()


def _flock_holder(lock_path):
    """A live process holding the flock on `lock_path` (a second owner)."""
    code = ("import fcntl, os, time\n"
            f"fd = os.open({lock_path!r}, os.O_CREAT | os.O_RDWR)\n"
            "fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
            "print('locked', flush=True)\n"
            "time.sleep(60)\n")
    p = subprocess.Popen([sys.executable, "-c", code],
                         stdout=subprocess.PIPE, text=True)
    assert p.stdout.readline().strip() == "locked"
    return p


REFUSED = {
    "model_mismatch": ({"model": "realesr-general-x4v3", "scale": 4},
                       dict(PORT_OPTS), "holds progress for model"),
    "scale_mismatch": ({"scale": 3}, dict(PORT_OPTS),
                       "holds progress for model"),
    "no_backend_stamp": ({}, {"dtype": "bfloat16", "io_backend": "y4m"},
                         "not reve_tpu_torch"),
    "other_weights": ({}, dict(PORT_OPTS, weights="/m.pth"),
                      "--weights or --denoise"),
    "second_owner": (None, None, "another live process"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_jobs(case, tmp_path):
    planted, opts, match = REFUSED[case]
    out = str(tmp_path / "out.y4m")
    inp = _clip(str(tmp_path / "in.y4m"), frames=12)
    holder = None
    if planted is None:
        ws = state_mod.Workspace(out + ".revework")
        os.makedirs(ws.root, exist_ok=True)
        holder = _flock_holder(ws.owner_path)
    else:
        _plant(out, opts=opts, model=planted.get("model",
                                                 "realesr-animevideov3"),
               scale=planted.get("scale", 2))
    eng = CountingEngine()
    manager = JobManager(config_mod.ServiceConfig(segment_size=5),
                         engine_factory=lambda m, s: eng, io_backend="y4m",
                         device="cpu")
    try:
        job = _wait(manager.submit(inp, 2, output_path=out))
        assert job.status == "error" and match in job.error, job.error
        assert eng.frames_seen == 0 and not os.path.exists(out)
    finally:
        manager.shutdown()
        if holder is not None:
            holder.kill()
            holder.wait()


def test_without_cuda_a_job_errors_instead_of_running_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    manager = JobManager(config_mod.ServiceConfig(segment_size=5),
                         engine_factory=lambda m, s: FakeEngine(),
                         io_backend="y4m")
    try:
        job = _wait(manager.submit(_clip(str(tmp_path / "in.y4m")), 2,
                                   output_path=str(tmp_path / "o.y4m")))
        assert job.status == "error" and "CUDA" in job.error
    finally:
        manager.shutdown()


def test_module_entry_point_serves(tmp_path):
    """`python -m reve_tpu_torch.service.server` serves the routes (its
    jobs would run on cuda:0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, XDG_CONFIG_HOME=str(tmp_path / "xdg"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "reve_tpu_torch.service.server", "--port",
         str(port), "--token", "sekrit"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 60
        while True:
            try:
                code, body, _ = _req(base + "/api/version", headers={
                    "Authorization": "Bearer sekrit"})
                break
            except urllib.error.URLError:
                assert proc.poll() is None and time.time() < deadline, \
                    proc.stderr.read() if proc.poll() is not None else ""
                time.sleep(0.2)
        assert (code, body) == (200, {"version": __version__})
        assert _req(base + "/api/jobs")[0] == 401
        # the port's settings file, regenerated with the defaults
        assert json.load(open(tmp_path / "xdg" / "reve-tpu-torch" /
                              "reve-tpu-config.json")) == \
            config_mod.ServiceConfig().to_json()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
