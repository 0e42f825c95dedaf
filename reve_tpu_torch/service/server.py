"""Web service: the GUI analog, as a thin HTTP layer over the pipeline core.

The port's copy of reve_tpu/service/server.py: the same routes, page,
checks and flags, over the port's JobManager (service/jobs.py), whose jobs
run through pipeline/job.py on the port's engine (cuda:0).  Run it as
`python -m reve_tpu_torch.service.server`; its settings file is the
port's own (service/config.py).

API (cf. the six Tauri commands, reve-gui/src-tauri/src/main.rs:12-19):
    GET  /api/version            <- get_version
    GET  /api/config             <- load_configuration
    POST /api/config             <- write_configuration
    POST /api/log                <- write_log (config-gated)
    GET  /api/log?lines=N        log tail (viewer page)
    POST /api/jobs {input,scale,model[,output]}  <- upscale_single_video
    GET  /api/jobs               job list + live progress
    GET  /api/jobs/<id>
    DELETE /api/jobs/<id>        cancel
    GET  /api/jobs/<id>/parts    progressive output: committed segments
    GET  /api/jobs/<id>/parts/<i>  download one committed segment
    GET  /api/jobs/<id>/output   download the final output
    GET  /api/browse?dir=        server-side file browser
    GET  /api/models             registry listing
    GET  /api/metrics            Prometheus text metrics
    POST /api/suffix {path,factor,ext}           <- replace_file_suffix

Trust model: binds to 127.0.0.1 by default and (like the reference's
desktop GUI) is a LOCAL operator tool — /api/browse and job inputs
intentionally reach the operator's filesystem; do not expose the port
publicly without an auth proxy.  Hardening on top of that model:

  * every request's Host header must name a known host (loopback names +
    the bound host + --allow-host extras) — closes DNS-rebinding, the
    classic hole in localhost HTTP tools (a victim's browser resolving
    evil.com -> 127.0.0.1 sends Host: evil.com and is refused);
  * state-changing requests (POST/DELETE) with a browser Origin header
    must come from an allowed origin (CSRF);
  * optional bearer token (--token / REVE_TPU_TOKEN) required on every
    /api and /metrics request when set;
  * optional --browse-root jails /api/browse to a directory subtree.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from reve_tpu_torch.service import config as config_mod
from reve_tpu_torch.service.jobs import JobManager, replace_file_suffix
from reve_tpu_torch.service.logger import ServiceLogger
from reve_tpu_torch.version import __version__

# Full-featured embedded frontend: hash-routed pages mirroring the
# reference GUI's flows — Index (multi-file batch with a server-side file
# browser + drag-drop, reve-gui/src/pages/Index.vue:120,340-353), Config
# bound to the config store (Config.vue:1-66), a log viewer, and About.
_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>reve-tpu</title>
<style>
 body{font-family:system-ui;margin:0;background:#14141a;color:#eee}
 nav{background:#1d1d26;padding:.6rem 2rem;display:flex;gap:1.2rem;align-items:baseline}
 nav a{color:#9ab;cursor:pointer;text-decoration:none}nav a.on{color:#4a9eff;font-weight:600}
 main{margin:1.5rem 2rem;max-width:860px}
 input,select,button{font-size:1rem;margin:.25rem;padding:.35rem;background:#232330;color:#eee;border:1px solid #444;border-radius:4px}
 button{cursor:pointer}button:hover{border-color:#4a9eff}
 .job,.card{border:1px solid #333;padding:.6rem;margin:.5rem 0;border-radius:6px}
 .bar{height:8px;background:#333;border-radius:4px;overflow:hidden}
 .bar>div{height:100%;background:#4a9eff}
 .err{color:#f66;white-space:pre-wrap}.ok{color:#6d6}
 .drop{border:2px dashed #444;border-radius:8px;padding:1.2rem;text-align:center;color:#89a;margin:.5rem 0}
 .drop.over{border-color:#4a9eff;color:#4a9eff}
 .sel{display:flex;justify-content:space-between;border-bottom:1px solid #2a2a33;padding:.25rem .4rem}
 .browser{max-height:320px;overflow:auto;border:1px solid #333;border-radius:6px;padding:.3rem;margin:.4rem 0}
 .browser div{padding:.15rem .4rem;cursor:pointer;border-radius:4px}
 .browser div:hover{background:#232336}
 .browser .dir{color:#9ab}.browser .vid{color:#cde}
 label{display:block;margin:.5rem 0}
 pre{background:#0d0d12;border:1px solid #333;border-radius:6px;padding:.8rem;max-height:420px;overflow:auto;white-space:pre-wrap}
 small{color:#789}
</style></head><body>
<nav><b>reve-tpu</b><small id=v></small>
 <a data-p=home>Upscale</a><a data-p=config>Settings</a>
 <a data-p=log>Log</a><a data-p=about>About</a></nav>
<main>
<section id=home>
 <div class=drop id=drop>drop file paths here, or
  <button onclick="openBrowser()">Browse&hellip;</button></div>
 <div id=browser style="display:none">
  <div><input id=bdir size=50><button onclick="browse(bdir.value)">Go</button>
   <button onclick="browser.style.display='none'">Close</button></div>
  <div class=browser id=blist></div>
 </div>
 <div id=selected></div>
 <div>
  <input id=path placeholder="/path/to/video.mp4 (or add files above)" size=42>
  <button onclick="addPath()">Add</button>
  <select id=model></select>
  <select id=scale><option>2</option><option>3</option><option>4</option></select>x
  <label><input type=checkbox id=turbo
    title="default: auto (turbo when certified >=50 dB on this video); check to force int8">
    force turbo (int8)</label>
  <label><input type=checkbox id=tta> TTA (8x slower, best quality)</label>
  <button onclick="go()">Upscale all</button>
 </div>
 <div id=jobs></div>
</section>
<section id=config style="display:none">
 <h3>Settings</h3><div class=card id=cfgform></div>
 <button onclick="saveCfg()">Save</button> <span id=cfgmsg></span>
</section>
<section id=log style="display:none">
 <h3>Service log</h3>
 <button onclick="loadLog()">Refresh</button><pre id=logbox></pre>
</section>
<section id=about style="display:none">
 <h3>About</h3>
 <div class=card>reve-tpu <span id=v2></span> &mdash; video upscaling
 (Real-ESRGAN family) on the PyTorch/CUDA port, segmented &amp; resumable.
 The service runs every job through the same pipeline as the CLI
 (segments, checkpoints, native concat/remux).</div>
</section>
</main>
<script>
const PAGES=['home','config','log','about'];
function route(){
 const p=(location.hash||'#home').slice(1);
 PAGES.forEach(x=>{document.getElementById(x).style.display=x===p?'':'none'});
 document.querySelectorAll('nav a').forEach(a=>a.classList.toggle('on',a.dataset.p===p));
 if(p==='config')loadCfg(); if(p==='log')loadLog();
}
document.querySelectorAll('nav a').forEach(a=>a.onclick=()=>location.hash='#'+a.dataset.p);
window.onhashchange=route;
fetch('/api/version').then(r=>r.json()).then(d=>{v.textContent=d.version;v2.textContent=d.version});
fetch('/api/models').then(r=>r.json()).then(ms=>{
 model.innerHTML=ms.map(m=>`<option>${m.name}</option>`).join('');
});
// ---- batch selection ----
let files=[];
function renderSel(){
 selected.innerHTML=files.map((f,i)=>`<div class=sel><span>${f}</span>
  <button onclick="files.splice(${i},1);renderSel()">remove</button></div>`).join('');
}
function addPath(){ if(path.value){files.push(path.value);path.value='';renderSel();} }
drop.ondragover=e=>{e.preventDefault();drop.classList.add('over')};
drop.ondragleave=()=>drop.classList.remove('over');
drop.ondrop=e=>{
 e.preventDefault();drop.classList.remove('over');
 const t=e.dataTransfer.getData('text');
 if(t)t.split(/\\n/).forEach(x=>{x=x.trim();if(x)files.push(x)});
 renderSel();
};
// ---- server-side file browser ----
function openBrowser(){browser.style.display='';browse(bdir.value||'.')}
async function browse(dir){
 const d=await (await fetch('/api/browse?dir='+encodeURIComponent(dir||'.'))).json();
 if(d.error){blist.innerHTML=`<div class=err>${d.error}</div>`;return;}
 bdir.value=d.dir;
 blist.innerHTML=(d.parent?`<div class=dir onclick="browse('${d.parent}')">&#8617; ..</div>`:'')+
  d.entries.map(e=>e.is_dir
   ?`<div class=dir onclick="browse('${e.path}')">&#128193; ${e.name}</div>`
   :(e.is_video?`<div class=vid onclick="files.push('${e.path}');renderSel()">&#127916; ${e.name}</div>`:'')
  ).join('');
}
// ---- jobs ----
async function go(){
 const batch=files.length?files:(path.value?[path.value]:[]);
 for(const f of batch){
  const r=await fetch('/api/jobs',{method:'POST',headers:{'Content-Type':'application/json'},
   body:JSON.stringify({input:f,scale:+scale.value,model:model.value,
    dtype:turbo.checked?'int8':undefined,tta:tta.checked})});
  if(!r.ok){const e=await r.json();jobs.insertAdjacentHTML('afterbegin',
   `<div class="job err">${f}: ${e.error}</div>`);}
 }
 files=[];renderSel();refresh();
}
async function cancel(id){await fetch('/api/jobs/'+id,{method:'DELETE'});refresh();}
async function refresh(){
 const js=await (await fetch('/api/jobs')).json();
 jobs.innerHTML=js.map(j=>{
  const p=j.progress?j.progress.encode:null;
  const pct=p&&p.total?Math.round(100*p.done/p.total):0;
  const live=j.status==='running'||j.status==='queued';
  return `<div class=job><b>#${j.id}</b> ${j.input} &rarr; x${j.scale} [${j.status}]
   ${live?`<button style="float:right" onclick="cancel(${j.id})">cancel</button>`:''}
   ${j.status==='done'?`<a style="float:right" href="/api/jobs/${j.id}/output" download>download</a>`:''}
   <div class=bar><div style="width:${pct}%"></div></div>
   ${p?`${p.done}/${p.total} frames (${p.rate} fps${p.eta_s!==undefined&&live?`, eta ${Math.round(p.eta_s)}s`:''}${j.progress.x_realtime!==undefined?`, ${j.progress.x_realtime}x realtime`:''})`:''}
   ${j.error?`<div class=err>${j.error}</div>`:''}</div>`;
 }).join('');
}
setInterval(()=>{if((location.hash||'#home')==='#home')refresh()},1000);refresh();
// ---- config ----
const CFG_FIELDS=[['application-logs','checkbox','enable the service log'],
 ['default-upscale-type','text','default model'],
 ['default-scale','number','default scale (2/3/4)'],
 ['segment-size','number','frames per segment'],
 ['crf','number','x265 crf (0-51)'],['preset','text','x265 preset']];
async function loadCfg(){
 const c=await (await fetch('/api/config')).json();
 cfgform.innerHTML=CFG_FIELDS.map(([k,t,h])=>`<label>${k}
  <input id="cfg_${k}" type=${t} ${t==='checkbox'?(c[k]?'checked':''):`value="${c[k]}"`}>
  <small>${h}</small></label>`).join('');
}
async function saveCfg(){
 const body={};
 CFG_FIELDS.forEach(([k,t])=>{const el=document.getElementById('cfg_'+k);
  body[k]=t==='checkbox'?el.checked:(t==='number'?+el.value:el.value)});
 const r=await fetch('/api/config',{method:'POST',
  headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 cfgmsg.className=r.ok?'ok':'err';
 cfgmsg.textContent=r.ok?'saved':(await r.json()).error;
}
// ---- log ----
async function loadLog(){
 logbox.textContent=(await (await fetch('/api/log?lines=300')).json()).log||'(empty)';
}
route();
</script></body></html>"""


class Handler(BaseHTTPRequestHandler):
    manager: JobManager = None
    cfg: config_mod.ServiceConfig = None
    logger: ServiceLogger = None
    #: hostnames accepted in Host/Origin headers (loopback + bound host
    #: + --allow-host extras); populated by make_server
    allowed_hosts = frozenset({"localhost", "127.0.0.1", "::1"})
    #: when set, every /api request must carry it (Authorization: Bearer
    #: or ?token=)
    token: Optional[str] = None
    #: when set, /api/browse may not escape this directory
    browse_root: Optional[str] = None

    def log_message(self, *args):  # quiet
        pass

    @staticmethod
    def _hostname_of(netloc: str) -> Optional[str]:
        """Hostname from a Host header / origin netloc ('[::1]:8321' ->
        '::1', 'Example.com:80' -> 'example.com')."""
        from urllib.parse import urlsplit

        try:
            return urlsplit("//" + netloc).hostname
        except ValueError:
            return None

    def _authorize(self, state_changing: bool) -> bool:
        """Host / Origin / token gate; sends the 403 itself on refusal."""
        host = self._hostname_of(self.headers.get("Host") or "")
        if host is None or host not in self.allowed_hosts:
            self._json({"error": f"refused: unknown Host {host!r} "
                        "(DNS-rebinding guard; see --allow-host)"}, 403)
            return False
        origin = self.headers.get("Origin")
        if state_changing and origin:
            from urllib.parse import urlsplit

            # "null" (sandboxed iframe / data: URI) is just as cross-site
            # as a foreign origin — refuse it too; browsers never send
            # Origin: null for the same-origin embedded UI
            o_host = (None if origin == "null"
                      else urlsplit(origin).hostname)
            if o_host is None or o_host not in self.allowed_hosts:
                self._json({"error": f"refused: cross-site Origin "
                            f"{origin!r}"}, 403)
                return False
        if self.token and (self.path.startswith("/api")
                           or self.path.split("?", 1)[0] == "/metrics"):
            from urllib.parse import parse_qs, urlsplit as _us

            auth = self.headers.get("Authorization") or ""
            q = parse_qs(_us(self.path).query)
            given = (auth[7:] if auth.startswith("Bearer ")
                     else (q.get("token") or [None])[0])
            import hmac

            if not (given and hmac.compare_digest(given, self.token)):
                self._json({"error": "missing or invalid token"}, 401)
                return False
        return True

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def do_GET(self):
        if not self._authorize(state_changing=False):
            return
        route = self.path.split("?", 1)[0]  # routing ignores the query
        if route in ("/", "/index.html"):
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif route == "/api/version":
            self._json({"version": __version__})
        elif route == "/api/models":
            from reve_tpu_torch.models import registry

            self._json([
                {"name": name, "arch": spec.arch,
                 "scales": [spec.upscale] if spec.upscale else [2, 3, 4]}
                for name, spec in registry.list_models()
            ])
        elif route == "/api/config":
            self._json(self.cfg.to_json())
        elif route in ("/api/metrics", "/metrics"):
            # Prometheus text exposition: machine-readable ops counters
            # (SURVEY.md §5 metrics/observability; the reference has none)
            jobs = self.manager.list_jobs()
            by_status = {}
            frames_done = 0
            for j in jobs:
                by_status[j["status"]] = by_status.get(j["status"], 0) + 1
                p = (j.get("progress") or {}).get("encode") or {}
                frames_done += p.get("done", 0)
            lines = [
                "# TYPE reve_jobs_total gauge",
            ]
            for status in ("queued", "running", "done", "error", "cancelled"):
                lines.append(
                    f'reve_jobs_total{{status="{status}"}} '
                    f"{by_status.get(status, 0)}"
                )
            lines += [
                "# TYPE reve_frames_encoded_total counter",
                f"reve_frames_encoded_total {frames_done}",
            ]
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif route == "/api/log":
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(self.path).query)
            lines = int(q.get("lines", ["200"])[0])
            self._json({"log": self.logger.tail(lines),
                        "path": self.logger.path,
                        "enabled": self.cfg.application_logs})
        elif route == "/api/browse":
            import os
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(self.path).query)
            raw = q.get("dir", ["."])[0] or "."
            if self.browse_root is not None:
                root = os.path.realpath(self.browse_root)
                # "." is the UI's entry-point request, not an explicit
                # path — inside a jail it means the jail root (the
                # server's cwd is usually OUTSIDE the root, and a 403 on
                # the first request would make the browser unusable)
                d = root if raw == "." else os.path.abspath(raw)
                if not os.path.isdir(d):
                    d = root
                real = os.path.realpath(d)
                if os.path.commonpath([root, real]) != root:
                    return self._json(
                        {"error": f"outside --browse-root: {d}"}, 403)
            else:
                d = os.path.abspath(raw)
            if not os.path.isdir(d):
                return self._json({"error": f"not a directory: {d}"}, 400)
            video_exts = (".mp4", ".mkv", ".avi", ".y4m", ".webm", ".mov")
            try:
                names = sorted(os.listdir(d))
            except OSError as e:
                return self._json({"error": str(e)}, 400)
            entries = []
            for name in names:
                if name.startswith("."):
                    continue
                p = os.path.join(d, name)
                is_dir = os.path.isdir(p)
                entries.append({
                    "name": name, "path": p, "is_dir": is_dir,
                    "is_video": (not is_dir and
                                 name.lower().endswith(video_exts)),
                })
            parent = os.path.dirname(d) if d != "/" else None
            if self.browse_root is not None and \
                    os.path.realpath(d) == os.path.realpath(self.browse_root):
                parent = None  # the jail root has no browsable parent
            self._json({"dir": d, "parent": parent, "entries": entries})
        elif route == "/api/jobs":
            self._json(self.manager.list_jobs())
        elif route.startswith("/api/jobs/"):
            # /api/jobs/<id> | /api/jobs/<id>/parts | /api/jobs/<id>/parts/<i>
            rest = route[len("/api/jobs/"):].split("/")
            try:
                job = self.manager.get(int(rest[0]))
            except ValueError:
                job = None
            if job is None:
                return self._json({"error": "no such job"}, 404)
            if len(rest) == 1:
                self._json(job.to_json())
            elif rest[1] == "parts" and len(rest) == 2:
                # progressive output: parts committed so far, streamable
                # while the job is still running
                self._json({"parts": job.committed_parts(),
                            "ext": job.part_ext})
            elif rest[1] == "output" and len(rest) == 2:
                # final output download (after the job is done)
                import os

                if job.status != "done" or not os.path.exists(
                        job.output_path):
                    return self._json({"error": "output not ready"}, 409)
                ext = os.path.splitext(job.output_path)[1].lower()
                ctype = {".mp4": "video/mp4",
                         ".mkv": "video/x-matroska"}.get(
                    ext, "application/octet-stream")
                size = os.path.getsize(job.output_path)
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(size))
                self.end_headers()
                with open(job.output_path, "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
            elif rest[1] == "parts" and len(rest) == 3:
                try:
                    idx = int(rest[2])
                except ValueError:
                    return self._json({"error": "bad part index"}, 400)
                parts = {p["index"]: p for p in job.committed_parts()}
                if idx not in parts:
                    return self._json({"error": "part not committed"}, 404)
                ctype = ("video/mp4" if job.part_ext == ".mp4"
                         else "application/octet-stream")
                import os

                size = os.path.getsize(parts[idx]["path"])
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(size))
                self.end_headers()
                with open(parts[idx]["path"], "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        self.wfile.write(chunk)
            else:
                self._json({"error": "not found"}, 404)
        else:
            self._json({"error": "not found"}, 404)

    def do_POST(self):
        if not self._authorize(state_changing=True):
            return
        try:
            data = self._body()
        except json.JSONDecodeError:
            return self._json({"error": "bad json"}, 400)
        if self.path == "/api/config":
            # partial update: merge the body into the CURRENT config —
            # fields the client omits keep their saved values instead of
            # silently resetting to package defaults
            merged = self.cfg.to_json()
            merged.update(data)
            cfg = config_mod.ServiceConfig.from_json(merged)
            if not cfg.validate():
                return self._json({"error": "invalid configuration"}, 400)
            config_mod.save(cfg)
            self.cfg.__dict__.update(cfg.__dict__)
            self._json(cfg.to_json())
        elif self.path == "/api/log":
            written = self.logger.write(str(data.get("message", "")))
            self._json({"written": written})
        elif self.path == "/api/suffix":
            self._json({
                "path": replace_file_suffix(
                    data["path"], int(data.get("factor", 2)),
                    data.get("ext", "mp4"),
                )
            })
        elif self.path == "/api/jobs":
            import os

            inp = data.get("input", "")
            if not inp or not os.path.exists(inp):
                return self._json({"error": "input path not found"}, 400)
            try:
                job = self.manager.submit(
                    inp, scale=data.get("scale"), model=data.get("model"),
                    output_path=data.get("output"),
                    dtype=data.get("dtype"),
                    int8_calib=data.get("int8_calib"),
                    tta=data.get("tta", False),
                )
            except ValueError as e:
                return self._json({"error": str(e)}, 400)
            self._json(job.to_json(), 201)
        else:
            self._json({"error": "not found"}, 404)


    def do_DELETE(self):
        if not self._authorize(state_changing=True):
            return
        if self.path.startswith("/api/jobs/"):
            try:
                job_id = int(self.path.rsplit("/", 1)[1])
            except ValueError:
                return self._json({"error": "bad job id"}, 400)
            if self.manager.cancel(job_id):
                self._json({"cancelled": job_id})
            else:
                self._json({"error": "not cancellable"}, 409)
        else:
            self._json({"error": "not found"}, 404)


def make_server(host="127.0.0.1", port=8321, cfg=None, manager=None,
                io_backend: Optional[str] = None,
                token: Optional[str] = None,
                browse_root: Optional[str] = None,
                allow_hosts=()) -> ThreadingHTTPServer:
    """The service on (host, port); port 0 takes a free one
    (`server.server_address`).  Without `manager`, jobs run on a
    JobManager of the port's engines on cuda:0."""
    cfg = cfg or config_mod.load()
    handler = type("BoundHandler", (Handler,), {})
    handler.cfg = cfg
    handler.manager = manager or JobManager(cfg, io_backend=io_backend)
    handler.logger = ServiceLogger(cfg)
    allowed = {"localhost", "127.0.0.1", "::1", host} | set(allow_hosts)
    if host in ("", "0.0.0.0", "::"):
        # wildcard bind: clients never send the wildcard as Host — they
        # use the machine's hostname or one of its addresses.  Accept
        # those (the DNS-rebinding guard still holds: an attacker's
        # domain resolves here but the browser sends Host: evil.com,
        # which is not in the set); anything else (reverse-proxy names,
        # extra interfaces) is --allow-host territory.
        import socket

        for name in {socket.gethostname(), socket.getfqdn()}:
            if not name:
                continue
            allowed.add(name.lower())
            try:
                for info in socket.getaddrinfo(name, None):
                    allowed.add(info[4][0])
            except OSError:
                pass
    handler.allowed_hosts = frozenset(a.lower() for a in allowed if a)
    handler.token = token
    handler.browse_root = browse_root
    return ThreadingHTTPServer((host, port), handler)


def main():
    import argparse
    import os

    ap = argparse.ArgumentParser(prog="reve-serve")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--token", default=os.environ.get("REVE_TPU_TOKEN"),
                    help="require this bearer token on every /api and "
                         "/metrics request (default: $REVE_TPU_TOKEN if "
                         "set)")
    ap.add_argument("--browse-root", default=None, metavar="DIR",
                    help="jail /api/browse to this directory subtree")
    ap.add_argument("--allow-host", action="append", default=[],
                    metavar="HOSTNAME",
                    help="additional hostname accepted in Host/Origin "
                         "headers (repeatable; loopback names and the "
                         "bound host are always accepted)")
    args = ap.parse_args()
    server = make_server(args.host, args.port, token=args.token,
                         browse_root=args.browse_root,
                         allow_hosts=args.allow_host)
    print(f"reve-tpu service (reve_tpu_torch) on "
          f"http://{args.host}:{args.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
