"""The port's CLI (reve_tpu_torch.cli) against the JAX package's on a
hermetic y4m job: 6 frames of 24x32, x4, segments of 3, batches of 2,
float32, the shipped x4 weights.

Both outputs are 10-bit 4:2:0 y4m files (the parts' yuv420p10le
encode), compared sample by sample in the file's own units: |dsample| <=
1.  (The two packages' float32 u8 frames may differ by 1 where an
accumulation-order difference meets a rounding boundary; on this job they
agree exactly.)

The same job with --dtype int8 (float parts in bfloat16), both packages
quantizing with one persisted calibration: |dsample| <= 4 on <= 2% of
samples.  The bf16 first conv sums in another order than JAX's and may
round an activation to the neighbouring bf16 value, which can move an s8
code and so one u8 step of the RGB frame; one u8 step is up to 4 steps of
a 10-bit sample (1023 / 255).
"""

import fcntl
import fractions
import json
import os
import time

import numpy as np
import pytest
import torch

from reve_tpu import cli as jcli
from reve_tpu import native as jnative
from reve_tpu.pipeline.engine import UpscaleEngine as JaxEngine
from reve_tpu_torch import cli, device as device_mod
from reve_tpu_torch.pipeline.engine import UpscaleEngine
from reve_tpu_torch.io import reader, writer
from reve_tpu_torch.pipeline.state import Workspace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTH = os.path.join(REPO, "models", "realesr-animevideov3-x4.pth")
JOB = ["-s", "4", "--io-backend", "y4m", "--weights", PTH, "-S", "3",
       "--batch", "2", "--dtype", "float32", "--yes"]


#: how long jax_native_core waits for a build of the core that another
#: process runs (one build takes about 15 s on one core)
NATIVE_WAIT_S = 300.0


@pytest.fixture(scope="module")
def jax_native_core():
    """reve_tpu's native core, loaded in this process before a test runs
    the JAX CLI or API as its reference: without it the JAX job's concat
    re-encodes its parts, and its output no longer matches the port's
    sample for sample.  reve_tpu.native builds the core with `make` in
    the source tree on first use, so in a fresh checkout several test
    processes may build it at once; a process whose load meets a
    half-written library marks the core unavailable for its whole life.
    So the first load here holds a lock across processes (on the
    Makefile), and where a build running elsewhere made it fail, the mark
    is cleared and the load retried, for at most NATIVE_WAIT_S."""
    deadline = time.monotonic() + NATIVE_WAIT_S
    with open(os.path.join(jnative._NATIVE_DIR, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while jnative.load() is None:
                if time.monotonic() > deadline:
                    pytest.fail(f"reve_tpu's native core did not load "
                                f"within {NATIVE_WAIT_S} s")
                time.sleep(1.0)
                jnative._build_failed = False
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return jnative.load()


def _input(tmp_path, frames=6, w=32, h=24):
    path = str(tmp_path / "in.y4m")
    rs = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w]
    with writer.Y4MWriter(path, w, h, fractions.Fraction(24)) as wr:
        for i in range(frames):
            grad = np.stack([yy * 9 + i * 20, xx * 7, (yy + xx) * 4 + i],
                            -1) % 256
            noise = rs.randint(-12, 13, grad.shape)
            wr.write(np.clip(grad + noise, 0, 255).astype(np.uint8))
    return path


def _samples(path):
    """(header, [frame sample arrays]) of a y4m file, raw planes."""
    with open(path, "rb") as f:
        header = f.readline()
        data = f.read()
    fields = dict((t[:1], t[1:]) for t in header.split()[1:])
    w, h = int(fields[b"W"]), int(fields[b"H"])
    bits = 10 if b"p10" in fields.get(b"C", b"") else 8
    bpp = 2 if bits > 8 else 1
    n = (w * h + 2 * (w // 2) * (h // 2)) * bpp
    frames, pos = [], 0
    while pos < len(data):
        assert data[pos:pos + 6] == b"FRAME\n"
        pos += 6
        frames.append(np.frombuffer(data[pos:pos + n],
                                    "<u2" if bpp == 2 else np.uint8)
                      .astype(np.int32))
        pos += n
    return header, bits, frames


def _assert_close_y4m(got_path, want_path, tol=1, share=1.0):
    gh, gbits, got = _samples(got_path)
    wh, wbits, want = _samples(want_path)
    assert gh == wh and gbits == wbits
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        d = np.abs(g - w)
        assert d.max() <= tol and (d > 0).mean() <= share, \
            (i, d.max(), (d > 0).mean())


@pytest.fixture
def small_calib_chunks(monkeypatch):
    """Calibration pads its sample to a whole chunk of _CALIB_CHUNK_ELEMS
    activations (2e8: thousands of 24x32 frames); both packages get the
    same budget of 2 frames, so their chunks still correspond."""
    for cls in (UpscaleEngine, JaxEngine):
        monkeypatch.setattr(cls, "_CALIB_CHUNK_ELEMS", 2 * 24 * 32 * 64)


INT8 = [a if a != "float32" else "int8" for a in JOB]


@pytest.mark.usefixtures("jax_native_core")
def test_cli_matches_jax_cli_on_hermetic_job(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    want = str(tmp_path / "jax.y4m")
    got = str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want] + JOB) == 0
    assert cli.run(["-i", inp, got] + JOB, device="cpu") == 0
    rd = reader.Y4MReader(got)
    assert (rd.width, rd.height, rd.frame_count()) == (128, 96, 6)
    assert not os.path.exists(got + ".revework")  # workspace cleaned
    _assert_close_y4m(got, want)


@pytest.mark.usefixtures("jax_native_core")
@pytest.mark.parametrize("feat, extra", [(32, ["--tile", "8"]),
                                         (128, ["--tta"])])
def test_cli_at_other_widths_matches_jax_cli(tmp_path, monkeypatch, feat,
                                             extra):
    """A student of 32 or 128 features (reve_tpu's seeded init, 2 convs,
    x2) as a user runs it: its .pth through --weights in both CLIs, with
    --tile 8 (real windows at this model's halo of 4) or --tta, sample
    for sample.  On the card these widths run K3, K1 and K2 at F."""
    import jax

    from reve_tpu.models import srvgg as jsrvgg
    from reve_tpu_torch.models import srvgg
    from reve_tpu_torch.weights.torch_loader import save_srvgg_pth

    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    cfg = srvgg.SRVGGConfig(num_feat=feat, num_conv=2, upscale=2)
    pth = str(tmp_path / f"student{feat}.pth")
    save_srvgg_pth(pth, cfg, srvgg.params_from_jax(jsrvgg.init_params(
        jax.random.key(feat), jsrvgg.SRVGGConfig(num_feat=feat, num_conv=2,
                                                 upscale=2))))
    job = ["-s", "2", "--io-backend", "y4m", "--weights", pth, "-S", "3",
           "--batch", "2", "--dtype", "float32", "--yes"] + extra
    want = str(tmp_path / "jax.y4m")
    got = str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want] + job) == 0
    assert cli.run(["-i", inp, got] + job, device="cpu") == 0
    rd = reader.Y4MReader(got)
    assert (rd.width, rd.height, rd.frame_count()) == (64, 48, 6)
    _assert_close_y4m(got, want)


@pytest.mark.usefixtures("jax_native_core")
@pytest.mark.parametrize("extra", [["--tile", "64"], ["--tile", "8"],
                                   ["--tta"]])
def test_cli_tile_and_tta_match_jax_cli(tmp_path, monkeypatch, extra):
    """--tile N and --tta through both CLIs, sample for sample.  (At this
    frame size and the shipped model's halo of 18, every window is the
    whole frame; the engine tests hold real windows.)"""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    want = str(tmp_path / "jax.y4m")
    got = str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want] + JOB + extra) == 0
    assert cli.run(["-i", inp, got, "--keep-workspace"] + JOB + extra,
                   device="cpu") == 0
    _assert_close_y4m(got, want)
    assert Workspace(got + ".revework").load().opts["tta"] == \
        ("--tta" in extra)


def test_cli_tta_resume_restores_tta(tmp_path, monkeypatch, capsys):
    """A --tta job interrupted after one segment resumes with tta
    restored from its workspace, even without --tta on the command line:
    the output is byte-identical to the uninterrupted --tta run."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    full = str(tmp_path / "full.y4m")
    assert cli.run(["-i", inp, full, "--tta"] + JOB, device="cpu") == 0
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--keep-workspace", "--tta"] + JOB,
                   device="cpu") == 0
    os.unlink(out)
    ws = Workspace(out + ".revework")
    state = ws.load()
    assert state.opts["tta"] is True
    os.unlink(ws.part_path(1, ".y4m"))
    state.pending = [s for s in state.plan if s.index == 1]
    ws.save(state)
    capsys.readouterr()
    assert cli.run(["-i", inp, out] + JOB, device="cpu") == 0
    err = capsys.readouterr().err
    assert "resuming: 1 segment(s) remaining" in err
    assert "resume: using saved --tta=True" in err
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()
    # and the ensemble is not the plain job's output
    plain = str(tmp_path / "plain.y4m")
    assert cli.run(["-i", inp, plain] + JOB, device="cpu") == 0
    with open(plain, "rb") as a, open(full, "rb") as b:
        assert a.read() != b.read()


@pytest.mark.usefixtures("jax_native_core")
def test_api_upscale_video_matches_jax_api(tmp_path, monkeypatch):
    """reve_tpu_torch.upscale_video against reve_tpu.upscale_video on the
    same y4m, with tile and tta."""
    import reve_tpu
    import reve_tpu_torch

    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    kw = dict(weights=PTH, segment_size=3, batch=2, dtype="float32",
              io_backend="y4m", tile=64, tta=True)
    want = str(tmp_path / "jax.y4m")
    got = str(tmp_path / "torch.y4m")
    jrep = reve_tpu.upscale_video(inp, want, 4, **kw)
    rep = reve_tpu_torch.upscale_video(inp, got, 4, device="cpu", **kw)
    assert rep["dtype"] == jrep["dtype"] == "float32"
    # both concatenate through their native core
    assert rep["backend"] == jrep["backend"] == "native"
    _assert_close_y4m(got, want)
    assert not os.path.exists(got + ".revework")
    with pytest.raises(FileExistsError):
        reve_tpu_torch.upscale_video(inp, got, 4, device="cpu", **kw)


def test_api_resumes_a_cli_tta_job_with_its_settings(tmp_path, monkeypatch):
    """The API and the CLI share one resume contract (pipeline/job.py): a
    --tta job the CLI started and that stopped after one segment resumes
    through upscale_video, called without tta, to the uninterrupted
    run's bytes."""
    from reve_tpu_torch import api

    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    full = str(tmp_path / "full.y4m")
    assert cli.run(["-i", inp, full, "--tta"] + JOB, device="cpu") == 0
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--keep-workspace", "--tta"] + JOB,
                   device="cpu") == 0
    os.unlink(out)
    ws = Workspace(out + ".revework")
    state = ws.load()
    os.unlink(ws.part_path(1, ".y4m"))
    state.pending = [s for s in state.plan if s.index == 1]
    ws.save(state)
    rep = api.upscale_video(inp, out, 4, weights=PTH, segment_size=3,
                            batch=2, device="cpu")
    assert rep["dtype"] == "float32"
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(out + ".revework")


@pytest.mark.parametrize("saved,match", [
    pytest.param({"backend": None}, "started by another implementation",
                 id="saved0-started by another implementation"),
    # (its id from before --denoise was ported, when the CLI refused to
    # resume it; the CLI resumes a --denoise job now, and refuses this
    # one, saved without --weights-wdn, as reve_tpu's CLI does)
    pytest.param({"denoise": 0.5}, "started with --denoise",
                 id="saved1-denoise.*ROADMAP"),
])
def test_api_refuses_the_resumes_the_cli_refuses(tmp_path, monkeypatch,
                                                 saved, match):
    """A workspace another package started, or one saved with --denoise
    (the API has no denoise argument, as in reve_tpu), is refused by the
    API, and by the CLI (the --denoise one lacks --weights-wdn), and left
    as it was."""
    from reve_tpu_torch import api

    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=3)
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--keep-workspace"] + JOB,
                   device="cpu") == 0
    os.unlink(out)
    ws = Workspace(out + ".revework")
    state = ws.load()
    state.opts.update(saved)
    ws.save(state)
    with pytest.raises(ValueError, match=match):
        api.upscale_video(inp, out, 4, weights=PTH, segment_size=3,
                          batch=2, dtype="float32", io_backend="y4m",
                          device="cpu")
    assert ws.load().opts == state.opts and not os.path.exists(out)
    assert cli.run(["-i", inp, out] + JOB, device="cpu") == 2


@pytest.mark.parametrize("kw,err,match", [
    # (ids as before scene_align, realesrgan-x2plus and ncnn weights left
    # this list: tests/test_torch_scenes.py, test_torch_rrdb_x2.py and
    # test_torch_weights.py run them through the API; so did `mesh`,
    # kw0, held below by test_api_mesh_*)
    pytest.param({"compile_attempts": 2}, ValueError, "no counterpart",
                 id="kw4-ValueError-no counterpart"),
    pytest.param({"device": 7}, ValueError, "out of range",
                 id="kw5-ValueError-out of range"),
])
def test_api_refuses_what_the_cli_refuses(tmp_path, kw, err, match):
    from reve_tpu_torch import api

    inp = _input(tmp_path, frames=1)
    base = dict(device="cpu", allow_random_init=True)
    base.update(kw)
    with pytest.raises(err, match=match):
        api.upscale_video(inp, str(tmp_path / "o.y4m"), 4, **base)
    assert not os.path.exists(str(tmp_path / "o.y4m.revework"))


def test_cli_resume_with_one_committed_part(tmp_path, monkeypatch):
    """A workspace holding one committed part (segment 0 of 2) resumes to
    the same output as an uninterrupted run."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    full = str(tmp_path / "full.y4m")
    assert cli.run(["-i", inp, full] + JOB, device="cpu") == 0
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--keep-workspace"] + JOB,
                   device="cpu") == 0
    # roll the workspace back to "segment 0 committed, segment 1 pending"
    os.unlink(out)
    ws = Workspace(out + ".revework")
    state = ws.load()
    assert ws.completed_parts(".y4m") == [0, 1]
    os.unlink(ws.part_path(1, ".y4m"))
    state.pending = [s for s in state.plan if s.index == 1]
    ws.save(state)
    assert cli.run(["-i", inp, out] + JOB, device="cpu") == 0
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()
    assert not os.path.exists(out + ".revework")


@pytest.mark.usefixtures("jax_native_core")
def test_cli_int8_matches_jax_cli_on_hermetic_job(tmp_path, monkeypatch,
                                                  capsys, small_calib_chunks):
    """--dtype int8 through both CLIs.  The port quantizes with the
    calibration the JAX job persisted, as a resume of one job would."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    want = str(tmp_path / "jax.y4m")
    got = str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want, "--keep-workspace"] + INT8) == 0
    with open(want + ".revework/int8_calibration.json") as f:
        maxima = json.load(f)["act_maxima"]
    monkeypatch.setattr(Workspace, "load_calibration", lambda self: maxima)
    capsys.readouterr()
    assert cli.run(["-i", inp, got] + INT8, device="cpu") == 0
    err = capsys.readouterr().err
    assert "int8 turbo:" in err and "path: int8 turbo (" in err
    rd = reader.Y4MReader(got)
    assert (rd.width, rd.height, rd.frame_count()) == (128, 96, 6)
    _assert_close_y4m(got, want, tol=4, share=0.02)


def test_cli_int8_gate_refuses_with_exit_3(tmp_path, monkeypatch, capsys,
                                           small_calib_chunks):
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--int8-gate", "99"] + INT8,
                   device="cpu") == 3
    err = capsys.readouterr().err
    assert "int8 turbo:" in err and "refusing" in err
    assert not os.path.exists(out + ".revework")  # no resume droppings
    assert not os.path.exists(out)
    # the int8 flags are validated as the reference validates them
    for extra in (["--int8-gate", "50"], ["--int8-calib", "max"]):
        assert cli.run(["-i", inp, out] + JOB + extra, device="cpu") == 2
        assert "requires --dtype int8 or auto" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.run(["-i", inp, out, "--int8-calib", "p101"] + INT8,
                device="cpu")


def test_cli_int8_resume_reuses_the_persisted_calibration(
        tmp_path, monkeypatch, capsys, small_calib_chunks):
    """A crashed int8 job (segment 1 of 2 not committed) resumes with the
    calibration and certificate its workspace persisted: the output is
    byte-identical to the uninterrupted run."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    full = str(tmp_path / "full.y4m")
    assert cli.run(["-i", inp, full] + INT8, device="cpu") == 0
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--keep-workspace"] + INT8,
                   device="cpu") == 0
    os.unlink(out)
    ws = Workspace(out + ".revework")
    saved, cert = ws.load_calibration(), ws.load_int8_cert()
    state = ws.load()
    assert state.opts["backend"] == "reve_tpu_torch"
    assert state.opts["dtype"] == "int8" and \
        state.opts["int8_calib"] == "p99.9"
    os.unlink(ws.part_path(1, ".y4m"))
    state.pending = [s for s in state.plan if s.index == 1]
    ws.save(state)
    capsys.readouterr()
    # a resumed job runs its saved path even when the command line says
    # otherwise
    assert cli.run(["-i", inp, out, "--keep-workspace"] + JOB,
                   device="cpu") == 0
    err = capsys.readouterr().err
    assert "resuming: 1 segment(s) remaining" in err
    assert f"int8 turbo ({cert:.1f} dB certified)" in err
    assert ws.load_calibration() == saved
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("forced", [True, False])
def test_cli_auto_dtype_int8_only_where_eligible(tmp_path, monkeypatch,
                                                 capsys, small_calib_chunks,
                                                 forced):
    """--dtype auto follows the reference's rule: off the TPU, bfloat16
    without certification, unless REVE_TPU_AUTO_INT8 makes int8 eligible;
    then it certifies on the sampled frames and resolves int8 at >= 50
    dB."""
    monkeypatch.chdir(tmp_path)
    if forced:
        monkeypatch.setenv("REVE_TPU_AUTO_INT8", "1")
    else:
        monkeypatch.delenv("REVE_TPU_AUTO_INT8", raising=False)
    inp = _input(tmp_path)
    out = str(tmp_path / "out.y4m")
    auto = [a for a in JOB if a not in ("--dtype", "float32")]
    assert cli.run(["-i", inp, out, "--keep-workspace"] + auto,
                   device="cpu") == 0
    err = capsys.readouterr().err
    ws = Workspace(out + ".revework")
    res = ws.load_resolution()
    if forced:
        assert "auto dtype: int8 turbo (certified" in err
        assert res["dtype"] == "int8" and res["db"] >= 50.0
        assert res["db"] == ws.load_int8_cert()
        assert ws.load_calibration() is not None
    else:
        assert "auto dtype: bfloat16 (int8 turbo is TPU-only; backend " \
            "is cpu)" in err
        assert res == {"dtype": "bfloat16", "db": None}
        assert ws.load_int8_cert() is None
    assert ws.load().opts["dtype"] == res["dtype"]


def test_cli_refuses_to_resume_a_reve_tpu_workspace(tmp_path, monkeypatch,
                                                    capsys):
    """A workspace the JAX package started carries no port stamp: the
    port exits 2 instead of joining its segments to the other
    package's."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    out = str(tmp_path / "out.y4m")
    assert jcli.run(["-i", inp, out, "--keep-workspace"] + JOB) == 0
    os.unlink(out)
    capsys.readouterr()
    assert cli.run(["-i", inp, out] + JOB, device="cpu") == 2
    err = capsys.readouterr().err
    assert "started by another implementation" in err
    assert not os.path.exists(out)


@pytest.mark.parametrize("extra", [
    pytest.param(extra, id=f"extra{i}") for i, extra in (
        # (ids as before --tta, extra0, and --tile 64, extra5, left, and
        # realesrgan-x2plus in int8 and bf16, extra1 and extra9,
        # --denoise, extra3, and --scene-align, extra7: their features
        # are held by tests/test_torch_rrdb_x2.py, test_torch_weights.py
        # and test_torch_scenes.py; --lease-stale-after, extra2,
        # --shard-worker, extra4, and --device 0,1, extra6, are ported:
        # held below and by test_torch_leases.py, test_torch_parallel.py)
        (8, ["--compile-attempts", "2"]),)])
def test_unported_flags_exit_2(tmp_path, monkeypatch, capsys, extra):
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=1)
    out = str(tmp_path / "out.y4m")
    rc = cli.run(["-i", inp, "-s", "4", out, "--io-backend", "y4m",
                  "--allow-random-init", "--yes"] + extra, device="cpu")
    assert rc == 2
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1
    assert "not yet ported in reve_tpu_torch" in err or \
        "no counterpart" in err
    assert not os.path.exists(out + ".revework")


def test_image_input_exits_2(tmp_path, capsys):
    """Image mode is ported (tests/test_torch_image.py): an input that is
    not a decodable image exits 2 as reve_tpu's does, and writes no
    output."""
    img = tmp_path / "in.png"
    img.write_bytes(b"\x89PNG")
    rc = cli.run(["-i", str(img), "-s", "2", str(tmp_path / "o.png")],
                 device="cpu")
    assert rc == 2
    err = capsys.readouterr().err
    assert "cannot decode image" in err and "not yet ported" not in err
    assert not os.path.exists(tmp_path / "o.png")


def test_cli_raises_without_cuda(tmp_path, monkeypatch):
    """No --device, no device= and no CUDA: the job raises before any
    workspace exists; it never drifts onto the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = _input(tmp_path, frames=1)
    out = str(tmp_path / "out.y4m")
    with pytest.raises(device_mod.NoCudaDeviceError):
        cli.run(["-i", inp, "-s", "2", out, "--io-backend", "y4m",
                 "--allow-random-init", "--yes"])
    assert not os.path.exists(out + ".revework")


def test_existing_output_and_missing_weights_refused(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=1)
    out = tmp_path / "out.y4m"
    out.write_bytes(b"x")
    assert cli.run(["-i", inp, "-s", "2", str(out)], device="cpu") == 2
    assert "already exists" in capsys.readouterr().err
    monkeypatch.delenv("REVE_TPU_ALLOW_RANDOM_INIT", raising=False)
    rc = cli.run(["-i", inp, "-s", "2", str(tmp_path / "o2.y4m")],
                 device="cpu")
    assert rc == 2
    assert "--allow-random-init" in capsys.readouterr().err


def test_list_models(capsys):
    assert cli.run(["--list-models"]) == 0
    out = capsys.readouterr().out
    assert "realesr-animevideov3" in out
    rows = {ln.split()[0]: ln for ln in out.splitlines() if ln.strip()}
    # every registered model is ported, RRDB at x2 too
    for name in ("realesrgan-x4plus", "realesrgan-x4plus-anime",
                 "realesrnet-x4plus", "realesrgan-x2plus"):
        assert "[rrdb, x" in rows[name] and "(not ported)" not in rows[name]
    assert "[rrdb, x2]" in rows["realesrgan-x2plus"]


# -- several devices and shard workers --------------------------------------


@pytest.mark.usefixtures("jax_native_core")
def test_two_shard_worker_runs_write_the_one_job_bytes(tmp_path, monkeypatch,
                                                       capsys):
    """Two --shard-worker CLI runs on one workspace: the first starts the
    job, runs the one segment it can claim while another worker holds
    the other two leases, and leaves the output to the others; the second
    resumes it, runs the rest and finalizes.  The output is the port's
    one-worker job byte for byte and within 1 of reve_tpu's; no
    single-owner lock is taken and the shared workspace stays."""
    from reve_tpu_torch.pipeline import leases

    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    one = str(tmp_path / "one.y4m")
    assert cli.run(["-i", inp, one] + JOB, device="cpu") == 0
    ref = str(tmp_path / "jax.y4m")
    assert jcli.run(["-i", inp, ref] + JOB) == 0
    out = str(tmp_path / "out.y4m")
    ws = Workspace(out + ".revework")
    other = os.path.join(ws.root, leases.LEASES_DIR)
    os.makedirs(other)
    for i in (1,):
        with open(os.path.join(other, f"{i:06d}.lease"), "w") as f:
            f.write("w-other")
    capsys.readouterr()
    assert cli.run(["-i", inp, out, "--shard-worker", "w1",
                    "--lease-stale-after", "30"] + JOB, device="cpu") == 0
    err = capsys.readouterr().err
    assert "worker w1: 1 segment(s)" in err
    assert "other workers still running; not finalizing" in err
    assert not os.path.exists(out) and not os.path.exists(ws.owner_path)
    assert ws.completed_parts(".y4m") == [0]
    os.unlink(os.path.join(other, "000001.lease"))  # the other worker quit
    assert cli.run(["-i", inp, out, "--shard-worker", "w2"] + JOB,
                   device="cpu") == 0
    err = capsys.readouterr().err
    assert "worker w2: 1 segment(s)" in err and "\ndone: " in err
    with open(out, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()
    _assert_close_y4m(out, ref)
    with open(os.path.join(other, "finalize.lease")) as f:
        assert f.read() == "w2"
    assert os.path.isdir(ws.root)
    # a third worker finds the output written: reve_tpu's refusal
    assert cli.run(["-i", inp, out, "--shard-worker", "w3"] + JOB,
                   device="cpu") == 2
    assert "output path already exists" in capsys.readouterr().err


def test_shard_worker_loses_the_finalize_election(tmp_path, monkeypatch,
                                                  capsys):
    """A worker that finds every part committed but another finalizing
    exits 0 with reve_tpu's line and writes nothing."""
    from reve_tpu_torch.pipeline import leases

    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=3)
    out = str(tmp_path / "out.y4m")
    lease_dir = os.path.join(out + ".revework", leases.LEASES_DIR)
    os.makedirs(lease_dir)
    with open(os.path.join(lease_dir, "finalize.lease"), "w") as f:
        f.write("w-other")
    capsys.readouterr()
    assert cli.run(["-i", inp, out, "--shard-worker", "w1"] + JOB,
                   device="cpu") == 0
    err = capsys.readouterr().err
    assert "worker w1: 1 segment(s)" in err
    assert "another worker is finalizing; exiting" in err
    assert not os.path.exists(out)


def test_shard_worker_never_removes_the_shared_workspace_on_a_refusal(
        tmp_path, monkeypatch, capsys, small_calib_chunks):
    """An int8 gate refusal (exit 3) removes an unshared workspace with
    nothing committed, and leaves a shard worker's (its leases,
    calibration and siblings' parts are shared)."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=2)
    for extra, kept in (([], False), (["--shard-worker", "w1"], True)):
        out = str(tmp_path / f"out{len(extra)}.y4m")
        assert cli.run(["-i", inp, out, "--int8-gate", "200"] + INT8 + extra,
                       device="cpu") == 3
        assert "below --int8-gate" in capsys.readouterr().err
        assert os.path.isdir(out + ".revework") is kept


@pytest.mark.parametrize("extra,msg,count", [
    # reve_tpu's tests/test_cli.py cases and messages
    (["--device", "0,0"], "must be distinct", 8),
    (["--device", "0,junk"], "comma list", 8),
    (["--device", "0,99"], "out of range", 8),
    (["--device", "0,1,2"], "must be a multiple of the --device", 8),
    (["--device", "0,1"], "out of range", None),  # this host: no card
    (["--device", "0"], "out of range", None),
])
def test_device_lists_refused_with_reve_tpus_messages(tmp_path, monkeypatch,
                                                      capsys, extra, msg,
                                                      count):
    """--device refusals exit 2 before any workspace exists; a count of
    devices is patched where the case needs one."""
    if count is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=1)
    out = str(tmp_path / "o.y4m")
    rc = cli.run(["-i", inp, "-s", "2", out, "--yes", "--io-backend", "y4m",
                  "--allow-random-init"] + extra)
    assert rc == 2
    assert msg in capsys.readouterr().err
    assert not os.path.exists(out + ".revework")


def test_device_list_builds_a_mesh_of_those_cards(tmp_path, monkeypatch):
    """--device 0,1 builds a Mesh of cuda:0 and cuda:1 for the engine (the
    engine itself is stubbed: there is no card here)."""
    from reve_tpu_torch.pipeline import job as job_mod

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = {}

    def open_engine(ws, state, settings, device, *, mesh=None, **kw):
        seen.update(device=device, mesh=mesh, batch=kw["batch"])
        raise job_mod.JobRefused("stop here")

    monkeypatch.setattr(job_mod, "open_engine", open_engine)
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=1)
    assert cli.run(["-i", inp, str(tmp_path / "o.y4m"), "--device",
                    "0,1"] + JOB) == 2
    assert seen["device"] is None and seen["batch"] == 2
    assert [str(d) for d in seen["mesh"].devices] == ["cuda:0", "cuda:1"]


def test_api_mesh_writes_the_one_device_bytes(tmp_path, monkeypatch):
    from reve_tpu_torch import api
    from reve_tpu_torch.parallel.mesh import Mesh

    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    one = str(tmp_path / "one.y4m")
    kw = dict(weights=PTH, segment_size=3, batch=2, dtype="float32",
              io_backend="y4m")
    api.upscale_video(inp, one, 4, device="cpu", **kw)
    out = str(tmp_path / "mesh.y4m")
    rep = api.upscale_video(inp, out, 4, mesh=Mesh(("cpu", "cpu")), **kw)
    assert rep["dtype"] == "float32"
    with open(out, "rb") as a, open(one, "rb") as b:
        assert a.read() == b.read()


def test_api_mesh_refusals(tmp_path, monkeypatch):
    """device with mesh, a batch the mesh's dp does not divide (reve_tpu's
    message) and a CUDA device twice raise before any workspace."""
    from reve_tpu_torch import api
    from reve_tpu_torch.parallel.mesh import Mesh

    inp = _input(tmp_path, frames=1)
    o = str(tmp_path / "o.y4m")
    base = dict(allow_random_init=True, io_backend="y4m")
    with pytest.raises(ValueError, match="mutually exclusive"):
        api.upscale_video(inp, o, 4, device="cpu",
                          mesh=Mesh(("cpu", "cpu")), **base)
    with pytest.raises(ValueError, match=r"batch 3 must be a multiple of "
                                         r"the mesh's dp size \(2\)"):
        api.upscale_video(inp, o, 4, batch=3, mesh=Mesh(("cpu", "cpu")),
                          **base)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="must be distinct"):
        api.upscale_video(inp, o, 4, mesh=Mesh(("cuda:0", "cuda:0")),
                          **base)
    assert not os.path.exists(o + ".revework")
