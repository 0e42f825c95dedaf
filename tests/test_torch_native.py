"""The port's native container core (reve_tpu_torch/native.py over its own
copy of the C++ sources in reve_tpu_torch/_native/) against the JAX
package's (reve_tpu/native.py), on the inputs tests/test_native.py
builds: concat outputs (y4m, mp4, mkv) byte-identical, probes equal; its
build (keyed by a hash of the sources, safe when several processes start
it at once); and its wiring into io/concat.py and io/probe.py, where the
exact y4m probe replaces the parent's file-size division.

The C++ sources are copies, so everything here is exact.
"""

import fcntl
import fractions
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mp4_mutate
from reve_tpu import native as jnative
from reve_tpu_torch import native
from reve_tpu_torch.io import concat as concat_mod
from reve_tpu_torch.io import probe, reader, writer
from reve_tpu_torch.pipeline import planner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: how long ref_core waits for a build of reve_tpu's core that another
#: process runs
NATIVE_WAIT_S = 300.0


@pytest.fixture(scope="module")
def ref_core():
    """reve_tpu's native core, loaded in this process (it builds with
    `make` in the source tree on first use; the first load here holds a
    lock on its Makefile across processes, as tests/test_torch_cli.py's
    jax_native_core does)."""
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
    assert native.available(), "the port's native core did not build"
    return jnative


def _write_parts(tmp_path, sizes, w=64, h=48):
    """mp4v parts of a luma ramp (tests/test_native.py's _write_parts)."""
    import cv2

    parts, n = [], 0
    for i, count in enumerate(sizes):
        p = str(tmp_path / f"p{i}.mp4")
        wr = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 24, (w, h))
        for _ in range(count):
            wr.write(np.full((h, w, 3), 20 + n * 9, np.uint8))
            n += 1
        wr.release()
        parts.append(p)
    return parts


def _write_y4m_parts(tmp_path, sizes, w=32, h=16, bits=8):
    parts, shade = [], 0
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"y{i}.y4m")
        with writer.Y4MWriter(p, w, h, fractions.Fraction(24),
                              bits=bits) as wr:
            for _ in range(n):
                wr.write(np.full((h, w, 3), 16 + shade % 200, np.uint8))
                shade += 13
        parts.append(p)
    return parts


def _both(tmp_path, name, fn):
    """fn(core, out) with each package's core; both outputs' bytes."""
    outs = []
    for tag, core in (("port", native), ("ref", jnative)):
        out = str(tmp_path / f"{tag}_{name}")
        fn(core, out)
        outs.append(open(out, "rb").read())
    return outs


def test_the_port_loads_its_own_library():
    assert native.available()
    path = native.build_info["path"]
    assert path == native.lib_path()
    assert os.path.dirname(path) == os.path.join(REPO, "reve_tpu_torch",
                                                 "_native", "build")
    assert "reve_core.so" not in path
    # the sources are the JAX package's, byte for byte
    for name in native.SOURCES + native.HEADERS + ("test_main.cpp",):
        a = open(os.path.join(native._NATIVE_DIR, name), "rb").read()
        b = open(os.path.join(jnative._NATIVE_DIR, name), "rb").read()
        assert a == b, name


@pytest.mark.usefixtures("ref_core")
def test_planner_parity():
    for frames, seg in [(1, 1), (7, 3), (1000, 250), (1001, 250),
                        (1440, 1000), (999, 1000), (100, 7)]:
        want = [(s.start, s.size) for s in planner.plan_segments(frames,
                                                                 seg)]
        assert native.plan_segments(frames, seg) == want
        assert jnative.plan_segments(frames, seg) == want


@pytest.mark.usefixtures("ref_core")
@pytest.mark.parametrize("bits", [8, 10])
def test_concat_y4m_byte_identical(tmp_path, bits):
    parts = _write_y4m_parts(tmp_path, [3, 2, 4], bits=bits)
    a, b = _both(tmp_path, "all.y4m", lambda c, o: c.concat_y4m(parts, o))
    assert a == b
    expected = b""
    for i, p in enumerate(parts):
        data = open(p, "rb").read()
        expected += data if i == 0 else data[data.index(b"\n") + 1:]
    assert a == expected


@pytest.mark.usefixtures("ref_core")
@pytest.mark.parametrize("sizes", [[8, 8, 5], [10]])
def test_concat_mp4_byte_identical(tmp_path, sizes):
    parts = _write_parts(tmp_path, sizes)
    a, b = _both(tmp_path, "o.mp4",
                 lambda c, o: c.concat_mp4(parts, None, o))
    assert a == b
    info = native.probe_mp4(str(tmp_path / "port_o.mp4"))
    assert info == jnative.probe_mp4(str(tmp_path / "ref_o.mp4"))
    assert info["video_samples"] == sum(sizes)


@pytest.mark.usefixtures("ref_core")
def test_concat_with_a_subtitled_original_byte_identical(tmp_path):
    """The original's non-video track (a tx3g subtitle track added by
    mp4_mutate) remuxed into mp4 and mkv outputs, and an mkv original's
    tracks copied verbatim, by both cores alike."""
    base = _write_parts(tmp_path, [12])[0]
    subbed = str(tmp_path / "subbed.mp4")
    assert mp4_mutate.add_tx3g_track(
        base, subbed, [("Hello world", 1000), ("", 500), ("Second cue", 750)])
    (tmp_path / "parts").mkdir()
    parts = _write_parts(tmp_path / "parts", [3, 2])
    for ext, fn in ((".mp4", "concat_mp4"), (".mkv", "concat_mkv")):
        a, b = _both(tmp_path, "o" + ext,
                     lambda c, o: getattr(c, fn)(parts, subbed, o))
        assert a == b and b"Second cue" in a
    orig_mkv = str(tmp_path / "port_o.mkv")
    a, b = _both(tmp_path, "o2.mkv",
                 lambda c, o: c.concat_mkv(parts, orig_mkv, o))
    assert a == b
    info = native.probe_mkv(str(tmp_path / "port_o2.mkv"))
    assert info == jnative.probe_mkv(str(tmp_path / "ref_o2.mkv"))
    assert info["n_tracks"] == 2 and info["video_blocks"] == 5


@pytest.mark.usefixtures("ref_core")
def test_concat_mkv_video_only_byte_identical(tmp_path):
    parts = _write_parts(tmp_path, [8, 8, 5])
    a, b = _both(tmp_path, "o.mkv",
                 lambda c, o: c.concat_mkv(parts, None, o))
    assert a == b
    info = native.probe_mkv(str(tmp_path / "port_o.mkv"))
    assert info == jnative.probe_mkv(str(tmp_path / "ref_o.mkv"))
    assert info["video_blocks"] == 21 and info["has_audio"] is False


def _y4m_with_frame_params(path, n=3, w=8, h=4):
    """A y4m whose FRAME markers carry parameters (legal y4m; the
    port's writer never writes them)."""
    frame = bytes(range(w * h + 2 * (w // 2) * (h // 2)))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C420\n".encode())
        for i in range(n):
            f.write(b"FRAME Ixyz X=comment-" + str(i).encode() + b"\n")
            f.write(frame)
    return path


def _y4m_raw(path, w, h, chroma, n=3):
    """n frames of a y4m whose chroma planes are sized per plane, as
    ffmpeg writes them: ceil(w/2) x ceil(h/2) at 420, w x h at 444."""
    cw, ch = ((w + 1) // 2, (h + 1) // 2) if chroma.startswith("420") \
        else (w, h)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F30000:1001 C{chroma}\n".encode())
        for i in range(n):
            f.write(b"FRAME\n" + bytes([i]) * (w * h + 2 * cw * ch))
    return path


@pytest.mark.usefixtures("ref_core")
def test_y4m_probe_walks_frame_markers(tmp_path):
    """FRAME parameters, torn tails, odd dimensions and other chroma
    layouts: the native walk counts the complete frames, equal to the
    reference's core.  The parent's probe (the Python reader, a file-size
    division checked by one stride, else a walk) counts the first two
    right, but sizes a 4:2:0 frame as w*h*3/2, which is wrong at odd
    dimensions, and refuses chroma other than 4:2:0."""
    params = _y4m_with_frame_params(str(tmp_path / "params.y4m"))
    (torn,) = _write_y4m_parts(tmp_path, [3])
    with open(torn, "rb+") as f:
        f.truncate(os.path.getsize(torn) - 10)
    (marker,) = _write_y4m_parts(tmp_path / "..", [2])
    with open(marker, "ab") as f:
        f.write(b"FRA")
    odd = _y4m_raw(str(tmp_path / "odd.y4m"), 5, 3, "420jpeg")
    c444 = _y4m_raw(str(tmp_path / "c444.y4m"), 4, 2, "444")
    for path, frames in ((params, 3), (torn, 2), (marker, 2), (odd, 3),
                         (c444, 3)):
        got = native.probe_y4m(path)
        assert got == jnative.probe_y4m(path)
        assert got["frames"] == frames
        assert probe.probe(path).frame_count == frames
    assert probe.probe(odd).fps == fractions.Fraction(30000, 1001)
    # the parent's route
    for path in (params, torn, marker):
        assert reader.Y4MReader(path).frame_count() == \
            native.probe_y4m(path)["frames"]
    assert reader.Y4MReader(odd).frame_count() != 3
    with pytest.raises(ValueError, match="420"):
        reader.Y4MReader(c444)


@pytest.mark.usefixtures("ref_core")
def test_bad_inputs_rejected_alike(tmp_path):
    bad = str(tmp_path / "bad.y4m")
    with open(bad, "wb") as f:
        f.write(b"\x00" * 200)
    for core in (native, jnative):
        with pytest.raises(core.NativeError):
            core.probe_y4m(bad)
        with pytest.raises(core.NativeError):
            core.concat_y4m([bad], str(tmp_path / "o.y4m"))
        with pytest.raises(core.NativeError):
            core.concat_mp4([str(tmp_path / "nope.mp4")], None,
                            str(tmp_path / "o.mp4"))
    parts = _write_y4m_parts(tmp_path, [2])
    other = _write_y4m_parts(tmp_path / "..", [1], w=64)
    with pytest.raises(native.NativeError, match="geometry mismatch"):
        native.concat_y4m(parts + other, str(tmp_path / "o.y4m"))


def test_io_concat_routes_to_native(tmp_path):
    """io/concat.py's chain: y4m, mp4 and mkv outputs through the core
    (backend "native"); the y4m bytes are the parts' stream copy."""
    ys = _write_y4m_parts(tmp_path, [2, 3])
    out = str(tmp_path / "out.y4m")
    rep = concat_mod.concatenate(ys, "", out, fractions.Fraction(24),
                                 backend="y4m")
    assert rep == {"backend": "native", "audio_copied": False}
    assert reader.Y4MReader(out).frame_count() == 5
    mp4s = _write_parts(tmp_path, [4, 4])
    for ext, count in ((".mp4", "video_samples"), (".mkv", "video_blocks")):
        o = str(tmp_path / ("out" + ext))
        rep = concat_mod.concatenate(mp4s, "missing.bin", o,
                                     fractions.Fraction(24))
        assert rep == {"backend": "native", "audio_copied": False}
        fn = native.probe_mp4 if ext == ".mp4" else native.probe_mkv
        assert fn(o)[count] == 8
    # the mkv probe counts the blocks natively
    assert probe.probe(str(tmp_path / "out.mkv")).frame_count == 8


def test_io_concat_falls_back_without_the_core(tmp_path, monkeypatch):
    """With the core unavailable, y4m parts take the Python stream copy
    (the same bytes); a mismatched part is still refused."""
    ys = _write_y4m_parts(tmp_path, [2, 3])
    out = str(tmp_path / "native.y4m")
    concat_mod.concatenate(ys, "", out, fractions.Fraction(24))
    monkeypatch.setattr(native, "available", lambda: False)
    out2 = str(tmp_path / "py.y4m")
    rep = concat_mod.concatenate(ys, "", out2, fractions.Fraction(24))
    assert rep == {"backend": "y4m", "audio_copied": False}
    assert open(out, "rb").read() == open(out2, "rb").read()
    with pytest.raises(RuntimeError, match="unusable"):
        concat_mod.concatenate(ys, "", out2, fractions.Fraction(24),
                               backend="native")


def test_frame_ring_and_counters():
    ring = native.FrameRing(frame_bytes=48, capacity=4)
    frames = [np.arange(48, dtype=np.uint8) + i for i in range(10)]
    got = []

    def consumer():
        buf = np.empty(48, np.uint8)
        while ring.pop(buf, timeout_ms=2000) == 0:
            got.append(buf.copy())

    t = threading.Thread(target=consumer)
    t.start()
    for f in frames:
        assert ring.push(f) == 0
    ring.close()
    t.join(timeout=5)
    assert [g.tolist() for g in got] == [f.tolist() for f in frames]
    with pytest.raises(ValueError):
        native.FrameRing(frame_bytes=8, capacity=0)
    lib = native.load()
    c = lib.rc_counters_create(3)
    lib.rc_counter_add(c, 0, 5)
    lib.rc_counter_add(c, 2, 1)
    assert [lib.rc_counter_get(c, i) for i in range(3)] == [5, 0, 1]
    lib.rc_counters_destroy(c)


_BUILD = """
import sys
sys.path.insert(0, {repo!r})
from reve_tpu_torch import native
native._NATIVE_DIR = {src!r}
native.BUILD_DIR = {build!r}
lib = native.load()
assert lib is not None
print(native.build_info["path"], native.build_info["cached"])
"""


def test_build_is_keyed_and_safe_under_six_workers(tmp_path):
    """Six processes started together on an empty build directory load
    one library, built once (the others wait on the lock and find it);
    an edited source gets a library of its own name."""
    src = tmp_path / "src"
    shutil.copytree(native._NATIVE_DIR, src,
                    ignore=shutil.ignore_patterns("build"))
    build = tmp_path / "build"
    code = _BUILD.format(repo=REPO, src=str(src), build=str(build))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=600)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len({o[0] for o in outs}) == 1
    assert sorted(o[1] for o in outs) == ["False"] + ["True"] * 5
    assert sorted(os.listdir(build)) == sorted(
        ["build.lock", os.path.basename(outs[0][0])])
    with open(src / "core.cpp", "a") as f:
        f.write("\n// edited\n")
    edited = subprocess.run([sys.executable, "-c", code], check=True,
                            capture_output=True, text=True).stdout.split()
    assert edited[0] != outs[0][0] and edited[1] == "False"
