"""The port's CLI (reve_tpu_torch.cli) against the JAX package's on a
hermetic y4m job: 6 frames of 24x32, x4, segments of 3, batches of 2,
float32, the shipped x4 weights.

Both outputs are 10-bit 4:2:0 y4m files (the parts' yuv420p10le
encode), compared sample by sample in the file's own units: |dsample| <=
1.  (The two packages' float32 u8 frames may differ by 1 where an
accumulation-order difference meets a rounding boundary; on this job they
agree exactly.)
"""

import fractions
import os

import numpy as np
import pytest
import torch

from reve_tpu import cli as jcli
from reve_tpu_torch import cli, device as device_mod
from reve_tpu_torch.io import reader, writer
from reve_tpu_torch.pipeline.state import Workspace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTH = os.path.join(REPO, "models", "realesr-animevideov3-x4.pth")
JOB = ["-s", "4", "--io-backend", "y4m", "--weights", PTH, "-S", "3",
       "--batch", "2", "--dtype", "float32", "--yes"]


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


def _assert_close_y4m(got_path, want_path):
    gh, gbits, got = _samples(got_path)
    wh, wbits, want = _samples(want_path)
    assert gh == wh and gbits == wbits
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        d = np.abs(g - w)
        assert d.max() <= 1, (i, d.max())


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


@pytest.mark.parametrize("extra", [
    ["--tta"], ["--dtype", "int8"], ["--int8-gate", "50"],
    ["--denoise", "0.5"], ["--shard-worker", "w0"], ["--tile", "64"],
    ["--device", "0,1"], ["--scene-align"], ["--compile-attempts", "2"],
    ["--model", "realesrgan-x4plus"],
])
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
    img = tmp_path / "in.png"
    img.write_bytes(b"\x89PNG")
    rc = cli.run(["-i", str(img), "-s", "2", str(tmp_path / "o.png")],
                 device="cpu")
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err


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
    assert "realesrgan-x4plus" in out and "(not ported)" in out
