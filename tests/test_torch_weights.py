"""ncnn .param/.bin weights and dni weight interpolation in the port
(reve_tpu_torch.weights.ncnn and .interpolate, the registry's weight
resolution, `--weights x.param`, `--denoise` / `--weights-wdn` through
the CLI, their resume, and the API) against the JAX package on the same
files, on the CPU.

ncnn files are built from params with tests/test_weights.py's
make_ncnn_srvgg (the layout realesrgan-ncnn-vulkan's models use), so no
weights are downloaded; the shipped models/realesr-animevideov3-x4.pth
gives trained weights.

Tolerances, each with its reason:
  * parsed params: identical to reve_tpu.weights.ncnn's (both widen the
    same fp16 or float32 bytes to float32 with numpy);
  * interpolate / load_dni: identical to reve_tpu's ((1 - d) * a + d * b,
    each step rounded to float32 on both sides);
  * the CLI jobs (float32): 10-bit samples |d| <= 1, as
    tests/test_torch_cli.py holds the hermetic job (the convs sum in
    another order); a job against the port's own jobs: byte-identical.
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu import api as japi
from reve_tpu import cli as jcli
from reve_tpu.models import registry as jregistry
from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.weights import interpolate as jinterp
from reve_tpu.weights import ncnn as jncnn
from reve_tpu.weights.torch_loader import load_srvgg_pth as jload_pth
from reve_tpu.weights.torch_loader import save_srvgg_pth as jsave_pth
from reve_tpu_torch import cli, upscale_video
from reve_tpu_torch.models import registry, srvgg
from reve_tpu_torch.pipeline.state import Workspace
from reve_tpu_torch.weights import interpolate, ncnn
from test_torch_cli import (JOB, PTH, _assert_close_y4m, _input,
                            jax_native_core)  # noqa: F401
from test_weights import make_ncnn_srvgg

torch.set_num_threads(2)


def _small(seed=42, upscale=3):
    cfg = jsrvgg.SRVGGConfig(num_conv=2, num_feat=8, upscale=upscale)
    return cfg, jsrvgg.init_params(jax.random.key(seed), cfg)


def _assert_params_equal(got, want):
    """The port's params (torch) equal reve_tpu's (jax) bit for bit."""
    assert len(got["convs"]) == len(want["convs"])
    assert len(got["prelus"]) == len(want["prelus"])
    for g, w in zip(got["convs"], want["convs"]):
        for k in ("w", "b"):
            assert g[k].dtype == torch.float32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    for g, w in zip(got["prelus"], want["prelus"]):
        np.testing.assert_array_equal(g["alpha"].numpy(),
                                      np.asarray(w["alpha"]))


def _write(tmp_path, stem, param_text, bin_data):
    par = str(tmp_path / f"{stem}.param")
    with open(par, "w") as f:
        f.write(param_text)
    with open(par[:-6] + ".bin", "wb") as f:
        f.write(bin_data)
    return par


# -- the parser ---------------------------------------------------------------


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
def test_ncnn_params_equal_jax_parsers(fp16):
    cfg, params = _small()
    param_text, bin_data = make_ncnn_srvgg(cfg, params, fp16=fp16)
    net = ncnn.load_srvgg(param_text, bin_data)
    jnet = jncnn.load_srvgg(param_text, bin_data)
    assert (net.upscale, net.num_feat, net.num_conv) == \
        (jnet.upscale, jnet.num_feat, jnet.num_conv) == (3, 8, 2)
    cfg2, params2 = ncnn.to_params(net)
    jcfg2, jparams2 = jncnn.to_params(jnet)
    assert cfg2 == srvgg.SRVGGConfig(num_conv=2, num_feat=8, upscale=3)
    assert cfg2.__dict__ == jcfg2.__dict__
    _assert_params_equal(params2, jparams2)


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
def test_ncnn_of_the_shipped_model_rounds_as_jax(tmp_path, fp16):
    """The shipped x4 model written as ncnn files: fp32 tags give its
    weights exactly, fp16 tags the fp16-rounded ones (np.float16 ->
    float32), in both packages; load_files reads the pair."""
    jcfg, jparams = jload_pth(PTH)
    par = _write(tmp_path, "m", *make_ncnn_srvgg(jcfg, jparams, fp16=fp16))
    cfg, params = ncnn.load_files(par, par[:-6] + ".bin")
    jcfg2, jparams2 = jncnn.load_files(par, par[:-6] + ".bin")
    assert cfg.__dict__ == jcfg2.__dict__ == jcfg.__dict__
    _assert_params_equal(params, jparams2)
    for g, w in zip(params["convs"], jparams["convs"]):
        w = np.asarray(w["w"])
        want = w.astype(np.float16).astype(np.float32) if fp16 else w
        np.testing.assert_array_equal(g["w"].numpy(), want)


def _quant_table_net(tag):
    """A 2-hidden-conv SRVGG whose first conv's weights are stored as u8
    indices into a 256-entry float32 table under `tag`, the rest float32."""
    cfg, params = _small(seed=3, upscale=2)
    param_text, _ = make_ncnn_srvgg(cfg, params, fp16=False)
    rs = np.random.RandomState(4)
    table = rs.uniform(-0.5, 0.5, 256).astype("<f4")
    parts = []
    convs, prelus = params["convs"], params["prelus"]
    for i, c in enumerate(convs):
        w = np.transpose(np.asarray(c["w"]), (3, 2, 0, 1))
        if i == 0:
            idx = rs.randint(0, 256, w.size).astype(np.uint8)
            parts += [struct.pack("<I", tag), table.tobytes(), idx.tobytes(),
                      b"\0" * (-w.size % 4)]
        else:
            parts += [struct.pack("<I", 0), w.astype("<f4").tobytes()]
        parts.append(np.asarray(c["b"]).astype("<f4").tobytes())
        if i < len(prelus):
            parts.append(np.asarray(prelus[i]["alpha"]).astype("<f4")
                         .tobytes())
    return param_text, b"".join(parts)


def test_ncnn_u8_quant_table_parses_as_jax():
    param_text, bin_data = _quant_table_net(0x00000002)
    cfg, params = ncnn.to_params(ncnn.load_srvgg(param_text, bin_data))
    jcfg, jparams = jncnn.to_params(jncnn.load_srvgg(param_text, bin_data))
    assert cfg.__dict__ == jcfg.__dict__
    _assert_params_equal(params, jparams)
    assert np.unique(params["convs"][0]["w"].numpy()).size > 100


@pytest.mark.parametrize("case", ["magic", "truncated", "int8", "one_conv"])
def test_ncnn_errors_match_jax(case):
    cfg, params = _small()
    param_text, bin_data = make_ncnn_srvgg(cfg, params, fp16=False)
    err = ValueError
    if case == "magic":
        param_text = "7767518" + param_text[7:]
    elif case == "truncated":
        bin_data = bin_data[:-40]
    elif case == "int8":
        param_text, bin_data = _quant_table_net(0x000D4B38)
        err = NotImplementedError
    else:
        lines = param_text.splitlines()
        param_text = "\n".join(["7767517", "2 2", lines[2], lines[3]])
    for mod in (ncnn, jncnn):
        with pytest.raises(err) as e:
            mod.load_srvgg(param_text, bin_data)
        msg = str(e.value)
    with pytest.raises(err, match=msg.split(":")[0][:20]):
        ncnn.load_srvgg(param_text, bin_data)


# -- interpolate and load_dni -------------------------------------------------


def _twin(params, seed=5):
    """params with every conv weight perturbed by a seeded 5% (numpy)."""
    rs = np.random.RandomState(seed)
    out = jax.tree_util.tree_map(np.asarray, params)
    for c in out["convs"]:
        c["w"] = (c["w"] * (1 + 0.05 * rs.standard_normal(c["w"].shape))
                  ).astype(np.float32)
    return out


def _to_torch(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


@pytest.mark.parametrize("d", [0.0, 0.3, 0.5, 1.0])
def test_interpolate_matches_jax(d):
    _cfg, params = _small()
    twin = _twin(params)
    got = interpolate.interpolate(_to_torch(twin), _to_torch(params), d)
    want = jinterp.interpolate(jax.tree_util.tree_map(jnp.asarray, twin),
                               params, d)
    _assert_params_equal(got, want)
    # the direction: d = 1 is the plain model, d = 0 the wdn twin
    if d in (0.0, 1.0):
        src = params if d else twin
        _assert_params_equal(got, jax.tree_util.tree_map(jnp.asarray, src))


def test_interpolate_errors_match_jax():
    _cfg, params = _small()
    a = _to_torch(params)
    for d in (-0.1, 1.5):
        for fn, p in ((interpolate.interpolate, a), (jinterp.interpolate,
                                                     params)):
            with pytest.raises(ValueError, match=r"must be in \[0,1\]"):
                fn(p, p, d)
    _cfg, other = _small(upscale=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        interpolate.interpolate(a, _to_torch(other), 0.5)
    with pytest.raises(ValueError, match="shape mismatch"):
        jinterp.interpolate(params, other, 0.5)


def test_load_dni_matches_jax(tmp_path):
    jcfg, jparams = jload_pth(PTH)
    wdn = str(tmp_path / "wdn.pth")
    jsave_pth(wdn, jcfg, _twin(jparams))
    cfg, got = interpolate.load_dni(wdn, PTH, 0.5)
    jcfg2, want = jinterp.load_dni(wdn, PTH, 0.5)
    assert cfg.__dict__ == jcfg2.__dict__
    _assert_params_equal(got, want)
    other = str(tmp_path / "x2.pth")
    scfg, sparams = _small(upscale=2)
    jsave_pth(other, scfg, sparams)
    for fn in (interpolate.load_dni, jinterp.load_dni):
        with pytest.raises(ValueError, match="config mismatch"):
            fn(other, PTH, 0.5)


# -- the registry -------------------------------------------------------------


def test_registry_loads_ncnn_as_jax(tmp_path, monkeypatch):
    """An explicit .param (or its .bin) loads the ncnn pair; in a models
    dir a .pth wins over a .param + .bin of the same stem, in both
    packages; an ncnn file named for an RRDB model is refused (explicit)
    or passed over (search path), as reve_tpu's RRDB loader reads .pth
    only."""
    monkeypatch.chdir(tmp_path)
    jcfg, jparams = jload_pth(PTH)
    d = tmp_path / "m"
    d.mkdir()
    par = _write(d, "realesr-animevideov3-x4",
                 *make_ncnn_srvgg(jcfg, jparams, fp16=True))
    for w in (par, par[:-6] + ".bin"):
        cfg, params = registry.load_model("realesr-animevideov3", 4,
                                          weights=w)
        jcfg2, jparams2 = jregistry.load_model("realesr-animevideov3", 4,
                                               weights=w)
        assert cfg.__dict__ == jcfg2.__dict__
        _assert_params_equal(params, jparams2)
    assert registry.resolve_weights("realesr-animevideov3", 4, [str(d)]) \
        == jregistry.resolve_weights("realesr-animevideov3", 4,
                                     [str(d)]) == par
    jsave_pth(str(d / "realesr-animevideov3-x4.pth"), jcfg, jparams)
    assert registry.resolve_weights("realesr-animevideov3", 4, [str(d)]) \
        == str(d / "realesr-animevideov3-x4.pth")
    with pytest.raises(ValueError, match="x4 but x2 was requested"):
        registry.load_model("realesr-animevideov3", 2, weights=par)
    with pytest.raises(ValueError, match="ncnn.*RRDBNet"):
        registry.load_model("realesrgan-x4plus", 4, weights=par)
    _write(d, "RealESRGAN_x4plus", *make_ncnn_srvgg(jcfg, jparams))
    monkeypatch.setenv("REVE_TPU_MODELS_DIR", str(d))
    monkeypatch.delenv("REVE_TPU_ALLOW_RANDOM_INIT", raising=False)
    for reg in (registry, jregistry):
        with pytest.raises(reg.MissingWeightsError):
            reg.load_model("realesrgan-x4plus", 4)


# -- the CLI and API jobs -----------------------------------------------------


@pytest.fixture
def ncnn_param(tmp_path):
    jcfg, jparams = jload_pth(PTH)
    return _write(tmp_path, "m", *make_ncnn_srvgg(jcfg, jparams,
                                                  fp16=True))


@pytest.fixture
def wdn_pth(tmp_path):
    jcfg, jparams = jload_pth(PTH)
    path = str(tmp_path / "wdn.pth")
    jsave_pth(path, jcfg, _twin(jparams))
    return path


def _job(weights, *extra):
    """JOB with its --weights replaced."""
    job = list(JOB)
    job[job.index(PTH)] = weights
    return job + list(extra)


@pytest.mark.usefixtures("jax_native_core")
def test_cli_ncnn_weights_job_matches_jax_cli(tmp_path, monkeypatch,
                                              ncnn_param):
    """--weights x.param (fp16 tags) through both CLIs, sample for
    sample; -m DIR holding only the .param + .bin resolves the same
    weights; the API with weights=x.param writes the CLI's bytes."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    want, got = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want] + _job(ncnn_param)) == 0
    assert cli.run(["-i", inp, got] + _job(ncnn_param), device="cpu") == 0
    _assert_close_y4m(got, want)
    d = tmp_path / "dir"
    d.mkdir()
    _write(d, "realesr-animevideov3-x4", open(ncnn_param).read(),
           open(ncnn_param[:-6] + ".bin", "rb").read())
    by_dir = str(tmp_path / "dir.y4m")
    job = [a for a in JOB if a not in ("--weights", PTH)]
    assert cli.run(["-i", inp, by_dir, "-m", str(d)] + job,
                   device="cpu") == 0
    api_out = str(tmp_path / "api.y4m")
    upscale_video(inp, api_out, 4, weights=ncnn_param, segment_size=3,
                  batch=2, dtype="float32", io_backend="y4m", device="cpu")
    for other in (by_dir, api_out):
        with open(other, "rb") as a, open(got, "rb") as b:
            assert a.read() == b.read()


@pytest.mark.usefixtures("jax_native_core")
def test_cli_denoise_job_matches_jax_cli(tmp_path, monkeypatch, wdn_pth):
    """--denoise 0.5 with --weights-wdn through both CLIs, sample for
    sample; it differs from the plain job, and equals the port's engine
    on the interpolated params (its state saves the three settings)."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    dn = ["--weights-wdn", wdn_pth, "--denoise", "0.5"]
    want, got = str(tmp_path / "jax.y4m"), str(tmp_path / "torch.y4m")
    assert jcli.run(["-i", inp, want] + JOB + dn) == 0
    assert cli.run(["-i", inp, got, "--keep-workspace"] + JOB + dn,
                   device="cpu") == 0
    _assert_close_y4m(got, want)
    opts = Workspace(got + ".revework").load().opts
    assert (opts["weights"], opts["weights_wdn"], opts["denoise"]) == \
        (PTH, wdn_pth, 0.5)
    plain = str(tmp_path / "plain.y4m")
    assert cli.run(["-i", inp, plain] + JOB, device="cpu") == 0
    with open(plain, "rb") as a, open(got, "rb") as b:
        assert a.read() != b.read()


def test_cli_denoise_resume_restores_its_weights(tmp_path, monkeypatch,
                                                 capsys, wdn_pth):
    """A crashed --denoise job (segment 1 of 2 not committed) resumes from
    a command line without the denoise flags: the saved --weights-wdn and
    --denoise come back (said on stderr), and the output is
    byte-identical to the uninterrupted run.  The API, which has no
    denoise argument, refuses to resume it, as reve_tpu's does."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path)
    dn = ["--weights-wdn", wdn_pth, "--denoise", "0.5"]
    full = str(tmp_path / "full.y4m")
    assert cli.run(["-i", inp, full] + JOB + dn, device="cpu") == 0
    out = str(tmp_path / "out.y4m")
    assert cli.run(["-i", inp, out, "--keep-workspace"] + JOB + dn,
                   device="cpu") == 0
    os.unlink(out)
    ws = Workspace(out + ".revework")
    state = ws.load()
    os.unlink(ws.part_path(1, ".y4m"))
    state.pending = [s for s in state.plan if s.index == 1]
    ws.save(state)
    with pytest.raises(ValueError, match="started with --denoise"):
        upscale_video(inp, out, 4, weights=PTH, segment_size=3, batch=2,
                      dtype="float32", io_backend="y4m", device="cpu")
    with pytest.raises(ValueError, match="started with --denoise"):
        japi.upscale_video(inp, out, 4, weights=PTH, segment_size=3,
                           batch=2, dtype="float32", io_backend="y4m",
                           workspace=out + ".revework")
    capsys.readouterr()
    assert cli.run(["-i", inp, out] + JOB, device="cpu") == 0
    err = capsys.readouterr().err
    assert "resuming: 1 segment(s) remaining" in err
    assert "using saved --denoise=0.5" in err
    with open(out, "rb") as a, open(full, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("case", ["no_wdn", "scale"])
def test_cli_denoise_refusals_match_jax(tmp_path, monkeypatch, capsys,
                                        wdn_pth, case):
    """--denoise without --weights-wdn, and --denoise weights of another
    scale than -s: exit 2 with reve_tpu's message in both CLIs."""
    monkeypatch.chdir(tmp_path)
    inp = _input(tmp_path, frames=1)
    if case == "no_wdn":
        extra, msg = ["--denoise", "0.5"], \
            "--denoise requires --weights and --weights-wdn"
        job = JOB
    else:
        extra, msg = ["--weights-wdn", wdn_pth, "--denoise", "0.5"], \
            "--denoise weights are x4 but -s 2 was requested"
        job = [a if a != "4" else "2" for a in JOB]
    for i, run in enumerate((lambda a: jcli.run(a),
                             lambda a: cli.run(a, device="cpu"))):
        capsys.readouterr()
        assert run(["-i", inp, str(tmp_path / f"o{i}.y4m")] + job
                   + extra) == 2
        assert msg in capsys.readouterr().err
