"""The port's training path (reve_tpu_torch/train, kernels/train.py,
srvgg.apply_float) held against reve_tpu's on the CPU.

Small SRVGGs (8-16 features, 1-2 hidden convs, x2, x3 and x4; and the
training kernels' other widths, 32 and 96 features, at one hidden conv)
with params
drawn by reve_tpu's init and inputs from numpy seeds go through both
packages: the JAX functions as its own tests run them (Trainer on
mesh_lib.make_mesh(jax.devices()), s2d on), the port through the plain
versions of T1-T3 (CPU tensors).  Tolerances: the float forward rtol
1e-5; the loss and each gradient leaf rtol 1e-4 (atol 1e-5 of the leaf's
largest value: float32 sums in other orders); three optimizer steps'
losses rtol 1e-5 and params atol 1e-6; data batches identical.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reve_tpu.io import writer as jwriter
from reve_tpu.models import srvgg as jsrvgg
from reve_tpu.parallel import mesh as mesh_lib
from reve_tpu.train import data as jdata
from reve_tpu.train import distill as jdistill
from reve_tpu.train import trainer as jtrainer
from reve_tpu.weights import torch_loader as jloader
from reve_tpu_torch.device import NoCudaDeviceError
from reve_tpu_torch.kernels import train as ktrain
from reve_tpu_torch.models import registry, srvgg
from reve_tpu_torch.train import checkpoint, data, distill, losses, trainer
from reve_tpu_torch.weights import torch_loader

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(feat, conv, r):
    return (jsrvgg.SRVGGConfig(num_feat=feat, num_conv=conv, upscale=r),
            srvgg.SRVGGConfig(num_feat=feat, num_conv=conv, upscale=r))


def _jax_params(cfg, seed):
    return jsrvgg.init_params(jax.random.key(seed), cfg)


def _pair(seed, b, h, w, r):
    rs = np.random.RandomState(seed)
    return (rs.rand(b, h, w, 3).astype(np.float32),
            rs.rand(b, h * r, w * r, 3).astype(np.float32))


def _jax_leaves(tree):
    """reve_tpu params (or grads) in the port's leaf order."""
    out = []
    for i, c in enumerate(tree["convs"]):
        out += [c["w"], c["b"]]
        if i < len(tree["prelus"]):
            out.append(tree["prelus"][i]["alpha"])
    return [np.asarray(t) for t in out]


def _port_leaves(params):
    return [t.detach().numpy() for t in trainer.leaves(params)]


def _zero_channel(tree, layer, ch):
    """reve_tpu params with conv `layer`'s output channel `ch` zeroed (w
    and b): that layer's z is exactly 0 there at every pixel."""
    convs = [dict(c) for c in tree["convs"]]
    convs[layer] = {"w": convs[layer]["w"].at[..., ch].set(0.0),
                    "b": convs[layer]["b"].at[ch].set(0.0)}
    return {"convs": convs, "prelus": tree["prelus"]}


@pytest.mark.parametrize("feat,conv,r", [(8, 1, 2), (16, 2, 4)])
def test_apply_float_matches_jax(feat, conv, r):
    cj, ct = _cfgs(feat, conv, r)
    pj = _jax_params(cj, 3)
    lr, _ = _pair(1, 2, 10, 14, r)
    want = np.asarray(jsrvgg.apply(pj, lr, cfg=cj,
                                   compute_dtype=jnp.float32))
    got = srvgg.apply_float(srvgg.params_from_jax(pj), torch.from_numpy(lr),
                            cfg=ct)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("loss,r", [("charbonnier", 2), ("l1", 4)])
def test_loss_and_gradients_match_jax(loss, r):
    cj, ct = _cfgs(8, 2, r)
    # hidden conv 1's channel 3 is exactly 0: its PReLU' there is
    # (1 + alpha) / 2, and d(alpha) gets nothing from it
    pj = _zero_channel(_jax_params(cj, 4), 1, 3)
    lr, hr = _pair(2, 2, 8, 12, r)
    lj, gj = jax.value_and_grad(jtrainer.loss_fn)(pj, lr, hr, cfg=cj,
                                                  loss=loss)
    pt = trainer.params_on(srvgg.params_from_jax(pj), "cpu", True)
    lt = trainer.loss_fn(pt, torch.from_numpy(lr), torch.from_numpy(hr),
                         cfg=ct, loss=loss)
    gt = torch.autograd.grad(lt, trainer.leaves(pt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
    for want, got in zip(_jax_leaves(gj), gt):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())
    # the zeroed channel still learns: dz there is dy (1 + alpha) / 2
    assert np.abs(_jax_leaves(gj)[6][..., 3]).max() > 0


def test_prelu_derivative_at_zero_is_jaxs():
    alpha = jnp.float32(0.25)
    d_jax = jax.grad(lambda z: jnp.maximum(z, 0) + alpha * jnp.minimum(
        z, 0))(jnp.float32(0.0))
    dy = torch.ones(1, 1, 1, 1)
    z = torch.zeros(1, 1, 1, 1)
    d = ktrain.prelu_grad_plain(dy, z, torch.tensor([0.25]))
    assert float(d) == float(d_jax) == 0.625


def test_conv_stack_plain_backward_passes_gradcheck():
    """T2's and T3's plain versions are the vjp of T1's: the Function on
    the plain versions against finite differences, in float64, on a
    3-conv stack (so T2 runs with a PReLU on each side)."""
    g = torch.Generator().manual_seed(0)
    chans = [(3, 4), (4, 5), (5, 12)]
    flat = []
    for i, (ci, co) in enumerate(chans):
        flat.append(torch.randn(3, 3, ci, co, generator=g,
                                dtype=torch.float64) * 0.3)
        flat.append(torch.randn(co, generator=g, dtype=torch.float64) * 0.1)
        if i < len(chans) - 1:
            flat.append(torch.rand(co, generator=g, dtype=torch.float64))
    for t in flat:
        t.requires_grad_(True)
    x = torch.randn(2, 5, 6, 3, generator=g, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda *f: ktrain._ConvStack.apply(x, True, *f), flat, eps=1e-6,
        atol=1e-6, rtol=1e-5)


def test_conv_stack_refuses_an_input_gradient_and_other_widths():
    cfg = srvgg.SRVGGConfig(num_feat=8, num_conv=1, upscale=2)
    p = srvgg.init_params(cfg)
    x = torch.rand(1, 4, 4, 3, requires_grad=True)
    with pytest.raises(ValueError, match="no gradient for its input"):
        ktrain.conv_stack(x, p)
    for cin, cout in ((8, 8), (1, 64), (40, 40), (64, 32), (32, 64)):
        with pytest.raises(ValueError, match=ktrain.WIDTHS_ITEM):
            ktrain.check_channels(cin, cout)
    ktrain.check_channels(3, 48)


def test_check_channels_takes_exactly_the_srvgg_pairs_and_todays():
    """The 9 pairs of before (Cin 3, 64, 128 x Cout 48, 64, 128) and every
    conv of an SRVGG at 32, 64, 96 or 128 features and x2, x3 or x4:
    conv_first (3, F), hidden (F, F), head (F, 3 r^2).  Every other pair
    of counts up to 130 raises, naming the ROADMAP item."""
    want = {(ci, co) for ci in (3, 64, 128) for co in (48, 64, 128)}
    for f in (32, 64, 96, 128):
        want |= {(3, f), (f, f)} | {(f, 3 * r * r) for r in (2, 3, 4)}
    assert len(want) == 23
    took = set()
    for cin in range(1, 131):
        for cout in range(1, 131):
            try:
                ktrain.check_channels(cin, cout)
                took.add((cin, cout))
            except ValueError as e:
                assert ktrain.WIDTHS_ITEM in str(e)
    assert took == want
    # every conv of each such SRVGG is a pair the kernels take
    for f in (32, 64, 96, 128):
        for r in (2, 3, 4):
            cfg = srvgg.SRVGGConfig(num_feat=f, num_conv=2, upscale=r)
            for c in srvgg.init_params(cfg)["convs"]:
                ktrain.check_channels(*c["w"].shape[2:])


@pytest.mark.parametrize("tc_kw", [
    {"learning_rate": 1e-3},                      # clip at 1.0, EMA 0.999
    {"learning_rate": 1e-3, "grad_clip": 1e-3},   # the clip fires
    {"learning_rate": 1e-3, "weight_decay": 1e-2, "ema_decay": 0.5},
    {"learning_rate": 1e-3, "loss": "l1", "ema_decay": 0.0},
], ids=["default", "clip", "weight_decay", "l1_no_ema"])
def test_trainer_steps_match_jax(tc_kw):
    cj, ct = _cfgs(8, 1, 2)
    _steps_match_jax(cj, ct, _jax_params(cj, 5), *_pair(3, 4, 8, 8, 2),
                     tc_kw)


@pytest.mark.parametrize("feat,r", [(8, 3), (32, 2), (96, 3), (32, 4)])
def test_trainer_steps_match_jax_at_other_scales_and_widths(feat, r):
    """Three steps at x3 (the head's 27 outputs) and x2 (12), and at the
    training kernels' 32 and 96 features: losses, params and the EMA as
    at x2 and 8 features, at TrainConfig's own learning rate (1e-4; the
    wider convs' gradients hold more elements a few float32 roundings
    from 0, whose Adam steps of up to about lr differ)."""
    cj, ct = _cfgs(feat, 1, r)
    _steps_match_jax(cj, ct, _jax_params(cj, 10 + feat + r),
                     *_pair(11 + r, 4, 8, 6, r), {})


def _steps_match_jax(cj, ct, pj, lr, hr, tc_kw):
    """Three Trainer steps of both packages from params `pj` on (lr, hr):
    each loss rtol 1e-5, the params and the EMA atol 1e-6 (see below), and
    the PSNR after."""
    jt = jtrainer.Trainer(cj, jtrainer.TrainConfig(**tc_kw),
                          mesh=mesh_lib.make_mesh(jax.devices()), params=pj)
    tt = trainer.Trainer(ct, trainer.TrainConfig(**tc_kw),
                         params=srvgg.params_from_jax(pj), device="cpu")
    if "grad_clip" in tc_kw:
        loss0 = trainer.loss_fn(tt.params, torch.from_numpy(lr),
                                torch.from_numpy(hr), cfg=ct)
        grads = torch.autograd.grad(loss0, trainer.leaves(tt.params))
        assert float(torch.sqrt(sum((g * g).sum() for g in grads))) > \
            tc_kw["grad_clip"]
    # Adam moves an element by about lr a step whatever its gradient's
    # size, so an element whose gradient is at float32's noise level (below
    # 1e-6 of its leaf's largest: the two packages sum it in other orders,
    # and its sign may differ) is only held to the 3 lr the steps can move
    # it; every other element to atol 1e-6
    noisy = [np.zeros(t.shape, bool) for t in _jax_leaves(jt.params)]
    for _ in range(3):
        _, gj = jax.value_and_grad(jtrainer.loss_fn)(
            jt.params, lr, hr, cfg=cj, loss=jt.tc.loss)
        for m, g in zip(noisy, _jax_leaves(gj)):
            m |= np.abs(g) < 1e-6 * np.abs(g).max()
        np.testing.assert_allclose(tt.step(lr, hr), jt.step(lr, hr),
                                   rtol=1e-5)
    # at most 2 such elements, or 1 in 1000 of a wider model's
    assert sum(m.sum() for m in noisy) <= max(
        2, sum(m.size for m in noisy) // 1000)
    pairs = [(jt.params, tt.params)]
    if jt.ema_params is None:
        assert tt.ema_params is None
    else:
        pairs.append((jt.export_params(), tt.export_params()))
    for tree_j, tree_t in pairs:
        for want, got, m in zip(_jax_leaves(tree_j), _port_leaves(tree_t),
                                noisy):
            np.testing.assert_allclose(got[~m], want[~m], rtol=0, atol=1e-6)
            np.testing.assert_allclose(got[m], want[m], rtol=0,
                                       atol=3 * jt.tc.learning_rate)
    np.testing.assert_allclose(tt.eval_psnr(lr, hr), jt.eval_psnr(lr, hr),
                               rtol=1e-5)


def test_trainer_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is cuda:0")
    cfg = srvgg.SRVGGConfig(num_feat=8, num_conv=1, upscale=2)
    with pytest.raises(NoCudaDeviceError):
        trainer.Trainer(cfg)


@pytest.mark.parametrize("hr_weight", [0.0, 0.3])
def test_distiller_matches_jax(hr_weight):
    _distiller_matches_jax(16, 8, 2, hr_weight, 1e-3, strict=True)


@pytest.mark.parametrize("student,r", [(32, 3), (96, 2), (8, 3)])
def test_distiller_matches_jax_at_other_scales_and_widths(student, r):
    """A 16-feature teacher into students of the training kernels' 32 and
    96 features and an 8-feature one, at x2 and x3: as at x2 above, at
    TrainConfig's own learning rate (1e-4: see the trainer's test at these
    widths), an element whose gradient is at float32's noise level held as
    the trainer's tests hold it."""
    _distiller_matches_jax(16, student, r, 0.0, 1e-4, strict=False)


def _distiller_matches_jax(teacher, student, r, hr_weight, learning_rate,
                           strict):
    """Two steps of both packages' Distillers: teacher targets, PSNRs and
    losses rtol 1e-5; the student's params atol 1e-6, every element with
    `strict`, else those whose gradient stays above float32's noise
    level."""
    tj, tt = _cfgs(teacher, 2, r)
    sj, st = _cfgs(student, 1, r)
    tp = _jax_params(tj, 6)
    mesh = mesh_lib.make_mesh(jax.devices())
    tc = dict(learning_rate=learning_rate)
    jd = jdistill.Distiller(tj, tp, sj, tc=jtrainer.TrainConfig(**tc),
                            mesh=mesh, seed=7)
    pd = distill.Distiller(tt, srvgg.params_from_jax(tp), st,
                           tc=trainer.TrainConfig(**tc), device="cpu",
                           student_params=srvgg.params_from_jax(
                               _jax_params(sj, 7)))
    lr, hr = _pair(4, 4, 8, 10, r)
    np.testing.assert_allclose(pd.teacher_targets(lr).numpy(),
                               np.asarray(jd.teacher_targets(lr)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pd.agreement_psnr(lr), jd.agreement_psnr(lr),
                               rtol=1e-5)
    # as in _steps_match_jax: an element whose gradient is at float32's
    # noise level in some step is held to the 2 lr a step by which the two
    # packages' Adam steps can differ, every other element to atol 1e-6
    noisy = [np.zeros(t.shape, bool) for t in _jax_leaves(jd.trainer.params)]
    for _ in range(2):
        target = (1 - hr_weight) * jd.teacher_targets(lr) + hr_weight * hr
        _, gj = jax.value_and_grad(jtrainer.loss_fn)(
            jd.trainer.params, lr, target, cfg=sj, loss=jd.trainer.tc.loss)
        for m, g in zip(noisy, _jax_leaves(gj)):
            m |= np.abs(g) < 1e-6 * np.abs(g).max()
        np.testing.assert_allclose(
            pd.step(lr, hr, hr_weight=hr_weight),
            jd.step(lr, hr, hr_weight=hr_weight), rtol=1e-5)
    assert sum(m.sum() for m in noisy) <= max(
        2, sum(m.size for m in noisy) // 1000)
    if strict:
        noisy = [np.zeros_like(m) for m in noisy]
    for want, got, m in zip(_jax_leaves(jd.trainer.params),
                            _port_leaves(pd.trainer.params), noisy):
        np.testing.assert_allclose(got[~m], want[~m], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[m], want[m], rtol=0,
                                   atol=4 * learning_rate)
    np.testing.assert_allclose(pd.agreement_psnr(lr), jd.agreement_psnr(lr),
                               rtol=1e-5)
    dc = distill.DistillConfig(steps=2, log_every=0)
    hist = distill.run_distillation(pd, iter([(lr, None)] * 3), dc)
    assert len(hist) == 2 and all(np.isfinite(hist))


def _write_y4m(path, n, h, w, seed=0):
    rs = np.random.RandomState(seed)
    frames = rs.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    with jwriter.Y4MWriter(str(path), w, h, 24) as wr:
        for f in frames:
            wr.write(f)
    return frames


def test_patch_pairs_and_video_batches_are_identical(tmp_path):
    path = tmp_path / "clip.y4m"
    frames = _write_y4m(path, 12, 40, 48)
    kw = dict(scale=2, patch=16, batch=3, noise_std=0.02, seed=3)
    pairs_j = list(jdata.patch_pairs_from_frames(iter(frames),
                                                 jdata.DataConfig(**kw)))
    pairs_t = list(data.patch_pairs_from_frames(iter(frames),
                                                data.DataConfig(**kw)))
    assert len(pairs_t) == len(pairs_j) == 48
    for (a, b), (c, d) in zip(pairs_t, pairs_j):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    got = list(data.batches_from_video(str(path), data.DataConfig(**kw),
                                       frame_stride=2))
    want = list(jdata.batches_from_video(str(path), jdata.DataConfig(**kw),
                                         frame_stride=2))
    assert len(got) == len(want) == 8
    for (a, b), (c, d) in zip(got, want):
        assert a.dtype == c.dtype and b.dtype == d.dtype
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_realesrgan_degradation_is_refused():
    cfg = data.DataConfig(pipeline="realesrgan")
    with pytest.raises(NotImplementedError, match=data.GAN_ITEM):
        data.degrade(np.zeros((8, 8, 3), np.float32), cfg,
                     np.random.RandomState(0))


def _small_trainer(seed, **tc_kw):
    cfg = srvgg.SRVGGConfig(num_feat=8, num_conv=1, upscale=2)
    return trainer.Trainer(cfg, trainer.TrainConfig(learning_rate=1e-3,
                                                    **tc_kw),
                           seed=seed, device="cpu")


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    lr, hr = _pair(5, 4, 8, 8, 2)
    t1 = _small_trainer(5)
    for _ in range(3):
        t1.step(lr, hr)
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    checkpoint.save(str(tmp_path / "ck"), t1, step=1)
    checkpoint.save(str(tmp_path / "ck"), t1, step=3)
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 3
    loss4 = t1.step(lr, hr)
    t2 = _small_trainer(99)
    assert checkpoint.restore(str(tmp_path / "ck"), t2) == 3
    assert t2.step(lr, hr) == loss4
    for a, b in zip(_port_leaves(t1.params), _port_leaves(t2.params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_port_leaves(t1.ema_params), _port_leaves(t2.ema_params)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_tolerates_the_ema_key_both_ways(tmp_path):
    lr, hr = _pair(6, 4, 8, 8, 2)
    no_ema = _small_trainer(5, ema_decay=0.0)
    no_ema.step(lr, hr)
    checkpoint.save(str(tmp_path / "old"), no_ema, step=1)
    with_ema = _small_trainer(99, ema_decay=0.9)
    checkpoint.restore(str(tmp_path / "old"), with_ema)
    for a, b in zip(_port_leaves(no_ema.params),
                    _port_leaves(with_ema.ema_params)):
        np.testing.assert_array_equal(a, b)
    with_ema.step(lr, hr)
    checkpoint.save(str(tmp_path / "new"), with_ema, step=2)
    again = _small_trainer(98, ema_decay=0.0)
    assert checkpoint.restore(str(tmp_path / "new"), again) == 2
    assert again.ema_params is None
    for a, b in zip(_port_leaves(with_ema.params), _port_leaves(again.params)):
        np.testing.assert_array_equal(a, b)
    wrong = trainer.Trainer(srvgg.SRVGGConfig(num_feat=16, num_conv=1,
                                              upscale=2), device="cpu")
    with pytest.raises(ValueError, match="shapes"):
        checkpoint.restore(str(tmp_path / "new"), wrong)


def test_srvgg_pth_passes_between_packages(tmp_path):
    cj, ct = _cfgs(8, 2, 4)
    pj = _jax_params(cj, 8)
    # the port's file in reve_tpu's loader
    torch_loader.save_srvgg_pth(str(tmp_path / "port.pth"), ct,
                                srvgg.params_from_jax(pj))
    cfg_j, back_j = jloader.load_srvgg_pth(str(tmp_path / "port.pth"))
    assert (cfg_j.num_feat, cfg_j.num_conv, cfg_j.upscale) == (8, 2, 4)
    for a, b in zip(_jax_leaves(back_j), _jax_leaves(pj)):
        np.testing.assert_array_equal(a, b)
    # reve_tpu's file in the port's loader
    jloader.save_srvgg_pth(str(tmp_path / "jax.pth"), cj, pj)
    cfg_t, back_t = torch_loader.load_srvgg_pth(str(tmp_path / "jax.pth"))
    assert cfg_t == ct
    for a, b in zip(_port_leaves(back_t), _jax_leaves(pj)):
        np.testing.assert_array_equal(a, b)
    # and the two files hold the same state dict
    sd_t = torch.load(str(tmp_path / "port.pth"))["params"]
    sd_j = torch.load(str(tmp_path / "jax.pth"))["params"]
    assert sorted(sd_t) == sorted(sd_j)
    for k in sd_t:
        assert torch.equal(sd_t[k], sd_j[k])


@pytest.mark.parametrize("feat,conv,r", [(32, 1, 2), (96, 2, 3),
                                          (64, 1, 3)])
def test_srvgg_pth_at_other_scales_and_widths(tmp_path, feat, conv, r):
    """The .pth at x2 and x3 and at 32 and 96 features: the port's file
    loads in reve_tpu's loader and through the port's registry (the name's
    scale and the file's agreeing), both to the params it holds."""
    cj, ct = _cfgs(feat, conv, r)
    pj = _jax_params(cj, 20 + r)
    path = str(tmp_path / f"m-x{r}.pth")
    torch_loader.save_srvgg_pth(path, ct, srvgg.params_from_jax(pj))
    cfg_j, back_j = jloader.load_srvgg_pth(path)
    assert (cfg_j.num_feat, cfg_j.num_conv, cfg_j.upscale) == (feat, conv, r)
    cfg_t, back_t = registry.load_model(f"realesr-animevideov3-x{r}", r,
                                        weights=path)
    assert cfg_t == ct
    for a, b, c in zip(_jax_leaves(back_j), _port_leaves(back_t),
                       _jax_leaves(pj)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_distill_script_defaults_with_an_x2_teacher(tmp_path, monkeypatch):
    """reve_tpu's distillation defaults -- the x2 teacher, the 128-feature
    student, batch 8, patch 64 -- through the port's script on the CPU,
    the teacher a random-init 64 x 16 x2 .pth drawn by reve_tpu's init;
    the student cut to 1 conv and the steps to 2 to keep the CPU's time
    small.  The student's .pth loads back through the registry at x2, and
    its params are the exported ones."""
    from reve_tpu_torch.scripts import distill as script

    monkeypatch.chdir(tmp_path)  # no ./models: the teacher is the flag's
    monkeypatch.delenv("REVE_TPU_ALLOW_RANDOM_INIT", raising=False)
    monkeypatch.delenv("REVE_TPU_MODELS_DIR", raising=False)
    cj, ct = _cfgs(64, 16, 2)
    teacher = str(tmp_path / "teacher-x2.pth")
    torch_loader.save_srvgg_pth(teacher, ct, srvgg.params_from_jax(
        _jax_params(cj, 30)))
    dest = str(tmp_path / "student.pth")
    res = script.main(["--teacher-weights", teacher, "--student-conv", "1",
                       "--steps", "2", "--out", dest, "--device", "cpu"])
    assert len(res["history"]) == 2 and all(np.isfinite(res["history"]))
    assert np.isfinite(res["agreement_db"])
    cfg, params = registry.load_model("realesr-animevideov3", 2,
                                      weights=dest)
    assert (cfg.num_feat, cfg.num_conv, cfg.upscale) == (128, 1, 2)
    cfg_j, params_j = jloader.load_srvgg_pth(dest)
    assert (cfg_j.num_feat, cfg_j.upscale) == (128, 2)
    for a, b in zip(_port_leaves(params), _jax_leaves(params_j)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("out", ["student.pth", "student.ckpt"])
def test_distill_script_on_the_cpu(tmp_path, monkeypatch, out):
    from reve_tpu_torch.scripts import distill as script

    monkeypatch.chdir(ROOT)  # ./models holds the shipped teacher
    monkeypatch.delenv("REVE_TPU_ALLOW_RANDOM_INIT", raising=False)
    monkeypatch.delenv("REVE_TPU_MODELS_DIR", raising=False)
    dest = str(tmp_path / out)
    res = script.main(["--teacher", "realesr-animevideov3-x4",
                       "--student-feat", "64", "--student-conv", "1",
                       "--steps", "2", "--batch", "2", "--patch", "12",
                       "--out", dest, "--device", "cpu"])
    assert len(res["history"]) == 2 and np.isfinite(res["agreement_db"])
    if out.endswith(".pth"):
        cfg, params = registry.load_model("realesr-animevideov3", 4,
                                          weights=dest)
        assert (cfg.num_feat, cfg.num_conv, cfg.upscale) == (64, 1, 4)
    else:
        assert checkpoint.latest_step(dest) == 2


def test_psnr_matches_jax():
    a, b = _pair(9, 1, 6, 6, 1)
    from reve_tpu.train import losses as jlosses

    np.testing.assert_allclose(
        float(losses.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jlosses.psnr(a, b)), rtol=1e-6)
