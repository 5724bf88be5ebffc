"""The port's trainer against the JAX package: three train steps of the tiny
ADM from the same weights, batch, timesteps, weights and JAX's noise, with
microbatches, the learning-rate anneal, clipping and EMA; the loss-aware
resampler's state machine; checkpoints and resume; the loop's toy runs
(tests/test_train_loop.py's, with the CI hook and SIGTERM); dropout by
module mode and the loaders' eval mode; the native and PIL data paths.

Tolerances. loss and grad_norm to 1e-5 relative; gradients to 1e-4 of
their largest value (f32, two frameworks' summation orders). Params and EMA
within 1e-6 after the three steps, except entries whose gradient lies
within 1e-4 of the largest one of 0 at some step: Adam's first updates are
about lr * sign(g), and such a gradient may take either sign in either
framework. Those entries are counted, bounded (at most 2% of all), and must
stay within the 2 * lr * steps a sign flip can move them."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from loco_edit_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from loco_edit_tpu.training import resample as jrs
from loco_edit_tpu.training import trainer as jtr
from loco_edit_tpu_torch.core.rng import RngStream
from loco_edit_tpu_torch.diffusion.schedule import NoiseSchedule
from loco_edit_tpu_torch.models.convert_util import flax_to_state_dict
from loco_edit_tpu_torch.training import (LossSecondMomentResampler, TrainConfig,
                                          UniformSampler, create_train_state,
                                          make_train_step)
from loco_edit_tpu_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                                     save_checkpoint)
from loco_edit_tpu_torch.training.loop import run_training
from _torch_port_utils import JaxDraws, _lecun_params, flat_params, tiny_pair

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-6
STEPS = 3
CFG = dict(lr=1e-4, ema_rate=0.9, microbatches=2, lr_anneal_steps=5, max_grad_norm=0.05)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def steps():
    """Both packages' states and metrics after each of STEPS steps, the
    gradients each step applied, and the port's gradients as its optimizer
    received them."""
    jm, params, tm = tiny_pair()
    sched = JaxSchedule.linear()
    apply_fn = lambda p, x, t: jm.apply(p, x, t.astype(jnp.float32))  # noqa: E731
    jcfg = jtr.TrainConfig(**CFG)
    jstep = jax.jit(jtr.make_train_step(apply_fn, jcfg, sched))
    ab = jnp.asarray(sched.alphas_cumprod, jnp.float32)

    jgrad = jax.jit(lambda p, x0, t, w, key: jax.grad(
        lambda q: jtr.eps_mse_loss(apply_fn, q, x0, t, w, key, ab)[0])(p))

    def jgrads(p, x0, t, w, rng):       # the step's averaged gradient
        gs = [jgrad(p, x0[2 * i:2 * i + 2], t[2 * i:2 * i + 2], w[2 * i:2 * i + 2],
                    jax.random.fold_in(rng, i)) for i in range(2)]
        return jax.tree.map(lambda a, b: (a + b) / 2, *gs)

    rng = np.random.default_rng(0)
    x0 = np.tanh(rng.normal(size=(4, 32, 32, 3))).astype(np.float32)
    t = np.array([5, 250, 600, 990], np.int32)
    w = np.array([1.0, 0.5, 2.0, 1.0], np.float32)

    cfg = TrainConfig(**CFG)
    state = create_train_state(dict(tm.named_parameters()), cfg)
    step = make_train_step(tm, cfg, NoiseSchedule.linear())
    seen = []
    inner = state.opt_state.step

    def capture(params, grads, grad_norm):
        seen.append({k: g.clone() for k, g in zip(params, grads)})
        inner(params, grads, grad_norm)

    state.opt_state.step = capture
    jstate = jtr.create_train_state(params, jcfg)
    out = []
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.key(1), i)
        jg = flax_to_state_dict(flat_params(jgrads(jstate.params, x0, t, w, key)))
        jstate, jmet = jstep(jstate, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(w), key)
        state, met = step(state, torch.from_numpy(x0), torch.from_numpy(t).long(),
                          torch.from_numpy(w), JaxDraws(key))
        out.append(dict(jmet=jmet, met=met, jgrads=jg, grads=seen[-1],
                        jparams=flax_to_state_dict(flat_params(jstate.params)),
                        jema=flax_to_state_dict(flat_params(jstate.ema_params)),
                        params={k: v.detach().clone() for k, v in state.params.items()},
                        ema={k: v.clone() for k, v in state.ema_params.items()}))
    return out, state, tm


def test_train_step_loss_grad_norm_and_gradients(steps):
    out, state, tm = steps
    assert state.step == STEPS
    for s in out:
        assert _rel(s["met"]["loss"], s["jmet"]["loss"]) <= LOSS_RTOL
        assert _rel(s["met"]["grad_norm"], s["jmet"]["grad_norm"]) <= LOSS_RTOL
        assert _rel(s["met"]["per_timestep_losses"], s["jmet"]["per_timestep_losses"]) <= LOSS_RTOL
        assert set(s["grads"]) == set(s["jgrads"])
        top = max(float(g.abs().max()) for g in s["jgrads"].values())
        worst = max(float((s["grads"][k] - g).abs().max()) for k, g in s["jgrads"].items())
        assert worst <= GRAD_RTOL * top, worst / top
        # the configuration clips: the norm is above max_grad_norm
        assert float(s["met"]["grad_norm"]) > CFG["max_grad_norm"]
    # the model's own weights are left as the trainer found them in mode and flags
    assert not tm.training and not any(p.requires_grad for p in tm.parameters())


def test_train_step_params_and_ema_within_adam_sign(steps):
    out, _, _ = steps
    near_zero = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in out[0]["params"].items()}
    for s in out:
        top = max(float(g.abs().max()) for g in s["jgrads"].values())
        for k, g in s["jgrads"].items():
            near_zero[k] |= g.abs() <= GRAD_RTOL * top
    last = out[-1]
    total = sum(v.numel() for v in near_zero.values())
    flipped = 0
    for name in ("params", "ema"):
        ref = last["j" + name]
        for k, v in last[name].items():
            d = (v - ref[k]).abs()
            far = d[~near_zero[k]]
            assert far.numel() == 0 or float(far.max()) <= PARAM_ATOL, (name, k)
            assert float(d.max()) <= 2 * CFG["lr"] * STEPS + PARAM_ATOL
            flipped += int((d > PARAM_ATOL).sum())
    assert flipped <= 0.02 * total, (flipped, total)
    moved = sum(int(((last["params"][k] - v).abs() > 1e-7).sum())
                for k, v in out[0]["jparams"].items())
    assert moved > 0


def test_bf16_model_trains_f32_masters():
    """A bf16 model: the masters stay f32, the model's bf16 weights are the
    masters rounded, and a step moves the masters by ~lr where bf16 would
    round the update away."""
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.adm.presets import tiny_test_config

    tm = ADMUNet(tiny_test_config(dtype=torch.bfloat16)).init_random_(
        torch.Generator().manual_seed(0))
    cfg = TrainConfig(lr=1e-4)
    state = create_train_state(dict(tm.named_parameters()), cfg)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    x0 = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    make_train_step(tm, cfg, NoiseSchedule.linear())(
        state, x0, torch.tensor([10, 500]), torch.ones(2), RngStream.from_seed(2))
    name = "input_1.res_0.in_conv.weight"
    assert state.params[name].dtype == torch.float32
    assert dict(tm.named_parameters())[name].dtype == torch.bfloat16
    step = (state.params[name] - before[name]).abs()
    assert 0.5e-4 < float(step.median()) <= 1.01e-4


def test_resampler_weights_and_update_equal_jax():
    kw = dict(num_timesteps=6, history_per_term=3, uniform_prob=0.01)
    s, js = LossSecondMomentResampler(**kw), jrs.LossSecondMomentResampler(**kw)
    st, jst = s.init_state(), js.init_state()
    rng = np.random.default_rng(0)
    for _ in range(6):      # repeats within a batch, rows past full
        t = rng.integers(0, 6, 8)
        losses = rng.gamma(2.0, size=8).astype(np.float32)
        st = s.update(st, torch.from_numpy(t), torch.from_numpy(losses))
        jst = js.update(jst, jnp.asarray(t), jnp.asarray(losses))
        np.testing.assert_array_equal(st["history"].numpy(), np.asarray(jst["history"]))
        np.testing.assert_array_equal(st["counts"].numpy(), np.asarray(jst["counts"]))
        np.testing.assert_allclose(s._weights(st).numpy(), np.asarray(js._weights(jst)),
                                   rtol=1e-6)
    assert s._warmed_up(st)


def test_samplers_draw_through_a_generator():
    t, w = UniformSampler(1000).sample(RngStream.from_seed(0), 64)
    assert t.shape == (64,) and bool(((t >= 0) & (t < 1000)).all())
    assert bool((w == 1).all())
    s = LossSecondMomentResampler(num_timesteps=10, history_per_term=2)
    st = s.init_state()
    t, w = s.sample(RngStream.from_seed(1), 32, st)
    np.testing.assert_allclose(w.numpy(), 1.0, rtol=1e-5)
    for _ in range(2):
        ts = torch.arange(10)
        st = s.update(st, ts, torch.where(ts == 3, 100.0, 0.01))
    t, w = s.sample(RngStream.from_seed(2), 4096, st)
    assert float((t == 3).float().mean()) > 0.5
    assert float(w.min()) < 0.5
    t2, _ = s.sample(RngStream.from_seed(2), 4096, st)
    assert torch.equal(t, t2)


class Toy(torch.nn.Module):
    """eps = x * w (tests/test_train_loop.py's toy)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x, t):
        return x * self.w


def _data(batch=16, sigterm_at=None):
    rng = np.random.default_rng(0)
    i = 0
    while True:
        i += 1
        if i == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)
        yield rng.normal(size=(batch, 8, 8, 3)).astype(np.float32), None


def test_checkpoint_roundtrip_and_keep(tmp_path):
    cfg = TrainConfig(lr=1e-2, lr_anneal_steps=10)
    model = Toy()
    state = create_train_state(dict(model.named_parameters()), cfg)
    step = make_train_step(model, cfg, NoiseSchedule.linear())
    x0 = torch.randn(4, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    ck = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(ck, state)
    assert latest_step(ck) is None
    for i in range(5):
        state, _ = step(state, x0, torch.full((4,), 300), torch.ones(4), RngStream.from_seed(i))
        save_checkpoint(ck, state, extra={"note": "toy"})
    assert latest_step(ck) == 5
    assert sorted(os.listdir(ck)) == ["3", "4", "5"]
    fresh = restore_checkpoint(ck, create_train_state(dict(Toy().named_parameters()), cfg))
    assert fresh.step == 5
    assert torch.equal(fresh.params["w"], state.params["w"])
    assert torch.equal(fresh.ema_params["w"], state.ema_params["w"])
    a, b = fresh.opt_state.state_dict(), state.opt_state.state_dict()
    assert a["anneal"] == b["anneal"]
    assert torch.equal(a["adamw"]["state"][0]["exp_avg"], b["adamw"]["state"][0]["exp_avg"])
    # the restored state continues exactly as the original
    s1, _ = step(state, x0, torch.full((4,), 300), torch.ones(4), RngStream.from_seed(9))
    s2, _ = step(fresh, x0, torch.full((4,), 300), torch.ones(4), RngStream.from_seed(9))
    assert torch.equal(s1.params["w"], s2.params["w"])


def test_loop_runs_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    state = run_training(Toy(), _data(), cfg=TrainConfig(lr=1e-2), total_steps=6,
                         log_interval=2, save_interval=3, ckpt_dir=ck, seed=1, device="cpu")
    assert state.step == 6 and latest_step(ck) == 6
    state2 = run_training(Toy(), _data(), cfg=TrainConfig(lr=1e-2), total_steps=8,
                          log_interval=2, save_interval=4, ckpt_dir=ck, seed=1, device="cpu")
    assert state2.step == 8
    with open(os.path.join(ck, "progress.jsonl")) as f:
        rows = f.read()
    assert '"loss_q' in rows and '"grad_norm"' in rows


def test_loss_aware_loop():
    state = run_training(Toy(), _data(), cfg=TrainConfig(lr=1e-2), total_steps=4,
                         log_interval=10, save_interval=100, ckpt_dir=None,
                         loss_aware=True, seed=2, device="cpu")
    assert state.step == 4


def test_training_test_env_hook(monkeypatch):
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    state = run_training(Toy(), _data(), cfg=TrainConfig(lr=1e-2), total_steps=100,
                         ckpt_dir=None, seed=3, device="cpu")
    assert state.step == 1


def test_sigterm_saves_and_stops(tmp_path):
    ck = str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGTERM)
    state = run_training(Toy(), _data(sigterm_at=3), cfg=TrainConfig(lr=1e-2),
                         total_steps=100, save_interval=1000, ckpt_dir=ck, seed=4,
                         device="cpu")
    assert state.step == 3 and latest_step(ck) == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_run_training_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(Toy(), _data(), cfg=TrainConfig(), total_steps=1)


@pytest.mark.parametrize("family", ["adm", "ddpm"])
def test_dropout_by_mode_and_loaders_in_eval(tmp_path, monkeypatch, family):
    """A dropout-0.3 tiny ADM and DDPM: dropout acts in training mode only;
    loaded through the port's loaders (eval mode), eps is the same on two
    calls and equals JAX's train=False output."""
    import dataclasses

    x = np.random.default_rng(1).normal(size=(1, 32, 32, 3)).astype(np.float32)
    if family == "adm":
        from loco_edit_tpu.models.adm import ADMUNet as JNet
        from loco_edit_tpu.models.adm.presets import tiny_test_config as jtiny
        from loco_edit_tpu_torch.models import registry
        from loco_edit_tpu_torch.models.adm.presets import tiny_test_config

        jm = JNet(jtiny(dropout=0.3))
        monkeypatch.setattr(registry, "adm_preset",
                            lambda name, dtype: tiny_test_config(dtype=dtype, dropout=0.3))
        load = lambda path: registry.load_adm_denoiser("TinyDrop", path, device="cpu")  # noqa
    else:
        from loco_edit_tpu.models.ddpm.unet import DDPMConfig as JCfg
        from loco_edit_tpu.models.ddpm.unet import DDPMUNet as JNet
        from loco_edit_tpu_torch.models.ddpm import loader
        from test_torch_ddpm import TINY

        jm = JNet(dataclasses.replace(JCfg(**TINY), dropout=0.3))
        monkeypatch.setitem(loader.DDPM_PRESETS, "TinyDrop", dict(TINY, dropout=0.3))
        load = lambda path: loader.load_ddpm_denoiser("TinyDrop", path, device="cpu")  # noqa
    params = jax.tree.map(lambda p: p + 0.02,
                          _lecun_params(jm, 0, jnp.zeros((1, 32, 32, 3)), 500.0))
    path = str(tmp_path / "w.npz")
    np.savez(path, **flat_params(params))
    den = load(path)
    model = den.meta["model"]
    assert not model.training
    e1, e2 = den.eps_fn(torch.from_numpy(x), 500.0), den.eps_fn(torch.from_numpy(x), 500.0)
    assert torch.equal(e1, e2)
    want = jax.jit(lambda z: jm.apply(params, z, 500.0))(x)
    assert _rel(e1, want) <= GRAD_RTOL
    model.train()
    with torch.no_grad():
        d1, d2 = model(torch.from_numpy(x), 500.0), model(torch.from_numpy(x), 500.0)
    assert float((d1 - d2).abs().max()) > 1e-3


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i, (size, fmt) in enumerate([((80, 64), "PNG"), ((123, 77), "JPEG"),
                                     ((300, 250), "JPEG"), ((64, 64), "PNG")]):
        arr = rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
        Image.fromarray(arr).save(str(d / f"c{i % 2}_{i}.{fmt.lower()}"), format=fmt,
                                  quality=95)
    return str(d)


@pytest.mark.parametrize("use_native", [True, False])
def test_loader_batches_equal_jax(images, use_native):
    from loco_edit_tpu import native as jnative
    from loco_edit_tpu.training.data import ShardedImageLoader as JLoader
    from loco_edit_tpu_torch.training.data import ShardedImageLoader

    if use_native and not jnative.available():
        pytest.skip("native pipeline could not build in this environment")
    kw = dict(batch_size=2, image_size=32, class_cond=True, seed=5, use_native=use_native)
    mine = ShardedImageLoader(images, device="cpu", **kw)
    assert mine.decoder == ("native" if use_native else "pil")
    ref = JLoader(images, process_index=0, process_count=1, **kw)
    for (a, la), (b, lb) in zip(iter(mine), iter(ref)):
        assert a.dtype == torch.float32 and a.shape == (2, 32, 32, 3)
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(la.numpy(), lb)
        if la is not None and lb is not None:
            break
    shard = ShardedImageLoader(images, device="cpu", process_index=1, process_count=2, **kw)
    assert shard.files == mine.files[1::2]


def test_native_decode_equals_jax(images):
    from loco_edit_tpu import native as jnative
    from loco_edit_tpu_torch import native

    if not jnative.available():
        pytest.skip("native pipeline could not build in this environment")
    assert native.available()
    assert os.path.dirname(native._so_path()).endswith(
        os.path.join("loco_edit_tpu_torch", "_build"))
    paths = sorted(os.path.join(images, f) for f in os.listdir(images))
    for p in paths:
        np.testing.assert_array_equal(native.decode_image(p), jnative.decode_image(p))
    np.testing.assert_array_equal(native.load_batch(paths, 32), jnative.load_batch(paths, 32))
    with pytest.raises(IOError):
        native.load_batch([paths[0], os.path.join(images, "missing.png")], 32)
