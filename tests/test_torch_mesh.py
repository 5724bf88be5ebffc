"""The port's mesh, checks, tensor-parallel and cache modules against the
JAX package, and its data-parallel and tensor-parallel training in 4 gloo
ranks on the CPU against the one-process run and JAX's one-device step.

One process: make_mesh's axis rule and errors (against JAX's make_mesh on
the conftest's 8-device virtual mesh), the backend rule, the checksum
against its own definition, tp_fraction_sharded equal to JAX's exactly on
the tiny ADM, and the build-directory resolution order.

Four ranks (one spawned group for the file, tests/_torch_dist_cases.py::
mesh_cases), each held to the one-process port and to JAX:
  - two data-parallel train steps (global batch 8, 2 rows a rank, 2
    microbatches, clipping, JAX's noise): loss, grad_norm and the
    per-sample losses to LOSS_RTOL, the checksum of the parameters to
    CHECKSUM_RTOL and equal on every rank;
  - run_training(mesh=) with the loss-aware resampler: the same step and
    checksum as one process; and, with the timesteps from a table and JAX's
    noise over an 8-step schedule whose resampler warms up after 2 steps,
    the same step, checksum and parameters as JAX's run_training over a
    4-device data mesh (the ranks' resampler fed the gathered losses);
  - the transport: gathers and halo exchanges by gloo's own all_gather and
    send/recv equal to the all_reduce fallback and to what they move;
  - one train step over a (data 2 x tp 2) mesh with the state split on its
    output features: the same loss, grad_norm and parameters, and the
    masters, EMA and Adam moments held in halves;
  - GroupNorm with the rows split over the ranks (statistics pass,
    all-reduce, normalize pass): value, J v and v^T J against the plain
    GroupNorm of the whole tensor, to GN_ATOL."""

import dataclasses
import os

import flax.traverse_util
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from loco_edit_tpu.core import mesh as jmesh
from loco_edit_tpu.diffusion.schedule import NoiseSchedule as JaxSchedule
from loco_edit_tpu.parallel import tp as jtp
from loco_edit_tpu.training import loop as jloop
from loco_edit_tpu.training import trainer as jtr
from loco_edit_tpu.training.resample import LossSecondMomentResampler as JaxResampler
from loco_edit_tpu_torch.core import cache, mesh
from loco_edit_tpu_torch.core.rng import RngStream, RowWindow
from loco_edit_tpu_torch.models.adm.presets import tiny_test_config
from loco_edit_tpu_torch.models.registry import adm_params_from_flax
from loco_edit_tpu_torch.ops.groupnorm import GroupNormFn
from loco_edit_tpu_torch.parallel import checks, tp
from _torch_dist_cases import mesh_cases, tiny_model, train_step_run
from _torch_dist_utils import Ranks
from _torch_port_utils import JaxDraws, tiny_pair

torch.set_num_threads(2)

LOSS_RTOL = 1e-5        # loss, grad_norm: f32 summation orders
CHECKSUM_RTOL = 1e-4    # the weighted parameter sum after the steps
PARAM_ATOL = 1e-6       # parameters, beyond Adam's sign flips (below)
GN_ATOL = 2e-6          # f32 GroupNorm, its J v and v^T J
CFG = dict(lr=1e-4, ema_rate=0.9, microbatches=2, lr_anneal_steps=5, max_grad_norm=0.05)
TP_CFG = dict(lr=1e-4, ema_rate=0.9, microbatches=1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- one process ----------------------------------------------------------------

@pytest.mark.parametrize("sizes", [
    {"data": -1}, {"data": -1, "probe": 2}, {"data": 2, "probe": -1},
    {"data": 4, "probe": 2}, {"data": 3}, {"data": -1, "probe": 3}, {"data": 16},
])
def test_make_mesh_axis_rule_and_errors_match_jax(sizes):
    """The -1 axis and both ValueErrors over 8 ranks, as JAX's make_mesh over
    the 8 virtual devices."""
    try:
        want = list(jmesh.make_mesh(dict(sizes)).shape.values())
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            mesh.resolve_axis_sizes(dict(sizes), 8)
        return
    assert mesh.resolve_axis_sizes(dict(sizes), 8) == want


def test_one_process_mesh_is_the_identity():
    assert mesh.world_size() == 1 and mesh.is_main_process()
    assert mesh.initialize_distributed(device="cpu") is None
    m = mesh.make_mesh()
    assert m.shape == {"data": 1} and m.group("data") is None and m.coordinate("data") == 0
    m2 = mesh.local_mesh()
    assert m2.shape == {"data": 1, "probe": 1}
    assert mesh.shard_leading(m2, "probe")[1][1].is_shard(0)
    assert all(p.is_replicate() for p in mesh.replicated(m2)[1])
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        mesh.make_mesh({"probe": 2})


def test_backend_rule():
    assert mesh.choose_backend("cpu", 4) == "gloo"
    assert mesh.choose_backend("cuda", 2, cards=1) == "gloo"    # two ranks, one card
    assert mesh.choose_backend("cuda", 2, cards=2) == "nccl"
    assert mesh.choose_backend("cuda", 1, cards=8) == "nccl"


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def test_checksum_definition_and_drift(pair):
    _, _, tm = pair
    named = dict(tm.named_parameters())
    want = 0.0
    for i, p in enumerate(named.values()):
        x = p.detach().double().numpy().reshape(-1)
        want += float((x * (np.arange(x.size) % 97 + 1)).sum()) * (i % 13 + 1)
    got = float(checks.replicated_params_checksum(tm))
    assert got == float(checks.replicated_params_checksum(named))
    assert abs(got - want) <= 1e-5 * abs(want)
    bumped = {k: v.clone() for k, v in named.items()}
    next(iter(bumped.values())).view(-1)[1] += 1.0   # above the f32 sum's ulp
    assert float(checks.replicated_params_checksum(bumped)) != got


@pytest.mark.parametrize("min_size", [1 << 16, 1 << 10, 1 << 6])
def test_tp_fraction_matches_jax(min_size, pair):
    """Sharding the output features of the torch layouts (dim 0 of conv and
    dense weights) shards exactly what JAX's last-dim rule does."""
    jm, params, tm = pair
    jax_mesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "tp"))
    want = jtp.tp_fraction_sharded(params, jax_mesh, min_size=min_size)
    m = mesh.Mesh(("data", "tp"), (4, 2))
    assert tp.tp_fraction_sharded(tm, m, min_size=min_size) == want
    assert 0.0 < want < 1.0
    placements = tp.tp_param_shardings(tm, m, min_size=min_size)
    n_sharded = sum(pl[1].is_shard() for pl in placements.values())
    jsh = jtp.tp_param_shardings(params, jax_mesh, min_size=min_size)
    assert n_sharded == sum(s.spec != jax.sharding.PartitionSpec()
                            for s in jax.tree.leaves(jsh))


def test_row_window_draws_rows_of_the_whole_batch():
    """A data-sharded share's stream: each draw is the whole batch's, this
    share's rows returned; a draw of any other row count raises."""
    s = RngStream.from_seed(4).fork("boost-eta")
    w = RowWindow(s, 2, 2, 6)
    for a, b in ((w.at_step(3), s.at_step(3)), (w.fork("x").at_step(1), s.fork("x").at_step(1))):
        np.testing.assert_array_equal(a.normal((2, 4, 4, 3), device="cpu").numpy(),
                                      b.normal((6, 4, 4, 3), device="cpu")[2:4].numpy())
    for shape in ((1, 4, 4, 3), (4, 4, 4, 3), ()):
        with pytest.raises(ValueError, match="share of 2 rows of 6"):
            w.normal(shape, device="cpu")


def test_build_directory_resolution(monkeypatch, tmp_path):
    """LOCO_COMPILE_CACHE first (a path, or off: a fresh temporary
    directory), then the checkout's _build/, then ~/.cache for an install;
    the first resolution holds for the process."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("LOCO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(cache, "_resolved", None)
    assert cache.default_cache_dir() == os.path.join(repo, "loco_edit_tpu_torch", "_build")
    assert cache.enable_compile_cache() == cache.default_cache_dir() == cache.build_dir()

    monkeypatch.setattr(cache, "_resolved", None)
    monkeypatch.setenv("LOCO_COMPILE_CACHE", str(tmp_path / "cc"))
    assert cache.enable_compile_cache() == str(tmp_path / "cc")
    assert os.path.isdir(tmp_path / "cc")
    monkeypatch.setenv("LOCO_COMPILE_CACHE", "elsewhere")
    assert cache.enable_compile_cache() == str(tmp_path / "cc")     # idempotent

    fresh = set()
    for _ in range(2):
        monkeypatch.setattr(cache, "_resolved", None)
        monkeypatch.setenv("LOCO_COMPILE_CACHE", "off")
        d = cache.enable_compile_cache()
        assert os.path.isdir(d) and not os.listdir(d)
        fresh.add(d)
    assert len(fresh) == 2

    monkeypatch.setattr(cache, "_PKG", str(tmp_path / "site-packages" / "loco_edit_tpu_torch"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cache.default_cache_dir() == str(tmp_path / "home" / ".cache"
                                            / "loco_edit_tpu_torch" / "build")
    monkeypatch.setattr(cache, "_resolved", None)


# -- four ranks -------------------------------------------------------------------

def _jax_steps(jm, params, x0, t, w, keys, cfg):
    apply_fn = lambda p, x, tt: jm.apply(p, x, tt.astype(jnp.float32))  # noqa: E731
    jcfg = jtr.TrainConfig(**cfg)
    jstep = jax.jit(jtr.make_train_step(apply_fn, jcfg, JaxSchedule.linear()))
    st = jtr.create_train_state(params, jcfg)
    out = []
    for k in keys:
        st, met = jstep(st, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(w), k)
        out.append({n: np.asarray(v) for n, v in met.items()})
    return out


def _noise(key, b, n_micro):
    """The step's noise as the JAX step draws it: microbatch i from
    fold_in(key, i) at the microbatch's shape."""
    return np.concatenate([JaxDraws(key).at_step(i).normal(
        (b // n_micro, 32, 32, 3), device="cpu").numpy() for i in range(n_micro)])


def _jax_loop(jm, params, batches, table, n_t, steps):
    """JAX's run_training over a 4-device data mesh on the batches, loss-
    aware over n_t timesteps with 2 losses of history, the timesteps from
    the table: the final step and parameters in the port's layout."""
    ts = iter(table[("t", s)] for s in range(steps))

    @dataclasses.dataclass(frozen=True)
    class TableResampler(JaxResampler):
        history_per_term: int = 2

        def sample(self, key, batch, state):
            # host arrays: the jitted step places them on the mesh (the
            # resampler's own would come back committed to it, replicated)
            t = np.asarray(next(ts))
            p = np.asarray(self._weights(state))
            return t, (1.0 / (self.num_timesteps * p[t])).astype(np.float32)

    def data():
        i = 0
        while True:
            yield batches[i % len(batches)], None
            i += 1

    apply_fn = lambda p, x, tt: jm.apply(p, x, tt.astype(jnp.float32))  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "LossSecondMomentResampler", TableResampler)
        state = jloop.run_training(
            apply_fn, params, data(), cfg=jtr.TrainConfig(lr=1e-3, microbatches=2),
            schedule=JaxSchedule.linear(timesteps=n_t),
            mesh=jmesh.make_mesh({"data": 4}, devices=jax.devices()[:4]),
            total_steps=steps, log_interval=100, ckpt_dir=None, loss_aware=True, seed=3)
    flat = {k: np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(state.params, sep="/").items()}
    sd = adm_params_from_flax(flat, tiny_test_config())
    model = tiny_model(sd)
    return {"step": int(state.step),
            "params": {k: v.detach().numpy() for k, v in model.named_parameters()}}


def _loop_table(batches, n_t, steps):
    """The timesteps (every one twice in the first two steps, so the
    resampler is warm from step 2) and JAX's noise of each step: microbatch
    i of step s from fold_in(fold_in(fold_in(key(3), s), 1), i)."""
    rng = np.random.default_rng(5)
    b = batches[0].shape[0]
    table = {("t", 0): np.arange(n_t), ("t", 1): np.arange(n_t)[::-1].copy()}
    for s in range(2, steps):
        table[("t", s)] = rng.integers(0, n_t, size=b)
    for s in range(steps):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.key(3), s), 1)
        for i in range(2):
            table[(s, 1, i)] = JaxDraws(key).at_step(i).normal(
                (b // 2,) + batches[0].shape[1:], device="cpu").numpy()
    return table


@pytest.fixture(scope="module")
def ranks(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(0)
    x0 = np.tanh(rng.normal(size=(8, 32, 32, 3))).astype(np.float32)
    t = np.array([5, 250, 600, 990, 17, 333, 444, 871], np.int32)
    w = np.array([1.0, 0.5, 2.0, 1.0, 1.5, 0.7, 1.0, 0.9], np.float32)
    keys = [jax.random.fold_in(jax.random.key(1), i) for i in range(2)]
    tp_x0 = np.tanh(rng.normal(size=(4, 32, 32, 3))).astype(np.float32)
    tp_t, tp_w = np.array([3, 500, 700, 999], np.int32), np.ones((4,), np.float32)
    tp_key = jax.random.key(9)
    gn_x = rng.normal(size=(2, 64, 16, 8)).astype(np.float32) * 2 + 0.5
    p = dict(state_dict={k: v.clone() for k, v in tm.state_dict().items()},
             cfg=CFG, x0=x0, t=t, w=w, noise=[_noise(k, 8, 2) for k in keys],
             tp_cfg=TP_CFG, tp_x0=tp_x0, tp_t=tp_t, tp_w=tp_w,
             tp_noise=[_noise(tp_key, 4, 1)],
             batches=[np.tanh(rng.normal(size=(8, 32, 32, 3))).astype(np.float32)
                      for _ in range(2)], loop_steps=3, loop_t_steps=8,
             gn_x=gn_x, gn_v=rng.normal(size=gn_x.shape).astype(np.float32),
             gn_u=rng.normal(size=gn_x.shape).astype(np.float32),
             gn_scale=rng.normal(size=(64,)).astype(np.float32),
             gn_bias=rng.normal(size=(64,)).astype(np.float32))
    p["loop_table"] = _loop_table(p["batches"], p["loop_t_steps"], p["loop_steps"])
    ranks = Ranks(mesh_cases, p, world=4, timeout=150)   # the references meanwhile
    from _torch_dist_cases import loop_run

    return dict(
        p=p,
        one=train_step_run(p, None, steps=2),
        one_tp=train_step_run(dict(p, x0=tp_x0, t=tp_t, w=tp_w, noise=p["tp_noise"],
                                   cfg=TP_CFG), None, steps=1),
        one_loop=loop_run(p, None),
        jax=_jax_steps(jm, params, x0, t, w, keys, CFG),
        jax_tp=_jax_steps(jm, params, tp_x0, tp_t, tp_w, [tp_key], TP_CFG),
        jax_loop=_jax_loop(jm, params, p["batches"], p["loop_table"], p["loop_t_steps"],
                           p["loop_steps"]),
        out=ranks.join())


def _params_close(got, want, grads_small=0.02, lr=CFG["lr"], steps=2):
    """Parameters within PARAM_ATOL except a few entries Adam's first
    sign-like steps moved apart (a gradient near 0 may take either sign):
    at most grads_small of them, each within 2 * lr * steps."""
    diffs = np.concatenate([np.abs(got[k] - want[k]).reshape(-1) for k in want])
    assert (diffs > PARAM_ATOL).mean() <= grads_small
    assert diffs.max() <= 2 * lr * steps + PARAM_ATOL


def test_ranks_start_on_gloo(ranks):
    assert [o["rank"] for o in ranks["out"]] == [0, 1, 2, 3]
    assert {o["backend"] for o in ranks["out"]} == {"gloo"}


def test_data_parallel_steps_match_one_process_and_jax(ranks):
    one, jx = ranks["one"], ranks["jax"]
    sums = {o["dp"]["checksum"] for o in ranks["out"]}
    assert len(sums) == 1                                # every rank the same
    for o in ranks["out"]:
        dp = o["dp"]
        for s, m in enumerate(dp["metrics"]):
            for k in ("loss", "grad_norm", "per_timestep_losses"):
                assert _rel(m[k], one["metrics"][s][k]) <= LOSS_RTOL
                assert _rel(m[k], jx[s][k]) <= LOSS_RTOL
        assert float(dp["metrics"][0]["grad_norm"]) > CFG["max_grad_norm"]   # clipped
        assert _rel(dp["checksum"], one["checksum"]) <= CHECKSUM_RTOL
        _params_close(dp["params"], one["params"])


def test_run_training_over_a_mesh_matches_one_process(ranks):
    for o in ranks["out"]:
        assert o["loop"]["step"] == ranks["one_loop"]["step"] == ranks["p"]["loop_steps"]
        assert _rel(o["loop"]["checksum"], ranks["one_loop"]["checksum"]) <= CHECKSUM_RTOL


def test_run_training_over_a_mesh_matches_jax(ranks):
    want = ranks["jax_loop"]
    want_sum = float(checks.replicated_params_checksum(
        {k: torch.from_numpy(v) for k, v in want["params"].items()}))
    for o in ranks["out"]:
        got = o["loop_jax"]
        assert got["step"] == want["step"] == ranks["p"]["loop_steps"]
        assert _rel(got["checksum"], want_sum) <= CHECKSUM_RTOL
        _params_close(got["params"], want["params"], lr=1e-3, steps=3)


def test_transport_fallback_moves_the_same_rows(ranks):
    """Each rank's x is 1000 * rank + arange: the gather stacks every
    rank's, the halo pads 2 rows above (the previous rank's last) and 1
    below (the next rank's first), its transpose adds the halo rows back."""
    w = len(ranks["out"])
    xs = [np.arange(120, dtype=np.float32).reshape(2, 3, 4, 5) + 1000 * r for r in range(w)]
    zero = np.zeros((2, 3, 1, 5), np.float32)
    for r, o in enumerate(ranks["out"]):
        above = xs[r - 1][:, :, 2:] if r > 0 else np.zeros((2, 3, 2, 5), np.float32)
        below = xs[r + 1][:, :, :1] if r < w - 1 else zero
        unpad = xs[r][:, :, 1:3].copy()
        if r < w - 1:
            unpad[:, :, -1:] += xs[r + 1][:, :, :1]       # the next rank's top halo
        if r > 0:
            unpad[:, :, :1] += xs[r - 1][:, :, 3:]        # the previous rank's bottom halo
        want = {"gather": np.stack(xs), "unpad": unpad,
                "pad": np.concatenate([above, xs[r], below], axis=2)}
        for name in ("native", "fallback"):
            for k, v in want.items():
                np.testing.assert_array_equal(o["transport"][name][k], v, err_msg=f"{name} {k}")


def test_tensor_parallel_step(ranks):
    one, jx = ranks["one_tp"], ranks["jax_tp"]
    for o in ranks["out"]:
        tpo = o["tp"]
        m = tpo["metrics"][0]
        for k in ("loss", "grad_norm", "per_timestep_losses"):
            assert _rel(m[k], one["metrics"][0][k]) <= LOSS_RTOL
            assert _rel(m[k], jx[0][k]) <= LOSS_RTOL
        _params_close(tpo["params"], one["params"])
        assert tpo["tp_dims"], "no parameter was split"
        for k, dim in tpo["tp_dims"].items():
            full = one["local_shapes"][k]
            assert tpo["local_shapes"][k][dim] * 2 == full[dim]
            assert tpo["moment_shapes"][k] == tpo["local_shapes"][k]   # Adam moments too


def test_sharded_group_norm_plain_versions(ranks):
    p = ranks["p"]
    x, v, u = (torch.from_numpy(p[k]) for k in ("gn_x", "gn_v", "gn_u"))
    scale, bias = torch.from_numpy(p["gn_scale"]), torch.from_numpy(p["gn_bias"])

    def f(z):
        return GroupNormFn.apply(z, scale, bias, 32, 1e-5)

    y, jv = torch.func.jvp(f, (x,), (v,))
    _, vjp = torch.func.vjp(f, x)
    want = {"y": y.numpy(), "jv": jv.numpy(), "vjp": vjp(u)[0].numpy(),
            "jvs": np.stack([jv.numpy(), 2 * jv.numpy()])}
    for o in ranks["out"]:
        for k, w_ in want.items():
            np.testing.assert_allclose(o["gn"][k], w_, atol=GN_ATOL * max(1, np.abs(w_).max()))
