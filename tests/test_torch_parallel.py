"""The port's probe sharding, data sharding and spatial parallelism in 4
gloo ranks on the CPU, against the one-process port and the JAX package's
one-device results, on the tiny ADM (one spawned group for the file,
tests/_torch_dist_cases.py::parallel_cases).

  - --mesh_probe: the solo (rank 5: shares of 2, 2, 1, 0 probes) and fused
    (2 x 3 probes) iterations with the same v_init: rows to PROBE_ATOL of
    the one-process run, and every principal-angle cosine to JAX's basis
    above MIN_COS with s to 1e-4 (tests/test_torch_editing.py's rule);
  - --mesh_data: 6 boosted strip frames padded to 8 and split 2 a rank,
    with JAX's eta-noise drawn for the padded batch: the one-process run of
    the padded batch and JAX's ddim_generate of it to STRIP_RTOL;
  - --mesh_sp (rows split 8 a rank, halo rows, all-reduced GroupNorm
    statistics, gathered attention keys): the forward at batch 2 (2e-5),
    an 8-step DDIM loop (5e-5) and the basis (s to 1e-3, projector within
    0.15; the solo basis's rank, mask and v_init), tests/test_sp.py's
    tolerances taken relative to the largest value, and a J v of the probe
    tests' PMP to 1e-4 of its largest value;
  - the CLI in the ranks with --mesh_probe 4 --mesh_data 4, and with
    --mesh_sp 4, against its one-process run (iterations cut to 3 sweeps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.core.rng import _stable_hash
from loco_edit_tpu.diffusion import LinspaceDDIM as JaxDDIM
from loco_edit_tpu.diffusion import ddim_generate as jax_ddim_generate
from loco_edit_tpu.diffusion.scheduler import pmp as jax_pmp
from loco_edit_tpu.editing import pullback as jpb
from _torch_dist_cases import cli_edit, parallel_cases, parallel_run
from _torch_dist_utils import Ranks
from _torch_port_utils import JaxDraws, tiny_pair

torch.set_num_threads(2)

T, AB = 600.0, 0.2
MIN_COS = 0.99997
PROBE_ATOL = 1e-5      # sharded against one-process unit rows: f32 rounding
# Relative to the largest value: the tiny model's random output layers give
# strips and DDIM states of 1e2-3e3 (tests/test_sp.py's atols were set on a
# model with values near 1).
U_RTOL = 5e-4          # left images J v: the last probes' rounding times s ~ 5e2
STRIP_RTOL = 1e-5      # strips: sharded, one process and JAX
SP_FWD_RTOL = 2e-5     # tests/test_sp.py's forward tolerance
SP_DDIM_RTOL = 5e-5    # tests/test_sp.py's DDIM-loop tolerance
FOR_STEPS = 10
CLI = ["--model_name", "TinyTest", "--for_steps", "6", "--inv_steps", "6",
       "--edit_t", "0.6", "--performance_boosting_t", "0.2",
       "--x_space_guidance_scale", "0.5", "--x_space_guidance_num_step", "2",
       "--pca_rank", "2", "--pca_rank_null", "2", "--vis_num", "1", "--seed", "7",
       "--device", "cpu", "--dataset_name", "Random", "--use_mask", "false",
       "--null_space_projection", "false", "--run_edit_null_space_projection", "true"]


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _cosines(a, b):
    return np.linalg.svd(np.asarray(a) @ np.asarray(b).T, compute_uv=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, params, tm = tiny_pair()
    tmp = tmp_path_factory.mktemp("par")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((1, 32, 32, 3), np.float32)
    mask[:, 8:20, 8:20, :] = 1.0
    d = x.size
    solo_v0 = np.array(jpb.init_probes(jax.random.key(1), 5, d))
    ka, kb = jax.random.key(2), jax.random.key(3)
    dual_v0 = np.stack([np.array(jpb.init_probes(k, 3, d)) for k in (ka, kb)])

    jgrid = JaxDDIM().generation_grid(FOR_STEPS)
    sched = JaxDDIM()
    edit_idx = sched.nearest_step_index(FOR_STEPS, 0.6)
    boost = sched.boost_eta_flags(FOR_STEPS, 0.4)
    frames = (rng.normal(size=(6, 32, 32, 3)) * 0.5).astype(np.float32)
    padded = np.concatenate([frames, np.zeros((2, 32, 32, 3), np.float32)])
    root = jax.random.key(5)
    tail = len(jgrid) - edit_idx
    eta = JaxDraws(root).fork("boost-eta").at_step(0)
    table = {("boost-eta", 0, i): eta.at_step(i).normal((8, 32, 32, 3), device="cpu").numpy()
             for i in range(tail)}
    sp_x = (rng.normal(size=(2, 32, 32, 3)) * 0.3).astype(np.float32)
    sp_x1 = (rng.normal(size=(1, 32, 32, 3)) * 0.3).astype(np.float32)
    sp_v = rng.normal(size=sp_x1.shape).astype(np.float32)
    cli_dir = str(tmp / "cli")
    p = dict(state_dict={k: v.clone() for k, v in tm.state_dict().items()},
             T=T, AB=AB, x=x, mask=mask, solo_rank=5, solo_v0=solo_v0, dual_rank=3,
             dual_v0=dual_v0, for_steps=FOR_STEPS, frames=frames, pad_to=8,
             eta_table=table, result_folder=str(tmp / "pipe"), sp_x=sp_x, sp_x1=sp_x1,
             sp_v=sp_v, cli_argv=CLI, cli_dir=cli_dir)
    ranks = Ranks(parallel_cases, p, world=4, timeout=180)   # JAX runs meanwhile

    # JAX, one device
    eps_j = lambda z, t: jm.apply(params, z, t)   # noqa: E731
    fj = lambda z: jax_pmp(z, eps_j(z, T), AB)     # noqa: E731
    kw = dict(min_iter=2, max_iter=3, tol=0.0, pad_probes=False)
    jsolo = jax.jit(lambda z: jpb.subspace_iteration(
        fj, z, None, rank=5, mask=jnp.asarray(mask), v_init=jnp.asarray(solo_v0),
        **kw))(jnp.asarray(x))
    jdual = jax.jit(lambda z: jpb.dual_subspace_iteration(
        fj, z, ka, kb, rank_a=3, rank_b=3, mask_a=jnp.asarray(mask),
        mask_b=jnp.asarray(1 - mask), **kw))(jnp.asarray(x))
    jstrips = np.asarray(jax.jit(lambda z: jax_ddim_generate(
        eps_j, z, jgrid, start_idx=edit_idx, end_idx=None, eta=boost,
        rng_key=jax.random.fold_in(jax.random.fold_in(root, _stable_hash("boost-eta")),
                                   0)))(jnp.asarray(padded)))
    jsp = dict(
        fwd=np.asarray(jax.jit(lambda z: eps_j(z, 431.0))(jnp.asarray(sp_x))),
        ddim=np.asarray(jax.jit(lambda z: jax_ddim_generate(
            eps_j, z, JaxDDIM().generation_grid(8)))(jnp.asarray(sp_x[:1]))),
        jv=np.asarray(jax.jit(lambda z, v: jax.jvp(fj, (z,), (v,))[1])(
            jnp.asarray(sp_x1), jnp.asarray(sp_v))))
    one = parallel_run(dict(p, result_folder=str(tmp / "pipe1")), sharded=False)
    one_cli_mesh = cli_edit(CLI + ["--result_folder", str(tmp / "cli1")])
    return dict(out=ranks.join(), one=one, one_cli=one_cli_mesh, jsolo=jsolo,
                jdual=jdual, jstrips=jstrips, jsp=jsp)


def _close_basis(got, one, jref):
    assert got["iters"] == one["iters"] == int(jref.iters)
    np.testing.assert_allclose(got["vT"], one["vT"], atol=PROBE_ATOL)
    np.testing.assert_allclose(got["s"], one["s"], rtol=1e-5)
    assert _cosines(got["vT"], jref.vT).min() > MIN_COS
    np.testing.assert_allclose(got["s"], np.asarray(jref.s), rtol=1e-4)


def test_probe_sharded_solo_basis(runs):
    for o in runs["out"]:
        _close_basis(o["solo"], runs["one"]["solo"], runs["jsolo"])
        _close(o["solo"]["u"], runs["one"]["solo"]["u"], U_RTOL)


def test_probe_sharded_fused_bases(runs):
    for o in runs["out"]:
        for g in range(2):
            _close_basis(o["dual"][g], runs["one"]["dual"][g], runs["jdual"][g])


def test_data_sharded_strips(runs):
    """Sharded strips equal the unsharded run of the padded batch, as the
    JAX package asserts of its sharded program."""
    for o in runs["out"]:
        assert o["strips"].shape == (6, 32, 32, 3)
        _close(o["strips"], runs["one"]["strips"][:6], STRIP_RTOL)
        _close(o["strips"], runs["jstrips"][:6], STRIP_RTOL)


def test_spatial_forward_and_ddim_loop(runs):
    jsp = runs["jsp"]
    for o in runs["out"]:
        _close(o["sp_fwd"], runs["one"]["sp_fwd"], SP_FWD_RTOL)
        _close(o["sp_fwd"], jsp["fwd"], SP_FWD_RTOL)
        _close(o["sp_ddim"], runs["one"]["sp_ddim"], SP_DDIM_RTOL)
        _close(o["sp_ddim"], jsp["ddim"], SP_DDIM_RTOL)
        top = np.abs(jsp["jv"]).max()
        assert np.abs(o["sp_jv"] - jsp["jv"]).max() <= 1e-4 * top
        assert np.abs(o["sp_jv"] - runs["one"]["sp_jv"]).max() <= 1e-4 * top


def test_spatial_basis(runs):
    """The solo basis (rank 5, the same v_init) through the spatially split
    denoiser."""
    jb = runs["jsolo"]
    for o in runs["out"]:
        for ref_vT, ref_s in ((runs["one"]["solo"]["vT"], runs["one"]["solo"]["s"]),
                              (np.asarray(jb.vT), np.asarray(jb.s))):
            np.testing.assert_allclose(o["sp_basis"]["s"], ref_s, rtol=1e-3)
            p1, p8 = ref_vT.T @ ref_vT, o["sp_basis"]["vT"].T @ o["sp_basis"]["vT"]
            assert np.linalg.norm(p8 - p1) / np.linalg.norm(p1) < 0.15


@pytest.mark.parametrize("run", ["cli_mesh", "cli_sp"])
def test_cli_mesh_flags_under_ranks(runs, run):
    """The CLI honours --mesh_probe/--mesh_data and --mesh_sp under ranks:
    the same directions and strips as one process."""
    one = runs["one_cli"]
    for o in runs["out"]:
        got = o[run]
        assert _cosines(got["vT"], one["vT"]).min() > MIN_COS
        _close(got["strips"], one["strips"], STRIP_RTOL)
