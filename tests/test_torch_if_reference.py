"""The port's DeepFloyd-IF cascade against the benchmark's plain float32
reference (perfbench/reference/ifm.py) on the CPU, at tiny sizes on seeded
weights: the U-Net of either stage, the stage-2 SuperResSampler, and a
served edit of the tiny cascade through EditService (LOCO_IF_PRESET
"tiny,tiny"), its uint8 frames at the upscaler's scale held to the
reference cascade. Then the bundle's models: the preset widths it builds
without files, counted on the meta device, the tiny override, and a
stage-1 checkpoint without an upscaler."""

import base64
import dataclasses

import numpy as np
import pytest
import torch

from loco_edit_tpu_torch.core.rng import RngStream
from loco_edit_tpu_torch.models import t2i_registry
from loco_edit_tpu_torch.models.ifm import IFUNet, infer_if_config, tiny_if_config
from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
from loco_edit_tpu_torch.pipelines.superres import SuperResSampler
from loco_edit_tpu_torch.utils import logger
from perfbench import inputs
from perfbench.reference import ifm, loco

torch.set_num_threads(2)

# Both sides compute in float32 on the CPU; the port's GroupNorm, attention
# and pooled-embedding paths sum in other orders than the reference's plain
# expressions, so a forward differs by float32 rounding carried through the
# network (1.9e-6 of the output's largest value seen)
FWD_RTOL = 2e-5


def _sizes(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


def _pair(stage2: bool, seed: int = 5):
    """The port's tiny IF U-Net with the benchmark's seeded weights
    (norm scales and biases drawn too) and the reference with the same."""
    cfg = tiny_if_config(stage2=stage2)
    model = IFUNet(cfg).eval()
    inputs.load_weights(model, seed, torch.float32)
    return model, _reference(model)


def _reference(model):
    ref = ifm.UNet(_sizes(model.cfg))
    ref.load_state_dict(model.state_dict())
    return ref.eval()


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("stage2", [False, True], ids=["stage1", "stage2"])
def test_reference_unet_matches_port(stage2):
    """eps | sigma of both U-Nets on the same x, t, T5 states and (stage 2)
    aug level; the parameter names and order agree, so make_weights' draws
    land on the same tensors."""
    model, ref = _pair(stage2)
    assert inputs.weight_specs(model) == inputs.weight_specs(ref)
    g = torch.Generator().manual_seed(1)
    s, c = model.cfg.sample_size, model.cfg.in_channels
    x = torch.randn(2, s, s, c, generator=g)
    ctx = torch.randn(2, 7, model.cfg.encoder_hid_dim, generator=g)
    with torch.no_grad():
        got = model(x, 500.0, ctx, 250.0 if stage2 else None)
        want = ref(x, 500.0, ctx, 250.0)
    assert got.shape == want.shape == (2, s, s, 6)
    assert _rel(got, want) < FWD_RTOL


def test_reference_superres_matches_sampler():
    """The stage-2 sampler: bilinear align-corners upsampling, aug-level
    noising and x_T from the "sr-aug" / "sr-noise" streams at the call's
    index, 49 CFG DDIM updates, the clamp; two calls, so the second draws at
    index 1. The first updates divide by sqrt(alpha-bar) of t 990 (about
    1 / 70), which carries the forwards' float32 rounding and the two
    bilinear weightings' (1e-6) into the frames: 6.4e-4 seen. Seeded
    weights drive 99 % of the values past the clamp, so those are held to
    the same sign and the rest to the bound. Each update is one U-Net call
    on the `sr_forwards` counter, the CFG variants riding on the batch."""
    model, ref = _pair(True)
    enc = fake_prompt_encoder(48, seq=7, device="cpu")
    sr = SuperResSampler(lambda x, t, c, a: model(x, t, c, a), enc, out_size=32, steps=50,
                         guidance_scale=4.0, aug_level=250, rng=RngStream.from_seed(11),
                         device="cpu")
    low = torch.rand(3, 16, 16, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    for call in range(2):
        logger.start_recording()
        try:
            got = sr(low, "a cat")
        finally:
            rec = logger.stop_recording()
        assert rec.counts[None]["sr_forwards"] == 49
        want = ifm.superres(ref, low, enc("a cat"), enc(""), out_size=32, steps=50,
                            scale=4.0, aug_level=250, root=loco.Stream.root(11), call=call)
        assert got.shape == want.shape == (3, 32, 32, 3)
        assert float((got - want).abs().max()) < 5e-3
        assert float(want.abs().max()) <= 1.0 and 0.05 < float(want.std())


def test_served_tiny_cascade_matches_reference(tmp_path, monkeypatch):
    """One unsupervised edit served by EditService over the tiny cascade
    ("pixel" true): 3 uint8 frames of the upscaler's 32 x 32 x 3, against
    the reference cascade on the served weights, prompts and draws: its own
    generation to edit_t, its own basis (the subspace gap of the spans),
    and its own stage-1 steps and upscale along the served first direction,
    as the 2nd call of the upscaler (the warm-up edit made the 1st). The
    basis agrees to float32 rounding; every frame pixel to one level of
    255, which is where a value near a rounding boundary lands."""
    from loco_edit_tpu_torch.cli.args import parse_args, preset
    from loco_edit_tpu_torch.serve import EditService

    monkeypatch.setenv("LOCO_IF_PRESET", "tiny,tiny")
    svc = EditService(preset(parse_args([
        "--model_name", "DeepFloyd-IF-I-M", "--dataset_name", "Random", "--device", "cpu",
        "--for_steps", "10", "--edit_t", "0.75", "--guidance_scale", "3.0",
        "--performance_boosting_t", "0", "--x_space_guidance_scale", "1.0",
        "--x_space_guidance_num_step", "4", "--vis_num", "1", "--pca_rank", "2",
        "--pca_rank_null", "2", "--null_space_projection", "true", "--seed", "7",
        "--result_folder", str(tmp_path)])))
    cfg = svc.pipe.cfg
    cfg.min_iter = cfg.max_iter = 2
    cfg.convergence_threshold = 0.0
    req = {"seed": 5, "for_prompt": "a cat", "mask_bbox": [2, 10, 4, 12],
           "semantic": False, "pixel": True}
    svc.edit(dict(req, sample_name="warm", seed=3))
    out = svc.edit(dict(req, sample_name="s0"))
    assert out["dtype"] == "uint8" and out["shape"] == [3, 32, 32, 3]
    got = torch.from_numpy(np.frombuffer(base64.b64decode(out["strips"]["0"]),
                                         np.uint8).reshape(3, 32, 32, 3).copy())
    vT = torch.from_numpy(np.load(tmp_path / "DeepFloyd-IF-Random-" / "results" / "s0"
                                  / "basis" / "vT.npz")["vT"]).reshape(2, -1)

    models = svc.bundle["models"]
    r1, r2 = _reference(models["unet"]), _reference(models["stage2"])
    enc = svc.bundle["prompt_encoder"]
    f, n = enc("a cat"), enc("")
    grid = ifm.Grid(10)
    t_idx = grid.index_of(0.75)

    def eps(x, t):
        return ifm.cfg_eps(r1, x, t, f, n, 3.0)

    xT = loco.Stream.root(5).normal((1, 16, 16, 3), "cpu")
    xt = loco.denoise(eps, xT, grid, 0, t_idx)
    mask = torch.zeros(1, 16, 16, 3)
    mask[:, 2:10, 4:12] = 1.0
    root = loco.Stream.root(7)
    t, ab = float(grid.t[t_idx]), grid.ab[t_idx]
    probes = loco.init_probes(root.fork("if-probes-2"), 2, xt.numel(), "cpu")
    want_vT = loco.edit_basis(lambda x: loco.pmp(x, eps(x, t), ab), xt, mask, probes,
                              probes, 2)
    assert loco.subspace_gap(vT, want_vT) < 1e-9

    offsets = loco.walk_offsets(1.0, 1.0, 4, 1)
    frames = torch.cat([xt + float(o) * vT[0].reshape(xt.shape) for o in offsets])
    x0 = loco.denoise(eps, frames, grid, t_idx, len(grid))
    want = loco.to_uint8(ifm.superres(r2, x0, f, n, out_size=32, steps=50, scale=4.0,
                                      aug_level=250, root=root, call=1))
    assert int((got.int() - want.int()).abs().max()) <= 1
    assert loco.pixel_gap(got, want) < 1e-3


def test_bundle_without_files_is_if_i_m_with_if_ii_l():
    """No checkpoint files: IF-I-M (426,944,518 parameters) and the IF-II-L
    upscaler (1,170,580,998), the pair LOCO-Edit serves; LOCO_IF_PRESET
    "tiny" is the tiny stage 1 alone, "tiny,tiny" the tiny cascade. Counted
    on the meta device."""
    cfg1, cfg2 = t2i_registry.if_configs()
    with torch.device("meta"):
        counts = [sum(p.numel() for p in IFUNet(c).parameters()) for c in (cfg1, cfg2)]
    assert counts == [426_944_518, 1_170_580_998]
    assert (cfg1.sample_size, cfg2.sample_size, cfg2.class_embed_timestep) == (64, 256, True)


@pytest.mark.parametrize("value, stages", [("tiny", (16, None)), ("tiny,tiny", (16, 32)),
                                           ("IF-I-L,IF-II-M", None)])
def test_bundle_preset_override(value, stages, monkeypatch):
    """LOCO_IF_PRESET takes `tiny` (the tiny stage 1 alone) and `tiny,tiny`
    (the tiny cascade) and refuses anything else."""
    monkeypatch.setenv("LOCO_IF_PRESET", value)
    if stages is None:
        with pytest.raises(ValueError, match="LOCO_IF_PRESET"):
            t2i_registry.if_configs()
        return
    cfg1, cfg2 = t2i_registry.if_configs()
    assert (cfg1.sample_size, cfg2 and cfg2.sample_size) == stages
    assert cfg2 is None or cfg2.class_embed_timestep


def test_stage1_checkpoint_without_stage2_has_no_upscaler(tmp_path, monkeypatch):
    """A stage-1 checkpoint (synthetic, diffusers names) and no stage-2
    path: the checkpoint's own geometry and no upscaler. The seeded preset
    pair is built only when no checkpoint is given at all."""
    from test_if_convert import synthetic_if_state_dict

    monkeypatch.delenv("LOCO_IF_PRESET", raising=False)
    sd = synthetic_if_state_dict(seed=2)
    s1 = tmp_path / "stage1.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, s1)

    class Args:
        checkpoint_path, stage2_checkpoint_path, text_encoder_path = str(s1), "", ""
        dtype, seed, device = "fp32", 3, "cpu"

    b = t2i_registry.load_if_bundle(Args())
    assert b["superres"] is None and set(b["models"]) == {"unet"}
    assert b["models"]["unet"].cfg.block_out_channels == \
        infer_if_config(sd).block_out_channels
