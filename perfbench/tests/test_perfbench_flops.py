"""The yardstick's operation counts against FlopCounterMode over the
program's own models at their tiny presets, and the counting rules."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _tiny
from perfbench import flops, manifest
from perfbench.reference import adm as ref_adm
from perfbench.reference import sd as ref_sd


def _counted(model, *args):
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(*args)
    return fc.get_total_flops()


def test_adm_forward_equals_flop_counter_on_the_programs_tiny_adm():
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.adm.presets import tiny_test_config

    cfg = _tiny.p2_cell().config["model"]
    with torch.device("meta"):
        ours = flops.forward_flops(ref_adm.build(cfg, "meta"), torch.empty(2, 32, 32, 3), 500.0)
    program = ADMUNet(tiny_test_config()).eval()
    assert ours == _counted(program, torch.randn(2, 32, 32, 3), 500.0) > 0


def test_sd_unet_and_decoder_equal_flop_counter_on_the_programs_tiny_models():
    from loco_edit_tpu_torch.models.sd import SDUNet, VAEConfig, VAEDecoder, sd_preset

    cfg = _tiny.lcm_cell().config
    cfg["vae"] = dict(cfg["vae"], block_out_channels=[32, 32, 64, 64])
    unet, dec = ref_sd.build(cfg, "meta")
    with torch.device("meta"):
        z, ctx = torch.empty(1, 8, 8, 4), torch.empty(1, 77, 32)
        ours_u = flops.forward_flops(unet, z, 500.0, ctx, 6.5)
        ours_d = flops.forward_flops(dec, z)
    p_unet = SDUNet(sd_preset("tiny")).eval()
    p_dec = VAEDecoder(VAEConfig(sample_size=64, block_out_channels=(32, 32, 64, 64))).eval()
    zz = torch.randn(1, 8, 8, 4)
    assert ours_u == _counted(p_unet, zz, 500.0, torch.randn(1, 77, 32)) > 0
    assert ours_d == _counted(p_dec, zz) > 0


def test_full_width_counts():
    p2 = _tiny._load("configs/ffhq_p2_f32.json")
    with torch.device("meta"):
        f = flops.forward_flops(ref_adm.build(p2["model"], "meta"),
                                torch.empty(1, 256, 256, 3), 500.0)
    assert f == pytest.approx(388e9, rel=1e-3)
    # one P2 edit at the script's settings: 79 generation forwards to edit_t
    # 0.2, a 10-sweep basis over 3 + 5 probes, 20 strip steps at batch 9
    # (3 components, 3 frames each)
    eng = manifest.engine_module("uncond").Engine(p2, device="cpu", weight_seed=1,
                                                  server_seed=1, prompt_seed=1)
    assert eng.flops == 79 * f + flops.basis_flops(f, 10, 8) + 20 * 9 * f
    assert eng.flops == pytest.approx(1.63e14, rel=0.01)


def test_basis_counts_one_primal_and_two_passes_a_probe_and_sweep():
    assert flops.basis_flops(1.0, 10, 10) == 201.0
    assert flops.basis_flops(3.0, 0, 10) == 3.0
