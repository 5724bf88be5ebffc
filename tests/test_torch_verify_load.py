"""The port's --verify_load against the JAX package's on the CPU, on
synthetic tiny state_dicts of every family (adm, ddpm in both namings,
sd_unet, sd_vae, ifm, lpips, sam): the same classification, the same
`keys` and `params` fields, the same forward on the same fixed input,
strictness in both, the same verify_all sweep, the oracles reporting
"unavailable" where they cannot be built, and the CLI flag reaching the
verifier."""

import argparse
import re
import sys

import numpy as np
import pytest
import torch

from loco_edit_tpu.cli import verify_load as jax_vl
from loco_edit_tpu.models.adm.config import ADMConfig as JaxADMConfig
from loco_edit_tpu.models.ddpm import DDPMConfig as JaxDDPMConfig
from loco_edit_tpu.models.sd import VAEConfig as JVAEConfig
from loco_edit_tpu.models.sd import sd_preset as jsd_preset
from loco_edit_tpu_torch.cli import verify_load as vl
from loco_edit_tpu_torch.models.adm.presets import tiny_test_config
from loco_edit_tpu_torch.models.ddpm import DDPMConfig
from loco_edit_tpu_torch.models.sd import SDUNet, VAEConfig, VAEDecoder, VAEEncoder, sd_preset
from loco_edit_tpu_torch.models.sd import convert as sd_convert
from _torch_port_utils import tiny_sam_model
from test_if_convert import synthetic_if_state_dict
from test_torch_ddpm import TINY, _synth_adm, _synth_ddpm
from test_torch_metrics import _named as lpips_named
from test_torch_sd_models import VAE_KW, _synthetic_diffusers

torch.set_num_threads(2)

# max |y| of the two converted forwards on the same input, relative
FWD_RTOL = 1e-4


def _save(sd, path) -> str:
    torch.save({k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                for k, v in sd.items()}, str(path))
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One synthetic checkpoint per family, with the configs both verifiers
    get (None: the verifier's own inference)."""
    root = tmp_path_factory.mktemp("weights")
    acfg = tiny_test_config()
    jacfg = JaxADMConfig(**{f: getattr(acfg, f) for f in acfg.__dataclass_fields__
                            if f != "dtype"})
    ucfg = sd_preset("tiny")
    with torch.device("meta"):
        unet, enc, dec = SDUNet(ucfg), VAEEncoder(VAEConfig(**VAE_KW)), \
            VAEDecoder(VAEConfig(**VAE_KW))
    vae_sd = {**_synthetic_diffusers(enc, sd_convert._vae_rules(VAEConfig(**VAE_KW),
                                                                "encoder", False), 2),
              **_synthetic_diffusers(dec, sd_convert._vae_rules(VAEConfig(**VAE_KW),
                                                                "decoder", False), 3)}
    unet_sd = {k: v * 0.05 for k, v in _synthetic_diffusers(
        unet, sd_convert._unet_rules(ucfg), 1).items()}
    _, sam = tiny_sam_model()
    sam_dir = root / "sam_tiny"
    sam.save_pretrained(str(sam_dir))
    return {
        "adm": (_save(_synth_adm(acfg), root / "adm.pt"), acfg, jacfg),
        "ddpm": (_save(_synth_ddpm("sdedit"), root / "ddpm_sdedit.pt"),
                 DDPMConfig(**TINY), JaxDDPMConfig(**TINY)),
        "ddpm_diffusers": (_save(_synth_ddpm("diffusers"), root / "ddpm_diffusers.bin"),
                           DDPMConfig(**TINY), JaxDDPMConfig(**TINY)),
        "sd_unet": (_save(unet_sd, root / "unet.bin"), ucfg, jsd_preset("tiny")),
        "sd_vae": (_save(vae_sd, root / "vae.bin"), VAEConfig(**VAE_KW),
                   JVAEConfig(**VAE_KW)),
        "ifm": (_save(synthetic_if_state_dict(seed=3), root / "if.pt"), None, None),
        "lpips": (_save(lpips_named("alex", "lpips")[0], root / "lpips.pth"), None, None),
        "sam": (str(sam_dir), None, None),
        "root": str(root),
    }


def _call(mod, fam, path, cfg, oracle, port):
    dev = {"device": "cpu"} if port else {}
    if fam in ("adm", "ddpm", "ddpm_diffusers"):
        f = mod._verify_adm if fam == "adm" else mod._verify_ddpm
        return f(path, "", cfg, oracle, **dev)
    if fam in ("sd_unet", "sd_vae"):
        return getattr(mod, f"_verify_{fam}")(path, cfg, oracle, **dev)
    return getattr(mod, f"_verify_{fam}")(path, oracle, **dev)


def _max_abs(rep) -> float:
    return float(re.search(r"max\|y\|=([0-9.e+-]+)", rep["forward"]).group(1))


@pytest.mark.parametrize("fam", ["adm", "ddpm", "ddpm_diffusers", "sd_unet", "sd_vae",
                                 "ifm", "lpips", "sam"])
def test_verify_family_matches_jax(fam, ckpts, monkeypatch):
    """keys, params and the family fields equal JAX's; the forward's max |y|
    within FWD_RTOL of JAX's on the same fixed input (t = 500.5)."""
    path, cfg, jcfg = ckpts[fam]
    seen = {}

    def spy(finite, tag):
        def f(name, y):
            a = y.float().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            seen[tag] = float(np.max(np.abs(a)))
            return finite(name, y)
        return f

    for mod, tag in ((vl, "port"), (jax_vl, "jax")):
        monkeypatch.setattr(mod, "_finite", spy(mod._finite, tag))
    got = _call(vl, fam, path, cfg, False, True)
    ref = _call(jax_vl, fam, path, jcfg, False, False)
    assert got["family"] == ref["family"] and got["keys"] == ref["keys"] > 0
    assert got["params"] == ref["params"] > 0
    for k in ("naming", "net"):
        assert got.get(k) == ref.get(k)
    if fam == "ifm":
        assert {k: tuple(v) if isinstance(v, (list, tuple)) else v
                for k, v in got["inferred_config"].items()} == {
            k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in ref["inferred_config"].items()}
    assert got["forward"].split("shape=")[1] == ref["forward"].split("shape=")[1]
    assert abs(seen["port"] - seen["jax"]) <= FWD_RTOL * seen["jax"], seen
    assert abs(_max_abs(got) - seen["port"]) <= 1e-3 * seen["port"]


def test_strictness_and_oracles(ckpts, tmp_path, monkeypatch):
    """A key left over fails both verifiers; with no reference checkout
    (LOCO_REFERENCE_DIR unset) the adm/ddpm oracles say "unavailable"
    and do not raise; the diffusers families say why they have none; the
    SAM oracle (transformers' vision encoder) agrees."""
    import safetensors  # noqa: F401  (transformers' save_pretrained format)

    for fam in ("sd_unet", "ifm"):
        path, cfg, jcfg = ckpts[fam]
        sd = torch.load(path, weights_only=True)
        bad = _save({**sd, "extra.weight": torch.zeros(3)}, tmp_path / f"{fam}_bad.pt")
        with pytest.raises(ValueError, match="unconsumed"):
            _call(vl, fam, bad, cfg, False, True)
        with pytest.raises(Exception):
            _call(jax_vl, fam, bad, jcfg, False, False)
    adm_path, acfg, _ = ckpts["adm"]
    sd = torch.load(adm_path, weights_only=True)
    with pytest.raises(ValueError, match="unconsumed"):
        _call(vl, "adm", _save({**sd, "time_embed.9.weight": torch.zeros(2)},
                               tmp_path / "adm_extra.pt"), acfg, False, True)

    monkeypatch.delenv("LOCO_REFERENCE_DIR", raising=False)
    for fam in ("adm", "ddpm"):
        path, cfg, _ = ckpts[fam]
        assert _call(vl, fam, path, cfg, True, True)["oracle"].startswith("unavailable (")
    # other test files may leave a diffusers stub behind: make it absent
    monkeypatch.setitem(sys.modules, "diffusers", None)
    assert _call(vl, "sd_vae", *ckpts["sd_vae"][:2], True, True)["oracle"].startswith(
        "unavailable (diffusers not installed")
    rep = _call(vl, "sam", ckpts["sam"][0], None, True, True)
    assert float(rep["oracle"].split("max_abs_diff=")[1]) < 5e-4


def test_classify_and_verify_all_match_jax(ckpts, capsys):
    """classify_state_dict on the JAX test's fingerprints and on every
    synthetic checkpoint; verify_all over the weights root: the same files
    found, the same family and ok per file (the tiny ADM and DDPM fit no
    production preset, the SD files not the default geometry)."""
    fingerprints = [
        {"vision_encoder.patch_embed.projection.weight": 0}, {"lins.0.model.1.weight": 0},
        {"lin0.model.1.weight": 0}, {"input_blocks.0.0.weight": 0, "time_embed.0.weight": 0},
        {"temb.dense.0.weight": 0, "conv_in.weight": 0},
        {"decoder.conv_in.weight": 0, "quant_conv.weight": 0},
        {"down_blocks.0.resnets.0.conv1.weight": 0, "encoder_hid_proj.weight": 0},
        {"down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight": 0,
         "time_embedding.linear_1.weight": 0},
        {"down_blocks.0.resnets.0.conv1.weight": 0, "time_embedding.linear_1.weight": 0},
        {"completely.unknown.key": 0}]
    for fp in fingerprints:
        assert vl.classify_state_dict(fp) == jax_vl.classify_state_dict(fp)
    for fam in ("adm", "ddpm", "ddpm_diffusers", "sd_unet", "sd_vae", "ifm", "lpips"):
        sd = vl._load_sd(ckpts[fam][0])
        assert vl.classify_state_dict(sd) == jax_vl.classify_state_dict(sd) == \
            fam.split("_diffusers")[0]
    torch.save({"mystery.weight": torch.zeros(1)}, ckpts["root"] + "/junk.pt")

    def sweep(mod, **kw):
        args = argparse.Namespace(verify_load="all", checkpoint_path=ckpts["root"],
                                  model_name="", no_oracle=True, **kw)
        rep = mod.verify_checkpoint(args)
        capsys.readouterr()
        return rep, {r["checkpoint"]: (r.get("family"), r.get("ok"), r.get("skipped"))
                     for r in rep["reports"]}

    got, by = sweep(vl, device="cpu")
    ref, jby = sweep(jax_vl)
    assert by == jby
    assert (got["found"], got["checked"], got["ok"]) == (ref["found"], ref["checked"],
                                                         ref["ok"]) == (9, 8, False)
    oks = {p.rsplit("/", 1)[-1] for p, (_, ok, _) in by.items() if ok}
    assert oks == {"if.pt", "lpips.pth", "sam_tiny"}


def test_cli_flag_reaches_the_verifier(ckpts, monkeypatch, capsys):
    """--verify_load through the port's CLI: dispatched before preset (no
    --model_name needed), on --device, printing the report."""
    import json

    from loco_edit_tpu_torch.cli import main as climain

    seen = {}
    monkeypatch.setattr(vl, "verify_checkpoint",
                        lambda args, cfg=None: seen.update(fam=args.verify_load) or {"ok": True})
    assert climain.main(["--verify_load", "adm", "--checkpoint_path", "x.pt",
                         "--device", "cpu"]) == {"ok": True}
    assert seen["fam"] == "adm"
    monkeypatch.undo()
    rep = climain.main(["--verify_load", "lpips", "--checkpoint_path", ckpts["lpips"][0],
                        "--device", "cpu"])
    assert rep["ok"] and rep["net"] == "alex"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["family"] == "lpips"
    with pytest.raises(SystemExit):
        climain.main(["--verify_load", "nope", "--checkpoint_path", "x", "--device", "cpu"])
