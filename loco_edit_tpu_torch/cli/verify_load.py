"""`--verify_load`: one-command converted-checkpoint verification (port of
loco_edit_tpu/cli/verify_load.py).

The first command to run on a machine with real pretrained weights: load
the checkpoint, convert it through the port's converter (strict key
coverage: a key left unconsumed is an error), run the converted model
forward on a fixed input on `--device` (the card unless `--device cpu`),
and, when a torch-side oracle is constructible in the current environment,
run the source model on the SAME input on the CPU and report the max-abs
difference.

    python -m loco_edit_tpu_torch.cli.main --verify_load adm \
        --model_name FFHQ_P2 --checkpoint_path /path/ffhq_p2.pt
    python -m loco_edit_tpu_torch.cli.verify_load --family sd_unet \
        --checkpoint_path /path/unet.bin
    # sweep: classify + verify EVERY checkpoint under a weights root,
    # fitting ADM/DDPM presets to each file's geometry, one JSON report
    python -m loco_edit_tpu_torch.cli.main --verify_load all \
        --checkpoint_path /path/to/weights_root

Oracles by family:
  adm / ddpm   -> the reference's torch models (guided_diffusion UNetModel,
                  SDEdit DDPM), imported read-only from the reference
                  checkout named by LOCO_REFERENCE_DIR (its src/ and
                  src/models/ go on sys.path)
  sam          -> transformers SamModel (checkpoint dir)
  sd_unet, sd_vae, ifm, lpips
               -> reported as unavailable when diffusers / lpips are not
                  installed; conversion + strict coverage + forward
                  finiteness still verify the load end to end.
An oracle that cannot be built is reported as "unavailable (...)"; it
never raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from loco_edit_tpu_torch.core.device import resolve_device, use_full_f32
from loco_edit_tpu_torch.models.convert_util import KeyTracker


def _param_count(model: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def _finite(name: str, y) -> str:
    a = y.detach().float().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    if not np.all(np.isfinite(a)):
        raise ValueError(f"{name}: converted forward produced non-finite values")
    return f"finite, max|y|={float(np.max(np.abs(a))):.4g}, shape={tuple(a.shape)}"


def _load_sd(path: str) -> dict:
    from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint

    return load_torch_checkpoint(path)


def _strict(convert, sd, cfg, what: str, *extra) -> dict:
    """convert(sd, cfg, *extra) with every key of sd required to be read."""
    tracker = KeyTracker(sd)
    out = convert(tracker, cfg, *extra)
    tracker.check(what)
    return out


def _build(cls, cfg, state_dict, device):
    with torch.device(device):
        model = cls(cfg)
    model.load_state_dict(state_dict)
    return model.requires_grad_(False).eval()


def _device(device) -> torch.device:
    dev = resolve_device(device)
    use_full_f32()
    return dev


def _ref_path() -> bool:
    """Put the reference checkout's source dirs on sys.path; False when
    LOCO_REFERENCE_DIR names none."""
    root = os.environ.get("LOCO_REFERENCE_DIR", "")
    found = False
    for p in (os.path.join(root, "src", "models"), os.path.join(root, "src")):
        if root and os.path.isdir(p):
            found = True
            if p not in sys.path:
                sys.path.insert(0, p)
    return found


def _adm_input(image_size: int, channels: int) -> np.ndarray:
    return (np.random.default_rng(0).normal(size=(1, image_size, image_size, channels))
            .astype(np.float32) * 0.5)


@torch.no_grad()
def _verify_adm(path: str, model_name: str, cfg=None, oracle: bool = True,
                device="cuda") -> dict:
    from loco_edit_tpu_torch.models.adm import ADMUNet, adm_preset
    from loco_edit_tpu_torch.models.adm.convert import convert_adm_state_dict

    dev = _device(device)
    sd = _load_sd(path)
    cfg = cfg or adm_preset(model_name)
    model = _build(ADMUNet, cfg, _strict(convert_adm_state_dict, sd, cfg, "ADM"), dev)
    x = _adm_input(cfg.image_size, cfg.in_channels)
    t = 500.5
    y = model(torch.from_numpy(x).to(dev), t).float().cpu().numpy()
    rep = {"family": "adm", "keys": len(sd), "params": _param_count(model),
           "forward": _finite("adm", y)}
    if oracle:
        rep["oracle"] = _adm_oracle(sd, cfg, x, t, y)
    return rep


def _adm_oracle(sd, cfg, x, t, y_ours) -> str:
    try:
        if not _ref_path():
            raise ImportError("LOCO_REFERENCE_DIR names no reference checkout")
        from guided_diffusion.unet import UNetModel
    except Exception as e:
        return f"unavailable ({type(e).__name__}: {e})"
    ref = UNetModel(
        image_size=cfg.image_size, in_channels=cfg.in_channels,
        model_channels=cfg.model_channels, out_channels=cfg.out_channels,
        num_res_blocks=cfg.num_res_blocks,
        attention_resolutions=tuple(cfg.attention_ds), dropout=0.0,
        channel_mult=cfg.channel_mult, num_classes=cfg.num_classes,
        use_checkpoint=False, use_fp16=False, num_heads=cfg.num_heads,
        num_head_channels=cfg.num_head_channels,
        num_heads_upsample=cfg.num_heads_upsample,
        use_scale_shift_norm=cfg.use_scale_shift_norm,
        resblock_updown=cfg.resblock_updown, use_new_attention_order=False)
    ref.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    ref.eval()
    with torch.no_grad():
        y_ref = ref(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                    torch.tensor([t])).numpy()
    # eps: the reference's first out channels (learn_sigma adds the variance's)
    d = float(np.max(np.abs(y_ours.transpose(0, 3, 1, 2) - y_ref[:, :y_ours.shape[-1]])))
    return f"torch guided_diffusion UNetModel: max_abs_diff={d:.3e}"


def _diffusers_named(sd) -> bool:
    return any(k.startswith(("down_blocks.", "time_embedding.")) for k in sd)


@torch.no_grad()
def _verify_ddpm(path: str, model_name: str, cfg=None, oracle: bool = True,
                 device="cuda") -> dict:
    from loco_edit_tpu_torch.models.ddpm import (DDPMUNet, convert_ddpm_state_dict,
                                                 convert_diffusers_unet2d_state_dict)
    from loco_edit_tpu_torch.models.ddpm.loader import ddpm_preset

    dev = _device(device)
    sd = _load_sd(path)
    cfg = cfg or ddpm_preset(model_name or "CelebA_HQ_HF")
    diffusers_named = _diffusers_named(sd)
    conv = (convert_diffusers_unet2d_state_dict if diffusers_named
            else convert_ddpm_state_dict)
    model = _build(DDPMUNet, cfg, _strict(conv, sd, cfg, "DDPM"), dev)
    x = _adm_input(cfg.resolution, cfg.in_channels)
    t = 500.5
    y = model(torch.from_numpy(x).to(dev), t).float().cpu().numpy()
    rep = {"family": "ddpm", "naming": "diffusers" if diffusers_named else "sdedit",
           "keys": len(sd), "params": _param_count(model),
           "forward": _finite("ddpm", y)}
    if oracle:
        rep["oracle"] = (_ddpm_oracle(sd, cfg, x, t, y) if not diffusers_named
                         else _diffusers_note("UNet2DModel"))
    return rep


def _ddpm_oracle(sd, cfg, x, t, y_ours) -> str:
    try:
        if not _ref_path():
            raise ImportError("LOCO_REFERENCE_DIR names no reference checkout")
        from ddpm.diffusion import DDPM, PullBackDDPM
    except Exception as e:
        return f"unavailable ({type(e).__name__}: {e})"

    class _NS:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    config = _NS(model=_NS(ch=cfg.ch, out_ch=cfg.out_ch, ch_mult=list(cfg.ch_mult),
                           num_res_blocks=cfg.num_res_blocks,
                           attn_resolutions=list(cfg.attn_resolutions),
                           dropout=0.0, in_channels=cfg.in_channels,
                           resamp_with_conv=cfg.resamp_with_conv),
                 data=_NS(image_size=cfg.resolution))
    ref = DDPM(config)
    ref.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    ref.eval()
    ref.device = torch.device("cpu")
    ref.dtype = torch.float32
    with torch.no_grad():
        y_ref = PullBackDDPM.forward(ref, torch.from_numpy(x.transpose(0, 3, 1, 2)),
                                     torch.tensor([t])).numpy()
    # eps: the reference's first out channels (learn_sigma adds the variance's)
    d = float(np.max(np.abs(y_ours.transpose(0, 3, 1, 2) - y_ref[:, :y_ours.shape[-1]])))
    return f"torch SDEdit DDPM: max_abs_diff={d:.3e}"


@torch.no_grad()
def _verify_sd_unet(path: str, cfg=None, oracle: bool = True, device="cuda") -> dict:
    from loco_edit_tpu_torch.models.sd import SDUNet, sd_preset
    from loco_edit_tpu_torch.models.sd.convert import convert_sd_unet_state_dict

    dev = _device(device)
    sd = _load_sd(path)
    cfg = cfg or sd_preset("sd21-base")
    model = _build(SDUNet, cfg, convert_sd_unet_state_dict(sd, cfg), dev)
    s = cfg.sample_size
    z = np.random.default_rng(0).normal(size=(1, s, s, 4)).astype(np.float32)
    ctx = np.random.default_rng(1).normal(
        size=(1, 77, cfg.cross_attention_dim)).astype(np.float32) * 0.1
    y = model(torch.from_numpy(z).to(dev), 500.5, torch.from_numpy(ctx).to(dev))
    return {"family": "sd_unet", "keys": len(sd), "params": _param_count(model),
            "forward": _finite("sd_unet", y),
            "oracle": _diffusers_note("UNet2DConditionModel") if oracle else ""}


@torch.no_grad()
def _verify_sd_vae(path: str, cfg=None, oracle: bool = True, device="cuda") -> dict:
    from loco_edit_tpu_torch.models.sd import VAEConfig, VAEDecoder
    from loco_edit_tpu_torch.models.sd.convert import convert_vae_state_dict

    dev = _device(device)
    sd = _load_sd(path)
    cfg = cfg or VAEConfig()
    _, pd = convert_vae_state_dict(sd, cfg)
    dec = _build(VAEDecoder, cfg, pd, dev)
    lat = cfg.sample_size // (2 ** (len(cfg.block_out_channels) - 1))
    z = np.random.default_rng(0).normal(
        size=(1, lat, lat, cfg.latent_channels)).astype(np.float32)
    y = dec(torch.from_numpy(z).to(dev))
    return {"family": "sd_vae", "keys": len(sd), "params": _param_count(dec),
            "forward": _finite("sd_vae", y),
            "oracle": _diffusers_note("AutoencoderKL") if oracle else ""}


@torch.no_grad()
def _verify_ifm(path: str, oracle: bool = True, device="cuda") -> dict:
    from loco_edit_tpu_torch.models.ifm import IFUNet, convert_if_state_dict, infer_if_config

    dev = _device(device)
    sd = _load_sd(path)
    cfg = infer_if_config(sd)
    model = _build(IFUNet, cfg, convert_if_state_dict(sd, cfg), dev)
    x = np.random.default_rng(0).normal(
        size=(1, cfg.sample_size, cfg.sample_size, cfg.in_channels)).astype(np.float32) * 0.5
    ctx = np.random.default_rng(1).normal(
        size=(1, 77, cfg.encoder_hid_dim)).astype(np.float32) * 0.1
    aug = (250.0,) if cfg.class_embed_timestep else ()
    y = model(torch.from_numpy(x).to(dev), 500.5, torch.from_numpy(ctx).to(dev), *aug)
    return {
        "family": "ifm", "keys": len(sd), "params": _param_count(model),
        "forward": _finite("ifm", y),
        # the shape-unrecoverable config choices are surfaced so a
        # mismatched real checkpoint is caught by eye even without an oracle
        "inferred_config": {k: getattr(cfg, k) for k in (
            "sample_size", "in_channels", "out_channels", "block_out_channels",
            "layers_per_block", "attention_head_dim", "encoder_hid_dim")
            if hasattr(cfg, k)},
        "oracle": _diffusers_note("UNet2DConditionModel (IF)") if oracle else "",
    }


@torch.no_grad()
def _verify_lpips(path: str, oracle: bool = True, device="cuda") -> dict:
    from loco_edit_tpu_torch.utils.lpips import LPIPSMetric

    dev = _device(device)
    sd = _load_sd(path)
    metric = LPIPSMetric.from_state_dict(sd, device=dev)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(1, 64, 64, 3)).astype(np.float32).clip(-1, 1)
    b = rng.normal(size=(1, 64, 64, 3)).astype(np.float32).clip(-1, 1)
    y = metric(a, b)
    note = "unavailable (lpips package not installed)"
    if oracle:
        try:
            import lpips  # noqa: F401

            note = "lpips package present: compare manually via utils.metrics"
        except Exception:
            pass
    return {"family": "lpips", "net": metric.net, "keys": len(sd),
            "params": _param_count(metric.model),
            "forward": _finite("lpips", y), "oracle": note}


@torch.no_grad()
def _verify_sam(path: str, oracle: bool = True, device="cuda") -> dict:
    """path: a SamModel save_pretrained directory (or a file holding a
    HF-named SamModel state_dict). The oracle is transformers' SamModel
    vision encoder on the same weights, when transformers is installed."""
    from loco_edit_tpu_torch.masks.sam import _read_pretrained_dir, prepare_sam

    dev = _device(device)
    if os.path.isdir(path):
        config, sd = _read_pretrained_dir(path)
    else:
        config, sd = None, _load_sd(path)
    bundle = prepare_sam(sd, config=config, device=dev)
    keys = sum(1 for k in sd if k.startswith("vision_encoder."))
    s = bundle.cfg.image_size
    x = np.random.default_rng(0).normal(size=(1, s, s, 3)).astype(np.float32) * 0.3
    y = bundle.encoder(torch.from_numpy(x).to(dev)).float().cpu().numpy()
    rep = {"family": "sam", "keys": keys, "params": _param_count(bundle.encoder),
           "forward": _finite("sam", y)}
    if oracle:
        rep["oracle"] = _sam_oracle(path, x, y)
    return rep


def _sam_oracle(path, x, y_ours) -> str:
    try:
        from transformers import SamModel

        tm = SamModel.from_pretrained(path).eval()
    except Exception as e:
        return f"unavailable ({type(e).__name__}: {e})"
    with torch.no_grad():
        y_ref = tm.vision_encoder(torch.from_numpy(x.transpose(0, 3, 1, 2))).last_hidden_state
    # transformers' neck outputs channels-first
    d = float(np.max(np.abs(y_ours - y_ref.numpy().transpose(0, 2, 3, 1))))
    return f"transformers SamModel vision encoder: max_abs_diff={d:.3e}"


def _diffusers_note(cls: str) -> str:
    try:
        import diffusers  # noqa: F401

        return (f"diffusers installed: torch {cls} oracle not wired yet; "
                "strict key coverage + finite forward verified")
    except Exception:
        return (f"unavailable (diffusers not installed; torch {cls} cannot "
                "be built). Conversion consumed every checkpoint key and the "
                "converted forward is finite: the two failure modes a "
                "partial/misrouted load would trip.")


def classify_state_dict(sd: dict) -> str | None:
    """Map a loaded torch state_dict to a verifier family by key fingerprint
    (the reference has one loader per family; here the keys identify the
    family so a weights directory can be swept without per-file flags)."""
    keys = set(sd)

    def any_start(*prefixes):
        return any(k.startswith(prefixes) for k in keys)

    if any_start("vision_encoder."):
        return "sam"
    if any(".model." in k and k.startswith(("lin", "lins.")) for k in keys):
        return "lpips"
    if any_start("input_blocks.", "time_embed."):
        return "adm"                      # guided_diffusion naming
    if any_start("temb.dense.0.", "down.0.block."):
        return "ddpm"                     # SDEdit naming
    if any_start("decoder.conv_in.", "post_quant_conv.") or "quant_conv.weight" in keys:
        return "sd_vae"
    if any_start("down_blocks.", "time_embedding."):
        # three diffusers UNets share this prefix: IF carries the T5 context
        # projection; SD carries cross-attention without it; plain UNet2D
        # (diffusers-format DDPM) has neither
        if any("encoder_hid_proj" in k for k in keys):
            return "ifm"
        if any(".attn2." in k for k in keys):
            return "sd_unet"
        return "ddpm"
    return None


def _iter_candidates(root: str):
    """Yield (path, kind) under root: checkpoint files and SAM
    save_pretrained directories."""
    exts = (".pt", ".pth", ".ckpt", ".bin", ".safetensors")
    for dirpath, dirnames, filenames in os.walk(root):
        if "config.json" in filenames:
            try:
                with open(os.path.join(dirpath, "config.json")) as f:
                    if '"sam"' in f.read():
                        yield dirpath, "sam_dir"
                        dirnames[:] = []   # don't descend into the save dir
                        continue
            except OSError:
                pass
        for fn in sorted(filenames):
            if fn.endswith(exts):
                yield os.path.join(dirpath, fn), "file"


def _infer_adm_cfg(sd: dict):
    """Pick the ADM preset whose geometry the checkpoint fits, by attempting
    the strict-coverage conversion against each DISTINCT preset config (a
    wrong geometry raises on the first mismatched key or on a key left over;
    class-cond is pre-filtered by the label_emb key). Returns (cfg,
    preset_name) or raises with the per-preset failures."""
    from loco_edit_tpu_torch.models.adm import ADMUNet
    from loco_edit_tpu_torch.models.adm.convert import convert_adm_state_dict
    from loco_edit_tpu_torch.models.adm.presets import PRESETS, adm_preset
    from loco_edit_tpu_torch.models.convert_util import check_state_dict

    has_label = any(k.startswith("label_emb.") for k in sd)
    failures, seen = [], set()
    for name in PRESETS:
        cfg = adm_preset(name)
        key = (cfg.image_size, cfg.model_channels, cfg.num_res_blocks,
               cfg.attention_ds, cfg.num_classes is not None, cfg.num_heads,
               cfg.num_head_channels, cfg.resblock_updown)
        if key in seen or (cfg.num_classes is not None) != has_label:
            continue
        seen.add(key)
        try:
            out = _strict(convert_adm_state_dict, sd, cfg, "ADM")
            with torch.device("meta"):
                check_state_dict(out, ADMUNet(cfg), name)
            return cfg, name
        except Exception as e:  # noqa: BLE001: try the next geometry
            failures.append(f"{name}: {type(e).__name__}")
    raise ValueError(f"no ADM preset fits this checkpoint ({failures})")


def _infer_ddpm_cfg(sd: dict):
    """Same preset-fitting for the SDEdit/diffusers DDPM family."""
    from loco_edit_tpu_torch.models.convert_util import check_state_dict
    from loco_edit_tpu_torch.models.ddpm import (DDPMUNet, convert_ddpm_state_dict,
                                                 convert_diffusers_unet2d_state_dict)
    from loco_edit_tpu_torch.models.ddpm.loader import DDPM_PRESETS, ddpm_preset

    conv = (convert_diffusers_unet2d_state_dict if _diffusers_named(sd)
            else convert_ddpm_state_dict)
    failures, seen = [], set()
    for name in sorted(DDPM_PRESETS):
        cfg = ddpm_preset(name)
        key = (cfg.resolution, cfg.ch, tuple(cfg.ch_mult), cfg.num_res_blocks)
        if key in seen:
            continue
        seen.add(key)
        try:
            out = _strict(conv, sd, cfg, "DDPM")
            with torch.device("meta"):
                check_state_dict(out, DDPMUNet(cfg), name)
            return cfg, name
        except Exception as e:  # noqa: BLE001
            failures.append(f"{name}: {type(e).__name__}")
    raise ValueError(f"no DDPM preset fits this checkpoint ({failures})")


def verify_all(args) -> dict:
    """`--verify_load all --checkpoint_path <weights_root>`: sweep every
    checkpoint found under the root, classify each by key fingerprint, run
    its family verifier, and emit ONE JSON report. Individual failures are
    recorded (ok: false + error) without aborting the sweep."""
    root = args.checkpoint_path
    reports = []
    for path, kind in _iter_candidates(root):
        item = {"checkpoint": path}
        try:
            cfg = None
            if kind == "sam_dir":
                fam = "sam"
            else:
                sd = _load_sd(path)
                fam = classify_state_dict(sd)
                if fam is None:
                    item.update(family=None, skipped=True,
                                note="unrecognized key fingerprint")
                    reports.append(item)
                    continue
                # the sweep carries no per-file --model_name: fit the preset
                # to the checkpoint's geometry instead
                if fam == "adm" and not getattr(args, "model_name", ""):
                    cfg, item["inferred_preset"] = _infer_adm_cfg(sd)
                elif fam == "ddpm" and not getattr(args, "model_name", ""):
                    cfg, item["inferred_preset"] = _infer_ddpm_cfg(sd)
            sub = argparse.Namespace(**vars(args))
            sub.checkpoint_path = path
            if not getattr(sub, "model_name", ""):
                sub.model_name = ""
            item.update(_HANDLERS[fam](sub, cfg))
            item["ok"] = True
        except Exception as e:  # noqa: BLE001: the sweep must finish
            item.update(ok=False, error=f"{type(e).__name__}: {e}")
        reports.append(item)
    checked = [r for r in reports if not r.get("skipped")]
    out = {"root": root, "found": len(reports), "checked": len(checked),
           "ok": bool(checked) and all(r.get("ok") for r in checked),
           "reports": reports}
    print(json.dumps(out, default=str))
    return out


def _dev(a):
    return getattr(a, "device", "cuda")


_HANDLERS = {
    "adm": lambda a, cfg: _verify_adm(a.checkpoint_path, a.model_name, cfg,
                                      not a.no_oracle, _dev(a)),
    "ddpm": lambda a, cfg: _verify_ddpm(a.checkpoint_path, a.model_name, cfg,
                                        not a.no_oracle, _dev(a)),
    "sd_unet": lambda a, cfg: _verify_sd_unet(a.checkpoint_path, cfg,
                                              not a.no_oracle, _dev(a)),
    "sd_vae": lambda a, cfg: _verify_sd_vae(a.checkpoint_path, cfg,
                                            not a.no_oracle, _dev(a)),
    "ifm": lambda a, cfg: _verify_ifm(a.checkpoint_path, not a.no_oracle, _dev(a)),
    "lpips": lambda a, cfg: _verify_lpips(a.checkpoint_path, not a.no_oracle, _dev(a)),
    "sam": lambda a, cfg: _verify_sam(a.checkpoint_path, not a.no_oracle, _dev(a)),
}

FAMILIES = tuple(_HANDLERS)


def verify_checkpoint(args, cfg=None) -> dict:
    """Run one family's verification on args.device (the card unless
    "cpu"); returns the report dict (raises on any conversion, coverage or
    finiteness failure)."""
    fam = args.verify_load
    if not getattr(args, "no_oracle", None):
        args.no_oracle = False
    if fam == "all":
        return verify_all(args)
    if fam not in _HANDLERS:
        raise SystemExit(
            f"--verify_load must be 'all' or one of {FAMILIES}, got {fam!r}")
    rep = _HANDLERS[fam](args, cfg)
    rep["checkpoint"] = args.checkpoint_path
    rep["ok"] = True
    print(json.dumps(rep, default=str))
    return rep


def main(argv=None):
    p = argparse.ArgumentParser("loco-edit-tpu verify_load")
    p.add_argument("--family", required=True, choices=FAMILIES + ("all",))
    p.add_argument("--checkpoint_path", required=True)
    p.add_argument("--model_name", default="")
    p.add_argument("--no_oracle", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, the default) | cpu")
    a = p.parse_args(argv)
    a.verify_load = a.family
    return verify_checkpoint(a)


if __name__ == "__main__":
    main()
