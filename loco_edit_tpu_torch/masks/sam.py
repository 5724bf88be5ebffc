"""SAM mask extraction (port of loco_edit_tpu/masks/sam.py).

The reference runs HF's mask-generation pipeline (facebook/sam-vit-large)
on the decoded image, saves ALL candidate masks plus per-mask overlays, and
exits when --sampling_mode; a follow-up run picks --mask_index
(src/modules/mask_segmentation.py:11-47, edit.py:2237-2247).

Two backends, named as on the JAX package's command line:
  - `hf_pipeline`: `segment_image`, transformers' pipeline on the host (needs
    transformers);
  - `flax`: `segment_image_on_device`, the port's own SAM
    (masks/sam_vit.py + masks/sam_decoder.py) on the card: the encoder
    once, the point grid decoded in batches of `points_per_batch`, only
    boolean candidate masks and scores back to the host for the filters,
    box NMS and the IoU dedup (the numpy helpers below, as in JAX).

Weights (`prepare_sam`): a HF-named SamModel state_dict, a file holding one,
or a local `save_pretrained` directory (config.json + weights). A hub name
of a published geometry (`sam_preset`) with no local file gives seeded
random weights at that geometry: the repo holds no SAM weights and the card
has no network.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from loco_edit_tpu_torch.core.device import resolve_device, use_full_f32
from loco_edit_tpu_torch.masks.sam_decoder import (SamDecoderConfig, SamMaskDecodeModel,
                                                   convert_sam_decoder_state_dict,
                                                   decoder_config_from_hf)
from loco_edit_tpu_torch.masks.sam_vit import (VIT_BASE, VIT_HUGE, VIT_LARGE, SamViTConfig,
                                               SamViTEncoder, config_from_hf,
                                               convert_sam_vision_state_dict)
from loco_edit_tpu_torch.utils.io import to_uint8

SAM_PRESETS = {"facebook/sam-vit-base": VIT_BASE, "facebook/sam-vit-large": VIT_LARGE,
               "facebook/sam-vit-huge": VIT_HUGE}
_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def segment_image(image_uint8: np.ndarray, model_name: str = "facebook/sam-vit-large",
                  filter_mask: int = 100, resolution: int = 256,
                  cache_folder: str | None = None) -> np.ndarray:
    """Run transformers' SAM mask-generation pipeline on the host; returns
    (N, H, W) boolean masks resized to `resolution`, filtered by minimum
    area (reference filter_mask=100). cache_folder is the HF weights cache
    dir (reference mask_segmentation.py:11 cache_dir=args.cache_folder).
    model_name must be a local save_pretrained directory: the port never
    fetches weights."""
    check_sam_source("hf_pipeline", model_name)
    from PIL import Image
    from transformers import pipeline

    kw = {"model_kwargs": {"cache_dir": cache_folder}} if cache_folder else {}
    generator = pipeline("mask-generation", model=model_name, **kw)
    outputs = generator(Image.fromarray(image_uint8), points_per_batch=64)
    masks = []
    for m in outputs["masks"]:
        m = np.asarray(m, bool)
        if m.sum() <= filter_mask:
            continue
        mi = Image.fromarray(m.astype(np.uint8) * 255).resize((resolution, resolution))
        masks.append(np.asarray(mi) > 127)
    if not masks:
        raise RuntimeError("SAM produced no masks above the area filter")
    return np.stack(masks)


def check_sam_source(backend: str, model_name: str) -> None:
    """Raise unless SAM can run here with these flags, before anything is
    built: the flax backend needs a local file or directory or a preset
    name, hf_pipeline a local save_pretrained directory and the
    transformers package."""
    if backend == "flax":
        if not (os.path.exists(model_name) or model_name in SAM_PRESETS):
            raise FileNotFoundError(
                f"--mask_model_name {model_name!r}: not a local file or directory, nor one "
                f"of {sorted(SAM_PRESETS)}")
        return
    if not os.path.isdir(model_name):
        raise FileNotFoundError(
            f"--mask_backend hf_pipeline reads a local save_pretrained directory, and "
            f"{model_name!r} is none (weights are never fetched); --mask_backend flax runs "
            "the port's own SAM, with seeded random weights for a hub name")
    try:
        import transformers  # noqa: F401
    except ImportError as e:
        raise ImportError("--mask_backend hf_pipeline needs the transformers package; "
                          "--mask_backend flax runs the port's own SAM on the card") from e


def _stability_scores(logits: np.ndarray, mask_threshold: float = 0.0,
                      offset: float = 1.0) -> np.ndarray:
    """SAM's stability score: IoU of the mask binarized at threshold+offset
    vs threshold-offset on the raw logits (HF AMG default offset 1.0) —
    near-1 means the mask barely moves under threshold perturbation."""
    hi = (logits > (mask_threshold + offset)).reshape(logits.shape[0], -1)
    lo = (logits > (mask_threshold - offset)).reshape(logits.shape[0], -1)
    inter = hi.sum(-1).astype(np.float64)
    union = lo.sum(-1).astype(np.float64)
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _mask_boxes(masks: np.ndarray) -> np.ndarray:
    """Bounding boxes (x0, y0, x1, y1) of boolean masks (N, H, W)."""
    boxes = np.zeros((masks.shape[0], 4), np.float64)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if ys.size:
            boxes[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
    return boxes


def _box_nms(boxes: np.ndarray, scores: np.ndarray, iou: float) -> np.ndarray:
    """Greedy box NMS (the AMG postprocess step HF runs via torchvision);
    returns kept indices in descending score order. The pairwise IoU against
    the kept set is a numpy broadcast: a dense 32x32-grid scene proposes ~3k
    candidates."""
    order = np.argsort(-scores)
    b = boxes[order].astype(np.float64)
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    kept: list[int] = []
    for i in range(b.shape[0]):
        if kept:
            kb = b[kept]
            ix0 = np.maximum(b[i, 0], kb[:, 0])
            iy0 = np.maximum(b[i, 1], kb[:, 1])
            ix1 = np.minimum(b[i, 2], kb[:, 2])
            iy1 = np.minimum(b[i, 3], kb[:, 3])
            inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
            union = areas[i] + areas[kept] - inter
            if np.any((union > 0) & (inter / np.maximum(union, 1e-300) > iou)):
                continue
        kept.append(i)
    return order[kept].astype(np.int64)


class SamBundle:
    """The encoder and decoder on one device with their configs, reusable
    across segment calls. `timings` holds the last segment_image_on_device
    call's seconds ("encode", "decode" over "decode_batches" batches, the
    host "filter") and counts ("candidates", "kept")."""

    def __init__(self, cfg: SamViTConfig, dcfg: SamDecoderConfig,
                 encoder: SamViTEncoder, decoder: SamMaskDecodeModel,
                 device: torch.device):
        self.cfg, self.dcfg = cfg, dcfg
        self.encoder = encoder.requires_grad_(False).eval()
        self.decoder = decoder.requires_grad_(False).eval()
        self.device = device
        self.timings: dict = {}


def sam_preset(name: str) -> tuple[SamViTConfig, SamDecoderConfig]:
    """The encoder and decoder geometry of a published SAM by hub name
    (facebook/sam-vit-{base,large,huge}); every size shares the decoder."""
    if name not in SAM_PRESETS:
        raise ValueError(f"no SAM preset named {name!r}; known: {sorted(SAM_PRESETS)}")
    return SAM_PRESETS[name], SamDecoderConfig()


def _configs_from_state_dict(sd: Mapping) -> tuple[SamViTConfig, SamDecoderConfig]:
    """The geometry of a HF-named SamModel state_dict, read from its shapes.
    The decoder's head count is not in the shapes: it is HF's default, 8,
    which every published SAM uses."""
    v, pe, md = "vision_encoder.", "prompt_encoder.", "mask_decoder."

    def count(prefix: str, leaf: str) -> int:
        n = 0
        while f"{prefix}{n}.{leaf}" in sd:
            n += 1
        return n

    c, _, patch, _ = sd[f"{v}patch_embed.projection.weight"].shape
    grid = sd[f"{v}pos_embed"].shape[1]
    layers = count(f"{v}layers.", "attn.qkv.weight")
    lens = [sd[f"{v}layers.{i}.attn.rel_pos_h"].shape[0] for i in range(layers)]
    head_dim = sd[f"{v}layers.0.attn.rel_pos_h"].shape[1]
    windowed = [n for n in lens if n != 2 * grid - 1]
    hidden = sd[f"{md}iou_token.weight"].shape[1]
    pe_key = next(k for k in ("shared_image_embedding.positional_embedding",
                              f"{pe}shared_embedding.positional_embedding") if k in sd)
    cfg = SamViTConfig(
        image_size=grid * patch, patch_size=patch, hidden_size=c, num_layers=layers,
        num_heads=c // head_dim,
        mlp_ratio=sd[f"{v}layers.0.mlp.lin1.weight"].shape[0] / c,
        window_size=(windowed[0] + 1) // 2 if windowed else 14,
        global_attn_indexes=tuple(i for i, n in enumerate(lens) if n == 2 * grid - 1),
        output_channels=sd[f"{v}neck.conv1.weight"].shape[0])
    dcfg = SamDecoderConfig(
        hidden_size=hidden, num_pos_feats=sd[pe_key].shape[1],
        num_hidden_layers=count(f"{md}transformer.layers.", "mlp.lin1.weight"),
        attention_downsample_rate=hidden // sd[
            f"{md}transformer.final_attn_token_to_image.q_proj.weight"].shape[0],
        mlp_dim=sd[f"{md}transformer.layers.0.mlp.lin1.weight"].shape[0],
        num_multimask_outputs=sd[f"{md}mask_tokens.weight"].shape[0] - 1,
        iou_head_depth=count(f"{md}iou_prediction_head.layers.", "weight") + 2,
        iou_head_hidden_dim=sd[f"{md}iou_prediction_head.proj_in.weight"].shape[0],
        image_embedding_size=grid, input_image_size=grid * patch,
        mask_input_channels=sd[f"{pe}mask_embed.conv2.weight"].shape[0])
    return cfg, dcfg


def _read_pretrained_dir(path: str) -> tuple[dict, dict]:
    """(config dict, state_dict) of a SamModel.save_pretrained directory."""
    from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint

    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    for name in ("model.safetensors", "pytorch_model.bin"):
        if os.path.isfile(os.path.join(path, name)):
            return config, load_torch_checkpoint(os.path.join(path, name))
    raise FileNotFoundError(f"{path}: no model.safetensors or pytorch_model.bin")


def prepare_sam(source, *, config=None, device: str | torch.device = "cuda",
                seed: int = 0) -> SamBundle:
    """A SamBundle on `device` (the card unless the caller asks for the CPU).

    source: a HF-named SamModel state_dict (a mapping of arrays or tensors),
    the path of a file holding one (geometry read from its shapes, or from
    `config`: a SamConfig or its dict), a local save_pretrained directory,
    or a hub name in SAM_PRESETS with no such file or directory, which gives
    seeded random weights (`init_random_` from a generator seeded with
    `seed`) at that geometry. SAM computes in f32: this sets the port's f32
    policy (core/device.py::use_full_f32)."""
    dev = resolve_device(device)
    use_full_f32()
    if isinstance(source, Mapping):
        sd = source
    elif os.path.isdir(source):
        config, sd = _read_pretrained_dir(source)
    elif os.path.isfile(source):
        from loco_edit_tpu_torch.models.adm.convert import load_torch_checkpoint

        sd = load_torch_checkpoint(source)
    elif source in SAM_PRESETS:
        cfg, dcfg = sam_preset(source)
        g = torch.Generator(dev).manual_seed(seed)
        with torch.device(dev):
            enc, dec = SamViTEncoder(cfg), SamMaskDecodeModel(dcfg)
        enc.init_random_(g)
        dec.init_random_(g, pe_scale=cfg.hidden_size // 2)
        print(f"prepare_sam: no local weights at {source!r}; seeded random weights "
              f"(seed {seed}) at its geometry", flush=True)
        return SamBundle(cfg, dcfg, enc, dec, dev)
    else:
        raise FileNotFoundError(
            f"SAM weights {source!r}: not a file, a save_pretrained directory or one "
            f"of {sorted(SAM_PRESETS)}")
    if config is None:
        cfg, dcfg = _configs_from_state_dict(sd)
    else:
        cfg = config_from_hf(config["vision_config"] if isinstance(config, Mapping)
                             else config.vision_config)
        dcfg = decoder_config_from_hf(config)
    with torch.device(dev):
        enc, dec = SamViTEncoder(cfg), SamMaskDecodeModel(dcfg)
    enc.load_state_dict(convert_sam_vision_state_dict(sd, cfg))
    dec.load_state_dict(convert_sam_decoder_state_dict(sd, dcfg))
    return SamBundle(cfg, dcfg, enc, dec, dev)


def _resize(m: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W) bilinear resize with half-pixel centers and no antialiasing
    (jax.image.resize(..., "bilinear", antialias=False) in the JAX package),
    on the upscale and the downscale alike."""
    return F.interpolate(m[:, None], size=(h, w), mode="bilinear",
                         align_corners=False)[:, 0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def _candidates(prepared: SamBundle, image_uint8: np.ndarray, sam_model, *,
                use_device_decoder: bool, points_per_side: int, points_per_batch: int,
                resolution: int, mask_threshold: float):
    """Every grid point's 3 candidate masks before any filter: (masks
    (3 * points, resolution, resolution) bool, predicted IoU, stability),
    numpy. Records "encode", "decode" and "decode_batches" in
    prepared.timings."""
    from PIL import Image

    cfg, dev, timings = prepared.cfg, prepared.device, prepared.timings
    size = cfg.image_size
    orig_h, orig_w = image_uint8.shape[:2]
    # SamImageProcessor: longest-edge bilinear resize, then zero-pad (in
    # normalized space) to a size x size square
    scale = size / max(orig_h, orig_w)
    new_h, new_w = int(orig_h * scale + 0.5), int(orig_w * scale + 0.5)
    pil = Image.fromarray(image_uint8).resize((new_w, new_h), Image.BILINEAR)
    x = np.zeros((size, size, 3), np.float32)
    x[:new_h, :new_w] = (np.asarray(pil, np.float32) - _PIXEL_MEAN) / _PIXEL_STD

    # uniform point grid over the ORIGINAL image (HF build_point_grid),
    # mapped into resized-frame pixel coords the prompt encoder expects
    gx = (np.arange(points_per_side) + 0.5) / points_per_side * new_w
    gy = (np.arange(points_per_side) + 0.5) / points_per_side * new_h
    pts = np.stack(np.meshgrid(gx, gy), -1).reshape(1, -1, 1, 2).astype(np.float32)
    n_pts = pts.shape[1]
    ppb = max(1, min(points_per_batch, n_pts))
    n_pad = (-n_pts) % ppb
    if n_pad:  # pad the grid to a batch multiple; extras dropped below
        pts = np.concatenate([pts, np.repeat(pts[:, :1], n_pad, 1)], axis=1)

    t0 = time.perf_counter()
    emb = prepared.encoder(torch.from_numpy(x[None]).to(dev))
    _sync(dev)
    timings["encode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cand_l, iou_l, stab_l = [], [], []
    for i in range(0, pts.shape[1], ppb):
        points = torch.from_numpy(pts[:, i:i + ppb])
        labels = torch.ones(points.shape[:3], dtype=torch.int32)
        if use_device_decoder:
            m, s = prepared.decoder(emb, points=points.to(dev), labels=labels.to(dev))
        else:
            out = sam_model(image_embeddings=emb.cpu().permute(0, 3, 1, 2),
                            input_points=points, input_labels=labels,
                            multimask_output=True)
            m, s = out.pred_masks.float(), out.iou_scores.float()
        m = m.reshape(-1, *m.shape[-2:])  # (3*ppb, h, w) low-res logits
        # HF post_process_masks: low-res -> padded frame -> crop -> image frame
        m = _resize(m, size, size)[:, :new_h, :new_w]
        mi = _resize(m, orig_h, orig_w)
        # stability on the image-frame logits (filter_masks order)
        hi = (mi > mask_threshold + 1.0).sum((1, 2)).float()
        lo = (mi > mask_threshold - 1.0).sum((1, 2)).float()
        stab_l.append(torch.where(lo > 0, hi / lo.clamp(min=1.0), 0.0).cpu().numpy())
        if (orig_h, orig_w) != (resolution, resolution):
            mi = _resize(m, resolution, resolution)
        cand_l.append((mi > mask_threshold).cpu().numpy())
        iou_l.append(s.reshape(-1).cpu().numpy())
    timings["decode"] = time.perf_counter() - t0
    timings["decode_batches"] = len(cand_l)
    return (np.concatenate(cand_l)[:3 * n_pts], np.concatenate(iou_l)[:3 * n_pts],
            np.concatenate(stab_l)[:3 * n_pts])


def segment_image_on_device(
        image_uint8: np.ndarray, sam_model=None, *, prepared: SamBundle | None = None,
        use_device_decoder: bool = True, device: str | torch.device = "cuda",
        points_per_side: int = 32, points_per_batch: int = 64,
        filter_mask: int = 100, resolution: int = 256,
        iou_threshold: float = 0.88, dedup_iou: float = 0.9,
        mask_threshold: float = 0.0, stability_thresh: float = 0.95,
        box_nms_iou: float = 0.7) -> np.ndarray:
    """Automatic mask generation with the port's SAM (port of
    segment_image_flax_encoder). Returns (N, resolution, resolution) bool.

    prepared: a `prepare_sam` bundle; without one, sam_model (a transformers
    SamModel, the weight source) is converted onto `device`. The encoder
    runs once; the point grid is decoded in batches of points_per_batch (the
    grid padded to a whole batch, the extras dropped). With
    use_device_decoder=False the decode runs through sam_model on the host
    instead (the split mode, for verification; it needs transformers).

    Pre/postprocessing mirrors the HF pipeline the reference runs
    (crops_n_layers=0): bilinear longest-edge resize + zero-pad-to-square
    input, a points_per_side^2 grid over the original image, all 3 masks
    per point, low-res logits upscaled to the padded frame -> cropped ->
    resized to the image frame before scoring, the predicted-IoU filter, the
    stability filter (+/-1.0 logit offset) on the image-frame logits (the
    best mask kept if none passes both), greedy box NMS scored by predicted
    IoU, then the reference's area filter and a mask-IoU dedup. The masks
    returned are the same cropped logits resized to `resolution`."""
    if prepared is None:
        if sam_model is None:
            raise ValueError("need sam_model or a prepare_sam bundle")
        prepared = prepare_sam(sam_model.state_dict(), config=sam_model.config,
                               device=device)
    if not use_device_decoder and sam_model is None:
        raise ValueError("the host-decode split mode needs sam_model")
    prepared.timings.clear()
    cand, iou, stability = _candidates(
        prepared, image_uint8, sam_model, use_device_decoder=use_device_decoder,
        points_per_side=points_per_side, points_per_batch=points_per_batch,
        resolution=resolution, mask_threshold=mask_threshold)

    t0 = time.perf_counter()
    prepared.timings["candidates"] = int(cand.shape[0])
    keep = (iou >= iou_threshold) & (stability >= stability_thresh)
    if not keep.any():
        keep = iou >= iou.max() - 1e-6          # keep at least the best mask
    iou, cand = iou[keep], cand[keep]
    cand = cand[_box_nms(_mask_boxes(cand), iou, box_nms_iou)]

    out_masks: list[np.ndarray] = []
    for m in cand:
        if m.sum() <= filter_mask:
            continue
        dup = False
        for prev in out_masks:
            inter = np.logical_and(m, prev).sum()
            union = np.logical_or(m, prev).sum()
            if union and inter / union > dedup_iou:
                dup = True
                break
        if not dup:
            out_masks.append(m)
    prepared.timings["filter"] = time.perf_counter() - t0
    prepared.timings["kept"] = len(out_masks)
    if not out_masks:
        raise RuntimeError("SAM produced no masks above the area filter")
    return np.stack(out_masks)


def extract_and_cache_masks(args, x0: np.ndarray, mask_path: str,
                            resolution: int | None = None) -> np.ndarray:
    """Run SAM on the image x0 ((1, H, W, 3) in [-1, 1]) and cache the masks
    at mask_path ("masks", (n, R, R, 3) bool) with an overlay PNG per mask
    beside it. R is args.image_size unless `resolution` says otherwise (the
    T2I engines pass their decoded image's side). --mask_backend flax (the
    flag value the JAX package names) runs the port's SAM on args.device."""
    img = to_uint8(x0)[0]
    res = args.image_size if resolution is None else resolution
    if args.mask_backend == "flax":
        masks = segment_image_on_device(
            img, prepared=prepare_sam(args.mask_model_name, device=args.device),
            filter_mask=args.filter_mask, resolution=res)
    else:
        masks = segment_image(img, args.mask_model_name, args.filter_mask,
                              resolution=res, cache_folder=args.cache_folder or None)
    os.makedirs(os.path.dirname(mask_path), exist_ok=True)
    # broadcast to 3 channels NHWC to match the edit mask convention
    masks3 = np.repeat(masks[:, :, :, None], 3, axis=-1)
    np.savez(mask_path, masks=masks3)
    _save_overlays(img, masks, os.path.dirname(mask_path))
    return masks3


def _save_overlays(img: np.ndarray, masks: np.ndarray, out_dir: str) -> None:
    from PIL import Image

    for i, m in enumerate(masks):
        mm = np.asarray(Image.fromarray(m.astype(np.uint8) * 255)
                        .resize((img.shape[1], img.shape[0]))) > 127
        overlay = img.copy()
        overlay[mm] = (0.5 * overlay[mm] + 0.5 * np.array([255, 0, 0])).astype(np.uint8)
        Image.fromarray(overlay).save(os.path.join(out_dir, f"mask_{i:03d}.png"))
