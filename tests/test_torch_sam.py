"""The port's SAM (masks/sam_vit.py, masks/sam_decoder.py, masks/sam.py)
against the JAX package's (masks/sam_flax.py, masks/sam_decoder_flax.py,
masks/sam.py) on the CPU, at tiny sizes: the same seeded numpy inputs and
the same weights through both. Tolerances: 3e-5 absolute on the encoder
embedding and on the decoder's logits and IoU (f32 rounding of two
frameworks through a few layers); the automatic-mask candidates' IoU and
stability within 1e-5; final masks equal except for at most 0.1 % of the
pixels of each (a threshold flip at a logit of ~0 is rounding, not a
defect)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loco_edit_tpu.masks import sam as jax_sam
from loco_edit_tpu.masks import sam_decoder_flax as jdec
from loco_edit_tpu.masks import sam_flax as jvit
from loco_edit_tpu_torch.masks import sam
from loco_edit_tpu_torch.masks.sam_decoder import (SamMaskDecodeModel,
                                                   convert_sam_decoder_state_dict,
                                                   decoder_config_from_hf,
                                                   sam_decoder_params_from_flax)
from loco_edit_tpu_torch.masks.sam_vit import (SamViTConfig, SamViTEncoder, _rel_pos_table,
                                               config_from_hf, convert_sam_vision_state_dict,
                                               sam_vit_params_from_flax)
from _torch_port_utils import flat_params, tiny_sam_model

torch.set_num_threads(2)

ATOL = 3e-5
# jax.eval_shape on the JAX package's VIT_LARGE encoder and on its decoder
# initialised with an input mask (so the mask_embed subtree is counted)
SAM_VIT_L_ENCODER_PARAMS = 308_278_272
SAM_DECODER_PARAMS = 4_064_816


def _tiny_vit(window: int) -> SamViTConfig:
    """tests/test_sam_flax.py's tiny encoder (windowed + global layers);
    window 3 does not divide the 4 x 4 grid, so the windows are padded."""
    return SamViTConfig(image_size=32, patch_size=8, hidden_size=32, num_layers=3,
                        num_heads=2, mlp_ratio=2.0, window_size=window,
                        global_attn_indexes=(1,), output_channels=16)


@pytest.mark.parametrize("window", [2, 3])
def test_encoder_matches_jax(window):
    cfg = _tiny_vit(window)
    jcfg = jvit.SamViTConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    params = jax.jit(jvit.SamViTEncoder(jcfg).init)(jax.random.key(0), jnp.asarray(x[:1]))
    rng = np.random.default_rng(2)
    # the zero-initialised rel-pos tables and positional embedding carry no
    # signal: randomize every leaf
    params = jax.tree.map(lambda p: p + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                          params)
    want = np.asarray(jax.jit(jvit.SamViTEncoder(jcfg).apply)(params, jnp.asarray(x)))
    enc = SamViTEncoder(cfg)
    enc.load_state_dict(sam_vit_params_from_flax(flat_params(params), cfg))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("size", [2, 5])
def test_rel_pos_table_matches_jax(size):
    """A stored table of 7 rows read at a 2-grid (downscaled: the linear
    interpolation branch) and at a 5-grid (upscaled)."""
    rel = np.random.default_rng(3).normal(size=(7, 8)).astype(np.float32)
    want = np.asarray(jax.jit(jvit._rel_pos_table, static_argnums=1)(jnp.asarray(rel), size))
    got = _rel_pos_table(torch.from_numpy(rel), size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.fixture(scope="module")
def sam_pair():
    """The tiny HF SamModel's state_dict through both packages' converters:
    (HF config, HF model, state_dict, JAX vision cfg + params, JAX decoder
    cfg + params, port encoder, port decoder)."""
    cfg, model = tiny_sam_model(window_size=3)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = jvit.config_from_hf(cfg.vision_config)
    jparams = jvit.convert_sam_vision_state_dict(sd, jcfg)
    jdcfg = jdec.decoder_config_from_hf(cfg)
    jdparams = jdec.convert_sam_decoder_state_dict(sd, jdcfg)
    vcfg, dcfg = config_from_hf(cfg.vision_config), decoder_config_from_hf(cfg)
    enc, dec = SamViTEncoder(vcfg), SamMaskDecodeModel(dcfg)
    enc.load_state_dict(convert_sam_vision_state_dict(sd, vcfg))
    dec.load_state_dict(convert_sam_decoder_state_dict(sd, dcfg))
    return dict(cfg=cfg, model=model, sd=sd, jcfg=jcfg, jparams=jparams, jdcfg=jdcfg,
                jdparams=jdparams, enc=enc.eval(), dec=dec.eval())


def test_configs_from_hf_match_jax(sam_pair):
    """config_from_hf / decoder_config_from_hf on the SamConfig object and
    on its dict (config.json) give the JAX package's configs."""
    cfg = sam_pair["cfg"]
    for src in (cfg, cfg.to_dict()):
        v = config_from_hf(src["vision_config"] if isinstance(src, dict) else src.vision_config)
        d = decoder_config_from_hf(src)
        for f in dataclasses.fields(v):
            assert getattr(v, f.name) == getattr(sam_pair["jcfg"], f.name), f.name
        assert dataclasses.asdict(d) == dataclasses.asdict(sam_pair["jdcfg"])


def test_vision_converter_matches_jax(sam_pair):
    """The HF vision weights through both converters: the same embedding,
    and the JAX params carried by sam_vit_params_from_flax equal the port
    converter's tensors."""
    x = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jvit.SamViTEncoder(sam_pair["jcfg"]).apply)(
        jax.tree.map(jnp.asarray, sam_pair["jparams"]), jnp.asarray(x)))
    with torch.no_grad():
        got = sam_pair["enc"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    carried = sam_vit_params_from_flax(flat_params(sam_pair["jparams"]), sam_pair["enc"].cfg)
    for k, v in sam_pair["enc"].state_dict().items():
        torch.testing.assert_close(carried[k], v, rtol=0, atol=0)


def test_decoder_params_from_flax_match_converter(sam_pair):
    carried = sam_decoder_params_from_flax(flat_params(sam_pair["jdparams"]),
                                           sam_pair["dec"].cfg)
    for k, v in sam_pair["dec"].state_dict().items():
        torch.testing.assert_close(carried[k], v, rtol=0, atol=0)


DECODER_CASES = ["labels", "boxes", "boxes_points_mask"]


def _prompts(case, rng):
    """Seeded prompts: (kwargs of the decoder call, multimask_output)."""
    boxes = np.array([[[4, 4, 20, 24], [1, 2, 30, 12]]], np.float32)
    if case == "labels":   # positive, negative, dropped (-10), not-a-point (-1)
        return dict(points=rng.uniform(0, 31, (1, 3, 3, 2)),
                    labels=np.array([[[1, 0, -10], [1, 1, 0], [0, -1, 1]]], np.int32)), True
    if case == "boxes":
        return dict(boxes=boxes), False
    return dict(points=rng.uniform(2, 30, (1, 2, 2, 2)),
                labels=np.array([[[1, 0], [1, -10]]], np.int32), boxes=boxes,
                input_masks=rng.normal(size=(1, 16, 16, 1))), True


@pytest.mark.parametrize("case", DECODER_CASES)
def test_decoder_matches_jax(sam_pair, case):
    """Positive, negative, dropped and not-a-point labels; boxes alone with
    single-mask output; boxes with points and an input-mask dense prompt."""
    rng = np.random.default_rng(DECODER_CASES.index(case) + 10)
    emb = rng.normal(size=(1, 4, 4, 32)).astype(np.float32)
    kw, multi = _prompts(case, rng)
    kw = {k: v.astype(np.int32 if k == "labels" else np.float32) for k, v in kw.items()}
    apply = jax.jit(lambda p, e, kw: jdec.SamMaskDecodeModel(sam_pair["jdcfg"]).apply(
        p, e, multimask_output=multi, **kw))
    jm, ji = apply(jax.tree.map(jnp.asarray, sam_pair["jdparams"]), jnp.asarray(emb),
                   {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tm, ti = sam_pair["dec"](torch.from_numpy(emb), multimask_output=multi,
                                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert tm.shape == jm.shape and ti.shape == ji.shape
    assert tm.shape[2] == (3 if multi else 1)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL)


@pytest.mark.parametrize("which", ["vision", "decoder"])
def test_converters_reject_unknown_keys(sam_pair, which):
    sd = dict(sam_pair["sd"])
    key = ("vision_encoder.layers.9.bogus.weight" if which == "vision"
           else "mask_decoder.bogus.weight")
    sd[key] = np.zeros((1,), np.float32)
    cfg = sam_pair["enc"].cfg if which == "vision" else sam_pair["dec"].cfg
    convert = convert_sam_vision_state_dict if which == "vision" else \
        convert_sam_decoder_state_dict
    with pytest.raises(ValueError, match="unconsumed"):
        convert(sd, cfg)


def test_stability_boxes_nms_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(12, 9, 11)) * 3
    np.testing.assert_array_equal(sam._stability_scores(logits),
                                  jax_sam._stability_scores(logits))
    masks = logits > 1.0
    masks[3] = False
    np.testing.assert_array_equal(sam._mask_boxes(masks), jax_sam._mask_boxes(masks))
    x0 = rng.uniform(0, 20, (60, 2))
    boxes = np.concatenate([x0, x0 + rng.uniform(1, 12, (60, 2))], axis=1)
    boxes[:3, 2:] = boxes[:3, :2]      # zero-area boxes
    scores = rng.uniform(size=60)
    for iou in (0.3, 0.7):
        np.testing.assert_array_equal(sam._box_nms(boxes, scores, iou),
                                      jax_sam._box_nms(boxes, scores, iou))


def _jax_candidates(bundle, img, ppb, resolution):
    """JAX's pre-filter candidates: the jitted encode and decode_batch that
    segment_image_flax_encoder left in the bundle's jit cache, run over
    the same padded point grid."""
    size = bundle.cfg.image_size
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    decode = next(v for k, v in bundle.jit_cache.items() if k[0] == "decode")
    from PIL import Image

    x = np.zeros((size, size, 3), np.float32)
    x[:nh, :nw] = (np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR),
                              np.float32) - sam._PIXEL_MEAN) / sam._PIXEL_STD
    emb = bundle.jit_cache["encode"](jnp.asarray(x[None]))
    g = 4
    pts = np.stack(np.meshgrid((np.arange(g) + 0.5) / g * nw, (np.arange(g) + 0.5) / g * nh),
                   -1).reshape(1, -1, 1, 2).astype(np.float32)
    parts = [decode(emb, jnp.asarray(pts[:, i:i + ppb]), jnp.ones((1, ppb, 1), jnp.int32))
             for i in range(0, pts.shape[1], ppb)]
    return [np.concatenate([np.asarray(p[j]) for p in parts]) for j in range(3)]


def test_segment_image_on_device_matches_jax(sam_pair):
    """segment_image_on_device against segment_image_flax_encoder on the
    same tiny weights and a non-square image (the crop path): the same
    candidate IoU and stability before the filters (1e-5), then the same
    number of final masks, each equal to JAX's but for <= 0.1 % of pixels."""
    img = np.random.default_rng(7).uniform(0, 255, (48, 64, 3)).astype(np.uint8)
    kw = dict(points_per_side=4, points_per_batch=8, filter_mask=0, resolution=64,
              iou_threshold=-1e9, stability_thresh=-1.0, box_nms_iou=1.0, dedup_iou=1.1)
    jbundle = jax_sam.prepare_sam_flax(sam_pair["model"])
    want = jax_sam.segment_image_flax_encoder(img, prepared=jbundle, **kw)
    bundle = sam.SamBundle(sam_pair["enc"].cfg, sam_pair["dec"].cfg, sam_pair["enc"],
                           sam_pair["dec"], torch.device("cpu"))
    got = sam.segment_image_on_device(img, prepared=bundle, **kw)

    cand, iou, stab = sam._candidates(
        bundle, img, None, use_device_decoder=True, points_per_side=4, points_per_batch=8,
        resolution=64, mask_threshold=0.0)
    jcand, jiou, jstab = _jax_candidates(jbundle, img, 8, 64)
    assert cand.shape == jcand.shape == (48, 64, 64)
    np.testing.assert_allclose(iou, jiou, atol=1e-5)
    np.testing.assert_allclose(stab, jstab, atol=1e-5)
    assert (cand != jcand).mean() <= 1e-3

    assert got.shape == want.shape and got.dtype == bool
    assert got.shape[0] > 1
    for a, b in zip(got, want):
        assert (a != b).mean() <= 1e-3
    t = bundle.timings
    assert t["candidates"] == 48 and t["decode_batches"] == 2 and t["kept"] == got.shape[0]


def test_split_mode_matches_device_decoder(sam_pair):
    """use_device_decoder=False decodes through the transformers SamModel
    on the host: the same masks as the port's decoder."""
    img = np.random.default_rng(8).uniform(0, 255, (40, 40, 3)).astype(np.uint8)
    kw = dict(points_per_side=3, filter_mask=0, resolution=32, iou_threshold=-1e9,
              stability_thresh=-1.0, dedup_iou=1.1, device="cpu")
    dev = sam.segment_image_on_device(img, sam_pair["model"], **kw)
    host = sam.segment_image_on_device(img, sam_pair["model"], use_device_decoder=False, **kw)
    assert dev.shape == host.shape
    assert (dev != host).mean() <= 1e-3


def test_presets_match_jax():
    """sam_preset's geometry is the JAX package's preset field by field, and
    its parameter count the JAX build's (meta-device count here)."""
    for name, jcfg in (("facebook/sam-vit-base", jvit.VIT_BASE),
                       ("facebook/sam-vit-large", jvit.VIT_LARGE),
                       ("facebook/sam-vit-huge", jvit.VIT_HUGE)):
        cfg, dcfg = sam.sam_preset(name)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (name, f.name)
        assert dataclasses.asdict(dcfg) == dataclasses.asdict(jdec.SamDecoderConfig())
    cfg, dcfg = sam.sam_preset("facebook/sam-vit-large")
    with torch.device("meta"):
        enc, dec = SamViTEncoder(cfg), SamMaskDecodeModel(dcfg)
    assert sum(p.numel() for p in enc.parameters()) == SAM_VIT_L_ENCODER_PARAMS
    assert sum(p.numel() for p in dec.parameters()) == SAM_DECODER_PARAMS
    with pytest.raises(ValueError, match="no SAM preset"):
        sam.sam_preset("facebook/sam-vit-tiny")


def test_prepare_sam_sources(sam_pair, tmp_path, monkeypatch):
    """A save_pretrained directory, a HF-named state_dict file (geometry
    read from its shapes; this model's decoder has HF's 8 heads) and a
    mapping give the same weights; a preset name with no file gives seeded
    random weights of HF's init distribution, the same for the same seed."""
    cfg, model = tiny_sam_model(decoder_heads=8, window_size=3)
    model.save_pretrained(tmp_path / "dir")
    torch.save(model.state_dict(), tmp_path / "sam.pt")
    bundles = [sam.prepare_sam(str(tmp_path / "dir"), device="cpu"),
               sam.prepare_sam(str(tmp_path / "sam.pt"), device="cpu"),
               sam.prepare_sam(model.state_dict(), config=cfg, device="cpu")]
    assert bundles[1].cfg == bundles[0].cfg == config_from_hf(cfg.vision_config)
    assert bundles[1].dcfg == bundles[0].dcfg == decoder_config_from_hf(cfg)
    for b in bundles[1:]:
        for part in ("encoder", "decoder"):
            for (k, v), v0 in zip(getattr(b, part).state_dict().items(),
                                  getattr(bundles[0], part).state_dict().values()):
                torch.testing.assert_close(v, v0, rtol=0, atol=0, msg=k)

    monkeypatch.setitem(sam.SAM_PRESETS, "tiny/sam", _tiny_vit(2))
    a, b, c = (sam.prepare_sam("tiny/sam", device="cpu", seed=s) for s in (0, 0, 1))
    wa = a.encoder.layer_0.attn.qkv.weight
    torch.testing.assert_close(wa, b.encoder.layer_0.attn.qkv.weight, rtol=0, atol=0)
    assert not torch.equal(wa, c.encoder.layer_0.attn.qkv.weight)
    assert abs(wa.std().item() - 0.02) < 2e-3
    assert a.encoder.layer_0.attn.rel_pos_h.abs().max() == 0
    assert abs(a.decoder.positional_embedding.std().item() / 16 - 1) < 0.5   # 32 // 2
    with pytest.raises(FileNotFoundError, match="not a file"):
        sam.prepare_sam(str(tmp_path / "missing.pt"), device="cpu")
