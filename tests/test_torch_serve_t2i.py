"""The port's edit server with the T2I engines on the CPU: tiny SD and LCM
bundles (the U-Nets and the 16 px VAE of sd_tiny_pairs / lcm_tiny_pair,
the fake prompt encoder) and the seeded tiny IF of load_if_bundle
(LOCO_IF_PRESET=tiny: the tiny stage 1 without an upscaler): /edit
with "pixel" true and false (LCM's and IF's on-device uint8 strips equal
to_uint8 of the float strips exactly), SD and LCM /edit_batch, the engines'
error surfaces, and /segment with a tiny SAM."""

import base64

import numpy as np
import pytest
import torch

from loco_edit_tpu_torch.utils.io import to_uint8
from _torch_port_utils import lcm_tiny_pair, sd_tiny_pairs, tiny_sam_model

torch.set_num_threads(2)


def _make_service(model_name, tmp_path, extra=()):
    from loco_edit_tpu_torch.cli.args import parse_args, preset
    from loco_edit_tpu_torch.serve import EditService

    args = preset(parse_args([
        "--model_name", model_name, "--dataset_name", "Random", "--device", "cpu",
        "--for_steps", "6", "--inv_steps", "6", "--edit_t", "0.7",
        "--guidance_scale", "3.0", "--num_inference_steps", "4",
        "--edit_t_idx", "2", "--pca_rank", "1", "--pca_rank_null", "1",
        "--null_space_projection", "true", "--use_mask", "false",
        "--x_space_guidance_num_step", "2", "--vis_num", "1",
        "--performance_boosting_t", "0",
        "--result_folder", str(tmp_path), "--seed", "7", *extra]))
    svc = EditService(args)
    svc.pipe.cfg.save_images = False
    svc.pipe.cfg.min_iter, svc.pipe.cfg.max_iter = 1, 2
    return svc


@pytest.fixture(scope="module")
def tiny_bundles():
    """load_sd_bundle stand-in over the tiny SD / LCM U-Nets and the 16 px
    VAE (8x8 latents decode to 16x16 images)."""
    from loco_edit_tpu_torch.models.sd.text import fake_prompt_encoder
    from loco_edit_tpu_torch.models.t2i_registry import sd_bundle

    pairs = sd_tiny_pairs()
    lcm_unet = lcm_tiny_pair()[2]

    def load(args, lcm=False):
        unet = lcm_unet if lcm else pairs["unet"]
        return sd_bundle(unet, pairs["enc"], pairs["dec"],
                         fake_prompt_encoder(unet.cfg.cross_attention_dim, seq=7,
                                             device="cpu"))
    return load


def _strip(out, key="0"):
    dt = np.uint8 if out["dtype"] == "uint8" else np.float32
    return np.frombuffer(base64.b64decode(out["strips"][key]), dt).reshape(out["shape"])


def test_sd_serve_edit_batch_and_errors(tiny_bundles, tmp_path, monkeypatch):
    import loco_edit_tpu_torch.models.t2i_registry as reg

    monkeypatch.setattr(reg, "load_sd_bundle", tiny_bundles)
    svc = _make_service("stable-diffusion-tiny", tmp_path)
    assert svc.engine == "sd" and svc.health()["engine"] == "sd"
    # the bbox is in decoded-image coordinates, the shape read off the VAE
    assert svc.sample_shape == (8, 8, 4) and svc.mask_shape == (1, 16, 16, 3)

    req = {"seed": 1, "for_prompt": "a cat", "mask_bbox": [0, 8, 0, 8], "sample_name": "s0"}
    out = svc.edit(req)                    # serve default: the uint8 payload
    assert out["null_space_projection"] is True and out["dtype"] == "uint8"
    assert _strip(out).shape == (3, 16, 16, 3)
    out_f = svc.edit(dict(req, pixel=False))   # the same basis, from the cache
    assert out_f["dtype"] == "float32"
    np.testing.assert_array_equal(_strip(out), to_uint8(_strip(out_f)))

    # text-supervised (an edit_prompt makes semantic default to true)
    out2 = svc.edit({"seed": 2, "for_prompt": "a cat", "edit_prompt": "a smiling cat",
                     "mask_bbox": [0, 8, 0, 8], "pixel": False})
    assert out2["dtype"] == "float32" and np.isfinite(_strip(out2)).all()

    outb = svc.edit_batch({"for_prompt": "a cat", "items": [
        {"seed": 3, "mask_bbox": [0, 8, 0, 8]}, {"seed": 4, "mask_bbox": [0, 8, 0, 8]}]})
    assert len(outb["results"]) == 2 and outb["null_space_projection"] is True
    for r in outb["results"]:
        assert _strip(r).shape == (3, 16, 16, 3)

    img = np.random.default_rng(0).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    inv = svc.invert({"image": base64.b64encode(img.tobytes()).decode()})
    assert inv["shape"] == [1, 8, 8, 4]
    with pytest.raises(ValueError, match="takes \"seed\""):
        svc.edit({"image": base64.b64encode(b"\x00" * 4).decode(), "for_prompt": "a cat"})
    with pytest.raises(ValueError, match="requires \"for_prompt\""):
        svc.edit({"seed": 0})
    with pytest.raises(ValueError, match="JSON boolean"):
        svc.edit({"seed": 0, "for_prompt": "a", "semantic": "yes"})
    assert svc.edits_served == 5


def test_lcm_serve_pixel_output_and_batch(tiny_bundles, tmp_path, monkeypatch):
    import loco_edit_tpu_torch.models.t2i_registry as reg

    monkeypatch.setattr(reg, "load_sd_bundle", tiny_bundles)
    svc = _make_service("LCM_tiny", tmp_path)
    assert svc.engine == "lcm" and svc.mask_shape == (1, 16, 16, 3)
    req = {"seed": 1, "for_prompt": "a man", "mask_bbox": [0, 8, 0, 8],
           "semantic": False, "sample_name": "s0"}
    svc.pipe._noise_calls = 0
    out_u = svc.edit(dict(req, pixel=True))
    svc.pipe._noise_calls = 0
    out_f = svc.edit(dict(req, pixel=False))
    assert out_u["dtype"] == "uint8" and out_f["dtype"] == "float32"
    assert out_u["null_space_projection"] is True
    # the decoded strip converted on the device equals the host conversion
    np.testing.assert_array_equal(_strip(out_u), to_uint8(_strip(out_f)))
    # the per-request overrides are restored
    assert svc.pipe.cfg.non_semantic is False and svc.pipe.cfg.pixel_output is False

    outb = svc.edit_batch({"for_prompt": "a man", "edit_prompt": "a man with glasses",
                           "items": [{"seed": 2}, {"seed": 3}], "pixel": False})
    assert len(outb["results"]) == 2 and outb["null_space_projection"] is False
    for r in outb["results"]:
        s = _strip(r)
        assert np.isfinite(s).all() and s.min() != s.max()
    with pytest.raises(ValueError, match="no inversion"):
        svc.invert({"image": ""})


def test_if_serve_pixel_output_and_segment(tmp_path, monkeypatch):
    """IF (the seeded tiny IF of load_if_bundle, 16 px, no upscaler:
    LOCO_IF_PRESET=tiny; the served cascade: test_torch_if_reference.py):
    the uint8 strip is to_uint8 of the float strip; no batch API; /segment
    over HTTP with a tiny SAM save_pretrained directory, the bundle kept
    warm."""
    import json
    import threading
    import urllib.request

    from loco_edit_tpu_torch.serve import make_server

    monkeypatch.setenv("LOCO_IF_PRESET", "tiny")
    svc = _make_service("DeepFloyd_IF_tiny", tmp_path)
    assert svc.engine == "if" and svc.mask_shape == (1,) + svc.sample_shape
    h = svc.sample_shape[0]
    req = {"seed": 5, "for_prompt": "a cat", "edit_prompt": "a sleeping cat",
           "mask_bbox": [0, h // 2, 0, h // 2], "sample_name": "s0"}
    out_u = svc.edit(req)
    out_f = svc.edit(dict(req, pixel=False))
    assert out_u["dtype"] == "uint8" and out_u["null_space_projection"] is True
    assert _strip(out_u).shape == (3,) + svc.sample_shape
    np.testing.assert_array_equal(_strip(out_u), to_uint8(_strip(out_f)))
    with pytest.raises(ValueError, match="no batch API"):
        svc.edit_batch({"for_prompt": "a cat", "items": [{"seed": 1}]})

    _, model = tiny_sam_model()
    mdir = tmp_path / "tiny-sam"
    model.save_pretrained(mdir)
    svc._args.mask_model_name = str(mdir)
    srv = make_server(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    img = np.random.default_rng(9).uniform(-1, 1, (1, h, h, 3)).astype(np.float32)
    body = json.dumps({"image": base64.b64encode(img.tobytes()).decode(),
                       "filter_mask": 0, "points_per_side": 4}).encode()
    try:
        shapes = []
        for _ in range(2):
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{srv.server_address[1]}/segment", data=body),
                    timeout=300) as r:
                out = json.loads(r.read())
            masks = np.frombuffer(base64.b64decode(out["masks"]), np.uint8)
            shapes.append(out["shape"])
            assert masks.reshape(out["shape"]).max() == 1
        assert shapes[0] == shapes[1] and shapes[0][1:] == [h, h]
        assert svc._sam is not None     # prepared once, kept for the next request
    finally:
        srv.shutdown()
