"""The port's warm edit server against the JAX package's on the CPU: both
EditServices on TinyTest with the same weights (the JAX package's TinyTest,
Flax init of key(0) + 0.02, carried into the port) and the JAX package's
random draws fed to the port's pipeline, each served over HTTP on port 0:
the wire format, /invert, a float /edit of one image, the cache names, the
error surfaces and the maskless fallback; then the port alone: /edit_batch
item by item against /edit, TF32 staying off on the device thread, and
/health answering while an edit runs."""

import base64
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from loco_edit_tpu_torch.core import rng as torch_rng
from loco_edit_tpu_torch.models import registry
from _torch_port_utils import JaxDraws, tiny_pair

torch.set_num_threads(2)

ARGV = ["--model_name", "TinyTest", "--dataset_name", "Random",
        "--for_steps", "8", "--inv_steps", "8", "--edit_t", "0.6",
        "--performance_boosting_t", "0.2", "--x_space_guidance_scale", "0.5",
        "--x_space_guidance_num_step", "2", "--pca_rank", "1",
        "--pca_rank_null", "1", "--vis_num", "1", "--null_space_projection", "true",
        "--seed", "11"]
# the xT of the inversion, relative to its largest |value|: f32 rounding of
# two frameworks through 8 steps of JAX's TinyTest (tests/test_torch_cli.py
# measures 8e-6 of the largest |xt|)
XT_RTOL = 6e-5
# strips after the boosted denoise against the JAX server's, relative to the
# largest |value| (~20): two frameworks' f32 rounding through the inversion,
# two sweeps of the basis and the boosted tail (measured 8e-5, the
# relative size of tests/test_torch_pipeline.py's strip tolerance)
STRIP_RTOL = 2e-4
# one server's batched edit against its single edits: batch-size-dependent
# summation order of the CPU convolutions (the tolerance of
# tests/test_torch_cli.py::test_run_edit_batch_matches_single_runs)
BATCH_RTOL = 5e-5


def _serve(service):
    from loco_edit_tpu_torch.serve import make_server

    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _strip(out, key="0"):
    dt = np.uint8 if out["dtype"] == "uint8" else np.float32
    return np.frombuffer(base64.b64decode(out["strips"][key]), dt).reshape(out["shape"])


def _image(seed):
    img = np.random.default_rng(seed).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    return img, base64.b64encode(img.tobytes()).decode()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from loco_edit_tpu.cli.args import parse_args as jax_parse
    from loco_edit_tpu.cli.args import preset as jax_preset
    from loco_edit_tpu.serve import EditService as JaxService
    from loco_edit_tpu_torch.cli.args import parse_args, preset
    from loco_edit_tpu_torch.serve import EditService

    mp = pytest.MonkeyPatch()
    _, _, tm = tiny_pair()          # Flax init of key(0) + 0.02: JAX's TinyTest
    load = registry.load_tiny_denoiser

    def load_jax_weights(*a, **k):  # the port's loader, then JAX's weights
        den = load(*a, **k)
        den.meta["model"].load_state_dict(tm.state_dict())
        return den

    mp.setattr(registry, "load_tiny_denoiser", load_jax_weights)
    mp.setattr(torch_rng, "seed_everything", lambda seed: JaxDraws(jax.random.key(seed)))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.benchmark)
    # PyTorch's defaults: the f32 service must turn TF32 off itself
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    try:
        svc = EditService(preset(parse_args(
            ARGV + ["--device", "cpu", "--result_folder",
                    str(tmp_path_factory.mktemp("torch"))])))
        jsvc = JaxService(jax_preset(jax_parse(
            ARGV + ["--result_folder", str(tmp_path_factory.mktemp("jax"))])))
        for s in (svc, jsvc):
            s.pipe.cfg.save_images = False
            s.pipe.cfg.min_iter, s.pipe.cfg.max_iter = 1, 2
        (srv, url), (jsrv, jurl) = _serve(svc), _serve(jsvc)
        yield dict(svc=svc, url=url, jsvc=jsvc, jurl=jurl)
        srv.shutdown()
        jsrv.shutdown()
    finally:
        mp.undo()
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags


def test_health_invert_and_refine_match_jax(servers):
    """/health in the JAX layout; /invert of one image equals the JAX
    server's within XT_RTOL, the refine_steps override changes it and the
    server default is restored."""
    s = servers
    code, health = _get(s["url"] + "/health")
    _, jhealth = _get(s["jurl"] + "/health")
    assert code == 200 and health.keys() == jhealth.keys()
    assert health == {"ok": True, "engine": "uncond", "edits_served": 0}
    _, payload = _image(13)
    code, out = _post(s["url"] + "/invert", {"image": payload})
    _, jout = _post(s["jurl"] + "/invert", {"image": payload})
    assert code == 200 and out.keys() == jout.keys() == {"xT", "shape"}
    assert out["shape"] == jout["shape"] == [1, 32, 32, 3]
    x = np.frombuffer(base64.b64decode(out["xT"]), np.float32)
    jx = np.frombuffer(base64.b64decode(jout["xT"]), np.float32)
    np.testing.assert_allclose(x, jx, atol=XT_RTOL * np.abs(jx).max())
    _, out2 = _post(s["url"] + "/invert", {"image": payload, "refine_steps": 2})
    x2 = np.frombuffer(base64.b64decode(out2["xT"]), np.float32)
    assert not np.allclose(x, x2)
    assert s["svc"].pipe.cfg.inv_refine_steps == 0


def test_edit_of_an_image_matches_jax(servers):
    """A float /edit of one posted image with a bbox: the JAX server's
    fields, shape and dtype, strips within STRIP_RTOL of the JAX server's
    (matched probes and boost noise), projection flagged on."""
    s = servers
    _, payload = _image(3)
    req = {"image": payload, "mask_bbox": [8, 20, 8, 20], "pixel": False,
           "sample_name": "img3"}
    s["svc"].pipe._boost_calls = s["jsvc"].pipe._boost_calls = 0
    code, out = _post(s["url"] + "/edit", req)
    _, jout = _post(s["jurl"] + "/edit", req)
    assert code == 200 and out.keys() == jout.keys()
    assert (out["shape"], out["dtype"]) == (jout["shape"], jout["dtype"]) == (
        [3, 32, 32, 3], "float32")
    assert out["null_space_projection"] is jout["null_space_projection"] is True
    assert out["strips"].keys() == jout["strips"].keys() == {"0"}
    ref = _strip(jout)
    np.testing.assert_allclose(_strip(out), ref, atol=STRIP_RTOL * np.abs(ref).max())
    assert isinstance(out["secs"], float) and out["secs"] > 0


def test_cache_names_match_jax(servers):
    svc, jsvc = servers["svc"], servers["jsvc"]
    _, payload = _image(4)
    for req in ({"seed": 3}, {"seed": 3, "mask_bbox": [0, 4, 0, 4]},
                {"image": payload}, {"seed": 1, "for_prompt": "a", "edit_prompt": "b",
                                     "semantic": True}, {"sample_name": "mine"}):
        for rank in (1, 5):
            assert svc._cache_name(req, rank) == jsvc._cache_name(req, rank)
    assert svc._cache_name({"seed": 3}, 1).startswith("serve-")


def test_error_surfaces_and_maskless_fallback(servers):
    """Malformed requests answer 500 with the JAX service's message, unknown
    paths 404, and the server keeps serving; a maskless /edit falls back to
    the unprojected basis and says so; one maskless item does it for the
    whole batch."""
    s = servers
    for path, bad in (("/edit_batch", {"items": []}), ("/edit_batch", {"items": "nope"}),
                      ("/edit_batch", {}), ("/edit_batch", {"items": [3]}),
                      ("/edit", {"seed": 1, "pixel": "false"})):
        code, out = _post(s["url"] + path, bad)
        method = getattr(s["jsvc"], path[1:])
        with pytest.raises(ValueError) as e:
            method(bad)
        assert code == 500 and out == {"error": str(e.value)}
    code, out = _post(s["url"] + "/invert", {"image": "not-base64!!"})
    assert code == 500 and "error" in out
    assert _post(s["url"] + "/nope", {})[0] == _get(s["url"] + "/nope")[0] == 404
    code, out = _post(s["url"] + "/edit", {"seed": 21, "pixel": True})
    assert code == 200 and out["null_space_projection"] is False
    assert out["dtype"] == "uint8" and _strip(out).shape == (3, 32, 32, 3)
    code, out = _post(s["url"] + "/edit", {"seed": 21, "pca_rank": 2})
    assert len(out["strips"]) == 2 and s["svc"].pipe.cfg.pca_rank == 1
    assert s["svc"].pipe.cfg.null_space_projection is True
    assert _get(s["url"] + "/health")[1]["edits_served"] >= 2


def test_edit_batch_items_match_single_edits(servers):
    """/edit_batch of a seed with a bbox, a seed with a bbox and an image
    with a bbox: each item equals the /edit of the same item (boost-noise
    counter pinned to the item's place in the batch) within BATCH_RTOL of
    its largest value (the batched forward runs at batch 3); projection on
    for the whole batch."""
    s = servers
    _, payload = _image(8)
    box = [8, 20, 8, 20]
    items = [{"seed": 61, "mask_bbox": box}, {"seed": 62, "mask_bbox": box},
             {"image": payload, "mask_bbox": box}]
    s["svc"].pipe._boost_calls = 0
    code, out = _post(s["url"] + "/edit_batch", {"items": items, "pixel": False})
    assert code == 200 and len(out["results"]) == 3 and out["null_space_projection"]
    for i, it in enumerate(items):
        s["svc"].pipe._boost_calls = i
        _, single = _post(s["url"] + "/edit", dict(it, pixel=False))
        r = out["results"][i]
        assert r.keys() == {"strips", "shape", "dtype", "null_space_projection"}
        ref = _strip(single)
        np.testing.assert_allclose(_strip(r), ref, atol=BATCH_RTOL * np.abs(ref).max())
    assert not np.allclose(_strip(out["results"][0]), _strip(out["results"][1]))
    code, mixed = _post(s["url"] + "/edit_batch", {"items": [{"seed": 1, "mask_bbox": box},
                                                             {"seed": 2}]})
    assert code == 200 and mixed["null_space_projection"] is False
    assert all(r["null_space_projection"] is False and r["dtype"] == "uint8"
               for r in mixed["results"])


def test_f32_server_keeps_tf32_off_in_handler_threads(servers, monkeypatch):
    """The f32 service set the port's f32 policy (core/device.py) at build;
    two /edit requests, each read on a handler thread of its own, run their
    edits on the service's one device thread (cuDNN keeps its measured
    choices per thread), which sees TF32 off for matmuls and convolutions
    and cuDNN's measured choice of algorithm on; the pixel strips equal
    to_uint8 of the float ones."""
    from loco_edit_tpu_torch.utils.io import to_uint8

    s = servers
    seen, handlers, devices = {}, [], []
    edit, run = s["svc"].edit, s["svc"].pipe.run_edit_null_space_projection

    def spy_edit(req):
        handlers.append(threading.current_thread())
        return edit(req)

    def spy_run(*a, **k):
        devices.append(threading.current_thread())
        seen.update(matmul=torch.backends.cuda.matmul.allow_tf32,
                    cudnn=torch.backends.cudnn.allow_tf32,
                    benchmark=torch.backends.cudnn.benchmark)
        return run(*a, **k)

    monkeypatch.setattr(s["svc"], "edit", spy_edit)
    monkeypatch.setattr(s["svc"].pipe, "run_edit_null_space_projection", spy_run)
    req = {"seed": 41, "mask_bbox": [8, 20, 8, 20], "sample_name": "px"}
    s["svc"].pipe._boost_calls = 0
    _, out_f = _post(s["url"] + "/edit", dict(req, pixel=False))
    s["svc"].pipe._boost_calls = 0
    _, out_u = _post(s["url"] + "/edit", dict(req, pixel=True))
    assert len(handlers) == len(devices) == 2 and devices[0] is devices[1]
    assert handlers[0] is not handlers[1]
    assert devices[0] not in (*handlers, threading.current_thread())
    assert seen["matmul"] is False and seen["cudnn"] is False and seen["benchmark"] is True
    assert out_f["dtype"] == "float32" and out_u["dtype"] == "uint8"
    np.testing.assert_array_equal(_strip(out_u), to_uint8(_strip(out_f)))


def test_health_answers_while_an_edit_runs(servers, monkeypatch):
    """/health, which does no device work, answers while an /edit holds the
    device thread, and a second /edit waits for the first."""
    s = servers
    started, release = threading.Event(), threading.Event()
    run = s["svc"].pipe.run_edit_null_space_projection
    order = []

    def held(*a, **k):
        order.append(k["sample_name"])
        started.set()
        assert release.wait(120), "the test never released the edit"
        return run(*a, **k)

    monkeypatch.setattr(s["svc"].pipe, "run_edit_null_space_projection", held)
    answers = {}

    def post(name):
        answers[name] = _post(s["url"] + "/edit", {"seed": 43, "sample_name": name})

    first = threading.Thread(target=post, args=("held1",))
    first.start()
    try:
        assert started.wait(60)
        second = threading.Thread(target=post, args=("held2",))
        second.start()
        served = s["svc"].edits_served
        code, health = _get(s["url"] + "/health")
        assert code == 200 and health["ok"] and health["edits_served"] == served
        assert order == ["held1"] and first.is_alive()
    finally:
        release.set()
        first.join(300)
    second.join(300)
    assert order == ["held1", "held2"]
    assert answers["held1"][0] == answers["held2"][0] == 200
