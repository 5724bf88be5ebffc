"""Warm-pipeline edit server for all four engines (port of
loco_edit_tpu/serve.py).

One warm edit pipeline (models on the card, kernels built, the basis disk
cache) behind a minimal HTTP API, so interactive editing front-ends pay the
model build once and steady-state latency per edit. The engine follows the
CLI flags: --model_name picks uncond / SD / LCM / DeepFloyd-IF exactly as
cli.main does, on --device (the card unless `--device cpu`). Each request
is read and answered on a thread of its own, and the device work of every
request runs on the service's one device thread, one request at a time (one
card, one compute stream; see EditService.on_device), so /health answers
while an edit runs; scale-out is one process per card behind any HTTP
balancer.

The wire format is the JAX server's, so the two servers' clients are
interchangeable:

  POST /edit    uncond: {"seed": int | "image": <b64 f32 NHWC bytes>,
                 "pixel": bool? (default true: uint8 PNG payload),
                 "mask_bbox": [y0, y1, x0, x1] | null,
                 "pca_rank": int?, "sample_name": str?}
                T2I engines add: {"for_prompt": str (required),
                 "edit_prompt": str?, "semantic": bool? (default: true iff
                 an edit_prompt is given: text-supervised direction; false
                 = unsupervised power iteration)}; "seed" seeds zT/xT; the
                 mask_bbox is in DECODED-image pixel coordinates for SD/LCM
                 (the pullback output space) and stage-1 sample pixels for
                 IF (64 px at the presets).
             -> {"strips": {pc: <b64 bytes>}, "shape": [...], "dtype": "float32"
                 | "uint8" (with "pixel": true: converted on the device, 4x
                 smaller copy and response; IF's strip is the upscaler's,
                 frames of 256 x 256 x 3 at the presets, stage 1's when no
                 upscaler is bound),
                 "null_space_projection": bool (false = maskless fallback to
                 the unprojected basis), "secs": float}
  POST /edit_batch {"items": [{"seed" | "image", "mask_bbox"?, "sample_name"?},
                 ...], "pixel": bool?, "pca_rank": int?
                 (+ top-level "for_prompt"/"edit_prompt"/"semantic" for
                 SD/LCM; IF has no batch API)}
             -> {"results": [<per-item /edit payload>],
                 "null_space_projection": bool, "secs": float}
                (ONE batched inversion/generation for the whole set: see
                run_edit_batch in pipelines/{uncond,sd,lcm}.py; projection
                is a whole-batch property, so ONE item without "mask_bbox"
                downgrades the batch to the unprojected basis, and the
                response flag, batch-level and per item, says which basis
                was used)
  POST /invert  {"image": <b64>, "refine_steps": int?}   (uncond + SD;
                exact-inversion fixed-point depth; default = server
                --inv_refine_steps)
             -> {"xT": <b64>, "shape": [...]}
  POST /segment {"image": <b64>, "filter_mask": int?, "points_per_side": int?}
             -> {"masks": <b64 uint8 (N, H, W)>, "shape": [...]}   (the
                port's SAM on the server's device: masks/sam.py)
  GET  /health  -> {"ok": true, "engine": "...", "edits_served": n}

Each POST is a `request` span (utils/logger.py; recorded only while the
recorder is on) and the edit inside it, on the device thread, a
`request.edit` span in the same request, whose clock reads give the
response's "secs".

A "seed" names x_T (z_T) through core/rng.py::RngStream.from_seed(seed) on
the pipeline's device: the same seed names a different x_T here than on
the JAX server (jax.random.normal). Post "image" (uncond, IF) for inputs
both servers agree on.

Run: python -m loco_edit_tpu_torch.serve --model_name FFHQ_P2 \
         --checkpoint_path ffhq_p2.pt --port 8787 [+ any cli.args flags]
  or: python -m loco_edit_tpu_torch.serve --model_name stable-diffusion-2-1-base \
         --checkpoint_path sd21_unet.safetensors --for_prompt "a photo" ...
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from loco_edit_tpu_torch.utils.logger import REQUEST, Span, carried, current_span, span


def _b64(a) -> str:
    a = np.asarray(a)
    if a.dtype != np.uint8:   # floats normalize to f32; uint8 pixels pass through
        a = np.ascontiguousarray(a, np.float32)
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _unb64(s: str, shape) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), np.float32).reshape(shape).copy()


def _decoded_shape(latent_shape, decoder) -> tuple[int, ...]:
    """The image shape the VAE decoder gives a (1,) + latent_shape latent,
    from its configuration (one 2x upsampling between consecutive levels),
    without running it."""
    cfg = decoder.cfg
    f = 2 ** (len(cfg.block_out_channels) - 1)
    h, w, _ = latent_shape
    return (1, h * f, w * f, cfg.out_channels)


class EditService:
    """The warm pipeline + request logic (transport-agnostic, used directly
    in tests and wrapped by the HTTP handler below)."""

    def __init__(self, args):
        if getattr(args, "is_stable_diffusion", False):
            self.engine = "sd"
        elif getattr(args, "is_LCM", False):
            self.engine = "lcm"
        elif getattr(args, "is_DeepFloyd_IF_diffusion", False):
            self.engine = "if"
        else:
            self.engine = "uncond"

        if self.engine == "uncond":
            from loco_edit_tpu_torch.cli.main import build_uncond_pipeline

            self.pipe, self.denoiser, self.rng = build_uncond_pipeline(args)
            self.sample_shape = tuple(self.denoiser.sample_shape)   # input space
            self.mask_shape = (1,) + self.sample_shape              # mask space
        else:
            from loco_edit_tpu_torch.cli.main import (build_if_pipeline,
                                                      build_lcm_pipeline,
                                                      build_sd_pipeline)

            build = {"sd": build_sd_pipeline, "lcm": build_lcm_pipeline,
                     "if": build_if_pipeline}[self.engine]
            self.pipe, self.bundle, self.rng = build(args)
            self.denoiser = None
            if self.engine == "if":
                # IF edits pixels directly: input == mask space
                self.sample_shape = tuple(self.bundle["sample_shape"])
                self.mask_shape = (1,) + self.sample_shape
            else:
                # SD/LCM: the seed samples zT in latent space, but the
                # pullback output (and hence the mask) lives in the DECODED
                # image space: its shape from the decoder's configuration
                self.sample_shape = tuple(self.bundle["latent_shape"])
                self.mask_shape = _decoded_shape(self.sample_shape,
                                                 self.bundle["models"]["decoder"])
        # one long-lived thread runs the device work of every request, one
        # at a time: cuDNN keeps the algorithm it measured for each
        # convolution signature per thread (core/device.py::use_full_f32),
        # so the warm-up edit chooses them for every later request
        self._device = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="edit-device")
        self.edits_served = 0
        self._args = args
        self._sam = None        # SamBundle, prepared on first use
        # the first SAM load can take a while; it runs on the requesting
        # thread under its own lock, so it does not stall the device thread
        self._sam_lock = threading.Lock()

    def on_device(self, fn, *args):
        """fn(*args) on the device thread, after the work queued before it;
        the caller's open span (its request) is carried across, so the
        spans and counters of the work fall in the caller's request."""
        parent = current_span()

        def run():
            with carried(parent):
                return fn(*args)
        return self._device.submit(run).result()

    def _sam_bundle(self):
        with self._sam_lock:
            if self._sam is None:
                from loco_edit_tpu_torch.masks.sam import prepare_sam

                # a local save_pretrained dir, a HF-named state_dict file,
                # or a hub name (seeded weights); never a fetch
                self._sam = prepare_sam(self._args.mask_model_name,
                                        device=self.pipe.device)
            return self._sam

    def _resolve_input(self, req: dict):
        from loco_edit_tpu_torch.core.rng import RngStream
        from loco_edit_tpu_torch.pipelines.common import _host

        h, w, c = self.sample_shape
        if "image" in req and req["image"]:
            if self.engine in ("sd", "lcm"):
                raise ValueError(
                    'SD/LCM /edit takes "seed" (zT); use /invert for images')
            x0 = _unb64(req["image"], (1, h, w, c))
            return x0, None
        seed = int(req.get("seed", 0))
        xT = RngStream.from_seed(seed).normal((1, h, w, c), device=self.pipe.device)
        return None, _host(xT)

    def _bbox_mask(self, req: dict) -> np.ndarray | None:
        """Boolean mask from a [y0, y1, x0, x1] bbox in the engine's mask
        space (sample pixels for uncond/IF, decoded-image pixels for SD/LCM)."""
        if not req.get("mask_bbox"):
            return None
        y0, y1, x0_, x1 = req["mask_bbox"]
        mask = np.zeros(self.mask_shape, bool)
        mask[:, y0:y1, x0_:x1, :] = True
        return mask

    def _cache_name(self, req: dict, rank: int) -> str:
        """Basis caches are disk-keyed by sample_name (pipelines/uncond.py),
        so the default name must be a function of everything that determines
        the basis (input: seed or image bytes; mask, prompts, rank) or a
        second request would silently reuse the first request's
        directions."""
        if req.get("sample_name"):
            return str(req["sample_name"])
        import hashlib

        ident = {k: req.get(k) for k in ("seed", "image", "mask_bbox",
                                         "for_prompt", "edit_prompt",
                                         "semantic")}
        digest = hashlib.sha1(
            json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]
        return f"serve-{digest}-r{rank}"

    @contextlib.contextmanager
    def _cfg_overrides(self, **kv):
        """Per-request pipeline-config overrides, restored on exit (the warm
        pipeline is shared state; requests serialize on the device thread)."""
        cfg = self.pipe.cfg
        old = {k: getattr(cfg, k) for k in kv}
        for k, v in kv.items():
            setattr(cfg, k, v)
        try:
            yield
        finally:
            for k, v in old.items():
                setattr(cfg, k, v)

    @staticmethod
    def _pixel_flag(req: dict) -> bool:
        # "pixel": strips return as uint8 pixels converted ON THE DEVICE (4x
        # smaller copy AND response payload). Default TRUE on the serve path
        # (the strips are the PNG payload for an HTTP client); "pixel": false
        # opts back into raw float strips (the library API's default)
        px = req.get("pixel", True)
        if not isinstance(px, bool):   # reject "false"/1/...: a string
            raise ValueError('"pixel" must be a JSON boolean')
        return px

    @staticmethod
    def _strip_payload(strips: dict) -> dict:
        first = next(iter(strips.values()))
        return {"strips": {str(pc): _b64(s) for pc, s in strips.items()},
                "shape": list(first.shape), "dtype": str(first.dtype)}

    @staticmethod
    def _semantic_flag(req: dict) -> bool:
        """Text-supervised direction iff an edit_prompt is given, unless the
        client says otherwise ("semantic": bool)."""
        if "semantic" in req:
            if not isinstance(req["semantic"], bool):
                raise ValueError('"semantic" must be a JSON boolean')
            return req["semantic"]
        return bool(req.get("edit_prompt"))

    def _t2i_prompts(self, req: dict) -> tuple[str, str]:
        fp = req.get("for_prompt")
        if not fp or not isinstance(fp, str):
            raise ValueError(f'"{self.engine}" engine requires "for_prompt"')
        return fp, str(req.get("edit_prompt") or "")

    def _t2i_overrides(self, px: bool, rank: int, nsp: bool, semantic: bool) -> dict:
        over = dict(pixel_output=px, pca_rank=rank, null_space_projection=nsp)
        if self.engine == "sd":
            over["vis_num_pc"] = rank
        if self.engine == "lcm":
            over["non_semantic"] = not semantic
        return over

    def _edit_t2i(self, req: dict) -> dict:
        """One warm T2I edit (SD / LCM / IF). The engines' own run_* methods
        do the work; this adapts the request (seeded zT/xT, bbox mask in
        the pullback output space, semantic switch) and normalizes the
        response to the /edit strips payload."""
        for_prompt, edit_prompt = self._t2i_prompts(req)
        semantic = self._semantic_flag(req)
        px = self._pixel_flag(req)
        mask = self._bbox_mask(req)
        _, zT = self._resolve_input(req)
        rank = int(req.get("pca_rank") or self.pipe.cfg.pca_rank)
        name = self._cache_name(req, rank)
        def run():
            with Span("request.edit") as timed:
                nsp = (self.pipe.cfg.null_space_projection and mask is not None)
                with self._cfg_overrides(**self._t2i_overrides(px, rank, nsp, semantic)):
                    if self.engine == "sd":
                        out = self.pipe.run_edit_null_space_projection_zt(
                            for_prompt, edit_prompt, zT=zT, mask=mask,
                            sample_name=name, semantic=semantic)
                        strips = out["strips"]
                    elif self.engine == "lcm":
                        out = self.pipe.run_edit_null_space_projection_zt(
                            for_prompt, edit_prompt, zT=zT, mask=mask,
                            sample_name=name)
                        strips = {0: out["image"]}
                    else:   # if
                        out = self.pipe.run_edit_null_space_projection_xt(
                            for_prompt, edit_prompt, xT=zT, mask=mask,
                            sample_name=name, semantic=semantic)
                        strips = {0: out["image"]}
                self.edits_served += 1
            return strips, nsp, timed.seconds

        strips, nsp, secs = self.on_device(run)
        return {**self._strip_payload(strips),
                "null_space_projection": nsp, "secs": round(secs, 3)}

    def edit(self, req: dict) -> dict:
        if self.engine != "uncond":
            return self._edit_t2i(req)
        mask = self._bbox_mask(req)
        x0, xT = self._resolve_input(req)
        px = self._pixel_flag(req)
        rank = int(req.get("pca_rank") or self.pipe.cfg.pca_rank)
        name = self._cache_name(req, rank)
        def run():
            with Span("request.edit") as timed:
                # API contract: one strip per requested principal component;
                # null-space projection needs a mask, and maskless requests
                # fall back to the unprojected basis (signalled in the response)
                nsp = (self.pipe.cfg.null_space_projection and mask is not None)
                with self._cfg_overrides(
                        pixel_output=px, pca_rank=rank, vis_num_pc=rank,
                        null_space_projection=nsp):
                    out = self.pipe.run_edit_null_space_projection(
                        x0=x0, xT=xT, mask=mask, sample_name=name)
                self.edits_served += 1
            return out, nsp, timed.seconds

        out, nsp, secs = self.on_device(run)
        return {**self._strip_payload(out["strips"]),
                "null_space_projection": nsp, "secs": round(secs, 3)}

    def edit_batch(self, req: dict) -> dict:
        """Throughput form: resolve every item, then run ONE batched
        inversion (all image items together) and one batched generation
        through run_edit_batch. Mask semantics follow /edit per item, but
        null-space projection is a whole-batch property: one maskless item
        switches the entire batch to the unprojected basis."""
        items = req.get("items")
        if not isinstance(items, list) or not items:
            raise ValueError('"items" must be a non-empty list')
        if self.engine == "if":
            raise ValueError("the IF engine has no batch API (cascade); "
                             "POST items to /edit individually")
        px = self._pixel_flag(req)
        h, w, c = self.sample_shape
        mh, mw, mc = self.mask_shape[1:]
        rank = int(req.get("pca_rank") or self.pipe.cfg.pca_rank)
        n = len(items)

        xTs = np.zeros((n, h, w, c), np.float32)
        masks = np.zeros((n, mh, mw, mc), bool)
        img_rows, img_stack, names = [], [], []
        all_masked = True
        for i, it in enumerate(items):
            if not isinstance(it, dict):
                raise ValueError('"items" entries must be objects')
            x0, xT = self._resolve_input(it)
            if x0 is not None:
                img_rows.append(i)
                img_stack.append(x0[0])
            else:
                xTs[i] = xT[0]
            if it.get("mask_bbox"):
                y0, y1, x0_, x1 = it["mask_bbox"]
                masks[i, y0:y1, x0_:x1, :] = True
            else:
                # all-ones == the basis's maskless path bit for bit
                masks[i] = True
                all_masked = False
            names.append(it.get("sample_name") or self._cache_name(it, rank))

        if self.engine in ("sd", "lcm"):
            return self._edit_batch_t2i(req, xTs, masks, names, all_masked,
                                        px, rank)

        from loco_edit_tpu_torch.pipelines.common import _host

        def run():
            with Span("request.edit") as timed:
                nsp = self.pipe.cfg.null_space_projection and all_masked
                with self._cfg_overrides(
                        pixel_output=px, pca_rank=rank, vis_num_pc=rank,
                        null_space_projection=nsp):
                    if img_rows:   # ONE inversion for every image item
                        inv = self.pipe.invert(np.stack(img_stack).astype(np.float32))
                        xTs[img_rows] = _host(inv)
                    results = self.pipe.run_edit_batch(
                        xTs=xTs, masks=masks, sample_names=names)
                self.edits_served += n
            return results, nsp, timed.seconds

        results, nsp, secs = self.on_device(run)
        return {"results": [
                    {**self._strip_payload(r["strips"]),
                     "null_space_projection": nsp} for r in results],
                "null_space_projection": nsp, "secs": round(secs, 3)}

    def _edit_batch_t2i(self, req, zTs, masks, names, all_masked, px, rank):
        """SD/LCM throughput form: ONE batched generation runs every seed to
        the edit step (pipelines/{sd,lcm}.py run_edit_batch)."""
        for_prompt, edit_prompt = self._t2i_prompts(req)
        semantic = self._semantic_flag(req)
        def run():
            with Span("request.edit") as timed:
                nsp = self.pipe.cfg.null_space_projection and all_masked
                with self._cfg_overrides(**self._t2i_overrides(px, rank, nsp, semantic)):
                    if self.engine == "sd":
                        results = self.pipe.run_edit_batch(
                            for_prompt, edit_prompt, zTs=zTs, masks=masks,
                            sample_names=names, semantic=semantic)
                        strips = [r["strips"] for r in results]
                    else:
                        results = self.pipe.run_edit_batch(
                            for_prompt, edit_prompt, zTs=zTs, masks=masks,
                            sample_names=names)
                        strips = [{0: r["image"]} for r in results]
                self.edits_served += len(names)
            return strips, nsp, timed.seconds

        strips, nsp, secs = self.on_device(run)
        return {"results": [{**self._strip_payload(st), "null_space_projection": nsp}
                            for st in strips],
                "null_space_projection": nsp, "secs": round(secs, 3)}

    def invert(self, req: dict) -> dict:
        from loco_edit_tpu_torch.pipelines.common import _host

        if self.engine in ("lcm", "if"):
            raise ValueError(f"the {self.engine} engine has no inversion "
                             "path (reference parity)")
        # uncond inverts in sample space; SD through the VAE encoder from
        # decoded-image space (pipelines/sd.py invert)
        shape = ((1,) + self.sample_shape if self.engine == "uncond"
                 else self.mask_shape)
        h, w, c = shape[1:]
        x0 = _unb64(req["image"], (1, h, w, c))
        refine = ({"inv_refine_steps": int(req["refine_steps"])}
                  if "refine_steps" in req else {})

        def run():
            with self._cfg_overrides(**refine):
                return _host(self.pipe.invert(x0))

        xT = self.on_device(run)
        return {"xT": _b64(xT), "shape": list(xT.shape)}

    def segment(self, req: dict) -> dict:
        """SAM mask proposals for an edit-frame image on the server's device
        (the SAM bundle is prepared once and kept warm, like the pipeline)."""
        from loco_edit_tpu_torch.masks.sam import segment_image_on_device
        from loco_edit_tpu_torch.utils.io import to_uint8

        # masks live in the engine's decoded-image space (== sample space
        # for uncond/IF)
        h, w, c = self.mask_shape[1:]
        x0 = _unb64(req["image"], (1, h, w, c))
        # the bundle is prepared on this thread (its own init lock); only
        # the device work below queues behind /edit
        bundle = self._sam_bundle()
        masks = self.on_device(lambda: segment_image_on_device(
            to_uint8(x0)[0], prepared=bundle, resolution=h,
            filter_mask=int(req.get("filter_mask", 100)),
            points_per_side=int(req.get("points_per_side", 32))))
        payload = base64.b64encode(
            np.ascontiguousarray(masks, np.uint8).tobytes()).decode()
        return {"masks": payload, "shape": list(masks.shape)}

    def health(self) -> dict:
        return {"ok": True, "engine": self.engine,
                "edits_served": self.edits_served}


def make_server(service: EditService, port: int = 8787) -> ThreadingHTTPServer:
    """A ThreadingHTTPServer on 127.0.0.1:port (0: any free port) over
    `service`. Each request is read and answered on its own thread; its
    device work runs on the service's device thread (EditService.on_device),
    where PyTorch's thread-local state (grad mode, the current stream)
    starts at its defaults; the backend flags the port sets
    (core/device.py::use_full_f32) are process-wide."""
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            self._send_body(code, json.dumps(payload).encode())

        def _send_body(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._send(200, service.health())
            return self._send(404, {"error": "unknown path"})

        def do_POST(self):
            # the span closes before the answer is written, so a client
            # that has the answer finds the request recorded
            with span(REQUEST, route=self.path):
                code, body = self._answer()
            self._send_body(code, body)

        def _answer(self) -> tuple[int, bytes]:
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/edit":
                    code, payload = 200, service.edit(req)
                elif self.path == "/edit_batch":
                    code, payload = 200, service.edit_batch(req)
                elif self.path == "/invert":
                    code, payload = 200, service.invert(req)
                elif self.path == "/segment":
                    code, payload = 200, service.segment(req)
                else:
                    code, payload = 404, {"error": "unknown path"}
                return code, json.dumps(payload).encode()
            except Exception as e:  # noqa: BLE001: report, keep serving
                return 500, json.dumps({"error": str(e)}).encode()

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    import argparse

    from loco_edit_tpu_torch.cli.args import check_supported, parse_args, preset
    from loco_edit_tpu_torch.cli.main import start_ranks
    from loco_edit_tpu_torch.core.cache import enable_compile_cache
    from loco_edit_tpu_torch.core.device import resolve_device

    outer = argparse.ArgumentParser("loco-edit-tpu serve", add_help=False)
    outer.add_argument("--port", type=int, default=8787)
    port_args, rest = outer.parse_known_args(argv)

    args = parse_args(rest)
    check_supported(args)
    resolve_device(args.device)      # no card and no --device cpu: raise now
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise ValueError("the edit server runs in one process; start it without torchrun")
    start_ranks(args, args.device)   # one process: the mesh flags must fit it
    print(f"kernel build directory: {enable_compile_cache()}", flush=True)
    args = preset(args)
    service = EditService(args)
    # one warm-up edit, on the device thread that serves every request,
    # builds and loads the kernels and chooses the convolutions' algorithms
    # before any request arrives; a failure here is the server's failure
    print(f"warming {service.engine} pipeline on {service.pipe.device}...", flush=True)
    warm = {"seed": 0, "sample_name": "warmup"}
    if service.engine != "uncond":
        warm["for_prompt"] = args.for_prompt or "a photo"
        warm["edit_prompt"] = args.edit_prompt or ""
    service.edit(warm)
    srv = make_server(service, port_args.port)
    print(f"serving on 127.0.0.1:{srv.server_address[1]}", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
