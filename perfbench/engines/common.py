"""What the engines share: the reference's precision, the benchmark's
weights in the reference models, and the judgement of served edits."""

from __future__ import annotations

import contextlib

import torch

from perfbench import inputs
from perfbench.reference import loco


@contextlib.contextmanager
def judging(check: dict):
    """Plain float32 for the reference: TF32 off for matmuls and
    convolutions, and cuDNN's benchmark mode as the configuration's check
    sets it ("cudnn_benchmark": whichever made the reference shorter in a
    fresh process); restored after."""
    b = torch.backends
    saved = b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.benchmark = bool(check.get("cudnn_benchmark", False))
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = saved


def reference_weights(model: torch.nn.Module, seed: int, device,
                      config: dict) -> torch.nn.Module:
    """A reference model built on the meta device, materialized on `device`
    with the benchmark's weights for `seed` (the same draws the served model
    got, in the configuration's dtype, widened to float32), frozen."""
    model = model.to_empty(device=device)
    params = dict(model.named_parameters())
    dtype = inputs.served_dtype(config)
    with torch.no_grad():
        for name, w in inputs.make_weights(inputs.weight_specs(model), seed, device, dtype):
            params[name].copy_(w.float())
    return model.requires_grad_(False).eval()


def judge(engine, records, quant=None) -> dict:
    """The comparison's numbers over the sampled edits (the largest of
    each). For each, the engine gives the program's answer (its judged
    frames as uint8, its projected directions, and the count of answer
    faults); with `quant` (reference/loco.py::tf32_round) the reference in
    that precision stands in for the program: the control. The reference then makes its own x at the edit step and its
    own basis (basis_gap), and its own frames along the given directions
    (strips_gap)."""
    with judging(engine.config["check"]):
        model = engine.reference()
        control = engine.reference(quant) if quant is not None else None
        out = {"basis_gap": 0.0, "strips_gap": 0.0, "answer_faults": 0.0}
        for rec in records:
            if control is not None:
                x = engine.generate(control, rec)
                vT = engine.basis(control, x, rec)
                frames, faults = engine.strips(control, x, vT, rec), 0
            else:
                frames, vT, faults = engine.program_output(rec)
            out["answer_faults"] += faults
            if faults:
                out["basis_gap"] = out["strips_gap"] = float("inf")
                continue
            x = engine.generate(model, rec)
            out["basis_gap"] = max(out["basis_gap"],
                                   loco.subspace_gap(vT, engine.basis(model, x, rec)))
            out["strips_gap"] = max(out["strips_gap"],
                                    loco.pixel_gap(frames, engine.strips(model, x, vT, rec)))
        return out
