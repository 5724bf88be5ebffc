"""The 3xTF32 convolution route (loco_edit_tpu_torch/ops/conv.py) on the CPU:
the TF32 split, the route's arithmetic and its differentiation rules against
F.conv2d at f32, and the CPU path of the models' Conv2d, which is F.conv2d.

On the CPU the route's Function runs its arithmetic with plain convolutions:
conv(hi_x, hi_w) (one convolution a chunk where its depth is cut into
chunks) + conv([hi_x, lo_x], [lo_w, hi_w]), short of lo_x * lo_w (2^-22 of a
product), so it agrees with F.conv2d to f32 summation order; 1e-5 of the
largest output leaves that room and is 50 times below a TF32 product's
2^-11.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from loco_edit_tpu_torch.ops import conv
from loco_edit_tpu_torch.ops.conv import (Conv2d, ConvFn, Geometry, conv2d, split_plain,
                                          tf32_split)
from loco_edit_tpu_torch.utils.logger import start_recording, stop_recording

RTOL = 1e-5

GEOMETRIES = {
    "3x3": (3, Geometry((1, 1), (1, 1), (1, 1))),
    "1x1": (1, Geometry((1, 1), (0, 0), (1, 1))),
    "3x3_stride2": (3, Geometry((2, 2), (1, 1), (1, 1))),
}


def _rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def _operands(kernel: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 6, 9, 9, generator=g).contiguous(memory_format=torch.channels_last)
    w = torch.randn(5, 6, kernel, kernel, generator=g) / (6 * kernel * kernel) ** 0.5
    b = torch.randn(5, generator=g)
    return x, w, b


def _ref(geo):
    return lambda x, w, b=None: F.conv2d(x, w, b, geo.stride, geo.padding, geo.dilation)


def _ours(geo):
    return lambda x, w, b=None: ConvFn.apply(x, w, b, geo)


def test_tf32_split_rounds_to_nearest_and_sums_back_exactly():
    """hi keeps TF32's 10 mantissa bits (the low 13 are zero), is the value
    rounded to nearest with ties away from zero (against a float64
    rounding), and hi + lo is the value, bit for bit (a negative zero sums
    back to +0: -0 - -0 is +0)."""
    g = torch.Generator().manual_seed(1)
    scale = 10.0 ** torch.randint(-6, 6, (4096,), generator=g)
    v = torch.cat([torch.randn(4096, generator=g) * scale,
                   torch.tensor([0.0, -0.0, 1.0, -3.5, 1e-40, 3e38])])
    ties = (torch.randint(0, 2 ** 30, (64,), generator=g, dtype=torch.int32) & -0x2000) | 0x1000
    v = torch.cat([v, ties.view(torch.float32), -ties.view(torch.float32)])
    hi, lo = tf32_split(v)
    assert torch.equal((hi.view(torch.int32) & 0x1FFF), torch.zeros_like(v, dtype=torch.int32))
    nonzero = v != 0
    assert torch.equal((hi + lo).view(torch.int32)[nonzero], v.view(torch.int32)[nonzero])
    assert torch.equal(hi + lo, v)
    # TF32's quantum: 2^(e - 11) for v = m 2^e, |m| in [0.5, 1) (11 significant
    # bits), and 2^-136 (10 bits below 2^-126) for subnormals
    quantum = 2.0 ** (np.maximum(np.frexp(v.double().numpy())[1], -125) - 11)
    scaled = v.double().numpy() / quantum
    want = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) * quantum
    assert np.array_equal(hi.double().numpy(), want)


@pytest.mark.parametrize("dim, lo_first", [(1, False), (1, True), (0, True)])
def test_split_plain_gives_hi_and_the_pair(dim, lo_first):
    """hi, and the pair [hi, lo] (an activation's) or [lo, hi] (a weight's)
    along the channels (dim 1) or the output channels (dim 0)."""
    x, _, _ = _operands(3)
    hi, lo = tf32_split(x)
    got_hi, pair = split_plain(x, dim, lo_first)
    assert torch.equal(got_hi, hi)
    want = [lo, hi] if lo_first else [hi, lo]
    assert all(torch.equal(a, b) for a, b in zip(pair.split(x.shape[dim], dim=dim), want))


@pytest.mark.parametrize("max_depth", [None, 18])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("case", ["forward", "jvp_x", "jvp_x_w_b", "vjp_x", "vjp_w_b",
                                  "vmap_jvp", "vmap_vjp"])
def test_route_arithmetic_matches_f32_conv(case, geometry, max_depth, monkeypatch):
    """The Function on the CPU against F.conv2d at f32, to 1e-5 of the
    largest output: forward; jvp with and without weight and bias tangents;
    vjp for the input, weight and bias gradients; vmap over a probe axis of
    the jvp's input tangent and of the vjp's cotangent (the basis sweeps of
    editing/pullback.py); with hi*hi in one accumulator and, at a MAX_DEPTH
    of 18 products, cut into chunks (3 of the forward's 6 x 9, 5 of the
    input gradient's 5 x 9)."""
    if max_depth is not None:
        monkeypatch.setattr(conv, "MAX_DEPTH", max_depth)
    kernel, geo = GEOMETRIES[geometry]
    x, w, b = _operands(kernel)
    ours, ref = _ours(geo), _ref(geo)
    g = torch.Generator().manual_seed(2)
    dx = torch.randn(x.shape, generator=g)
    dw, db = torch.randn(w.shape, generator=g), torch.randn(b.shape, generator=g)
    if case == "forward":
        pairs = [(ours(x, w, b), ref(x, w, b))]
    elif case == "jvp_x":
        pairs = [(torch.func.jvp(lambda z: f(z, w, b), (x,), (dx,))[1]) for f in (ours, ref)]
        pairs = [tuple(pairs)]
    elif case == "jvp_x_w_b":
        pairs = [tuple(torch.func.jvp(f, (x, w, b), (dx, dw, db))[1] for f in (ours, ref))]
    elif case in ("vjp_x", "vjp_w_b"):
        args = (x,) if case == "vjp_x" else (w, b)
        outs = []
        for f in (ours, ref):
            fn = (lambda z: f(z, w, b)) if case == "vjp_x" else (lambda ww, bb: f(x, ww, bb))
            y, vjp_fn = torch.func.vjp(fn, *args)
            outs.append(vjp_fn(torch.randn(y.shape, generator=torch.Generator().manual_seed(3))))
        pairs = list(zip(*outs))
    elif case == "vmap_jvp":
        probes = torch.randn(3, *x.shape, generator=g)
        pairs = [tuple(torch.func.vmap(
            lambda v: torch.func.jvp(lambda z: f(z, w, b), (x,), (v,))[1])(probes)
            for f in (ours, ref))]
    else:
        outs = []
        for f in (ours, ref):
            y, vjp_fn = torch.func.vjp(lambda z: f(z, w, b), x)
            cot = torch.randn(3, *y.shape, generator=torch.Generator().manual_seed(4))
            outs.append(torch.func.vmap(vjp_fn)(cot)[0])
        pairs = [tuple(outs)]
    for got, want in pairs:
        assert got.shape == want.shape
        assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_conv2d_module_on_cpu_is_f_conv2d(geometry):
    """The models' Conv2d on the CPU returns exactly what F.conv2d returns,
    forward and gradients, and keeps nn.Conv2d's parameters and state_dict
    keys; the route is never entered (nothing is counted)."""
    kernel, geo = GEOMETRIES[geometry]
    torch.manual_seed(5)
    m = Conv2d(6, 5, kernel, stride=geo.stride, padding=geo.padding)
    plain = torch.nn.Conv2d(6, 5, kernel, stride=geo.stride, padding=geo.padding)
    assert list(m.state_dict()) == list(plain.state_dict())
    plain.load_state_dict(m.state_dict())
    x, _, _ = _operands(kernel)
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    start_recording()
    try:
        y1, y2 = m(x1), plain(x2)
        assert torch.equal(y1, y2)
        (y1 * y1).sum().backward()
        (y2 * y2).sum().backward()
    finally:
        rec = stop_recording()
    assert torch.equal(x1.grad, x2.grad) and torch.equal(m.weight.grad, plain.weight.grad)
    assert rec.counts == {}


@pytest.mark.parametrize("dtype, groups", [(torch.float32, 1), (torch.bfloat16, 1),
                                           (torch.float32, 2)])
def test_only_f32_card_convolutions_under_the_policy_take_the_route(dtype, groups):
    """on_card_f32: never on the CPU (on the card, f32 and groups 1 only,
    and only while cuDNN's TF32 is off); conv2d elsewhere is F.conv2d, bit
    for bit."""
    x = torch.randn(1, 4, 5, 5, dtype=dtype)
    w = torch.randn(4, 4 // groups, 3, 3, dtype=dtype)
    assert not conv.on_card_f32(x, w, 1, groups)
    assert torch.equal(conv2d(x, w, None, 1, 1, 1, groups), F.conv2d(x, w, None, 1, 1, 1, groups))


@pytest.mark.parametrize("x_shape, w_shape, geometry, flop, routed", [
    ((6, 256, 256, 256), (256, 256, 3, 3), "3x3", 2 * 6 * 256 * 256 * 256 * 256 * 9, True),
    ((9, 256, 256, 256), (256, 256, 1, 1), "1x1", 2 * 9 * 256 * 256 * 256 * 256, True),
    ((9, 128, 256, 256), (128, 128, 1, 1), "1x1", 2 * 9 * 256 * 256 * 128 * 128, False),
    ((9, 256, 256, 256), (128, 256, 1, 1), "1x1", 2 * 9 * 256 * 256 * 128 * 256, False),
    ((1, 128, 256, 256), (128, 128, 3, 3), "3x3", 2 * 256 * 256 * 128 * 128 * 9, False),
    ((9, 256, 256, 256), (256, 256, 3, 3), "3x3_stride2", 2 * 9 * 128 * 128 * 256 * 256 * 9, True),
    ((9, 3, 512, 512), (128, 3, 3, 3), "3x3", 2 * 9 * 512 * 512 * 128 * 3 * 9, False),
])
def test_route_takes_convolutions_by_size(x_shape, w_shape, geometry, flop, routed):
    """takes_route: the implicit GEMM's operations (as the caller sees the
    shapes) from MIN_FLOP up, MIN_CHANNELS channels in and out, and a 1x1
    convolution only from MIN_1X1_OUT output channels."""
    geo = GEOMETRIES[geometry][1]
    x, w = torch.empty(x_shape, device="meta"), torch.empty(w_shape, device="meta")
    assert conv.gemm_flop(x.shape, w.shape, geo) == flop
    assert conv.takes_route(x, w, geo) == routed


def test_spatial_parallelism_sees_every_model_convolution():
    """A TorchFunctionMode (parallel/sp.py's halo rewrite) is handed each
    Conv2d call as ops.conv2d, with the module's arguments."""
    seen = []

    class Spy(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is conv2d:
                seen.append(args[4])
            return func(*args, **(kwargs or {}))

    m = torch.nn.Sequential(Conv2d(6, 6, 3, padding=1), Conv2d(6, 5, 1))
    x, _, _ = _operands(3)
    with Spy():
        m(x)
    assert seen == [(1, 1), (0, 0)]


def test_weight_parts_are_kept_per_parameter_version():
    """A parameter's parts (hi in runs of the pass's chunks, and the pair
    [lo, hi], both along the pass's dimension) are made once a pass and
    number of chunks, and made anew after the parameter changes in place;
    a plain tensor's are not kept."""
    w = torch.nn.Parameter(torch.randn(4, 6, 3, 3))
    his, pair = conv._weight_parts(w, 1, 1)
    assert conv._weight_parts(w, 1, 1)[1] is pair
    want = split_plain(w.detach(), 1, lo_first=True)
    assert len(his) == 1 and torch.equal(his[0], want[0]) and torch.equal(pair, want[1])
    assert torch.equal(conv._weight_parts(w, 0, 1)[1], split_plain(w.detach(), 0, lo_first=True)[1])
    # the forward's chunks run along the input channels, the input gradient's
    # along the output channels
    assert [tuple(h.shape) for h in conv._weight_parts(w, 1, 2)[0]] == [(4, 3, 3, 3)] * 2
    assert torch.equal(torch.cat(conv._weight_parts(w, 1, 3)[0], 1), want[0])
    assert torch.equal(torch.cat(conv._weight_parts(w, 0, 2)[0], 0), want[0])
    with torch.no_grad():
        w.mul_(2.0)
    pair2 = conv._weight_parts(w, 1, 1)[1]
    assert pair2 is not pair and torch.equal(pair2, split_plain(w.detach(), 1, lo_first=True)[1])
    t = torch.randn(5, 6, 3, 3)
    assert conv._weight_parts(t, 0, 1)[1] is not conv._weight_parts(t, 0, 1)[1]


@pytest.mark.parametrize("channels, taps, max_depth, want", [
    (128, 9, 1152, 1), (256, 9, 1152, 2), (384, 9, 1152, 3), (320, 9, 1152, 4),
    (4096, 9, 1152, 32), (512, 1, 1152, 1), (6, 9, 18, 3), (5, 9, 18, 5), (7, 400, 18, 7),
])
def test_chunks_hold_at_most_max_depth_products(channels, taps, max_depth, want, monkeypatch):
    """chunks: the fewest that divide the channels with at most MAX_DEPTH
    products each (320 x 9 = 2880 needs 3, which 320 does not divide: 4),
    one channel a chunk where its taps alone are more."""
    monkeypatch.setattr(conv, "MAX_DEPTH", max_depth)
    assert conv.chunks(channels, taps) == want


@pytest.mark.parametrize("routed", [True, False])
def test_counters_weigh_each_call_once(routed, monkeypatch):
    """conv2d adds each call's operations (GFLOP, as the caller sees its
    shapes: a probe's under vmap) to conv_gflop, and a routed call's to
    conv_tc_gflop too, once a call on either route: its tangent and input
    gradient are not counted again. The card's domain is stood in for on
    the CPU, where the route runs with plain convolutions."""
    monkeypatch.setattr(conv, "on_card_f32", lambda *a: True)
    monkeypatch.setattr(conv, "MIN_CHANNELS", 1)
    monkeypatch.setattr(conv, "MIN_FLOP", 0 if routed else float("inf"))
    geo = GEOMETRIES["3x3"][1]
    x, w, b = _operands(3)
    w.requires_grad_()
    probes = torch.randn(3, *x.shape, generator=torch.Generator().manual_seed(6))

    def f(z):
        return conv2d(z, w, b, 1, 1)

    start_recording()
    try:
        y = f(x)
        tangents = torch.func.vmap(lambda v: torch.func.jvp(f, (x,), (v,))[1])(probes)
        out, vjp_fn = torch.func.vjp(f, x)
        grads = torch.func.vmap(vjp_fn)(torch.randn(3, *out.shape))[0]
    finally:
        rec = stop_recording()
    ref = _ref(geo)
    assert _rel(y, ref(x, w, b)) <= RTOL
    want_t = torch.func.vmap(lambda v: torch.func.jvp(lambda z: ref(z, w, b), (x,), (v,))[1])(probes)
    assert _rel(tangents, want_t) <= RTOL and grads.shape == probes.shape
    gflop = conv.gemm_flop(x.shape, w.shape, geo) / 1e9
    counts = rec.counts[None]
    assert counts["conv_gflop"] == pytest.approx(3 * gflop)
    assert counts.get("conv_tc_gflop", 0) == pytest.approx(3 * gflop if routed else 0)
