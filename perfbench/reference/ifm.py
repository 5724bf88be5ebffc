"""Plain float32 DeepFloyd-IF cascade: the reference the benchmark holds the
served IF-I-M edit and its IF-II-L upscale to (engines/deepfloyd.py), as
tests/test_torch_if_reference.py holds the port to it on the CPU. Imports
nothing of the program; `set_quant` as in reference/adm.py.

- The IF U-Net (`UNet`, either stage): res blocks with scale-shift time
  conditioning and the up / down sampling inside the block (nearest 2x /
  2x2 average, on the h path and the residual alike), exact-erf GELU;
  added-KV attention: the GroupNorm-ed image tokens give q, k and v, and
  the text states, projected by encoder_hid_proj and group-normed over
  their channels with the statistics pooled over the sequence (norm_cross),
  add keys and values, text first, before one softmax with the 1/sqrt(d)
  scale (N_kv = 77 + H W); the attention-pooled text embedding (LayerNorm,
  one query, the tokens' mean plus a learned positional embedding,
  attending over [query; tokens] with q and k each scaled by d^-1/4,
  Linear, LayerNorm) of the raw T5 states added to the time embedding;
  stage 2's aug-level class embedding (a timestep MLP) added too, and its
  input [x_t | the conditioning image] on channels; the learned-sigma
  output (eps | sigma), of which the samplers take the eps half.
- The squaredcos_cap_v2 schedule (diffusers' betas_for_alpha_bar over 1000
  steps, capped at 0.999), its betas and cumulative product in float64,
  cast to float32 where used; the linspace DDIM grid with t_max 990
  (`Grid`).
- CFG on the eps half: e_null + g (e_for - e_null), the two prompts
  stacked on the batch.
- The stage-2 sampler (`superres`): bilinear align-corners upsampling of
  the stage-1 frames, the conditioning image noised at the aug level with
  the draw of stream "sr-aug" at the call's index, x_T from "sr-noise" at
  that index, a CFG DDIM (eta 0) over the upscaler's grid, then a clamp to
  [-1, 1].

Departures from diffusers' UNet2DConditionModel, whose config.json flags
would settle them (the hub's files are not in the repository; these
follow the served model): the time embedding is activated once, inside
each res block before time_emb_proj, where diffusers can also activate
the summed embedding (time_embedding_act_fn) and skip the blocks' own
activation (resnet_skip_time_act); the res blocks' outputs are not
rescaled (resnet_out_scale_factor 1); the input and output are NHWC, and
the learned-sigma channels are split by the samplers, not by a scheduler.
The aug-level class MLP is activated by GELU, as diffusers builds its
class TimestepEmbedding with the U-Net's act_fn.

The module tree and the parameter names, in registration order, are the
served model's, so perfbench/inputs.py::make_weights gives both sides the
same draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import loco
from perfbench.reference.adm import Conv, _Q, timestep_embedding
from perfbench.reference.sd import GroupNorm, LayerNorm, Linear, attention, image, tokens


def _lpb(sizes: dict, level: int) -> int:
    n = sizes["layers_per_block"]
    return n if isinstance(n, int) else n[level]


class ResBlock(nn.Module):
    def __init__(self, cin, cout, ted, up=False, down=False):
        super().__init__()
        self.up, self.down = up, down
        self.norm1 = GroupNorm(cin, 1e-5)
        self.conv1 = Conv(cin, cout)
        self.time_emb_proj = Linear(ted, 2 * cout)
        self.norm2 = GroupNorm(cout, 1e-5)
        self.conv2 = Conv(cout, cout)
        if cin != cout:
            self.conv_shortcut = Conv(cin, cout, k=1)

    def forward(self, x, temb):
        h = F.gelu(self.norm1(x))
        if self.up:
            h, x = (F.interpolate(t, scale_factor=2, mode="nearest") for t in (h, x))
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.conv1(h)
        scale, shift = self.time_emb_proj(F.gelu(temb))[:, :, None, None].chunk(2, dim=1)
        h = self.conv2(F.gelu(self.norm2(h) * (1 + scale) + shift))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class AddedKVAttention(nn.Module, _Q):
    def __init__(self, ch, ctx_dim, head_dim):
        super().__init__()
        self.heads = max(ch // head_dim, 1)
        self.group_norm = GroupNorm(ch, 1e-5)
        self.norm_cross = GroupNorm(ctx_dim, 1e-5)
        self.to_q, self.to_k = Linear(ch, ch), Linear(ch, ch)
        self.to_v, self.to_out_0 = Linear(ch, ch), Linear(ch, ch)
        self.add_k_proj = Linear(ctx_dim, ch)
        self.add_v_proj = Linear(ctx_dim, ch)

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        t = tokens(self.group_norm(x))
        # the states as a (B, dim, 1, seq) image: GroupNorm over their channels
        s = self.norm_cross(ctx.transpose(1, 2)[:, :, None, :])[:, :, 0, :].transpose(1, 2)
        k = torch.cat([self.add_k_proj(s), self.to_k(t)], dim=1)
        v = torch.cat([self.add_v_proj(s), self.to_v(t)], dim=1)

        def split(z):
            return z.reshape(b, z.shape[1], self.heads, c // self.heads).transpose(1, 2)

        a = attention(split(self.to_q(t)), split(k), split(v), self.q)
        return x + image(self.to_out_0(a.transpose(1, 2).reshape(b, hh * ww, c)), hh, ww)


class TextPool(nn.Module, _Q):
    """The attention-pooled text embedding (the served model's
    `add_embedding`)."""

    def __init__(self, dim, ted, heads):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.positional_embedding = nn.Parameter(torch.empty(1, dim))
        self.q_proj, self.k_proj, self.v_proj = (Linear(dim, dim) for _ in range(3))
        self.proj = Linear(dim, ted)
        self.norm2 = LayerNorm(ted)

    def forward(self, ctx):
        b, _, e = ctx.shape
        d = e // self.heads
        x = self.norm1(ctx)
        query = x.mean(dim=1, keepdim=True) + self.positional_embedding
        both = torch.cat([query, x], dim=1)

        def split(z):
            return z.reshape(b, z.shape[1], self.heads, d).transpose(1, 2)

        sc = d ** -0.25
        w = torch.softmax(torch.matmul(self.q(split(self.q_proj(query)) * sc),
                                       self.q((split(self.k_proj(both)) * sc)
                                              .transpose(-1, -2))), dim=-1)
        a = torch.matmul(self.q(w), self.q(split(self.v_proj(both))))
        return self.norm2(self.proj(a.transpose(1, 2).reshape(b, e)))


class UNet(nn.Module):
    """[eps | sigma](x, t, ctx, aug_t): x (B, H, W, in_channels) NHWC, t and
    aug_t scalar timesteps, ctx (B or 1, seq, encoder_hid_dim) T5 states;
    float32. `sizes` is a stage of the configuration file."""

    def __init__(self, sizes: dict):
        super().__init__()
        self.sizes = s = sizes
        chs = list(s["block_out_channels"])
        ch0, ted, xd = chs[0], 4 * chs[0], s["cross_attention_dim"]
        hd, attn = s["attention_head_dim"], s["attn_levels"]
        self.time_dense0 = Linear(ch0, ted)
        self.time_dense1 = Linear(ted, ted)
        if s["class_embed_timestep"]:
            self.class_dense0 = Linear(ch0, ted)
            self.class_dense1 = Linear(ted, ted)
        self.add_embedding = TextPool(s["encoder_hid_dim"], ted, s["addition_embed_num_heads"])
        self.encoder_hid_proj = Linear(s["encoder_hid_dim"], xd)
        self.conv_in = Conv(s["in_channels"], ch0)
        n = len(chs)
        ch, skips = ch0, [ch0]
        for i, out in enumerate(chs):
            for j in range(_lpb(s, i)):
                self.add_module(f"down_{i}_res_{j}", ResBlock(ch, out, ted))
                ch = out
                if attn[i]:
                    self.add_module(f"down_{i}_attn_{j}", AddedKVAttention(ch, xd, hd))
                skips.append(ch)
            if i != n - 1:
                self.add_module(f"down_{i}_downsample", ResBlock(ch, ch, ted, down=True))
                skips.append(ch)
        self.mid_res_0 = ResBlock(ch, ch, ted)
        self.mid_attn = AddedKVAttention(ch, xd, hd)
        self.mid_res_1 = ResBlock(ch, ch, ted)
        for k in range(n):
            i = n - 1 - k
            for j in range(_lpb(s, i) + 1):
                self.add_module(f"up_{i}_res_{j}", ResBlock(ch + skips.pop(), chs[i], ted))
                ch = chs[i]
                if attn[i]:
                    self.add_module(f"up_{i}_attn_{j}", AddedKVAttention(ch, xd, hd))
            if i != 0:
                self.add_module(f"up_{i}_upsample", ResBlock(ch, ch, ted, up=True))
        self.conv_norm_out = GroupNorm(ch, 1e-5)
        self.conv_out = Conv(ch, s["out_channels"])

    def set_quant(self, quant):
        for m in self.modules():
            if isinstance(m, _Q):
                m.quant = quant
        return self

    def forward(self, x, t, ctx, aug_t=None):
        s = self.sizes
        b = x.shape[0]
        ch0 = s["block_out_channels"][0]

        def embed(v):
            return timestep_embedding(
                torch.full((b,), float(v), dtype=torch.float32, device=x.device), ch0)

        ctx = ctx.expand((b,) + tuple(ctx.shape[-2:]))
        temb = self.time_dense1(F.gelu(self.time_dense0(embed(t))))
        if s["class_embed_timestep"]:
            temb = temb + self.class_dense1(F.gelu(self.class_dense0(embed(aug_t))))
        temb = temb + self.add_embedding(ctx)
        ctx = self.encoder_hid_proj(ctx)
        h = self.conv_in(x.permute(0, 3, 1, 2))
        skips = [h]
        n = len(s["block_out_channels"])
        for i in range(n):
            for j in range(_lpb(s, i)):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb)
                if s["attn_levels"][i]:
                    h = getattr(self, f"down_{i}_attn_{j}")(h, ctx)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h, temb)
                skips.append(h)
        h = self.mid_res_1(self.mid_attn(self.mid_res_0(h, temb), ctx), temb)
        for k in range(n):
            i = n - 1 - k
            for j in range(_lpb(s, i) + 1):
                h = getattr(self, f"up_{i}_res_{j}")(torch.cat([h, skips.pop()], dim=1), temb)
                if s["attn_levels"][i]:
                    h = getattr(self, f"up_{i}_attn_{j}")(h, ctx)
            if i != 0:
                h = getattr(self, f"up_{i}_upsample")(h, temb)
        return self.conv_out(F.gelu(self.conv_norm_out(h))).permute(0, 2, 3, 1)


def build(config: dict, device="meta"):
    """(stage-1 U-Net, stage-2 U-Net) at the configuration's sizes, weights
    uninitialized."""
    with torch.device(device):
        return UNet(config["stage1"]), UNet(config["stage2"])


# -- the schedule, the grid and the samplers ---------------------------------------


def squaredcos_cap_v2(n: int = 1000) -> np.ndarray:
    """The alpha-bar table: beta_i = min(1 - f((i + 1) / n) / f(i / n), 0.999)
    with f(u) = cos((u + 0.008) / 1.008 pi / 2)^2, cumulated in float64."""
    def f(u):
        return math.cos((u + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.array([min(1 - f((i + 1) / n) / f(i / n), 0.999) for i in range(n)])
    return np.cumprod(1.0 - betas)


class Grid(loco.Grid):
    """loco.Grid's descending DDIM grid of `steps` steps over t in [0,
    t_max] (torch's float32 linspace), on the squaredcos_cap_v2 table."""

    def __init__(self, steps: int, t_max: int = 990):
        self.table = squaredcos_cap_v2()
        g = loco._linspace_f32(steps).astype(np.float32) * np.float32(t_max)
        g = g.astype(np.float64)
        t, t_next = g[1:][::-1], g[:-1][::-1]

        def look(v):
            return self.table[np.clip(v.astype(np.int64), 0, 999)].astype(np.float32)

        self.t = t.astype(np.float32)
        self.ab, self.ab_next = look(t), look(t_next)


def cfg_eps(unet, x, t, ctx_for, ctx_null, scale: float, cond=None, aug_t=None):
    """e_null + scale (e_for - e_null) on the eps half, the prompts stacked
    on the batch; `cond` (stage 2) rides on the channels."""
    b, c = x.shape[0], x.shape[-1]
    ctx = torch.cat([ctx_for.expand((b,) + tuple(ctx_for.shape[-2:])),
                     ctx_null.expand((b,) + tuple(ctx_null.shape[-2:]))])
    xx = x if cond is None else torch.cat([x, cond], dim=-1)
    e_for, e_null = unet(torch.cat([xx, xx]), t, ctx, aug_t)[..., :c].chunk(2)
    return e_null + scale * (e_for - e_null)


@torch.no_grad()
def superres(unet, low, ctx_for, ctx_null, *, out_size: int, steps: int, scale: float,
             aug_level: int, root: loco.Stream, call: int, t_max: int = 990):
    """The upscale of the (B, h, w, 3) stage-1 frames `low` in [-1, 1] to
    (B, out_size, out_size, 3), the `call`-th upscale of the server seeded
    by `root`."""
    grid = Grid(steps, t_max)
    cond = F.interpolate(low.permute(0, 3, 1, 2), size=(out_size, out_size),
                         mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
    ab = np.float32(grid.table[aug_level])
    noise = root.fork("sr-aug").at_step(call).normal(cond.shape, cond.device)
    cond = float(np.sqrt(ab)) * cond + float(np.sqrt(np.float32(1.0) - ab)) * noise
    xT = root.fork("sr-noise").at_step(call).normal(
        (low.shape[0], out_size, out_size, low.shape[-1]), low.device)
    x = loco.denoise(lambda z, t: cfg_eps(unet, z, t, ctx_for, ctx_null, scale, cond,
                                          float(aug_level)),
                     xT, grid, 0, len(grid))
    return torch.clamp(x, -1.0, 1.0)
