"""SAM prompt encoder + mask decoder (port of
loco_edit_tpu/masks/sam_decoder_flax.py).

transformers' SamModel decode stage, NHWC as in the JAX package:
  - random-Fourier positional encoding shared between the image grid and
    the points;
  - point / box / mask prompt embeddings (labels -10 drop the point, -1
    "not a point", 0 negative, 1 positive; +0.5 pixel-center shift; one
    (0, 0) / -1 pad point when there are no boxes; box corners take
    point_embed[2:4]; the learned no-mask embedding broadcast as the dense
    prompt when no mask is given);
  - the two-way transformer (token self-attention, token->image and
    image->token cross-attention at half width, MLP, positional embeddings
    re-added at every layer), f32 logits;
  - the 2x2 stride-2 transposed-conv upscaler with a channel LayerNorm
    between, per-mask-token hypernetwork MLPs, the IoU head.

Plain torch throughout: the JAX module reaches no Pallas kernel.
Submodules carry the Flax names; the transposed convolutions keep torch's
(Ci, Co, 2, 2) weight layout, where the JAX package stores (Ci, 2, 2, Co).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from loco_edit_tpu_torch.masks.sam_vit import _hf_field, hf_init_
from loco_edit_tpu_torch.models.convert_util import (KeyTracker, check_state_dict,
                                                     flax_to_state_dict, to_tensor)


@dataclasses.dataclass(frozen=True)
class SamDecoderConfig:
    hidden_size: int = 256             # prompt/decoder width (= 2*num_pos_feats)
    num_pos_feats: int = 128           # random-Fourier features per coordinate
    num_hidden_layers: int = 2         # two-way transformer depth
    num_attention_heads: int = 8
    attention_downsample_rate: int = 2
    mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    layer_norm_eps: float = 1e-6
    image_embedding_size: int = 64     # spatial side of the vision embeddings
    input_image_size: int = 1024       # pixel space the point coords live in
    mask_input_channels: int = 16

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


def decoder_config_from_hf(sam_config) -> SamDecoderConfig:
    """A SamConfig (the full model config), or its dict as config.json holds
    it -> SamDecoderConfig (HF's defaults where a dict leaves a field out)."""
    pe = _hf_field(sam_config, "prompt_encoder_config") or {}
    md = _hf_field(sam_config, "mask_decoder_config") or {}
    vc = _hf_field(sam_config, "vision_config") or {}
    f = _hf_field
    return SamDecoderConfig(
        hidden_size=f(md, "hidden_size", 256),
        num_pos_feats=f(vc, "num_pos_feats", 128),
        num_hidden_layers=f(md, "num_hidden_layers", 2),
        num_attention_heads=f(md, "num_attention_heads", 8),
        attention_downsample_rate=f(md, "attention_downsample_rate", 2),
        mlp_dim=f(md, "mlp_dim", 2048),
        num_multimask_outputs=f(md, "num_multimask_outputs", 3),
        iou_head_depth=f(md, "iou_head_depth", 3),
        iou_head_hidden_dim=f(md, "iou_head_hidden_dim", 256),
        layer_norm_eps=f(md, "layer_norm_eps", 1e-6),
        image_embedding_size=f(pe, "image_embedding_size", 64),
        input_image_size=f(pe, "image_size", 1024),
        mask_input_channels=f(pe, "mask_input_channels", 16),
    )


def fourier_pos_encode(pe_matrix: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """coords in [0,1]^2, pe_matrix (2, F) -> (..., 2F) sin/cos features."""
    proj = 2.0 * np.pi * ((2.0 * coords01 - 1.0) @ pe_matrix)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def image_grid_pos_embedding(pe_matrix: torch.Tensor, size: int) -> torch.Tensor:
    """The image-wide positional grid SamModel feeds the decoder as key PE:
    pixel centers (i+0.5)/size on both axes, x before y. Returns
    (size, size, 2F)."""
    coord = (torch.arange(size, dtype=torch.float32, device=pe_matrix.device) + 0.5) / size
    x = coord[None, :].expand(size, size)
    y = coord[:, None].expand(size, size)
    return fourier_pos_encode(pe_matrix, torch.stack([x, y], dim=-1))


class DecAttention(nn.Module):
    """SAM decoder attention with internal-dim downsampling. Inputs are
    (N, T, C) with N = image_batch * point_batch already flattened."""

    def __init__(self, cfg: SamDecoderConfig, downsample_rate: int = 1):
        super().__init__()
        c = cfg.hidden_size
        inner = c // downsample_rate
        self.heads = cfg.num_attention_heads
        self.q_proj, self.k_proj, self.v_proj = (nn.Linear(c, inner) for _ in range(3))
        self.out_proj = nn.Linear(inner, c)

    def forward(self, q, k, v):
        def heads_split(x):
            n, t, inner = x.shape
            return x.reshape(n, t, self.heads, inner // self.heads).transpose(1, 2)

        q, k, v = heads_split(self.q_proj(q)), heads_split(self.k_proj(k)), heads_split(
            self.v_proj(v))
        d = q.shape[-1]
        logits = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        a = torch.matmul(w, v).transpose(1, 2)
        return self.out_proj(a.reshape(a.shape[0], a.shape[1], -1))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamDecoderConfig, skip_first_layer_pe: bool):
        super().__init__()
        c, eps, rate = cfg.hidden_size, cfg.layer_norm_eps, cfg.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecAttention(cfg, 1)
        self.cross_attn_token_to_image = DecAttention(cfg, rate)
        self.cross_attn_image_to_token = DecAttention(cfg, rate)
        self.mlp_lin1 = nn.Linear(c, cfg.mlp_dim)
        self.mlp_lin2 = nn.Linear(cfg.mlp_dim, c)
        for i in range(1, 5):
            self.add_module(f"layer_norm{i}", nn.LayerNorm(c, eps=eps))

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.layer_norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        h = self.mlp_lin2(F.relu(self.mlp_lin1(queries)))
        queries = self.layer_norm3(queries + h)
        q, k = queries + query_pe, keys + key_pe
        keys = self.layer_norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamDecoderConfig):
        super().__init__()
        self.depth = cfg.num_hidden_layers
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer_{i}", TwoWayBlock(cfg, skip_first_layer_pe=(i == 0)))
        self.final_attn_token_to_image = DecAttention(cfg, cfg.attention_downsample_rate)
        # HF: the final LayerNorm keeps nn.LayerNorm's default eps (1e-5)
        self.layer_norm_final_attn = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, point_embeddings, image_embeddings, image_pe):
        queries, keys = point_embeddings, image_embeddings
        for i in range(self.depth):
            queries, keys = getattr(self, f"layer_{i}")(
                queries, keys, point_embeddings, image_pe)
        q, k = queries + point_embeddings, keys + image_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.layer_norm_final_attn(queries), keys


class FeedForward(nn.Module):
    """SamFeedForward: ReLU MLP of `depth` linear layers."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, depth: int,
                 sigmoid_output: bool = False):
        super().__init__()
        self.depth, self.sigmoid_output = depth, sigmoid_output
        self.proj_in = nn.Linear(input_dim, hidden_dim)
        for i in range(depth - 2):
            self.add_module(f"layer_{i}", nn.Linear(hidden_dim, hidden_dim))
        self.proj_out = nn.Linear(hidden_dim, output_dim)

    def forward(self, x):
        x = F.relu(self.proj_in(x))
        for i in range(self.depth - 2):
            x = F.relu(getattr(self, f"layer_{i}")(x))
        x = self.proj_out(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


def _conv_t_2x2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(kernel=2, stride=2) on NHWC as an einsum + block
    reshape. x (N,H,W,Ci), w (Ci,Co,2,2) (torch's layout), b (Co,): each
    output 2x2 block is one input pixel times w."""
    n, h, wd, _ = x.shape
    y = torch.einsum("nhwi,ioab->nhawbo", x, w)
    return y.reshape(n, 2 * h, 2 * wd, w.shape[1]) + b


class MaskEmbedding(nn.Module):
    """Dense (mask-input) prompt embedder: 2 strided convs + 1x1, channels-
    last LayerNorms, erf-GELU. Input (N, 4E, 4E, 1) -> (N, E, E, C)."""

    def __init__(self, cfg: SamDecoderConfig):
        super().__init__()
        c4, mic = cfg.mask_input_channels // 4, cfg.mask_input_channels
        self.conv1 = nn.Conv2d(1, c4, 2, stride=2)
        self.layer_norm1 = nn.LayerNorm(c4, eps=cfg.layer_norm_eps)
        self.conv2 = nn.Conv2d(c4, mic, 2, stride=2)
        self.layer_norm2 = nn.LayerNorm(mic, eps=cfg.layer_norm_eps)
        self.conv3 = nn.Conv2d(mic, cfg.hidden_size, 1)

    def forward(self, m):
        def conv(layer, x):
            return layer(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        h = F.gelu(self.layer_norm1(conv(self.conv1, m)))
        h = F.gelu(self.layer_norm2(conv(self.conv2, h)))
        return conv(self.conv3, h)


class SamMaskDecodeModel(nn.Module):
    """Prompt encoder + mask decoder over precomputed image embeddings.

    forward(image_embeddings (B, E, E, C) NHWC,
            points (B, P, Np, 2) xy pixel coords in input_image_size space,
            labels (B, P, Np) in {-10 pad-drop, -1 not-a-point, 0 neg, 1 pos},
            boxes (B, P, 4) or None, input_masks (B, 4E, 4E, 1) or None)
    -> (masks (B, P, M, 4E, 4E) logits, iou (B, P, M)) with M = 3 when
    multimask_output else 1.
    """

    def __init__(self, cfg: SamDecoderConfig):
        super().__init__()
        self.cfg = cfg
        c, m = cfg.hidden_size, cfg.num_mask_tokens
        self.positional_embedding = nn.Parameter(torch.zeros(2, cfg.num_pos_feats))
        self.point_embed = nn.Parameter(torch.zeros(4, c))  # pos/neg point, box corners
        self.not_a_point_embed = nn.Parameter(torch.zeros(c))
        self.no_mask_embed = nn.Parameter(torch.zeros(c))
        self.iou_token = nn.Parameter(torch.zeros(1, c))
        self.mask_tokens = nn.Parameter(torch.zeros(m, c))
        self.mask_embed = MaskEmbedding(cfg)
        self.transformer = TwoWayTransformer(cfg)
        self.upscale_conv1 = nn.ConvTranspose2d(c, c // 4, 2, stride=2)
        # HF SamLayerNorm here keeps its 1e-6 default eps regardless of config
        self.upscale_layer_norm = nn.LayerNorm(c // 4, eps=1e-6)
        self.upscale_conv2 = nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2)
        for i in range(m):
            self.add_module(f"hyper_mlp_{i}", FeedForward(c, c, c // 8, 3))
        self.iou_head = FeedForward(c, cfg.iou_head_hidden_dim, m, cfg.iou_head_depth)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator, pe_scale: float,
                     std: float = 0.02) -> "SamMaskDecodeModel":
        """Seeded weights from HF SamModel's init distribution: linear, conv
        and embedding weights N(0, std), biases 0, LayerNorms (1, 0); the
        Fourier matrix pe_scale * N(0, 1) (HF: the vision width // 2)."""
        hf_init_(self, generator, std)
        for p in (self.point_embed, self.not_a_point_embed, self.no_mask_embed,
                  self.iou_token, self.mask_tokens):
            p.normal_(0.0, std, generator=generator)
        self.positional_embedding.normal_(generator=generator).mul_(pe_scale)
        return self

    def forward(self, image_embeddings, points=None, labels=None, boxes=None,
                input_masks=None, multimask_output: bool = True):
        cfg = self.cfg
        b, e, _, c = image_embeddings.shape
        pe = self.positional_embedding
        size = float(cfg.input_image_size)

        sparse = []
        if points is not None:
            pts = points.float() + 0.5  # pixel-center shift
            lbl = labels
            if boxes is None:  # HF pads with one (0,0)/-1 "not a point"
                pts = torch.cat([pts, pts.new_zeros(*pts.shape[:2], 1, 2)], dim=2)
                lbl = torch.cat([lbl, -torch.ones_like(lbl[:, :, :1])], dim=2)
            emb = fourier_pos_encode(pe, pts / size)
            lbl = lbl[..., None]
            emb = torch.where(lbl == -1, self.not_a_point_embed, emb)
            emb = torch.where(lbl == -10, torch.zeros_like(emb), emb)
            emb = torch.where(lbl == 0, emb + self.point_embed[0], emb)
            emb = torch.where(lbl == 1, emb + self.point_embed[1], emb)
            sparse.append(emb)
        if boxes is not None:
            corners = (boxes.float().reshape(*boxes.shape[:2], 2, 2) + 0.5) / size
            sparse.append(fourier_pos_encode(pe, corners) + self.point_embed[2:4])
        p = sparse[0].shape[1] if sparse else 1
        sparse_emb = (torch.cat(sparse, dim=2) if sparse
                      else image_embeddings.new_zeros(b, 1, 0, c))

        if input_masks is not None:
            dense = self.mask_embed(input_masks.float())
        else:
            dense = self.no_mask_embed.expand(b, e, e, c)

        out_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([out_tokens.expand(b, p, *out_tokens.shape), sparse_emb], dim=2)
        n = b * p
        tokens = tokens.reshape(n, tokens.shape[2], c)
        img = (image_embeddings + dense).reshape(b, 1, e * e, c)
        img = img.expand(b, p, e * e, c).reshape(n, e * e, c)
        img_pe = image_grid_pos_embedding(pe, e).reshape(1, e * e, c).expand(n, e * e, c)

        queries, keys = self.transformer(tokens, img, img_pe)
        iou_out = queries[:, 0]
        mask_out = queries[:, 1:1 + cfg.num_mask_tokens]

        feat = keys.reshape(n, e, e, c)
        feat = _conv_t_2x2(feat, self.upscale_conv1.weight, self.upscale_conv1.bias)
        feat = F.gelu(self.upscale_layer_norm(feat))
        feat = F.gelu(_conv_t_2x2(feat, self.upscale_conv2.weight, self.upscale_conv2.bias))
        hyper = torch.stack([getattr(self, f"hyper_mlp_{i}")(mask_out[:, i])
                             for i in range(cfg.num_mask_tokens)], dim=1)
        masks = torch.einsum("nmc,nhwc->nmhw", hyper, feat)
        iou = self.iou_head(iou_out)

        sl = slice(1, None) if multimask_output else slice(0, 1)
        masks = masks[:, sl].reshape(b, p, -1, 4 * e, 4 * e)
        iou = iou[:, sl].reshape(b, p, -1)
        return masks, iou


# --------------------------------------------------------------- conversion


def convert_sam_decoder_state_dict(sd: Mapping, cfg: SamDecoderConfig) -> dict[str, torch.Tensor]:
    """HF SamModel state_dict -> SamMaskDecodeModel state_dict (f32 CPU
    tensors). Consumes the `shared_image_embedding.` / `prompt_encoder.` /
    `mask_decoder.` keys (vision_encoder.* is converted by sam_vit) with
    full coverage, and the result must match the module tree of `cfg`."""
    sd = {k: v for k, v in sd.items() if not k.startswith("vision_encoder.")}
    # the prompt encoder's shared_embedding ties to shared_image_embedding;
    # checkpoints may carry either or both
    pe_keys = [k for k in ("shared_image_embedding.positional_embedding",
                           "prompt_encoder.shared_embedding.positional_embedding")
               if k in sd]
    if not pe_keys:
        raise ValueError("no SAM positional_embedding key in state_dict")
    tr = KeyTracker(sd)
    out: dict[str, torch.Tensor] = {"positional_embedding": to_tensor(tr[pe_keys[0]])}
    for k in pe_keys[1:]:
        tr[k]  # consume the tied duplicate

    def copy(src: str, dst: str):
        out[f"{dst}.weight"] = to_tensor(tr[f"{src}.weight"])
        out[f"{dst}.bias"] = to_tensor(tr[f"{src}.bias"])

    def ffn(src: str, dst: str, depth: int):
        copy(f"{src}.proj_in", f"{dst}.proj_in")
        copy(f"{src}.proj_out", f"{dst}.proj_out")
        for i in range(depth - 2):
            copy(f"{src}.layers.{i}", f"{dst}.layer_{i}")

    pe_, md = "prompt_encoder", "mask_decoder"
    out["point_embed"] = torch.cat([to_tensor(tr[f"{pe_}.point_embed.{i}.weight"])
                                    for i in range(4)])
    out["not_a_point_embed"] = to_tensor(tr[f"{pe_}.not_a_point_embed.weight"]).reshape(-1)
    out["no_mask_embed"] = to_tensor(tr[f"{pe_}.no_mask_embed.weight"]).reshape(-1)
    out["iou_token"] = to_tensor(tr[f"{md}.iou_token.weight"])
    out["mask_tokens"] = to_tensor(tr[f"{md}.mask_tokens.weight"])
    for name in ("upscale_conv1", "upscale_conv2", "upscale_layer_norm"):
        copy(f"{md}.{name}", name)
    for name in ("conv1", "conv2", "conv3", "layer_norm1", "layer_norm2"):
        copy(f"{pe_}.mask_embed.{name}", f"mask_embed.{name}")
    ffn(f"{md}.iou_prediction_head", "iou_head", cfg.iou_head_depth)
    for i in range(cfg.num_mask_tokens):
        ffn(f"{md}.output_hypernetworks_mlps.{i}", f"hyper_mlp_{i}", 3)

    def attn(src: str, dst: str):
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            copy(f"{src}.{p}", f"{dst}.{p}")

    t = f"{md}.transformer"
    attn(f"{t}.final_attn_token_to_image", "transformer.final_attn_token_to_image")
    copy(f"{t}.layer_norm_final_attn", "transformer.layer_norm_final_attn")
    for i in range(cfg.num_hidden_layers):
        s, d = f"{t}.layers.{i}", f"transformer.layer_{i}"
        for name in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            attn(f"{s}.{name}", f"{d}.{name}")
        copy(f"{s}.mlp.lin1", f"{d}.mlp_lin1")
        copy(f"{s}.mlp.lin2", f"{d}.mlp_lin2")
        for j in range(1, 5):
            copy(f"{s}.layer_norm{j}", f"{d}.layer_norm{j}")
    tr.check("SAM prompt-encoder/mask-decoder")
    with torch.device("meta"):
        check_state_dict(out, SamMaskDecodeModel(cfg), "SAM decoder weights")
    return out


_RAW_LEAVES = ("positional_embedding", "point_embed", "not_a_point_embed",
               "no_mask_embed", "iou_token", "mask_tokens")


def sam_decoder_params_from_flax(flat: Mapping[str, np.ndarray],
                                 cfg: SamDecoderConfig) -> dict[str, torch.Tensor]:
    """Carry a flat Flax SamMaskDecodeModel parameter dict (with the
    mask_embed subtree, as convert_sam_decoder_state_dict makes it) to a
    SamMaskDecodeModel state_dict: the transposed-conv kernels (Ci, 2, 2,
    Co) become (Ci, Co, 2, 2), raw embeddings keep their layout, the rest
    as flax_to_state_dict carries it."""
    sd: dict[str, torch.Tensor] = {}
    rest = {}
    for key, arr in flat.items():
        parts = key.split("/")
        parts = parts[1:] if parts[0] == "params" else parts
        leaf = parts[-1]
        if leaf in _RAW_LEAVES:
            sd[".".join(parts)] = to_tensor(arr)
        elif leaf.startswith("upscale_conv"):
            name, kind = leaf.rsplit("_", 1)
            a = to_tensor(arr)
            sd[f"{name}.{'weight' if kind == 'kernel' else 'bias'}"] = (
                a.permute(0, 3, 1, 2).contiguous() if kind == "kernel" else a)
        else:
            rest[key] = arr
    sd.update(flax_to_state_dict(rest))
    with torch.device("meta"):
        check_state_dict(sd, SamMaskDecodeModel(cfg), "Flax SAM decoder params")
    return sd

