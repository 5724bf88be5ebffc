"""Text encoders for the SD engine (port of loco_edit_tpu/models/sd/text.py).

A prompt encoder maps a prompt to (1, seq, dim) hidden states on a device.
`clip_prompt_encoder` is transformers' CLIP tokenizer + text model (torch)
from a local directory, imported where it is built, as the JAX package
imports Flax's; `fake_prompt_encoder` is a deterministic hash-seeded table
for tests and runs without text-encoder files, bit-equal to the JAX
package's (the same numpy draws). `t5_prompt_encoder` is transformers'
T5 encoder (DeepFloyd-IF's conditioning, 4096 wide for T5-XXL), built the
same way.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np
import torch

# prompt -> (1, seq, dim) hidden states
PromptEncoder = Callable[[str], torch.Tensor]


def clip_prompt_encoder(model_path: str, max_length: int = 77,
                        device: str | torch.device = "cuda") -> PromptEncoder:
    """CLIPTokenizer + CLIPTextModel from a local directory (transformers'
    torch classes), run on `device`."""
    try:
        from transformers import CLIPTextModel, CLIPTokenizer
    except ImportError as e:
        raise ImportError("--text_encoder_path: the CLIP text encoder needs the "
                          "transformers package, which is not installed") from e

    tok = CLIPTokenizer.from_pretrained(model_path)
    enc = CLIPTextModel.from_pretrained(model_path).to(device).eval()

    @torch.no_grad()
    def encode(prompt: str) -> torch.Tensor:
        ids = tok(prompt, padding="max_length", max_length=max_length,
                  truncation=True, return_tensors="pt")
        out = enc(input_ids=ids["input_ids"].to(device))
        return out.last_hidden_state.float()

    return encode


def t5_prompt_encoder(model_path: str, max_length: int = 77,
                      device: str | torch.device = "cuda") -> PromptEncoder:
    """AutoTokenizer + T5EncoderModel from a local directory (transformers'
    torch classes), run on `device`; the attention mask of the padded
    prompt is passed, as the JAX package's Flax encoder gets it."""
    try:
        from transformers import AutoTokenizer, T5EncoderModel
    except ImportError as e:
        raise ImportError("--text_encoder_path: the T5 text encoder needs the "
                          "transformers package, which is not installed") from e

    tok = AutoTokenizer.from_pretrained(model_path)
    enc = T5EncoderModel.from_pretrained(model_path).to(device).eval()

    @torch.no_grad()
    def encode(prompt: str) -> torch.Tensor:
        ids = tok(prompt, padding="max_length", max_length=max_length,
                  truncation=True, return_tensors="pt")
        out = enc(input_ids=ids["input_ids"].to(device),
                  attention_mask=ids["attention_mask"].to(device))
        return out.last_hidden_state.float()

    return encode


def fake_prompt_encoder(dim: int, seq: int = 77,
                        device: str | torch.device = "cuda") -> PromptEncoder:
    """Deterministic prompt-dependent embeddings: distinct prompts map to
    distinct fixed Gaussian tables (seeded from a blake2b of the prompt)."""

    def encode(prompt: str) -> torch.Tensor:
        seed = int.from_bytes(
            hashlib.blake2b(prompt.encode(), digest_size=4).digest(), "big")
        rng = np.random.default_rng(seed)
        a = rng.normal(size=(1, seq, dim)).astype(np.float32) * 0.2
        return torch.from_numpy(a).to(device)

    return encode
