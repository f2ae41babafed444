"""Synthetic weights and tokenizer for the diffusion tests and smoke runs.

No checkpoint or CLIP vocabulary is in the repo (the loaders are ROADMAP
A7), so tests and `chip_smoke.py` run on random weights and stub tokens.

`init_params` of the UNet (like the JAX one) zero-initialises each ResNet's
conv2, proj_out, the final out conv, the GLIGEN gates alpha_attn/alpha_dense
and all biases, as training from scratch wants. With those zeros the UNet's
output is identically zero and tanh(0) switches the fuser off, so a parity
check on such a net would pass while testing nothing. `fill_zero_leaves`
gives every all-zero leaf seeded values at init scale instead.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Dict, List

import numpy as np

import torch


def fill_zero_leaves(tree: Any, gen: torch.Generator) -> Any:
    """Same structure; each all-zero floating leaf replaced by: U(0.5, 1) for
    a scalar gate (tanh 0.46-0.76), N(0, 0.1^2) for a vector (biases, null
    embeddings), N(0, 1/fan_in) with fan_in = prod(shape[:-1]) for a weight.
    Values are drawn in float32 on `gen`'s device and cast to the leaf's."""
    if isinstance(tree, dict):
        return {k: fill_zero_leaves(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fill_zero_leaves(v, gen) for v in tree)
    if not (tree.is_floating_point() and tree.numel() and not bool(tree.any())):
        return tree
    shape = tuple(tree.shape)
    if tree.dim() == 0:
        w = 0.5 + 0.5 * torch.rand(shape, generator=gen, device=gen.device)
    else:
        w = torch.randn(shape, generator=gen, device=gen.device)
        w = w * (0.1 if tree.dim() == 1 else 1.0 / math.sqrt(math.prod(shape[:-1])))
    return w.to(device=tree.device, dtype=tree.dtype)


class StubClipTokenizer:
    """Deterministic stand-in for the CLIP BPE tokenizer, called as the
    pipeline calls HF's: BOS, one id per whitespace word (crc32 of the word,
    so the same text gives the same ids in every process), EOS, then EOS
    padding to max_length. BOS and EOS are the top two ids of the vocabulary,
    so argmax finds the first EOS, as with CLIP's own ids."""

    def __init__(self, vocab_size: int):
        self.bos, self.eos = vocab_size - 2, vocab_size - 1
        self.n_words = vocab_size - 3

    def __call__(self, texts: List[str], padding="max_length", max_length: int = 77,
                 truncation: bool = True, return_tensors: str = "np") -> Dict[str, np.ndarray]:
        out = np.full((len(texts), max_length), self.eos, np.int64)
        for i, text in enumerate(texts):
            words = [1 + zlib.crc32(w.encode()) % self.n_words for w in text.split()]
            ids = [self.bos] + words[: max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return {"input_ids": out}
