"""Training losses.

Port of `vitron_tpu/train/losses.py`: causal-LM cross entropy with
IGNORE_INDEX label masking. The reference masks every non-assistant token
to -100 during conversation preprocessing (reference:
vitron/train/train.py:480-560) and relies on HF's shifted cross entropy.
"""
from __future__ import annotations

import torch

from vitron_tpu_torch.constants import IGNORE_INDEX


def causal_lm_sums(logits: torch.Tensor, labels: torch.Tensor):
    """Shifted cross entropy, summed. logits [B, L, V]; labels [B, L]
    integer with IGNORE_INDEX at masked positions -> (the summed token loss
    float32, the count of valid target tokens int64)."""
    targets = labels[:, 1:]
    valid = targets != IGNORE_INDEX
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    token_logp = torch.gather(logp, -1, torch.where(valid, targets, 0)[..., None].long())[..., 0]
    return torch.where(valid, -token_logp, 0.0).sum(), valid.sum()


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Shifted cross entropy -> scalar mean over the valid target tokens (0
    when there are none)."""
    total, count = causal_lm_sums(logits, labels)
    return total / torch.clamp(count, min=1)
