"""Sentinel-token interleaving for multimodal prompts.

Splits prompts on `<image>` / `<objs>` markers and interleaves negative
sentinel ids into the token stream (reference: vitron/mm_utils.py:80-135).
The splice stage (vitron_tpu_torch/mm/splice.py) later replaces each sentinel with
a block of media features.

Host-side only: works on Python lists / numpy, never device arrays. The
port's own copy of `vitron_tpu/mm/tokenization.py`.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX, OBJS_TOKEN_INDEX


def tokenizer_image_token(
    prompt: str,
    tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    is_first: bool = True,
) -> List[int]:
    """Tokenize, inserting `image_token_index` at each `<image>` marker.

    Matches reference vitron/mm_utils.py:80-99, including BOS handling: when
    the first chunk starts with BOS (and `is_first`), the BOS is kept once and
    each separator carries `offset + 1` copies of the sentinel with the chunk
    offset skipping the re-tokenized BOS.
    """
    prompt_chunks = [tokenizer(chunk).input_ids for chunk in prompt.split("<image>")]

    def insert_separator(x, sep):
        return [ele for sublist in zip(x, [sep] * len(x)) for ele in sublist][:-1]

    input_ids: List[int] = []
    offset = 0
    if (
        len(prompt_chunks) > 0
        and len(prompt_chunks[0]) > 0
        and prompt_chunks[0][0] == tokenizer.bos_token_id
        and is_first
    ):
        offset = 1
        input_ids.append(prompt_chunks[0][0])

    for x in insert_separator(prompt_chunks, [image_token_index] * (offset + 1)):
        input_ids.extend(x[offset:])
    return input_ids


def tokenizer_image_region_token(
    prompt: str,
    tokenizer,
    region_token_index: int = OBJS_TOKEN_INDEX,
) -> List[int]:
    """Split on `<objs>` first, then `<image>` within each chunk.

    Matches reference vitron/mm_utils.py:102-117.
    """
    input_ids: List[int] = []
    chunks = prompt.split("<objs>")
    for idx, ck in enumerate(chunks):
        input_ids.extend(tokenizer_image_token(ck, tokenizer, is_first=(idx == 0)))
        if idx < len(chunks) - 1:
            input_ids.append(region_token_index)
    return input_ids


def preprocess_region(
    region: Sequence[float],
    image_size: Sequence[float],
    target_size: Sequence[float],
) -> List[float]:
    """Rescale an (x1, y1, x2, y2) bbox from `image_size` to `target_size`.

    Reference: vitron/mm_utils.py:121-135. The reference returns long ints
    when tensorized; we keep floats and let callers truncate — the region
    extractor's mask rasterization int-truncates anyway (layer.py:83).
    """
    x1, y1, x2, y2 = region
    scale_x = target_size[0] / image_size[0]
    scale_y = target_size[1] / image_size[1]
    return [x1 * scale_x, y1 * scale_y, x2 * scale_x, y2 * scale_y]


def expand2square_array(img: np.ndarray, background_color: Sequence[float]) -> np.ndarray:
    """Pad an HWC uint8/float image to a centered square.

    Array equivalent of the reference PIL version (vitron/mm_utils.py:51-62).
    """
    h, w, c = img.shape
    if w == h:
        return img
    side = max(w, h)
    out = np.empty((side, side, c), dtype=img.dtype)
    out[...] = np.asarray(background_color, dtype=img.dtype)
    if w > h:
        top = (w - h) // 2
        out[top : top + h, :, :] = img
    else:
        left = (h - w) // 2
        out[:, left : left + w, :] = img
    return out


class KeywordStopper:
    """Stop-string detection over generated ids.

    Functional rebuild of KeywordsStoppingCriteria
    (reference: vitron/mm_utils.py:146-177): first match the tokenized
    keyword suffix exactly, otherwise decode the last `max_keyword_len`
    tokens and substring-match.
    """

    def __init__(self, keywords: Sequence[str], tokenizer, prompt_len: int):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.prompt_len = prompt_len
        self.keyword_ids: List[List[int]] = []
        self.max_keyword_len = 0
        for keyword in self.keywords:
            ids = tokenizer(keyword).input_ids
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.max_keyword_len = max(self.max_keyword_len, len(ids))
            self.keyword_ids.append(list(ids))

    def should_stop(self, output_ids: Sequence[int]) -> bool:
        """`output_ids` is the full sequence including the prompt."""
        output_ids = list(output_ids)
        offset = min(len(output_ids) - self.prompt_len, self.max_keyword_len)
        if offset <= 0:
            return False
        for kw_ids in self.keyword_ids:
            if len(output_ids) >= len(kw_ids) and output_ids[-len(kw_ids):] == kw_ids:
                return True
        tail = self.tokenizer.decode(output_ids[-offset:], skip_special_tokens=True)
        return any(kw in tail for kw in self.keywords)
