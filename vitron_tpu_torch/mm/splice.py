"""Static-shape multimodal token splice.

Port of `vitron_tpu/mm/splice.py`, in two halves:

1. a **host planner** (`plan_splice`, pure numpy, the port's own copy):
   walks the sentinel token stream once and emits fixed-shape index maps,
   which output position reads which text token or which media feature
   row; and
2. a **device apply** (`apply_splice`): two gathers and a select.

Semantics replicated from the reference (vitron/model/llava_arch.py:189-573):
- videos flatten to `num_frames` image-sized blocks (llava_arch.py:253-268)
- a row with no sentinels still consumes one media block (llava_arch.py:317-324)
- `<objs>` splices the region features of the *most recent* image block
  (`region_features[cur_image_idx-1]`, llava_arch.py:350-353)
- post-splice truncation to `max_len` (llava_arch.py:363-366)
- right/left padding with labels=IGNORE_INDEX and position_ids restarting at
  0 for each row (llava_arch.py:369-396)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from vitron_tpu_torch.constants import (
    IGNORE_INDEX,
    IMAGE_FEATURE_LENGTH,
    IMAGE_TOKEN_INDEX,
    NUM_VIDEO_FRAMES,
    OBJS_TOKEN_INDEX,
    REGION_FEATURE_LENGTH,
)


@dataclasses.dataclass
class SplicePlan:
    """Fixed-shape gather/select maps for one batch.

    All arrays are [B, pad_len]. `media_idx` indexes into the flat media-row
    space: rows `[0, n_image_blocks*image_len)` are image/video-frame feature
    rows in block order, rows after that are region feature rows (block j at
    offset `n_image_blocks*image_len + j*region_len`).
    """

    token_ids: np.ndarray       # int32, cleaned ids at output positions (0 at media/pad)
    media_idx: np.ndarray       # int32, flat media row index (0 where unused)
    use_media: np.ndarray       # bool
    attention_mask: np.ndarray  # bool
    position_ids: np.ndarray    # int32
    labels: np.ndarray          # int32
    seq_lens: np.ndarray        # int32 [B], true (unpadded) lengths
    n_image_blocks: int
    image_len: int
    region_len: int
    region_blocks: np.ndarray = None  # int32 [num_regions], flat block id
                                      # each <objs> pools from, in batch order


def _flatten_media_blocks(media_kinds: Sequence[str], num_video_frames: int) -> int:
    """Number of flat image-sized blocks after video expansion."""
    n = 0
    for kind in media_kinds:
        n += num_video_frames if kind == "video" else 1
    return n


def plan_splice(
    input_ids: Sequence[Sequence[int]],
    media_kinds: Sequence[str],
    pad_len: int,
    labels: Optional[Sequence[Sequence[int]]] = None,
    image_len: int = IMAGE_FEATURE_LENGTH,
    region_len: int = REGION_FEATURE_LENGTH,
    num_video_frames: int = NUM_VIDEO_FRAMES,
    max_len: Optional[int] = None,
    padding_side: str = "right",
) -> SplicePlan:
    """Plan the splice for a batch of ragged sentinel token streams.

    Args:
      input_ids: per-row token id lists containing IMAGE/OBJS sentinels.
      media_kinds: batch-flat list of 'image'/'video', in the order media
        blocks are consumed across rows (reference `images` list order).
      pad_len: static output length (compile-time bucket).
      labels: optional per-row label lists (same lengths as input_ids).
      max_len: optional post-splice truncation (tokenizer_model_max_length).
    """
    batch = len(input_ids)
    if max_len is None:
        max_len = pad_len
    eff_len = min(max_len, pad_len)

    n_image_blocks = _flatten_media_blocks(media_kinds, num_video_frames)
    region_row_base = n_image_blocks * image_len

    token_ids = np.zeros((batch, pad_len), dtype=np.int32)
    media_idx = np.zeros((batch, pad_len), dtype=np.int32)
    use_media = np.zeros((batch, pad_len), dtype=bool)
    attention_mask = np.zeros((batch, pad_len), dtype=bool)
    position_ids = np.zeros((batch, pad_len), dtype=np.int32)
    out_labels = np.full((batch, pad_len), IGNORE_INDEX, dtype=np.int32)
    seq_lens = np.zeros((batch,), dtype=np.int32)

    # Per-media-kind flat block spans: block index -> first flat block id.
    # Videos occupy num_video_frames consecutive blocks.
    media_block_starts: List[int] = []
    media_block_counts: List[int] = []
    acc = 0
    for kind in media_kinds:
        media_block_starts.append(acc)
        cnt = num_video_frames if kind == "video" else 1
        media_block_counts.append(cnt)
        acc += cnt

    cur_media = 0  # reference cur_image_idx, but over the *un-flattened* list
    frame_cursor: dict = {}  # media item -> next frame block for videos
    region_blocks: List[int] = []
    for b in range(batch):
        row = list(input_ids[b])
        row_labels = list(labels[b]) if labels is not None else [IGNORE_INDEX] * len(row)
        # Ragged triplet stream for this row: (token_id, label, media_block or None)
        toks: List[int] = []
        labs: List[int] = []
        med: List[int] = []  # flat media row index, or -1 for text

        num_sentinels = sum(1 for t in row if t in (IMAGE_TOKEN_INDEX, OBJS_TOKEN_INDEX))
        num_images = sum(1 for t in row if t == IMAGE_TOKEN_INDEX)
        if num_images == 0 and num_sentinels == 0:
            # No media sentinels: pure text row still consumes one media slot
            # (reference llava_arch.py:317-324).
            for t, l in zip(row, row_labels):
                toks.append(t); labs.append(l); med.append(-1)
            if cur_media < len(media_kinds):
                cur_media += 1
        else:
            last_img_block = -1  # flat block id of most recent image
            for t, l in zip(row, row_labels):
                if t == IMAGE_TOKEN_INDEX:
                    if cur_media >= len(media_kinds):
                        raise ValueError("more <image> sentinels than media items")
                    start = media_block_starts[cur_media]
                    count = media_block_counts[cur_media]
                    # video sentinel was pre-expanded to 8x <image> upstream;
                    # here one sentinel maps to one block of the current media
                    if media_kinds[cur_media] == "video":
                        # one <image> sentinel consumes one frame block; the
                        # caller is expected to emit num_video_frames sentinels
                        # per video (<video> -> 8x<image>, train.py:380)
                        frame = frame_cursor.get(cur_media, 0)
                        block = start + frame
                        frame_cursor[cur_media] = frame + 1
                        if frame + 1 >= count:
                            frame_cursor.pop(cur_media, None)
                            cur_media += 1
                    else:
                        block = start
                        cur_media += 1
                    last_img_block = block
                    for r in range(image_len):
                        toks.append(0)
                        labs.append(IGNORE_INDEX)
                        med.append(block * image_len + r)
                elif t == OBJS_TOKEN_INDEX:
                    # Region features of the most recent image block
                    # (llava_arch.py:350-353: region_features[cur_image_idx-1])
                    block = last_img_block if last_img_block >= 0 else max(cur_media - 1, 0)
                    region_blocks.append(block)
                    for r in range(region_len):
                        toks.append(0)
                        labs.append(IGNORE_INDEX)
                        med.append(region_row_base + block * region_len + r)
                else:
                    toks.append(t); labs.append(l); med.append(-1)

        # Truncate post-splice (llava_arch.py:363-366), then pad.
        toks = toks[:eff_len]
        labs = labs[:eff_len]
        med = med[:eff_len]
        cur_len = len(toks)
        seq_lens[b] = cur_len
        if padding_side == "left":
            sl = slice(pad_len - cur_len, pad_len)
        else:
            sl = slice(0, cur_len)
        token_ids[b, sl] = toks
        out_labels[b, sl] = labs
        med_arr = np.asarray(med, dtype=np.int32)
        is_media = med_arr >= 0
        media_idx[b, sl] = np.where(is_media, med_arr, 0)
        use_media[b, sl] = is_media
        attention_mask[b, sl] = True
        position_ids[b, sl] = np.arange(cur_len, dtype=np.int32)

    return SplicePlan(
        token_ids=token_ids,
        media_idx=media_idx,
        use_media=use_media,
        attention_mask=attention_mask,
        position_ids=position_ids,
        labels=out_labels,
        seq_lens=seq_lens,
        n_image_blocks=n_image_blocks,
        image_len=image_len,
        region_len=region_len,
        region_blocks=np.asarray(region_blocks, dtype=np.int32),
    )


def apply_splice(embedding_table: torch.Tensor, plan_token_ids: torch.Tensor,
                 plan_media_idx: torch.Tensor, plan_use_media: torch.Tensor,
                 image_feats: torch.Tensor,
                 region_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, L] plan maps + [n_blocks, image_len, H] media features (+ optional
    [n_blocks, region_len, H] region rows) -> [B, L, H] input embeddings."""
    h = embedding_table.shape[-1]
    text_emb = embedding_table[plan_token_ids]
    flat = image_feats.reshape(-1, h)
    if region_feats is not None:
        flat = torch.cat([flat, region_feats.reshape(-1, h)], dim=0)
    media_emb = flat[plan_media_idx]
    return torch.where(plan_use_media[..., None], media_emb.to(text_emb.dtype), text_emb)
