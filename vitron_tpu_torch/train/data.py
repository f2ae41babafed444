"""Training data pipeline: conversation preprocessing and batching.

The port's own copy of `vitron_tpu/train/data.py` (host code, numpy only),
on the port's `constants`, `mm.conversation` and `mm.tokenization`; it
rebuilds the reference L1 data layer (reference: vitron/train/train.py:
351-930 and llava_trainer.py:72-165):

- preprocess_multimodal: <video> -> num_frames x <image> expansion, media
  token clamping to MAX_IMAGE_LENGTH (train.py:351-395);
- preprocess_v1: vicuna-v1 prompt assembly with IGNORE_INDEX masking of
  everything except assistant replies (train.py:480-560), sentinel-token
  aware length accounting;
- SupervisedDataset: lazy JSON + media loading with error-resample
  (train.py:746-930);
- modality-grouped batching: multimodal and text-only samples batched
  separately, length-sorted megabatches (llava_trainer.py:94-130).
"""
from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vitron_tpu_torch.constants import (
    DEFAULT_IMAGE_TOKEN,
    DEFAULT_OBJS_TOKEN,
    DEFAULT_VIDEO_TOKEN,
    IGNORE_INDEX,
    MAX_IMAGE_LENGTH,
    NUM_VIDEO_FRAMES,
)
from vitron_tpu_torch.mm.conversation import SeparatorStyle, conv_templates
from vitron_tpu_torch.mm.tokenization import (
    tokenizer_image_region_token,
    tokenizer_image_token,
)


def preprocess_multimodal(sources: List[List[Dict[str, str]]],
                          num_frames: int = NUM_VIDEO_FRAMES) -> List[List[Dict[str, str]]]:
    """<video> -> num_frames x <image>; clamp image tokens (train.py:351-395)."""
    sources = copy.deepcopy(sources)
    for source in sources:
        for sentence in source:
            v = sentence["value"]
            if v.startswith(DEFAULT_IMAGE_TOKEN) or v.startswith(DEFAULT_VIDEO_TOKEN):
                n_img = v.count(DEFAULT_IMAGE_TOKEN)
                if n_img > MAX_IMAGE_LENGTH:
                    v = v.replace(DEFAULT_IMAGE_TOKEN * n_img,
                                  DEFAULT_IMAGE_TOKEN * MAX_IMAGE_LENGTH).strip()
            v = v.replace(DEFAULT_VIDEO_TOKEN, DEFAULT_IMAGE_TOKEN * num_frames)
            sentence["value"] = v
    return sources


def preprocess_v1(
    sources: List[List[Dict[str, str]]],
    tokenizer,
    has_image: bool = False,
    has_region: bool = False,
    conv_template: str = "llava_v1",
    model_max_length: int = 2048,
) -> Dict[str, List[List[int]]]:
    """Vicuna-v1 supervised preprocessing with assistant-only labels
    (train.py:480-560). Returns ragged input_ids/labels lists."""
    conv = conv_templates[conv_template].copy()
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}

    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2]
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())

    def tok(text):
        if has_image and has_region:
            return tokenizer_image_region_token(text, tokenizer)
        if has_image:
            return tokenizer_image_token(text, tokenizer)
        return list(tokenizer(text).input_ids)

    assert conv.sep_style == SeparatorStyle.TWO
    sep = conv.sep + conv.roles[1] + ": "
    all_ids, all_labels = [], []
    for conversation in conversations:
        input_ids = tok(conversation)[:model_max_length]
        labels = list(input_ids)
        cur = 1
        labels[:cur] = [IGNORE_INDEX] * cur
        rounds = conversation.split(conv.sep2)
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tok(rou))
            instruction_len = len(tok(parts[0])) - 2
            labels[cur : cur + instruction_len] = [IGNORE_INDEX] * min(
                instruction_len, max(len(labels) - cur, 0))
            cur += round_len
        labels[cur:] = [IGNORE_INDEX] * max(len(labels) - cur, 0)
        all_ids.append(input_ids)
        all_labels.append(labels)
    return {"input_ids": all_ids, "labels": all_labels}


@dataclasses.dataclass
class SupervisedSample:
    input_ids: List[int]
    labels: List[int]
    media_kinds: List[str]          # 'image'/'video' per media item
    media_paths: List[str]
    region_boxes: Optional[np.ndarray] = None
    length: int = 0
    is_multimodal: bool = False


class SupervisedDataset:
    """Lazy JSON dataset (train.py:746-930): items hold 'conversations' and
    optional 'image'/'video'/'bbox' fields; media decoded on access; any
    per-item failure resamples a random index (train.py:927-930)."""

    def __init__(self, data_path: str, tokenizer, image_dir: str = "",
                 video_dir: str = "", conv_template: str = "llava_v1",
                 num_frames: int = NUM_VIDEO_FRAMES,
                 model_max_length: int = 2048, seed: int = 0):
        self.items = json.loads(pathlib.Path(data_path).read_text())
        self.tokenizer = tokenizer
        self.image_dir = image_dir
        self.video_dir = video_dir
        self.conv_template = conv_template
        self.num_frames = num_frames
        self.model_max_length = model_max_length
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.items)

    def lengths(self) -> List[int]:
        """Approximate token lengths for the grouped sampler
        (llava_trainer.py:60-70 uses word counts + media bonus)."""
        out = []
        for it in self.items:
            n = sum(len(s["value"].split()) for s in it["conversations"])
            if "image" in it or "video" in it:
                n += 128
            out.append(n)
        return out

    def modality_flags(self) -> List[bool]:
        return [("image" in it or "video" in it) for it in self.items]

    def __getitem__(self, idx: int) -> SupervisedSample:
        for _ in range(8):
            try:
                return self._get(idx)
            except Exception:
                idx = self.rng.randrange(len(self.items))
        raise RuntimeError("too many consecutive bad samples")

    def _get(self, idx: int) -> SupervisedSample:
        item = self.items[idx]
        media_kinds: List[str] = []
        media_paths: List[str] = []
        if "image" in item:
            imgs = item["image"] if isinstance(item["image"], list) else [item["image"]]
            for p in imgs:
                media_kinds.append("image")
                media_paths.append(str(pathlib.Path(self.image_dir) / p))
        if "video" in item:
            vids = item["video"] if isinstance(item["video"], list) else [item["video"]]
            for p in vids:
                media_kinds.append("video")
                media_paths.append(str(pathlib.Path(self.video_dir) / p))
        has_image = bool(media_kinds)
        has_region = "bbox" in item
        sources = [item["conversations"]]
        if has_image:
            sources = preprocess_multimodal(sources, self.num_frames)
        proc = preprocess_v1(sources, self.tokenizer, has_image=has_image,
                             has_region=has_region,
                             conv_template=self.conv_template,
                             model_max_length=self.model_max_length)
        boxes = None
        if has_region:
            boxes = np.asarray(item["bbox"], np.float32).reshape(-1, 4)
        return SupervisedSample(
            input_ids=proc["input_ids"][0], labels=proc["labels"][0],
            media_kinds=media_kinds, media_paths=media_paths,
            region_boxes=boxes, length=len(proc["input_ids"][0]),
            is_multimodal=has_image)


def modality_grouped_indices(lengths: Sequence[int], multimodal: Sequence[bool],
                             batch_size: int, generator: random.Random) -> List[int]:
    """Group multimodal vs text-only, length-sort within shuffled megabatches
    (llava_trainer.py:94-130). Returns a flat index order."""
    mm = [i for i, m in enumerate(multimodal) if m]
    lang = [i for i, m in enumerate(multimodal) if not m]
    if not mm or not lang:
        idx = list(range(len(lengths)))
        generator.shuffle(idx)
        return idx

    def megabatches(indices):
        generator.shuffle(indices)
        mega = batch_size * 50
        out = []
        for i in range(0, len(indices), mega):
            chunk = sorted(indices[i : i + mega], key=lambda j: -lengths[j])
            out.extend(chunk)
        return out

    mm_sorted = megabatches(mm)
    lang_sorted = megabatches(lang)
    # interleave whole batches so a batch never mixes modalities
    batches = []
    for src in (mm_sorted, lang_sorted):
        for i in range(0, len(src), batch_size):
            b = src[i : i + batch_size]
            if len(b) == batch_size:
                batches.append(b)
    generator.shuffle(batches)
    return [i for b in batches for i in b]
