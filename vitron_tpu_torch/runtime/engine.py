"""Request engine: host-side batch preparation + the chat pipeline.

Port of `vitron_tpu/runtime/engine.py`: conversation prompt -> sentinel
tokenization -> splice plan -> generate -> structured-output parse. The
prompt, tokenization, planning and parsing helpers are the port's own
copies of the JAX package's numpy host modules.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vitron_tpu_torch.constants import (
    IMAGE_FEATURE_LENGTH,
    IMAGE_TOKEN_INDEX,
    NUM_VIDEO_FRAMES,
    OBJS_TOKEN_INDEX,
    REGION_FEATURE_LENGTH,
)
from vitron_tpu_torch.mm.conversation import conv_templates
from vitron_tpu_torch.mm.protocol import parse_model_output
from vitron_tpu_torch.mm.splice import SplicePlan, plan_splice
from vitron_tpu_torch.mm.tokenization import KeywordStopper, tokenizer_image_region_token
from vitron_tpu_torch.runtime.generation import Generator, SamplingConfig, has_packed_int4

PAD_BUCKET = 128  # prefill length is rounded up to a multiple of this


@dataclasses.dataclass
class MediaItem:
    kind: str              # "image" | "video"
    pixels: torch.Tensor   # image: [S, S, 3]; video: [T, S, S, 3] (HWC float)


def compute_block_perm(media_kinds: Sequence[str], num_frames: int) -> np.ndarray:
    """Planner flat-block order -> row in [all images | all video frames]."""
    n_img = sum(1 for k in media_kinds if k == "image")
    perm: List[int] = []
    img_i = vid_i = 0
    for kind in media_kinds:
        if kind == "image":
            perm.append(img_i)
            img_i += 1
        else:
            perm.extend(n_img + vid_i * num_frames + f for f in range(num_frames))
            vid_i += 1
    return np.asarray(perm, np.int32)


def pack_media(media: Sequence[MediaItem]
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[np.ndarray]]:
    """-> (images [Ni,S,S,3], videos [Nv,T,S,S,3], block_perm)."""
    imgs = [torch.as_tensor(m.pixels) for m in media if m.kind == "image"]
    vids = [torch.as_tensor(m.pixels) for m in media if m.kind == "video"]
    images = torch.stack(imgs) if imgs else None
    videos = torch.stack(vids) if vids else None
    nf = videos.shape[1] if videos is not None else NUM_VIDEO_FRAMES
    perm = compute_block_perm([m.kind for m in media], nf) if (imgs and vids) else None
    return images, videos, perm


def round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def prepare_batch(token_rows: Sequence[Sequence[int]], media: Sequence[MediaItem],
                  image_len: int = IMAGE_FEATURE_LENGTH, pad_to: Optional[int] = None,
                  labels: Optional[Sequence[Sequence[int]]] = None
                  ) -> Tuple[SplicePlan, Optional[torch.Tensor], Optional[torch.Tensor],
                             Optional[np.ndarray]]:
    """Tokenized rows + media -> (plan, images, videos, block_perm). The
    padded length is `pad_to` (the trainer's fixed length) or the spliced
    length rounded up to a multiple of PAD_BUCKET; `labels` (per-row lists
    beside the token rows) are spliced into `plan.labels`."""
    kinds = [m.kind for m in media]
    vids = [m for m in media if m.kind == "video"]
    nf = vids[0].pixels.shape[0] if vids else NUM_VIDEO_FRAMES
    est = max(
        (sum(1 for t in row if t == IMAGE_TOKEN_INDEX) * image_len
         + sum(1 for t in row if t == OBJS_TOKEN_INDEX) * REGION_FEATURE_LENGTH
         + sum(1 for t in row if t >= 0))
        for row in token_rows
    )
    pad_len = pad_to or round_up(max(est, 8), PAD_BUCKET)
    plan = plan_splice(token_rows, kinds, pad_len, num_video_frames=nf, image_len=image_len,
                       labels=labels)
    images, videos, perm = pack_media(media)
    return plan, images, videos, perm


class VitronEngine:
    """End-to-end chat: prompt assembly -> generate -> protocol parse."""

    def __init__(self, params, cfg, tokenizer, conv_template: str = "llava_v1", device=None):
        self.generator = Generator(params, cfg, device=device)
        self.tokenizer = tokenizer
        self.conv_template = conv_template
        # set by ServingPipeline(batched=True): chat decode co-batches with
        # other in-flight requests through runtime/batching.py
        self.batcher = None

    def plan_turn(self, user_message: str, media: Sequence[MediaItem] = (),
                  history: Optional[List[Tuple[str, str]]] = None):
        """The turn's prompt, tokenized and planned -> (plan, images, videos,
        block_perm, stop string)."""
        conv = conv_templates[self.conv_template].copy()
        for u, a in history or []:
            conv.append_message(conv.roles[0], u)
            conv.append_message(conv.roles[1], a)
        conv.append_message(conv.roles[0], user_message)
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_region_token(conv.get_prompt(), self.tokenizer)
        plan, images, videos, perm = prepare_batch(
            [ids], media, image_len=self.generator.cfg.image_tower.num_patches)
        return plan, images, videos, perm, conv.sep if conv.sep2 is None else conv.sep2

    def chat(self, user_message: str, media: Sequence[MediaItem] = (),
             region_boxes: Optional[np.ndarray] = None,
             history: Optional[List[Tuple[str, str]]] = None,
             sampling: SamplingConfig = SamplingConfig(),
             gen: Optional[torch.Generator] = None,
             decode_chunk: Optional[int] = None) -> Dict[str, Any]:
        """One turn -> {"raw", "text", "module", "instructions", "region",
        "tokens"}. Decode runs in device chunks (decode_chunk None: 128
        tokens for int4 weights, 32 otherwise, as the JAX engine; 0: per
        token), or on `self.batcher` when one is set."""
        gen_ = self.generator
        plan, images, videos, perm, stop_str = self.plan_turn(user_message, media, history)
        stopper = KeywordStopper([stop_str], self.tokenizer, prompt_len=0) if stop_str else None
        if decode_chunk is None and not has_packed_int4(gen_.params):
            decode_chunk = 32
        out = gen_.generate(
            plan, images=images, videos=videos, block_perm=perm, region_boxes=region_boxes,
            sampling=sampling, gen=gen, stopper=stopper, decode_chunk=decode_chunk,
            batcher=self.batcher)[0]
        text = self.tokenizer.decode(out, skip_special_tokens=True)
        if stop_str and text.endswith(stop_str):
            text = text[: -len(stop_str)].strip()
        clean, module, instructions, region = parse_model_output(text)
        return {"raw": text, "text": clean, "module": module,
                "instructions": instructions, "region": region, "tokens": out}
