"""VitronSystem: the multimodal assistant's chat turn, end to end.

Port of the chat half of `vitron_tpu/runtime/system.py` (:444-513):
`prepare` (media preprocessing + prompt assembly on the host), then
`chat_prepared` (the model, then protocol routing). Routing uses the JAX
package's `BackendRegistry`. Of the task backends, A (image generation) and
C (image editing) are ported (`register_gligen`, :252-347); a tool call for
a backend not registered is answered as unavailable, as the JAX system
answers it. C's SEEM-chained branch waits for the SEEM backend.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from vitron_tpu.mm.sketch import mask_to_bbox
from vitron_tpu.mm.tokenization import preprocess_region
from vitron_tpu.runtime.router import (BackendRegistry, TaskRequest, parse_region_boxes,
                                       route_model_output)
from vitron_tpu_torch.media.preprocess import preprocess_image, preprocess_video
from vitron_tpu_torch.runtime.engine import MediaItem, VitronEngine
from vitron_tpu_torch.runtime.generation import SamplingConfig


class VitronSystem:
    def __init__(self, engine: VitronEngine):
        self.engine = engine
        self.registry = BackendRegistry()

    def register_gligen(self, pipeline):
        """A image_generation and C image_editing on a `GligenPipeline`."""

        def norm_boxes(region):
            return [[min(max(v, 0.0), 1.0) for v in b] for b in parse_region_boxes(region)]

        def handle_a(req: TaskRequest) -> Dict[str, Any]:
            prompt = (req.instructions or [req.text])[0]
            norm = norm_boxes(req.region)
            if norm:
                # protocol boxes ground the prompt; extra instruction lines
                # are the per-box phrases
                phrases = (req.instructions[1:] if req.instructions and
                           len(req.instructions) > 1 else [prompt] * len(norm))
                img = pipeline.generate(prompt, norm, phrases[: len(norm)], guidance_scale=7.5)
            else:
                # no boxes: the reference's placeholder phrase, no grounding
                img = pipeline.generate(prompt, [], ["placeholder"], guidance_scale=7.5)
            return {"image": img.cpu().numpy()}

        def handle_c(req: TaskRequest) -> Dict[str, Any]:
            if req.image is None:
                return {"status": "error", "error": "image_editing needs an image"}
            prompt = (req.instructions or [req.text])[0]
            # one edit instruction, split on ';' into per-object phrases
            texts = [x.strip() for x in prompt.split(";") if x.strip()] or [prompt]
            h, w = req.image.shape[:2]
            lat = pipeline.cfg.latent_size
            gy, gx = np.mgrid[0:lat, 0:lat]

            def outside(boxes):
                keep = np.ones((lat, lat), bool)
                for b in boxes:
                    keep &= ~((gx >= b[0] * lat) & (gx < b[2] * lat) &
                              (gy >= b[1] * lat) & (gy < b[3] * lat))
                return keep.astype(np.float32)

            keep = None
            if req.sketch_mask is not None and np.asarray(req.sketch_mask).any():
                # the user's stroke: its bbox is the region to repaint
                bb = mask_to_bbox(np.asarray(req.sketch_mask, bool))
                norm = [[bb[0] / w, bb[1] / h, bb[2] / w, bb[3] / h]]
                phrases = texts[:1]
                keep = outside(norm)
            elif parse_region_boxes(req.region):
                norm = norm_boxes(req.region)
                phrases = texts[: len(norm)] or [prompt]
                keep = outside(norm)
            else:
                norm = [[0.25, 0.25, 0.75, 0.75]]
                phrases = texts[:1]
            img = pipeline.generate(prompt, norm, phrases, guidance_scale=30.0,
                                    inpaint_image=np.asarray(req.image), inpaint_keep_mask=keep)
            return {"image": img.cpu().numpy()}

        self.registry.register("A", handle_a)
        self.registry.register("C", handle_c)

    def prepare(self, user_message: str, image: Optional[np.ndarray] = None,
                video: Optional[np.ndarray] = None,
                region_box: Optional[list] = None) -> Dict[str, Any]:
        """Host half of a turn: media preprocessing + prompt assembly."""
        cfg = self.engine.generator.cfg
        tower_size = cfg.image_tower.image_size
        media = []
        msg = user_message
        if image is not None:
            media.append(MediaItem("image", preprocess_image(image, size=tower_size)))
            if "<image>" not in msg:
                msg = "<image>\n" + msg
        if video is not None:
            px = preprocess_video(video[:cfg.video_tower.num_frames], size=tower_size)
            media.append(MediaItem("video", px))
            if "<image>" not in msg and "<video>" not in msg:
                msg = "<image>" * px.shape[0] + "\n" + msg
        region_boxes = None
        if region_box is not None and image is not None:
            scaled = preprocess_region(region_box, image.shape[:2][::-1],
                                       (tower_size, tower_size))
            region_boxes = np.asarray([scaled], np.float32)
            if "<objs>" not in msg:
                msg = msg + " <objs>"
        return {"msg": msg, "media": media, "region_boxes": region_boxes,
                "image": image, "video": video}

    def chat_prepared(self, prepared: Dict[str, Any], sketch_mask: Optional[np.ndarray] = None,
                      history=None, sampling: SamplingConfig = SamplingConfig(),
                      gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Device half: generate, then route the reply's tool call if any."""
        reply = self.engine.chat(prepared["msg"], media=prepared["media"],
                                 region_boxes=prepared["region_boxes"], history=history,
                                 sampling=sampling, gen=gen)
        result = self.route(reply["raw"], image=prepared["image"], video=prepared["video"],
                            sketch_mask=sketch_mask)
        result["reply"] = reply
        return result

    def route(self, raw: str, image: Optional[np.ndarray] = None,
              video: Optional[np.ndarray] = None,
              sketch_mask: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Parse a model reply and run its tool call on the registered
        backends (the chat's second half, also callable on a reply alone)."""
        return route_model_output(self.registry, raw, image=image, video=video,
                                  sketch_mask=sketch_mask)

    def chat(self, user_message: str, image: Optional[np.ndarray] = None,
             video: Optional[np.ndarray] = None, sketch_mask: Optional[np.ndarray] = None,
             region_box: Optional[list] = None, history=None,
             sampling: SamplingConfig = SamplingConfig(),
             gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """One turn: preprocess media, run the model, route any tool call.
        (Task extras such as audio arrive with the backends that read them.)"""
        prepared = self.prepare(user_message, image=image, video=video, region_box=region_box)
        return self.chat_prepared(prepared, sketch_mask=sketch_mask, history=history,
                                  sampling=sampling, gen=gen)
