"""VitronSystem: the multimodal assistant's chat turn, end to end.

Port of the chat half of `vitron_tpu/runtime/system.py` (:444-513):
`prepare` (media preprocessing + prompt assembly on the host), then
`chat_prepared` (the model, then protocol routing). Routing uses the JAX
package's `BackendRegistry`; no task backend (A-G) is ported yet, so a
tool call in a reply is routed and answered as unavailable, exactly as the
JAX system answers with no backends registered.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from vitron_tpu.mm.tokenization import preprocess_region
from vitron_tpu.runtime.router import BackendRegistry, route_model_output
from vitron_tpu_torch.media.preprocess import preprocess_image, preprocess_video
from vitron_tpu_torch.runtime.engine import MediaItem, VitronEngine
from vitron_tpu_torch.runtime.generation import SamplingConfig


class VitronSystem:
    def __init__(self, engine: VitronEngine):
        self.engine = engine
        self.registry = BackendRegistry()

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

    def chat_prepared(self, prepared: Dict[str, Any], history=None,
                      sampling: SamplingConfig = SamplingConfig(),
                      gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Device half: generate, then route the reply's tool call if any."""
        reply = self.engine.chat(prepared["msg"], media=prepared["media"],
                                 region_boxes=prepared["region_boxes"], history=history,
                                 sampling=sampling, gen=gen)
        result = route_model_output(self.registry, reply["raw"], image=prepared["image"],
                                    video=prepared["video"])
        result["reply"] = reply
        return result

    def chat(self, user_message: str, image: Optional[np.ndarray] = None,
             video: Optional[np.ndarray] = None, region_box: Optional[list] = None,
             history=None, sampling: SamplingConfig = SamplingConfig(),
             gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """One turn: preprocess media, run the model, route any tool call.
        (Sketch masks and task extras arrive with the task backends.)"""
        prepared = self.prepare(user_message, image=image, video=video, region_box=region_box)
        return self.chat_prepared(prepared, history=history, sampling=sampling, gen=gen)
