"""Task router: structured model output -> backend invocation (A-G).

Rebuilds the reference routing table (reference: app.py:400-408,586-657):

    A image_generation   -> GLIGEN text-box generation
    B image_segmentation -> SEEM (text phrase or stroke)
    C image_editing      -> SEEM text-seg -> merged mask -> GLIGEN inpaint
    D video_generation   -> ZeroScope-style text-to-video
    E video_tracking     -> SEEM visual-query tracking
    F video_editing      -> StableVideo atlas + ControlNet
    G image_to_video     -> I2VGen-XL-style image-to-video

Backends register once and stay resident (the reference reloads checkpoints
per request, app.py:94-103,228,295-303,324). Each handler receives the
parsed (instructions, region, media) and returns a result dict. The port's
own copy of `vitron_tpu/runtime/router.py`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from vitron_tpu_torch.mm.protocol import TASK_NAMES, parse_model_output


@dataclasses.dataclass
class TaskRequest:
    module: str
    instructions: Optional[List[str]]
    region: Optional[str]
    text: str
    image: Any = None          # np.ndarray [H, W, 3] uint8
    video: Any = None          # np.ndarray [T, H, W, 3] uint8 or path
    sketch_mask: Any = None    # np.ndarray [H, W] bool
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class BackendRegistry:
    """module letter -> handler(request) -> result dict."""

    def __init__(self):
        self._handlers: Dict[str, Callable[[TaskRequest], Dict[str, Any]]] = {}
        self.timings: List[Dict[str, Any]] = []

    def register(self, module: str, handler: Callable) -> None:
        if module not in TASK_NAMES:
            raise ValueError(f"unknown module letter {module!r}; valid: {sorted(TASK_NAMES)}")
        self._handlers[module] = handler

    def available(self) -> Dict[str, str]:
        return {m: TASK_NAMES[m] for m in sorted(self._handlers)}

    def dispatch(self, req: TaskRequest) -> Dict[str, Any]:
        if req.module not in TASK_NAMES:
            return {"status": "error",
                    "error": f"model emitted unknown module {req.module!r}"}
        handler = self._handlers.get(req.module)
        if handler is None:
            return {"status": "unavailable",
                    "task": TASK_NAMES[req.module],
                    "error": f"no backend registered for {TASK_NAMES[req.module]}"}
        t0 = time.perf_counter()
        result = handler(req)
        dt = time.perf_counter() - t0
        self.timings.append({"task": TASK_NAMES[req.module], "seconds": dt})
        result.setdefault("status", "ok")
        result["task"] = TASK_NAMES[req.module]
        result["seconds"] = dt
        return result


def route_model_output(
    registry: BackendRegistry,
    model_output: str,
    image=None, video=None, sketch_mask=None, extra=None,
) -> Dict[str, Any]:
    """Parse the LLM's structured response and dispatch (app.py:572-657).
    If no <module> tag is present the reply is pure chat."""
    text, module, instructions, region = parse_model_output(model_output)
    if module is None or module.strip() == "":
        return {"status": "chat", "text": text}
    req = TaskRequest(module=module.strip(), instructions=instructions,
                      region=region, text=text, image=image, video=video,
                      sketch_mask=sketch_mask, extra=extra or {})
    result = registry.dispatch(req)
    result["text"] = text
    return result


def parse_region_boxes(region: Optional[str]) -> List[List[float]]:
    """Parse the `<region>` payload into bbox lists. The reference emits
    bracketed coordinate lists like '[x1,y1,x2,y2]' (app.py:367-372)."""
    import re

    if not region:
        return []
    boxes = []
    for m in re.findall(r"\[([^\[\]]+)\]", region):
        try:
            vals = [float(v) for v in m.replace(";", ",").split(",") if v.strip()]
        except ValueError:
            continue
        if len(vals) == 4:
            boxes.append(vals)
    return boxes
