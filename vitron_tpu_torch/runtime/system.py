"""VitronSystem: the multimodal assistant's chat turn and task backends.

Port of `vitron_tpu/runtime/system.py`: `prepare` (media preprocessing +
prompt assembly on the host), then `chat_prepared` (the model, then protocol
routing through the port's `runtime/router.py`). Of the task backends, B
(image segmentation) and E (video tracking) run on SEEM (`register_seem`,
:57-250), A (image generation) and C (image editing) on GLIGEN
(`register_gligen`, :252-347), D (video generation) on the T2V pipeline
(`register_text2video`, :349-357), G (image to video) on the I2V pipeline
(`register_image2video`, :359-371), F (video editing) on StableVideo
(`register_video_editor`, :373-440); C's edit mask comes from SEEM when no
sketch and no region is given. A tool call for a backend not registered is answered
as unavailable, as the JAX system answers it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from vitron_tpu_torch.media import visualize as vz
from vitron_tpu_torch.media.asr import default_asr
from vitron_tpu_torch.media.preprocess import _resize_hw, preprocess_image, preprocess_video
from vitron_tpu_torch.mm.sketch import mask_to_bbox
from vitron_tpu_torch.mm.tokenization import preprocess_region
from vitron_tpu_torch.runtime.engine import MediaItem, VitronEngine
from vitron_tpu_torch.runtime.generation import SamplingConfig
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan, tree_bytes
from vitron_tpu_torch.runtime.router import (BackendRegistry, TaskRequest, parse_region_boxes,
                                             route_model_output)


def _resize_linear(x, h: int, w: int) -> torch.Tensor:
    """[..., H, W] float32 (numpy or tensor) -> [..., h, w], as
    jax.image.resize(..., "linear") with its default antialiasing."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return _resize_hw(x[..., None], h, w, "linear")[..., 0]


class VitronSystem:
    def __init__(self, engine: Optional[VitronEngine], memory_plan: Optional[MemoryPlan] = None,
                 device=None):
        """`device`: where the system's backends live; with an engine, its
        device (another one is an error), without one `cuda` unless given.
        The memory plan is that device's (`MemoryPlan.for_device`, which
        knows no budget off the card: a CPU system passes `memory_plan`)."""
        self.engine = engine
        self.serving_mesh = None  # set by sharded_serving.install_mesh
        self.registry = BackendRegistry()
        gen = getattr(engine, "generator", None)
        if gen is not None:
            asked = None if device is None else torch.device(device)
            if asked is not None and (asked.type != gen.device.type or (
                    None not in (asked.index, gen.device.index)
                    and asked.index != gen.device.index)):
                raise ValueError(f"device {asked}: the engine's is {gen.device}")
            device = gen.device
        self.device = torch.device("cuda" if device is None else device)
        # speech-to-text hook for audio-referred segmentation: any object
        # with .transcribe(audio) -> {"text": str}; a Whisper checkpoint
        # when VITRON_WHISPER names one, else None
        self.asr = default_asr(self.device)
        self._seem_text_mask = None
        # resident-weights placement ledger against the device's memory
        # (the reference reloads backends from disk per request instead)
        self.memory_plan = memory_plan or MemoryPlan.for_device(self.device)
        self.memory_plan.add("llm+towers", tree_bytes(gen.params) if gen is not None else 0)

    def _track(self, name: str, params) -> None:
        self.memory_plan.add(name, tree_bytes(params))

    def register_seem(self, seem_params, seem_cfg, tokenizer, compute_dtype: str = "float32"):
        """B image_segmentation, E video_tracking, and the mask half of C
        image_editing (app.py:114-155, 158-212, 243-273) on a SEEM param tree.

        compute_dtype="bfloat16" serves the backbone + pixel decoder in bf16
        (weights cast once here; decoder and language stay float32)."""
        from vitron_tpu_torch.models.seem import decoder as seem_dec
        from vitron_tpu_torch.models.seem import language as seem_lang
        from vitron_tpu_torch.models.seem import model as seem_model
        from vitron_tpu_torch.models.seem import postprocess as pp

        if compute_dtype != "float32":
            seem_cfg = dataclasses.replace(seem_cfg, compute_dtype=compute_dtype)
            seem_params = seem_model.cast_tower_params(seem_params, getattr(torch, compute_dtype))
        device = seem_params["lang"]["token_emb"].device
        size = seem_cfg.input_size
        ctx_len = seem_cfg.lang.context_length

        def model_input(pixels) -> torch.Tensor:
            """uint8 [..., H, W, 3] -> [..., size, size, 3] uint8 on the device:
            the antialiased linear resize, truncated back to uint8."""
            x = torch.as_tensor(np.asarray(pixels), dtype=torch.float32, device=device)
            return _resize_hw(x, size, size, "linear").to(torch.uint8)

        def tokens(text: str):
            ids = seem_lang.tokenize(tokenizer, [text], ctx_len)
            return (torch.as_tensor(ids, device=device),
                    torch.as_tensor((np.asarray(ids) != 0).astype(np.int64), device=device))

        def stroke_points(sketch_mask):
            stroke = _resize_linear(np.asarray(sketch_mask, np.float32), size, size) > 0.5
            pts, valid = seem_dec.sample_stroke_points(
                stroke.numpy(), seem_cfg.decoder.max_spatial_len, np.random.RandomState(0))
            return torch.as_tensor(pts, device=device), torch.as_tensor(valid, device=device)

        def upsampled(mask, hw) -> np.ndarray:
            return seem_model.upsample_mask(mask, hw).cpu().numpy()

        bank_cache: list = []

        def class_bank() -> torch.Tensor:
            """COCO class bank (133 classes + a 'background' no-object row),
            embedded once (demo_code/app.py:69-71)."""
            if not bank_cache:
                ids, n_t = seem_lang.class_prompt_ids(
                    tokenizer, list(pp.COCO_PANOPTIC_CLASSES) + ["background"], seem_cfg.lang)
                bank_cache.append(seem_lang.class_embeddings_from_ids(
                    seem_params["lang"], seem_cfg.lang, torch.as_tensor(ids, device=device), n_t))
            return bank_cache[0]

        def text_mask(image: np.ndarray, phrase: str) -> np.ndarray:
            mask, _ = seem_model.segment_text(seem_params, seem_cfg, model_input(image),
                                              *tokens(phrase))
            return upsampled(mask, image.shape[:2])

        def annotated(image, mask, label):
            """Overlay as the reference Visualizer draws it (draw_binary_mask
            + class text)."""
            img = np.asarray(image)
            if img.dtype != np.uint8:
                img = np.clip(img, 0, 255).astype(np.uint8)
            return vz.draw_binary_mask(img, np.asarray(mask), color=vz.COLORS[0], text=label,
                                       alpha=0.5)

        def handle_b(req: TaskRequest) -> Dict[str, Any]:
            if req.image is None:
                return {"status": "error", "error": "image_segmentation needs an image"}
            if req.extra.get("audio") is not None and not req.extra.get("audio_transcript"):
                # raw audio -> transcript through the installed ASR hook
                # (reference interactive.py:105-109)
                if self.asr is None:
                    return {"status": "error",
                            "error": "audio input but no ASR hook installed (set system.asr)"}
                req.extra["audio_transcript"] = self.asr.transcribe(req.extra["audio"])["text"]
            hw = req.image.shape[:2]
            if req.sketch_mask is not None:
                mask, _ = seem_model.segment_stroke(seem_params, seem_cfg, model_input(req.image),
                                                    *stroke_points(req.sketch_mask))
                up = upsampled(mask, hw)
                return {"mask": up, "overlay": annotated(req.image, up, None)}
            if req.extra.get("audio_transcript"):
                # the transcript routes through the decoder's audio token group
                transcript = req.extra["audio_transcript"]
                mask, _ = seem_model.segment_audio(seem_params, seem_cfg, model_input(req.image),
                                                   *tokens(transcript))
                up = upsampled(mask, hw)
                return {"mask": up, "transcript": transcript,
                        "overlay": annotated(req.image, up, transcript)}
            phrase = ((req.instructions or [req.text or ""])[0] or "").strip()
            if not phrase:
                # 'segment all': no referring text and no stroke runs the
                # panoptic pass (app.py:131-136, task=[])
                logits, masks = seem_model.segment_panoptic(seem_params, seem_cfg,
                                                             model_input(req.image), class_bank())
                masks = _resize_hw(masks[..., None], size, size, "linear")[..., 0]
                pan, segments = pp.panoptic_inference(logits.cpu().numpy(), masks.cpu().numpy(),
                                                      pp.COCO_THING_IDS)
                h, w = hw
                yi = (np.arange(h) * pan.shape[0]) // h
                xi = (np.arange(w) * pan.shape[1]) // w
                pan_up = pan[yi[:, None], xi[None, :]]
                img8 = np.clip(np.asarray(req.image), 0, 255).astype(np.uint8)
                overlay, labels = vz.draw_panoptic(img8, pan_up, segments,
                                                   class_names=pp.COCO_PANOPTIC_CLASSES)
                return {"panoptic": pan_up, "segments": segments, "labels": labels,
                        "overlay": overlay}
            m = text_mask(req.image, phrase)
            return {"mask": m, "overlay": annotated(req.image, m, phrase)}

        def handle_e(req: TaskRequest) -> Dict[str, Any]:
            if req.video is None or req.sketch_mask is None:
                return {"status": "error", "error": "video_tracking needs a video and a stroke"}
            frames = np.stack([np.asarray(f) for f in req.video]).astype(np.float32)
            fr = model_input(frames)
            masks = seem_model.track_video(seem_params, seem_cfg, fr, fr[0],
                                           *stroke_points(req.sketch_mask)).cpu().numpy()
            raw = np.clip(frames, 0, 255).astype(np.uint8)
            return {"masks": masks, "overlay_frames": vz.masks_to_video_overlay(raw, masks)}

        self._seem_text_mask = text_mask
        self._track("seem", seem_params)
        self.registry.register("B", handle_b)
        self.registry.register("E", handle_e)

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
            elif self._seem_text_mask is not None:
                # SEEM segments each phrase; the masks are OR-ed, each gives
                # a box, and everything outside the merged mask is kept
                # (app.py:176-186)
                merged = np.zeros((h, w), bool)
                norm, phrases = [], []
                for t in texts:
                    seg = self._seem_text_mask(req.image, t).astype(bool)
                    merged |= seg
                    bb = mask_to_bbox(seg)
                    if bb is not None:
                        norm.append([bb[0] / w, bb[1] / h, bb[2] / w, bb[3] / h])
                        phrases.append(t)
                if not norm:
                    norm, phrases = [[0.25, 0.25, 0.75, 0.75]], texts[:1]
                keep = (_resize_linear(merged, lat, lat) < 0.5).numpy().astype(np.float32)
            else:
                norm = [[0.25, 0.25, 0.75, 0.75]]
                phrases = texts[:1]
            img = pipeline.generate(prompt, norm, phrases, guidance_scale=30.0,
                                    inpaint_image=np.asarray(req.image), inpaint_keep_mask=keep)
            return {"image": img.cpu().numpy()}

        self._track("gligen", pipeline.__dict__)
        self.registry.register("A", handle_a)
        self.registry.register("C", handle_c)

    def register_text2video(self, pipeline):
        """D video_generation on a `Text2VideoPipeline`: the first
        instruction (or the reply text) is the prompt."""

        def handle_d(req: TaskRequest) -> Dict[str, Any]:
            prompt = (req.instructions or [req.text])[0]
            return {"video": pipeline.generate(prompt).cpu().numpy()}

        self._track("text2video", pipeline.__dict__)
        self.registry.register("D", handle_d)

    def register_image2video(self, pipeline):
        """G image_to_video on an `Image2VideoPipeline`: the request image
        (any size: the pipeline resizes it, C7) and the first instruction (or
        the reply text) as the prompt."""

        def handle_g(req: TaskRequest) -> Dict[str, Any]:
            if req.image is None:
                return {"status": "error", "error": "image_to_video needs an image"}
            prompt = (req.instructions or [req.text])[0]
            return {"video": pipeline.generate(np.asarray(req.image), prompt).cpu().numpy()}

        self._track("image2video", pipeline.__dict__)
        self.registry.register("G", handle_g)

    def register_video_editor(self, editor, atlas_provider=None, num_keyframes: int = 3,
                              noise_source=None):
        """F video_editing on a `StableVideoEditor`: the first instruction
        edits the foreground (a canny ControlNet edit of `num_keyframes`
        keyframes with atlas propagation, scattered and median-aggregated),
        the second the background (the depth ControlNet when the editor has
        a DPT annotator, canny otherwise); both atlases re-render at every
        frame's UVs. `atlas_provider(video, extra)` returns the video's atlas
        bundle (the reference's per-video NLA checkpoints).
        `noise_source(key)`, when given, supplies each edit's initial noise
        (key: the keyframe's index, or "back"); else it comes from the
        default generator."""
        from vitron_tpu_torch.models.diffusion import stablevideo as sv

        def handle_f(req: TaskRequest) -> Dict[str, Any]:
            if atlas_provider is None:
                return {"status": "error", "error": "video_editing needs precomputed atlases"}
            instructions = req.instructions or [req.text]
            fore = instructions[0]
            back = instructions[1] if len(instructions) > 1 else ""
            return {"video": sv.edit_video(editor, atlas_provider(req.video, req.extra), fore,
                                           back, num_keyframes=num_keyframes,
                                           noise_source=noise_source)}

        self._track("video_editor", editor.__dict__)
        self.registry.register("F", handle_f)

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
                      gen: Optional[torch.Generator] = None,
                      extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Device half: generate, then route the reply's tool call if any."""
        reply = self.engine.chat(prepared["msg"], media=prepared["media"],
                                 region_boxes=prepared["region_boxes"], history=history,
                                 sampling=sampling, gen=gen)
        result = self.route(reply["raw"], image=prepared["image"], video=prepared["video"],
                            sketch_mask=sketch_mask, extra=extra)
        result["reply"] = reply
        return result

    def route(self, raw: str, image: Optional[np.ndarray] = None,
              video: Optional[np.ndarray] = None, sketch_mask: Optional[np.ndarray] = None,
              extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Parse a model reply and run its tool call on the registered
        backends (the chat's second half, also callable on a reply alone).
        `extra` carries task inputs such as "audio" / "audio_transcript"."""
        return route_model_output(self.registry, raw, image=image, video=video,
                                  sketch_mask=sketch_mask, extra=extra)

    def chat(self, user_message: str, image: Optional[np.ndarray] = None,
             video: Optional[np.ndarray] = None, sketch_mask: Optional[np.ndarray] = None,
             region_box: Optional[list] = None, history=None,
             sampling: SamplingConfig = SamplingConfig(),
             gen: Optional[torch.Generator] = None,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """One turn: preprocess media, run the model, route any tool call."""
        prepared = self.prepare(user_message, image=image, video=video, region_box=region_box)
        return self.chat_prepared(prepared, sketch_mask=sketch_mask, history=history,
                                  sampling=sampling, gen=gen, extra=extra)
