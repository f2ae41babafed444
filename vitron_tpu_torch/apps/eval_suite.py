"""Eval suite: the demo run and the checkpoint acceptance run, in PyTorch.

Port of `vitron_tpu/apps/eval_suite.py`. `run_demo_suite` (:29) drives the
five BASELINE workloads on small random-weight models (single-image QA,
8-frame video QA, SEEM segmentation and tracking, GLIGEN generation, text
to video and an atlas render): a pipeline check without checkpoints, in
seconds on the CPU. `run_acceptance_suite` (:217) is the acceptance run on
a weights directory (`ACCEPTANCE_MANIFEST`): every component present is
loaded through the serving assembly's converters, run once on a small
seeded workload and reported with a sha256 prefix of its output (the hash
to pin per weights release) and a pass verdict; a missing component is a
`missing` row, a present one that fails a red row. Everything runs on
`--device` (default `cuda`; without a CUDA device that is an error, exit 2).

  python -m vitron_tpu_torch.apps.eval_suite --demo --device cpu
  python -m vitron_tpu_torch.apps.eval_suite --weights weights/ [--geometry tiny]

The hashes are of this package's outputs: they pin a release on the port,
not across frameworks.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time
import zlib
from typing import Any, Dict, Optional

import numpy as np

ACCEPTANCE_MANIFEST = """\
Checkpoint manifest — every weight file the reference application loads
(reference file:line in parens), its expected location under --weights,
and the acceptance task run on it:

  vicuna-7b/            HF llama dir (builder.py:54-57)        -> image QA reply hash
  vitron_lora/          peft adapter + non_lora_trainables     -> merged into the QA run
                        (builder.py:63-86)
  clip_vit_l14/         HF CLIP vision tower (builder.py:149)  -> image tower for the QA run
  languagebind_video/   LanguageBind video tower w/ temporal
                        attn (languagebind/video)              -> 8-frame encode hash
  seem_focall_v1.pt     SEEM FocalNet-L (demo_code/app.py:37)  -> text-referred mask hash
  gligen/*.pth          GLIGEN generation bundle
                        (demo/app.py:67-80)                    -> one grounded UNet step
  gligen/*inpaint*.pth  GLIGEN inpainting bundle
                        (demo/app.py:81-91)                    -> one 9-channel UNet step
  stablevideo/<name>/   NLA atlas checkpoint + config.json
                        (atlas_utils.py:75-80)                 -> UV eval + render hash
  i2vgen/*.pth          UNetSD_I2VGen (app.py:324 equivalent)  -> one v-pred DDIM step hash
  t2v/*.pth             UNetSD_T2VBase / ZeroScope
                        (app.py:228 equivalent)                -> one v-pred DDIM step hash
                        (a real-geometry step runs on a CUDA device; on the
                        CPU it is skipped unless VITRON_ACCEPT_FORWARD=1)

Every row present on disk must end `pass: true`; missing rows report
`status: missing` (skipped, pass: null). Exit code 1 if any present row
fails. `--geometry tiny` runs the same pipeline against synthetic tiny
checkpoints for a dry run.

The SERVING assembly (runtime/assembly.build_system_from_weights,
`python -m vitron_tpu_torch.apps.serve --weights`) reads the same layout
plus optional rows:

  clip_tokenizer/       HF CLIP tokenizer (SEEM language + diffusion text)
  t2v/vae.pth           ldm AutoencoderKL (else the GLIGEN VAE is shared)
  t2v/text_encoder/     HF CLIPTextModel dir (open-clip ViT-H text)
  i2vgen/vae.pth, i2vgen/text_encoder/    same for image-to-video
  stablevideo/control_sd15_canny.pth      ControlLDM bundle -> task F
  stablevideo/control_sd15_depth.pth      depth ControlNet arm
  stablevideo/dpt_hybrid*.pt              MiDaS depth annotator
"""


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, round(time.perf_counter() - t0, 2)


def _sha16(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


class _WordTokenizer:
    """The demo's chat tokenizer: id = crc32(word) % 200 + 10."""

    bos_token_id, eos_token_id = 1, 2

    def __call__(self, s):
        class Encoded:
            pass

        enc = Encoded()
        enc.input_ids = [1] + [zlib.crc32(w.encode()) % 200 + 10 for w in s.split()]
        return enc

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(t) for t in ids)


class _TextTokenizer:
    """The demo's CLIP-text stand-in: BOS 49, up to 14 word ids, EOS 127."""

    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 return_tensors="np"):
        out = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            ids = [49] + [zlib.crc32(w.encode()) % 100 + 2 for w in t.split()][:14] + [127]
            out[i, : len(ids)] = ids
        return {"input_ids": out}


def _host_plan(device):
    """The memory plan of a system off the card (none is known there)."""
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan

    return None if device.type == "cuda" else MemoryPlan(budget_bytes=8 << 30)


def run_demo_suite(seed: int = 0, device="cuda") -> Dict[str, Any]:
    import torch

    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.models.diffusion import clip_text
    from vitron_tpu_torch.models.diffusion import gligen_pipeline as gp
    from vitron_tpu_torch.models.diffusion import stablevideo as sv
    from vitron_tpu_torch.models.diffusion import unet2d, unet_sd_video, vae
    from vitron_tpu_torch.models.diffusion import video_pipelines as vp
    from vitron_tpu_torch.models.seem import decoder as seem_dec
    from vitron_tpu_torch.models.seem import model as seem_model
    from vitron_tpu_torch.runtime.assembly import resolve_device
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.generation import SamplingConfig
    from vitron_tpu_torch.runtime.system import VitronSystem

    device = resolve_device(device)
    report: Dict[str, Any] = {}
    rs = np.random.RandomState(seed)

    def gen(offset: int):
        return torch.Generator(device=device).manual_seed(seed + offset)

    # (1) single-image QA
    cfg = vitron_model.VitronConfig.tiny()
    system = VitronSystem(VitronEngine(vitron_model.init_params(gen(0), cfg, device), cfg,
                                       _WordTokenizer(), device=device),
                          memory_plan=_host_plan(device))
    greedy = SamplingConfig(greedy=True, max_new_tokens=8, eos_ids=())
    img = rs.randint(0, 255, (64, 64, 3), np.uint8)
    with torch.no_grad():
        out, dt = _timed(lambda: system.chat("what is in this image?", image=img,
                                             sampling=greedy))
        report["1_image_qa"] = {"status": out["status"],
                                "tokens": len(out["reply"]["raw"].split()), "seconds": dt}

        # (2) 8-frame video understanding
        vid = rs.randint(0, 255, (8, 64, 64, 3), np.uint8)
        out, dt = _timed(lambda: system.chat("what happens in this video?", video=vid,
                                             sampling=greedy))
        report["2_video_qa"] = {"status": out["status"], "seconds": dt}

        # (3) SEEM segmentation + tracking
        scfg = seem_model.SeemConfig.tiny()
        sparams = seem_model.init_params(gen(1), scfg, device)
        stroke = np.zeros((64, 64), bool)
        stroke[16:48, 16:48] = True
        pts, valid = seem_dec.sample_stroke_points(stroke, scfg.decoder.max_spatial_len, rs)
        image = torch.as_tensor(img, device=device)
        pts, valid = torch.as_tensor(pts, device=device), torch.as_tensor(valid, device=device)
        mask, dt = _timed(lambda: seem_model.upsample_mask(seem_model.segment_stroke(
            sparams, scfg, image, pts, valid)[0], (64, 64)).cpu().numpy())
        frames = torch.as_tensor(np.stack([np.roll(img, s, axis=1) for s in (0, 4, 8)]),
                                 device=device)
        masks, dt2 = _timed(lambda: seem_model.track_video(sparams, scfg, frames, image, pts,
                                                           valid).cpu().numpy())
        report["3_seem"] = {"mask_pixels": int(mask.sum()), "tracked_frames": int(masks.shape[0]),
                            "seg_seconds": dt, "track_seconds": dt2}

        # (4) GLIGEN grounded generation
        gcfg = gp.GligenConfig.tiny(steps=4)
        g = gen(2)
        pipe = gp.GligenPipeline(gcfg, unet2d.init_params(g, gcfg.unet, device),
                                 vae.init_params(g, gcfg.vae, device),
                                 clip_text.init_params(g, gcfg.text, device),
                                 tokenizer=_TextTokenizer())
        out, dt = _timed(lambda: pipe.generate("a red cube", [[0.2, 0.2, 0.7, 0.7]], ["red cube"],
                                               gen=gen(0), steps=4).cpu().numpy())
        report["4_gligen"] = {"image": list(out.shape), "seconds": dt}

        # (5) video generation + atlas editing
        tcfg = vp.Text2VideoConfig.tiny()
        g = gen(3)
        t2v = vp.Text2VideoPipeline(tcfg, unet_sd_video.init_params(g, tcfg.unet, device),
                                    vae.init_params(g, tcfg.vae, device),
                                    clip_text.init_params(g, tcfg.text, device),
                                    tokenizer=_TextTokenizer())
        vidgen, dt = _timed(lambda: t2v.generate("a dog running", gen=gen(0), steps=4)
                            .cpu().numpy())

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        ys = np.linspace(-1, 1, 8)
        gy, gx = np.meshgrid(ys, ys, indexing="ij")
        uv = t(np.broadcast_to(np.stack([gx, gy], -1), (4, 8, 8, 2)))
        fg, bg = t(rs.rand(16, 16, 3)), t(rs.rand(16, 16, 3))
        rendered, dt2 = _timed(lambda: sv.render_frames(fg, bg, uv, uv,
                                                        torch.full((4, 8, 8, 1), 0.6,
                                                                   device=device)).cpu().numpy())
    report["5_video_gen_edit"] = {"t2v_frames": list(vidgen.shape), "t2v_seconds": dt,
                                  "atlas_render_frames": int(rendered.shape[0]),
                                  "render_seconds": dt2}
    return report


def run_acceptance_suite(weights: str, seed: int = 0, image_path: Optional[str] = None,
                         geometry: str = "real", device="cuda") -> Dict[str, Any]:
    """The checkpoint-backed acceptance run (ACCEPTANCE_MANIFEST) on
    `device`. geometry: "real" expects the released checkpoints' shapes
    (SeemConfig(), GligenConfig(), UNetSDVideoConfig.t2v() / i2vgen_xl()),
    "tiny" the synthetic test shapes; the Llama and CLIP rows read their
    geometry from the HF config files either way."""
    import torch

    from vitron_tpu_torch.runtime import assembly

    device = assembly.resolve_device(device)
    tiny = geometry == "tiny"
    w = pathlib.Path(weights)
    report: Dict[str, Any] = {"weights_dir": str(w), "geometry": geometry}
    rs = np.random.RandomState(seed)

    def _row(key: str, present: bool, expected: str, fn) -> None:
        """One manifest row: missing -> skipped, an exception -> a red row,
        a returned dict -> its verdict."""
        if not present:
            report[key] = {"status": "missing", "expected": expected, "pass": None}
            return
        try:
            with torch.no_grad():
                out = fn()
            report[key] = {**out, "pass": bool(out.get("pass", True))}
        except Exception as e:  # any failure of a present checkpoint is the row's verdict
            report[key] = {"pass": False, "error": f"{type(e).__name__}: {e}"}

    if image_path:
        from vitron_tpu_torch.media.preprocess import load_image

        image = np.asarray(load_image(image_path))
    else:
        image = rs.randint(0, 255, (480, 640, 3), np.uint8)

    # ---- MLLM: base (+LoRA) + towers + projector / region adapters
    base = w / "vicuna-7b"

    def _row_image_qa():
        from vitron_tpu_torch.runtime.generation import SamplingConfig

        t0 = time.perf_counter()
        lora, clip = w / "vitron_lora", w / "clip_vit_l14"
        system, _ = assembly.build_mllm_system(
            str(base), lora=str(lora) if lora.is_dir() else None,
            clip_tower=str(clip) if clip.is_dir() else None, geometry=geometry,
            allow_random_towers=True, device=device, memory_plan=_host_plan(device))
        out, dt = _timed(lambda: system.chat(
            "What is in this image?", image=image,
            sampling=SamplingConfig(greedy=True, max_new_tokens=32),
            gen=torch.Generator(device=device).manual_seed(seed)))
        raw = out["reply"]["raw"]
        # a trained checkpoint must produce text; tiny random weights may
        # greedy-decode straight into a stop separator
        return {"load_seconds": round(time.perf_counter() - t0 - dt, 1), "seconds": dt,
                "reply": raw[:200], "pass": len(raw) > 0 if not tiny else True,
                "reply_sha16": _sha16(np.frombuffer(raw.encode(), np.uint8))}

    _row("1_image_qa", base.is_dir(), str(base), _row_image_qa)

    # ---- LanguageBind video tower
    lbv = w / "languagebind_video"

    def _row_video_tower():
        import dataclasses

        from vitron_tpu_torch.models.vision import loader as vloader
        from vitron_tpu_torch.models.vision import vit

        tcfg = dataclasses.replace(assembly.vit_cfg_from_hf(lbv), add_time_attn=True)
        vparams = vloader.convert_hf_clip_vision(assembly._load_state_dir(lbv), tcfg,
                                                 device=device)
        frames = torch.as_tensor(rs.rand(1, tcfg.num_frames, tcfg.image_size, tcfg.image_size,
                                         3), dtype=torch.float32, device=device)
        feats, dt = _timed(lambda: vit.forward_video_features(vparams, tcfg, frames)
                           .float().cpu().numpy())
        return {"seconds": dt, "pass": bool(np.isfinite(feats).all()), "feat_sha16": _sha16(feats)}

    _row("2_languagebind_video", lbv.is_dir(), str(lbv), _row_video_tower)

    # ---- SEEM
    seem_pt = w / "seem_focall_v1.pt"

    def _row_seem():
        from vitron_tpu_torch.media.preprocess import _resize_hw
        from vitron_tpu_torch.models.llm.loader import load_torch_pth
        from vitron_tpu_torch.models.seem import language as seem_lang
        from vitron_tpu_torch.models.seem import model as seem_model

        scfg = seem_model.SeemConfig.tiny() if tiny else seem_model.SeemConfig()
        sp = seem_model.convert_torch(load_torch_pth(seem_pt), scfg, device=device)
        size = scfg.input_size
        img = _resize_hw(torch.as_tensor(image, dtype=torch.float32, device=device), size, size,
                         "linear").to(torch.uint8)
        tok = assembly._clip_tokenizer(w)
        if tok is not None:
            ids = seem_lang.tokenize(tok, ["the main object"], scfg.lang.context_length)
        else:
            # no tokenizer: fixed token ids still drive the language encoder
            # and the decoder end to end
            ids = np.zeros((1, scfg.lang.context_length), np.int64)
            ids[0, :6] = [49, 12, 33, 7, 21, 120]
        ids = np.asarray(ids)
        mask, dt = _timed(lambda: seem_model.segment_text(
            sp, scfg, img, torch.as_tensor(ids, device=device),
            torch.as_tensor((ids != 0).astype(np.int64), device=device))[0].cpu().numpy())
        return {"seconds": dt, "pass": bool(np.isfinite(mask).all()), "mask_sha16": _sha16(mask > 0)}

    _row("3_seem_text_seg", seem_pt.exists(), str(seem_pt), _row_seem)

    # ---- GLIGEN generation + inpainting
    gdir = w / "gligen"
    gpth = sorted(gdir.glob("*.pth")) if gdir.is_dir() else []
    gen_pths = [p for p in gpth if "inpaint" not in p.name.lower()]
    inp_pths = [p for p in gpth if "inpaint" in p.name.lower()]

    def _gligen_row(path, inpaint: bool):
        from vitron_tpu_torch.models.diffusion import gligen_pipeline as gp
        from vitron_tpu_torch.models.diffusion import unet2d

        gcfg = gp.GligenConfig.tiny() if tiny else gp.GligenConfig()
        (unet_params, _, _), dt = _timed(lambda: gp.load_gligen_checkpoint(
            path, gcfg, inpaint=inpaint, device=device))
        lat = 16 if tiny else 64
        in_ch = 9 if inpaint else gcfg.unet.in_channels

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        x = t(rs.randn(1, lat, lat, in_ch))
        ctx = t(rs.randn(1, 4, gcfg.unet.context_dim) * 0.02)
        objs = t(rs.randn(1, 4, gcfg.unet.context_dim) * 0.02)
        eps, fdt = _timed(lambda: unet2d.forward(
            unet_params, gcfg.unet, x, torch.full((1,), 5.0, device=device), ctx, objs=objs)
            .float().cpu().numpy())
        return {"load_seconds": dt, "step_seconds": fdt, "pass": bool(np.isfinite(eps).all()),
                "eps_sha16": _sha16(eps)}

    _row("4_gligen_gen", bool(gen_pths), str(gdir / "*.pth"),
         lambda: _gligen_row(gen_pths[0], False))
    _row("4_gligen_inpaint", bool(inp_pths), str(gdir / "*inpaint*.pth"),
         lambda: _gligen_row(inp_pths[0], True))

    # ---- StableVideo NLA atlases
    svdir = w / "stablevideo"
    nla_dirs = sorted(d for d in (svdir.iterdir() if svdir.is_dir() else [])
                      if (d / "checkpoint").exists())

    def _row_nla():
        from vitron_tpu_torch.models.diffusion import stablevideo as sv

        store = assembly.NLAAtlasStore(svdir, atlas_res=16, device=device)
        bundle, dt = _timed(lambda: store.bundle(nla_dirs[0].name, 2, 24, 24))

        def t(k):
            return torch.as_tensor(bundle[k], dtype=torch.float32, device=device)

        frames = sv.render_frames(t("fg_atlas"), t("bg_atlas"), t("fg_uv"), t("bg_uv"),
                                  t("alpha")).cpu().numpy()
        ok = bool(np.isfinite(frames).all() and np.isfinite(bundle["fg_atlas"]).all())
        return {"seconds": dt, "video": nla_dirs[0].name, "pass": ok,
                "render_sha16": _sha16(frames)}

    _row("5_stablevideo_nla", bool(nla_dirs), str(svdir / "<name>/checkpoint"), _row_nla)

    # ---- video UNets: converted, then one v-pred DDIM step
    from vitron_tpu_torch.models.diffusion import samplers, unet_sd_video
    from vitron_tpu_torch.models.llm.loader import load_torch_pth

    for name, variant in (("i2vgen", "i2vgen"), ("t2v", "t2v")):
        vdir = w / name
        pths = sorted(p for p in (vdir.glob("*.pth") if vdir.is_dir() else [])
                      if p.name != "vae.pth")

        def _row_unet(pths=pths, variant=variant):
            if tiny:
                vcfg = unet_sd_video.UNetSDVideoConfig.tiny(variant)
            else:
                vcfg = (unet_sd_video.UNetSDVideoConfig.i2vgen_xl() if variant == "i2vgen"
                        else unet_sd_video.UNetSDVideoConfig.t2v())
            vparams, dt = _timed(lambda: unet_sd_video.convert_torch(load_torch_pth(pths[0]),
                                                                     vcfg, device=device))
            n_params = sum(int(np.prod(t.shape)) for t in _leaves(vparams))
            out = {"load_seconds": dt, "params": n_params, "pass": n_params > 0}
            # a real-geometry forward on the CPU takes minutes: there the row
            # stays converter-only unless VITRON_ACCEPT_FORWARD=1
            if not (tiny or device.type == "cuda"
                    or os.environ.get("VITRON_ACCEPT_FORWARD") == "1"):
                out["step"] = "skipped (CPU host; parity suite covers numerics)"
                return out

            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=device)

            if tiny:
                f, lh, lw = 2, 8, 8
                y = t(rs.randn(1, 3, 1024) * 0.02)
            else:  # the deployed latent geometry (video_pipelines defaults)
                f, lh, lw = (16, 32, 32) if variant == "i2vgen" else (24, 40, 72)
                y = t(rs.randn(1, 77, 1024) * 0.02)
            x = t(rs.randn(1, f, lh, lw, 4))
            kw = {}
            if variant == "i2vgen":
                kw = dict(image=t(np.zeros((1, vcfg.y_dim))), local_image=t(np.zeros((1, lh, lw,
                                                                                       4))),
                          fps=t([8.0]))
            v32 = unet_sd_video.forward(vparams, vcfg, x, t([981.0]), y=y, **kw).float()
            v32, x32 = v32.cpu().numpy(), x.cpu().numpy()
            # one step 981 -> 961 on the pipelines' zero-terminal-SNR cosine schedule
            ac = np.asarray(samplers.DiffusionSchedule.create(
                "cosine", 1000, zero_terminal_snr=True).alphas_cumprod, np.float64)
            a_t, a_prev = float(ac[981]), float(ac[961])
            x0 = np.sqrt(a_t) * x32 - np.sqrt(1 - a_t) * v32
            eps = np.sqrt(a_t) * v32 + np.sqrt(1 - a_t) * x32
            x_prev = (np.sqrt(a_prev) * x0 + np.sqrt(1 - a_prev) * eps).astype(np.float32)
            out.update({"pass": bool(np.isfinite(x_prev).all()), "step_geometry": [1, f, lh, lw, 4],
                        "step_sha16": _sha16(x_prev)})
            return out

        _row(f"6_{name}_unet", bool(pths), str(vdir / "*.pth"), _row_unet)

    failures = [k for k, v in report.items() if isinstance(v, dict) and v.get("pass") is False]
    report["all_present_pass"] = not failures
    report["failed_rows"] = failures
    return report


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Vitron PyTorch/CUDA eval suite")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights", help="weights dir for the acceptance run (ACCEPTANCE_MANIFEST)")
    p.add_argument("--image", help="example image for the acceptance run")
    p.add_argument("--geometry", choices=("real", "tiny"), default="real",
                   help="checkpoint geometry: the released shapes, or the tiny synthetic ones")
    p.add_argument("--manifest", action="store_true",
                   help="print the checkpoint manifest and exit")
    args = p.parse_args(argv)
    if args.manifest:
        print(ACCEPTANCE_MANIFEST)
        return 0
    if not args.demo and not args.weights:
        print("provide --weights DIR for the acceptance run, or --demo")
        return 2
    from vitron_tpu_torch.runtime.assembly import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.demo:
        print(json.dumps(run_demo_suite(args.seed, device), indent=2))
        return 0
    report = run_acceptance_suite(args.weights, args.seed, args.image, geometry=args.geometry,
                                  device=device)
    print(json.dumps(report, indent=2))
    # the unattended pass/fail table: one line per manifest row
    print(f"\n{'row':24s} verdict")
    for k, v in report.items():
        if not isinstance(v, dict) or "pass" not in v:
            continue
        verdict = ("SKIP (missing)" if v["pass"] is None
                   else "PASS" if v["pass"] else f"FAIL {v.get('error', '')}")
        print(f"{k:24s} {verdict}")
    return 0 if report.get("all_present_pass", False) else 1


if __name__ == "__main__":
    sys.exit(main())
