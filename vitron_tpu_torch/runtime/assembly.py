"""Assembly from checkpoint files, in PyTorch: a weights directory in, one
resident `VitronSystem` out.

Port of `vitron_tpu/runtime/assembly.py`. `build_system_from_weights` (:605)
reads a directory in the reference layout (below) and loads every component
present through the converters, registers it on one `VitronSystem` (chat
plus tasks A-G) and accounts it in the system's `MemoryPlan`; a missing
component degrades the system and is reported in the `AssemblyReport`,
never random-initialised. `build_mllm_system` (:573) is the chat half from
explicit paths: an HF Llama/Vicuna dir, a peft LoRA adapter with
`non_lora_trainables.bin`, the HF CLIP vision tower and the LanguageBind
video tower. A missing vision tower is refused unless `allow_random_towers`
(a random tower answers garbage to every image question); at
`geometry="real"` the towers serve in bf16 and SEEM's backbone and pixel
decoder too, as the reference loads them in half precision. The LLM keeps
`attn_impl`'s default (the einsum path), as the JAX assembly does.

Weights directory (the JAX module's layout, its `ACCEPTANCE_MANIFEST`):

    vicuna-7b/              HF llama dir + tokenizer   (required)
    vitron_lora/            peft adapter + non_lora_trainables.bin
    clip_vit_l14/           HF CLIP vision tower       (required unless
                            allow_random_towers)
    languagebind_video/     video tower with temporal attention
    clip_tokenizer/         HF CLIP tokenizer (SEEM language, the diffusion
                            text encoders)
    seem_focall_v1.pt       -> tasks B, E (+ the mask half of C)
    gligen/*.pth            -> task A; *inpaint*.pth -> task C
    t2v/*.pth               UNetSD_T2VBase -> task D
    t2v/vae.pth             ldm AutoencoderKL (else the GLIGEN bundle's VAE)
    t2v/text_encoder/       HF CLIPTextModel dir (open-clip ViT-H text)
    i2vgen/*.pth (+ vae.pth, text_encoder/ as t2v) -> task G
    stablevideo/control_sd15_canny.pth   ControlLDM bundle -> task F
    stablevideo/control_sd15_depth.pth   depth ControlNet
    stablevideo/dpt_hybrid*.pt           MiDaS depth annotator (real geometry)
    stablevideo/<video>/checkpoint       per-video NLA atlases (task F)

Every file is read as the diffusion converters read it: `.pth` / `.pt` files
mapped (`loader.load_torch_pth`, `weights_only`; GLIGEN's bundle and the NLA
checkpoints through `loader.load_torch_bundle`, which imports nothing the
file pickles), each entry moved to `device` and widened there, so no host
copy of a file is made.

Seams the JAX module lacks, for a machine without `transformers`:
`tokenizer` (None: `transformers.AutoTokenizer.from_pretrained(base)`,
imported when called; without the package a `MissingWeightsError` naming
it), `clip_tokenizer` (None: the `clip_tokenizer/` dir through transformers
the same way; without that dir the backends that need it are skipped, as in
JAX), `image_embedder` (task G's global image embedding, ROADMAP C4; JAX
registers none, which gives zeros), `device` (default `cuda`; without a
CUDA device that is an error, never a switch to the CPU) and the system's
`memory_plan`. A mesh over more than one device is not ported (ROADMAP
A16). `NLAAtlasStore` keeps JAX's atlas grid (one grid for the foreground
and background atlases, ROADMAP C4).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


class MissingWeightsError(RuntimeError):
    """A component required for a sound deployment is absent."""


@dataclasses.dataclass
class AssemblyReport:
    """Per-component load ledger: name -> {status, detail}."""

    rows: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)

    def add(self, name: str, status: str, detail: str = "") -> None:
        self.rows[name] = {"status": status, "detail": detail}

    def loaded(self) -> list:
        return [k for k, v in self.rows.items() if v["status"] == "loaded"]

    def summary(self) -> str:
        width = max((len(k) for k in self.rows), default=4)
        lines = [f"{k:{width}s}  {v['status']:8s} {v['detail']}".rstrip()
                 for k, v in self.rows.items()]
        return "\n".join(lines)


def llama_cfg_from_hf(base):
    """LlamaConfig from an HF checkpoint dir's config.json (Vicuna-7B's when
    there is none); param and compute dtypes, and attn_impl, at their
    defaults."""
    from vitron_tpu_torch.models.llm import llama

    cfg_file = pathlib.Path(base) / "config.json"
    if not cfg_file.exists():
        return llama.LlamaConfig.vicuna_7b()
    c = json.loads(cfg_file.read_text())
    return llama.LlamaConfig(
        vocab_size=c.get("vocab_size", 32000),
        hidden_size=c.get("hidden_size", 4096),
        intermediate_size=c.get("intermediate_size", 11008),
        num_layers=c.get("num_hidden_layers", 32),
        num_heads=c.get("num_attention_heads", 32),
        num_kv_heads=c.get("num_key_value_heads", c.get("num_attention_heads", 32)),
        rope_theta=c.get("rope_theta", 10000.0),
        rms_norm_eps=c.get("rms_norm_eps", 1e-5),
        max_seq_len=min(c.get("max_position_embeddings", 4096), 4096))


def vit_cfg_from_hf(clip_dir):
    """ViTConfig from an HF CLIP dir's config.json (None when absent)."""
    from vitron_tpu_torch.models.vision import vit

    cfg_file = pathlib.Path(clip_dir) / "config.json"
    if not cfg_file.exists():
        return None
    c = json.loads(cfg_file.read_text())
    v = c.get("vision_config", c)
    return vit.ViTConfig(
        image_size=v.get("image_size", 224),
        patch_size=v.get("patch_size", 14),
        hidden_size=v.get("hidden_size", 1024),
        num_layers=v.get("num_hidden_layers", 24),
        num_heads=v.get("num_attention_heads", 16),
        intermediate_size=v.get("intermediate_size", 4096))


def _load_state_dir(d):
    """A safetensors-or-torch-bin directory as one state dict (safetensors
    first, the reference's load order)."""
    from vitron_tpu_torch.models.llm import loader

    sd = loader.load_safetensors_dir(d)
    if not sd:
        for f in sorted(pathlib.Path(d).glob("*.bin")):
            sd.update(loader.load_torch_bin(f))
    return sd


def _transformers(what: str, arg: str):
    """The `transformers` module; without it, a MissingWeightsError naming
    the package and the argument that takes its place."""
    try:
        import transformers
    except ImportError as e:
        raise MissingWeightsError(
            f"the tokenizer of {what} needs the `transformers` package, which is not "
            f"installed: pass {arg}=") from e
    return transformers


def auto_tokenizer(base):
    """`transformers.AutoTokenizer.from_pretrained(base)`; without the
    package, a MissingWeightsError that names it."""
    return _transformers(base, "tokenizer").AutoTokenizer.from_pretrained(str(base))


def text_cfg_from_hf(text_dir):
    """clip_text.TextConfig from an HF CLIPTextModel dir's config.json (None
    when absent)."""
    from vitron_tpu_torch.models.diffusion import clip_text

    cfg_file = pathlib.Path(text_dir) / "config.json"
    if not cfg_file.exists():
        return None
    c = json.loads(cfg_file.read_text())
    t = c.get("text_config", c)
    return clip_text.TextConfig(
        vocab_size=t.get("vocab_size", 49408),
        hidden_size=t.get("hidden_size", 768),
        num_layers=t.get("num_hidden_layers", 12),
        num_heads=t.get("num_attention_heads", 12),
        intermediate_size=t.get("intermediate_size", 3072),
        max_length=t.get("max_position_embeddings", 77))


def _load_mllm(base: pathlib.Path, lora: pathlib.Path, clip_dir: pathlib.Path,
               lbv_dir: pathlib.Path, geometry: str, quantize: str,
               allow_random_towers: bool, report: AssemblyReport, device, tokenizer):
    from vitron_tpu_torch.models import vitron_model
    from vitron_tpu_torch.models.llm import loader
    from vitron_tpu_torch.models.vision import loader as vloader
    from vitron_tpu_torch.models.vision import projector, region_extractor, vit

    if not base.is_dir():
        raise MissingWeightsError(f"{base} (HF llama dir) is required")
    tiny = geometry == "tiny"
    llm_cfg = llama_cfg_from_hf(base)
    tower_cfg = vit_cfg_from_hf(clip_dir)
    if tower_cfg is None and not allow_random_towers:
        raise MissingWeightsError(
            f"{clip_dir} (HF CLIP vision tower) is required: "
            "a random-init tower answers garbage for every image question. "
            "Pass allow_random_towers=True only for smoke tests.")
    if not tiny and tower_cfg is not None:
        # bf16 tower serving (the reference loads the towers in fp16)
        tower_cfg = dataclasses.replace(tower_cfg, param_dtype=torch.bfloat16,
                                        compute_dtype=torch.bfloat16)
    kw: Dict[str, Any] = {"llm": llm_cfg}
    if tower_cfg is not None:
        kw["image_tower"] = tower_cfg
        kw["video_tower"] = dataclasses.replace(tower_cfg, add_time_attn=True)
    cfg = vitron_model.VitronConfig.tiny(**kw) if tiny else vitron_model.VitronConfig(**kw)
    # what is not loaded stays random, made from seed 0 on the device
    gen = torch.Generator(device=device).manual_seed(0)

    params: Dict[str, Any] = {"llm": loader.load_pretrained_llama(
        base, llm_cfg, lora_path=lora if lora.is_dir() else None, quantize=quantize,
        device=device)}
    report.add("llm", "loaded",
               f"{base.name}"
               + (f" + LoRA({lora.name})" if lora.is_dir() else " (no LoRA)")
               + (f" quant={quantize}" if quantize else ""))

    for key, d, tcfg in (("image_tower", clip_dir, cfg.image_tower),
                         ("video_tower", lbv_dir, cfg.video_tower)):
        if d.is_dir():
            params[key] = vloader.convert_hf_clip_vision(_load_state_dir(d), tcfg, device=device)
            report.add(key, "loaded", d.name)
        else:
            params[key] = vit.init_params(gen, tcfg, device)
            report.add(key, "missing",
                       f"{d} absent — {key.replace('_', ' ')} stays random init"
                       + ("" if allow_random_towers else " (video understanding degraded)"))

    # adapter-only weights: projector + region extractor (the reference's
    # non_lora_trainables.bin)
    nl: Dict[str, Any] = {}
    if lora.is_dir():
        for f in lora.glob("non_lora_trainables.bin"):
            nl.update(loader.load_torch_bin(f))
        for f in lora.glob("non_lora_trainables.npz"):
            nl.update(dict(np.load(str(f))))
    vdt = cfg.image_tower.param_dtype
    if any("mm_projector" in k for k in nl):
        params["projector"] = projector.convert_hf(nl, device=device)
        report.add("projector", "loaded", "non_lora_trainables")
    else:
        params["projector"] = projector.init_params(
            gen, cfg.vision_hidden, llm_cfg.hidden_size, device, cfg.projector_type, vdt)
        report.add("projector", "missing",
                   "no mm_projector weights — multimodal replies will be untrained")
    if any("region_extractor" in k for k in nl):
        params["region"] = region_extractor.convert_hf(nl, device=device)
        report.add("region_extractor", "loaded", "non_lora_trainables")
    else:
        params["region"] = region_extractor.init_params(
            gen, cfg.vision_hidden, llm_cfg.hidden_size, device, vdt)
        report.add("region_extractor", "missing", "no region weights")

    return params, cfg, tokenizer if tokenizer is not None else auto_tokenizer(base)


def _check_mesh(device: torch.device, mesh) -> None:
    """One device only: more than one device (or any mesh but "auto") is
    not ported (ROADMAP A16). Checked before anything is read."""
    if mesh is None:
        return
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if mesh != "auto" or count > 1:
        raise NotImplementedError(
            f"serving over a mesh ({mesh!r}, {count} {device.type} devices) is not ported "
            f"yet (ROADMAP A16): pass mesh=None")


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for but no CUDA device is available")
    return device


def build_mllm_system(
    base_model: str,
    lora: Optional[str] = None,
    clip_tower: Optional[str] = None,
    video_tower: Optional[str] = None,
    geometry: str = "real",
    quantize: str = "",
    mesh: Any = None,
    allow_random_towers: bool = False,
    device="cuda",
    memory_plan=None,
    tokenizer=None,
) -> Tuple[Any, AssemblyReport]:
    """Chat-only assembly from explicit checkpoint paths -> (VitronSystem,
    AssemblyReport). quantize: "" / "int8" / "int4" weight-only LLM
    quantization (int4 runs every projection and lm_head on the int4
    kernel); geometry "tiny" takes the tiny configs for what is not loaded.
    `memory_plan` is the system's (on a CUDA device by default the card's;
    off the card the caller names its budget)."""
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.system import VitronSystem

    device = resolve_device(device)
    _check_mesh(device, mesh)
    report = AssemblyReport()
    missing = pathlib.Path("/nonexistent")
    params, cfg, tokenizer = _load_mllm(
        pathlib.Path(base_model),
        pathlib.Path(lora) if lora else missing,
        pathlib.Path(clip_tower) if clip_tower else missing,
        pathlib.Path(video_tower) if video_tower else missing,
        geometry, quantize, allow_random_towers, report, device, tokenizer)
    if mesh is not None:  # "auto" on one device: JAX's row
        report.add("mesh", "skipped", "single device — replicated")
    system = VitronSystem(VitronEngine(params, cfg, tokenizer, device=device),
                          memory_plan=memory_plan)
    return system, report


# ------------------------------------------------------------- NLA atlases


def nla_imlp_cfgs():
    """The released NLA IMLP geometries (atlas_utils.py:26-72), by net."""
    from vitron_tpu_torch.models.diffusion.stablevideo import IMLPConfig

    return {"fg": IMLPConfig(input_dim=3, output_dim=2, num_layers=6, positional_dim=0,
                             skip_layers=()),
            "bg": IMLPConfig(input_dim=3, output_dim=2, num_layers=4, positional_dim=0,
                             skip_layers=()),
            "alpha": IMLPConfig(input_dim=3, output_dim=1, num_layers=8, positional_dim=5,
                                skip_layers=()),
            "atlas": IMLPConfig(input_dim=2, output_dim=3, num_layers=8, positional_dim=10,
                                skip_layers=(4, 7))}


class NLAAtlasStore:
    """Resident per-video Neural-Layered-Atlas bundles for task F.

    The reference expects a precomputed NLA checkpoint per editable video
    (StableVideo/app.py:67-76, atlas_utils.py:75-80) and rebuilds everything
    per request; here each <video>/checkpoint is converted on `device` once
    per (video, frames, height, width) and the bundle cached. The atlas
    colours are evaluated on one `atlas_res` grid over [-1, 1]^2 for both
    atlases, as the JAX store does (ROADMAP C4)."""

    def __init__(self, root, atlas_res: int = 256, device="cuda"):
        self.root = pathlib.Path(root)
        self.atlas_res = atlas_res
        self.device = resolve_device(device)
        self.videos = sorted(d.name for d in self.root.iterdir()
                             if d.is_dir() and (d / "checkpoint").exists()
                             ) if self.root.is_dir() else []
        self._cache: Dict[Any, Dict[str, Any]] = {}

    def bundle(self, name: str, t: int, h: int, w: int) -> Dict[str, Any]:
        """{"fg_atlas", "bg_atlas" [R, R, 3] in [0, 1], "fg_uv", "bg_uv"
        [t, h, w, 2], "alpha" [t, h, w, 1]} as numpy arrays."""
        from vitron_tpu_torch.models.diffusion import stablevideo as sv
        from vitron_tpu_torch.models.llm.loader import load_torch_bundle

        key = (name, t, h, w)
        if key in self._cache:
            return self._cache[key]
        vdir = self.root / name
        ckpt = load_torch_bundle(vdir / "checkpoint")
        nets = {k: sv.convert_imlp_torch(ckpt[entry], device=self.device)
                for k, entry in (("fg", "model_F_mapping1_state_dict"),
                                 ("bg", "model_F_mapping2_state_dict"),
                                 ("alpha", "model_F_alpha_state_dict"),
                                 ("atlas", "F_atlas_state_dict"))}
        meta = {}
        if (vdir / "config.json").exists():
            meta = json.loads((vdir / "config.json").read_text())
        cfgs = nla_imlp_cfgs()
        fg_uv, bg_uv, alpha = sv.atlas_uvs(nets["fg"], nets["bg"], nets["alpha"], cfgs, t, h, w,
                                           max_frames=meta.get("maximum_number_of_frames", t))
        r = self.atlas_res
        gy, gx = np.meshgrid(np.linspace(-1, 1, r), np.linspace(-1, 1, r), indexing="ij")
        pts = torch.as_tensor(np.stack([gx, gy], -1), dtype=torch.float32, device=self.device)
        colors = 0.5 * (sv.imlp_forward(nets["atlas"], cfgs["atlas"], pts).cpu().numpy() + 1.0)
        out = {"fg_atlas": np.clip(colors, 0.0, 1.0), "bg_atlas": np.clip(colors, 0.0, 1.0),
               "fg_uv": fg_uv.cpu().numpy(), "bg_uv": bg_uv.cpu().numpy(),
               "alpha": alpha.cpu().numpy()}
        self._cache[key] = out
        return out

    def provider(self):
        """atlas_provider(video, extra) for `register_video_editor`: the bundle
        named extra['atlas'] (default: the first video), at the request
        video's frames and size."""

        def provide(video, extra):
            if not self.videos:
                raise FileNotFoundError(f"no NLA atlas checkpoints under {self.root}")
            name = (extra or {}).get("atlas", self.videos[0])
            if name not in self.videos:
                raise FileNotFoundError(f"unknown atlas {name!r}; have {self.videos}")
            t = len(video) if video is not None else 8
            h, w = video[0].shape[:2] if video is not None else (256, 256)
            return self.bundle(name, t, h, w)

        return provide


# ----------------------------------------------------------- the A-G backends


def _clip_tokenizer(w: pathlib.Path, given=None):
    """The CLIP tokenizer: `given`, else the `clip_tokenizer/` dir's through
    transformers (a MissingWeightsError naming the package without it), else
    None."""
    if given is not None:
        return given
    d = w / "clip_tokenizer"
    if not d.is_dir():
        return None
    transformers = _transformers(d, "clip_tokenizer")
    try:
        return transformers.AutoTokenizer.from_pretrained(str(d))
    except (OSError, ValueError):  # a slow-only dir AutoTokenizer cannot map
        return transformers.CLIPTokenizer.from_pretrained(str(d))


def _register_seem(system, w: pathlib.Path, geometry: str, clip_tok, report: AssemblyReport,
                   device) -> None:
    from vitron_tpu_torch.models.llm.loader import load_torch_pth
    from vitron_tpu_torch.models.seem import model as seem_model

    pt = w / "seem_focall_v1.pt"
    if not pt.exists():
        report.add("seem", "missing", f"{pt.name} absent — tasks B/E off")
        return
    if clip_tok is None:
        report.add("seem", "skipped", "clip_tokenizer/ absent (needed for referring text)")
        return
    tiny = geometry == "tiny"
    scfg = seem_model.SeemConfig.tiny() if tiny else seem_model.SeemConfig()
    params = seem_model.convert_torch(load_torch_pth(pt), scfg, device=device)
    system.register_seem(params, scfg, clip_tok, compute_dtype="float32" if tiny else "bfloat16")
    report.add("seem", "loaded", f"{pt.name} -> B, E (+C masks)")


def _register_gligen(system, w: pathlib.Path, geometry: str, clip_tok, report: AssemblyReport,
                     device):
    """-> the VAE params or None (the shared KL-f8 VAE, which t2v and i2vgen
    take when they ship none of their own)."""
    from vitron_tpu_torch.models.diffusion import gligen_pipeline as gp

    gdir = w / "gligen"
    pths = sorted(gdir.glob("*.pth")) if gdir.is_dir() else []
    gen = [p for p in pths if "inpaint" not in p.name.lower()]
    inp = [p for p in pths if "inpaint" in p.name.lower()]
    if not gen:
        report.add("gligen", "missing", f"{gdir}/*.pth absent — tasks A/C off")
        return None
    if clip_tok is None:
        report.add("gligen", "skipped", "clip_tokenizer/ absent")
        return None
    gcfg = gp.GligenConfig.tiny() if geometry == "tiny" else gp.GligenConfig()
    unet_p, vae_p, text_p = gp.load_gligen_checkpoint(gen[0], gcfg, device=device)
    inpaint_p = None
    if inp:
        inpaint_p = gp.load_gligen_checkpoint(inp[0], gcfg, inpaint=True, device=device)[0]
    system.register_gligen(gp.GligenPipeline(gcfg, unet_p, vae_p, text_p,
                                             inpaint_unet_params=inpaint_p, tokenizer=clip_tok))
    report.add("gligen", "loaded", f"{gen[0].name} -> A"
               + (f"; {inp[0].name} -> C" if inp else " (no inpaint bundle)"))
    return vae_p


def _video_components(w: pathlib.Path, name: str, geometry: str, fallback_vae,
                      report: AssemblyReport, device):
    """(file name, unet params, unet cfg, vae params, vae cfg, text params,
    text cfg, the VAE's source) of t2v/ or i2vgen/, or None with the reason
    reported. Every part is found before any is read."""
    from vitron_tpu_torch.models.diffusion import clip_text, unet_sd_video, vae
    from vitron_tpu_torch.models.llm.loader import load_torch_pth

    vdir = w / name
    pths = sorted(p for p in (vdir.glob("*.pth") if vdir.is_dir() else [])
                  if p.name != "vae.pth")
    if not pths:
        report.add(name, "missing", f"{vdir}/*.pth absent")
        return None
    tdir = vdir / "text_encoder"
    tcfg = text_cfg_from_hf(tdir)
    if tcfg is None:
        report.add(name, "skipped", f"{tdir}/ (HF CLIPTextModel) absent — cannot condition")
        return None
    vae_file = vdir / "vae.pth"
    if not vae_file.exists() and fallback_vae is None:
        report.add(name, "skipped", f"{vae_file} absent and no GLIGEN VAE to share")
        return None
    tiny = geometry == "tiny"
    variant = "i2vgen" if name == "i2vgen" else "t2v"
    if tiny:
        ucfg = unet_sd_video.UNetSDVideoConfig.tiny(variant)
    else:
        ucfg = (unet_sd_video.UNetSDVideoConfig.i2vgen_xl() if variant == "i2vgen"
                else unet_sd_video.UNetSDVideoConfig.t2v())
    unet_p = unet_sd_video.convert_torch(load_torch_pth(pths[0]), ucfg, device=device)
    text_p = clip_text.convert_hf_clip_text(_load_state_dir(tdir), tcfg, device=device)
    vcfg = vae.VAEConfig.tiny() if tiny else vae.VAEConfig.sd()
    if vae_file.exists():
        vae_p = vae.convert_ldm_vae(load_torch_pth(vae_file), vcfg, device=device)
        vae_src = "own vae.pth"
    else:
        vae_p, vae_src = fallback_vae, "shared GLIGEN KL-f8 VAE"
    return pths[0].name, unet_p, ucfg, vae_p, vcfg, text_p, tcfg, vae_src


def _register_t2v(system, w: pathlib.Path, geometry: str, clip_tok, fallback_vae,
                  report: AssemblyReport, device) -> None:
    from vitron_tpu_torch.models.diffusion import video_pipelines as vp

    if clip_tok is None:
        if (w / "t2v").is_dir():
            report.add("t2v", "skipped", "clip_tokenizer/ absent")
        return
    parts = _video_components(w, "t2v", geometry, fallback_vae, report, device)
    if parts is None:
        return
    fname, unet_p, ucfg, vae_p, vcfg, text_p, tcfg, vae_src = parts
    make = vp.Text2VideoConfig.tiny if geometry == "tiny" else vp.Text2VideoConfig
    system.register_text2video(vp.Text2VideoPipeline(
        make(unet=ucfg, vae=vcfg, text=tcfg), unet_p, vae_p, text_p, tokenizer=clip_tok))
    report.add("t2v", "loaded", f"{fname} -> D ({vae_src})")


def _register_i2vgen(system, w: pathlib.Path, geometry: str, clip_tok, fallback_vae,
                     report: AssemblyReport, device, image_embedder=None) -> None:
    from vitron_tpu_torch.models.diffusion import video_pipelines as vp

    if clip_tok is None:
        if (w / "i2vgen").is_dir():
            report.add("i2vgen", "skipped", "clip_tokenizer/ absent")
        return
    parts = _video_components(w, "i2vgen", geometry, fallback_vae, report, device)
    if parts is None:
        return
    fname, unet_p, ucfg, vae_p, vcfg, text_p, tcfg, vae_src = parts
    make = vp.Image2VideoConfig.tiny if geometry == "tiny" else vp.Image2VideoConfig
    # without an image embedder the global CLIP image embedding is zeros,
    # as the JAX assembly registers it (ROADMAP C4)
    system.register_image2video(vp.Image2VideoPipeline(
        make(unet=ucfg, vae=vcfg, text=tcfg), unet_p, vae_p, text_p, tokenizer=clip_tok,
        image_embedder=image_embedder))
    report.add("i2vgen", "loaded", f"{fname} -> G ({vae_src})")


def _register_stablevideo(system, w: pathlib.Path, geometry: str, clip_tok,
                          report: AssemblyReport, device) -> None:
    from vitron_tpu_torch.models.diffusion import (clip_text, controlnet, depth, stablevideo,
                                                   unet2d, vae)
    from vitron_tpu_torch.models.llm.loader import load_torch_pth

    svdir = w / "stablevideo"
    canny = svdir / "control_sd15_canny.pth"
    tiny = geometry == "tiny"
    # the atlas size is the editor's native edit size: the background atlas
    # is the image edit_image denoises (SD works at 512^2, the tiny UNet at
    # 32^2)
    store = NLAAtlasStore(svdir, atlas_res=32 if tiny else 512, device=device)
    if not canny.exists():
        report.add("stablevideo", "missing" if not store.videos else "skipped",
                   f"{canny.name} absent — task F off"
                   + (f" ({len(store.videos)} NLA atlases present)" if store.videos else ""))
        return
    if clip_tok is None:
        report.add("stablevideo", "skipped", "clip_tokenizer/ absent")
        return
    if not store.videos:
        report.add("stablevideo", "skipped",
                   "editor weights present but no <video>/checkpoint NLA atlases")
        return
    # the ControlLDM bundle holds the UNet, the ControlNet, the VAE and the
    # text encoder (cldm/model.py; StableVideo/app.py:50-66)
    sd = load_torch_pth(canny)
    ucfg = unet2d.UNetConfig.tiny() if tiny else unet2d.UNetConfig.sd_v1()
    vcfg = vae.VAEConfig.tiny() if tiny else vae.VAEConfig.sd()
    tcfg = (clip_text.TextConfig.tiny(hidden_size=ucfg.context_dim, num_heads=2,
                                      intermediate_size=32) if tiny else clip_text.TextConfig())
    kw: Dict[str, Any] = {}
    detail = [canny.name]
    dep = svdir / "control_sd15_depth.pth"
    if dep.exists():
        kw["depth_control_params"] = controlnet.convert_torch(load_torch_pth(dep), ucfg,
                                                              device=device)
        detail.append(dep.name)
    dpt = sorted(svdir.glob("dpt_hybrid*.pt"))
    if dpt and not tiny:
        dcfg = depth.DPTConfig.dpt_hybrid()
        kw["depth_annotator"] = (depth.convert_midas_torch(load_torch_pth(dpt[0]), dcfg,
                                                           device=device), dcfg)
        detail.append(dpt[0].name)
    editor = stablevideo.StableVideoEditor(
        ucfg, unet2d.convert_ldm_unet(sd, ucfg, device=device),
        controlnet.convert_torch(sd, ucfg, device=device), vcfg,
        vae.convert_ldm_vae(sd, vcfg, device=device), tcfg,
        clip_text.convert_hf_clip_text(sd, tcfg, device=device), tokenizer=clip_tok, **kw)
    system.register_video_editor(editor, atlas_provider=store.provider())
    report.add("stablevideo", "loaded", f"{'+'.join(detail)} + atlases {store.videos} -> F")


def build_system_from_weights(
    weights_dir: str,
    geometry: str = "real",
    quantize: str = "",
    mesh: Any = None,
    allow_random_towers: bool = False,
    device="cuda",
    memory_plan=None,
    tokenizer=None,
    clip_tokenizer=None,
    image_embedder=None,
) -> Tuple[Any, AssemblyReport]:
    """A weights dir (the module docstring's layout) -> (the VitronSystem
    with every component present registered, AssemblyReport), resident on
    `device`.

    geometry: "real" expects the released checkpoints' shapes, "tiny" the
    synthetic test shapes. quantize: "" / "int8" / "int4" weight-only LLM
    quantization. `tokenizer` and `clip_tokenizer` replace the ones read
    from `vicuna-7b/` and `clip_tokenizer/` (both through transformers);
    `image_embedder` gives task G its global image embedding;
    `memory_plan` is the system's (on a CUDA device by default the card's;
    off the card the caller names its budget)."""
    from vitron_tpu_torch.runtime.engine import VitronEngine
    from vitron_tpu_torch.runtime.system import VitronSystem

    device = resolve_device(device)
    _check_mesh(device, mesh)
    w = pathlib.Path(weights_dir)
    if not w.is_dir():
        raise MissingWeightsError(f"weights dir {w} does not exist")
    # before anything is read: a missing package fails here, not after the LLM
    clip_tok = _clip_tokenizer(w, clip_tokenizer)
    report = AssemblyReport()
    params, cfg, tokenizer = _load_mllm(
        w / "vicuna-7b", w / "vitron_lora", w / "clip_vit_l14", w / "languagebind_video",
        geometry, quantize, allow_random_towers, report, device, tokenizer)
    system = VitronSystem(VitronEngine(params, cfg, tokenizer, device=device),
                          memory_plan=memory_plan)
    if mesh is not None:  # "auto" on one device: JAX's row
        report.add("mesh", "skipped", "single device — replicated")
    if clip_tok is None:
        report.add("clip_tokenizer", "missing",
                   "clip_tokenizer/ absent — SEEM/GLIGEN/video backends skipped")
    else:
        report.add("clip_tokenizer", "loaded", "" if clip_tokenizer is None else "given")
    _register_seem(system, w, geometry, clip_tok, report, device)
    shared_vae = _register_gligen(system, w, geometry, clip_tok, report, device)
    _register_t2v(system, w, geometry, clip_tok, shared_vae, report, device)
    _register_i2vgen(system, w, geometry, clip_tok, shared_vae, report, device, image_embedder)
    _register_stablevideo(system, w, geometry, clip_tok, report, device)
    return system, report
