"""Chat assembly from checkpoint files, in PyTorch.

Port of the chat half of `vitron_tpu/runtime/assembly.py`:
`build_mllm_system` (:573) turns explicit checkpoint paths (the reference's
inference_image.py load: an HF Llama/Vicuna dir, a peft LoRA
adapter with `non_lora_trainables.bin`, the HF CLIP vision tower and the
LanguageBind video tower) into a chat-only `VitronSystem`, with an
`AssemblyReport` of what loaded. A missing vision tower is refused unless
`allow_random_towers` (a random tower answers garbage to every image
question); at `geometry="real"` the towers serve in bf16, as the reference
loads them in half precision. The LLM keeps `attn_impl`'s default (the
einsum path), as the JAX assembly does.

Two seams the JAX module lacks, for a machine without `transformers`:
`tokenizer` (None: `transformers.AutoTokenizer.from_pretrained(base)`,
imported when called; without the package that is a `MissingWeightsError`
naming it) and `device` (default `cuda`; without a CUDA device that is an
error, never a switch to the CPU), with the system's `memory_plan`. A mesh
over more than one device is not ported (ROADMAP A16). The full A-G
assembly (`build_system_from_weights`, the `_register_*` functions,
`NLAAtlasStore`) waits for the diffusion and SEEM converters (ROADMAP A14).
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


def auto_tokenizer(base):
    """`transformers.AutoTokenizer.from_pretrained(base)`; without the
    package, a MissingWeightsError that names it."""
    try:
        import transformers
    except ImportError as e:
        raise MissingWeightsError(
            f"the tokenizer of {base} needs the `transformers` package, which is not "
            f"installed: pass tokenizer= to build_mllm_system") from e
    return transformers.AutoTokenizer.from_pretrained(str(base))


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
