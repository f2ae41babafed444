"""Parity of the port's A-G assembly from one weights directory with the JAX
package's on the CPU: `runtime/assembly.build_system_from_weights(...,
geometry="tiny", device="cpu")` against JAX's on the same directory.

The directory is built in-process. Its HF parts come from
`tests/synthetic_weights` (`build_llama_lora_clip`, `build_clip_tokenizer`);
its reference-layout parts from the port's writers (never from helpers that
need the vendored reference): seem_focall_v1.pt (`synthetic.seem_state_dict`
on a numpy-valued tree), GLIGEN's two bundles (`synthetic.gligen_bundle`;
JAX's loader cannot read one with a config of a class it cannot import,
which `test_torch_diffusion_convert.py` holds for the port), the t2v and i2vgen
UNets and t2v's vae.pth (`synthetic.reference_state_dict` on the
converters' key maps), their HF CLIPTextModel dirs (the same writer under
'text_model.' and a config.json), the ControlLDM canny bundle
(`synthetic.controlldm_state_dict`), the depth ControlNet, and one NLA
checkpoint (`synthetic.imlp_state_dict` at the released IMLP geometries).

Held: the same `AssemblyReport` rows and registered tasks, also with each
component removed in turn; tasks B and E on the loaded SEEM against JAX's
handlers (masks equal but where the logit is within 1e-4 of 0, as
`test_torch_seem.py` holds them); A, C, D, F and G routed on the port's
system; `--weights` through the port's CLI and server (exit codes as JAX's
CLI, /health listing A-G); the `SystemConfig` JSON round trip;
`run_acceptance_suite(geometry="tiny")` with JAX's rows, statuses and pass
verdicts (hashes are of each framework's outputs and are not compared); the
ASR hook; and the engine-less system's device.
"""
import argparse
import dataclasses
import json
import os
import pathlib
import sys
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_seem import _logit_guard, _same_mask
from test_torch_seem_convert import _numpy_tree
from vitron_tpu_torch.apps import cli as tcli
from vitron_tpu_torch.apps import eval_suite as teval
from vitron_tpu_torch.apps import serve as tserve
from vitron_tpu_torch.core import config as tconfig
from vitron_tpu_torch.media import asr as tasr
from vitron_tpu_torch.models.diffusion import clip_text, controlnet, gligen_pipeline, synthetic
from vitron_tpu_torch.models.diffusion import stablevideo as sv
from vitron_tpu_torch.models.diffusion import unet2d, unet_sd_video, vae
from vitron_tpu_torch.models.diffusion.layers import KeyMap
from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves, reference_state_dict
from vitron_tpu_torch.models.seem import model as tseem
from vitron_tpu_torch.runtime import assembly as tasm
from vitron_tpu_torch.runtime import memory_plan
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HOST = MemoryPlan(budget_bytes=8 << 30)
ALL = {"llm", "image_tower", "video_tower", "projector", "region_extractor", "clip_tokenizer",
       "seem", "gligen", "t2v", "i2vgen", "stablevideo"}
# the t2v / i2vgen text encoders: the tiny UNets' context width (1024)
VIDEO_TEXT = clip_text.TextConfig(vocab_size=128, hidden_size=1024, num_layers=2, num_heads=4,
                                  intermediate_size=128, max_length=16)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _live(tree, seed: int):
    return fill_zero_leaves(tree, _gen(seed))


def _write_text_encoder(d: pathlib.Path, seed: int) -> None:
    """An HF CLIPTextModel dir: config.json and pytorch_model.bin."""
    d.mkdir(parents=True)
    tree = _live(clip_text.init_params(_gen(seed), VIDEO_TEXT, "cpu"), seed)
    torch.save(reference_state_dict(clip_text.convert_hf_clip_text(KeyMap(), VIDEO_TEXT), tree,
                                    "text_model."), d / "pytorch_model.bin")
    (d / "config.json").write_text(json.dumps({
        "architectures": ["CLIPTextModel"], "vocab_size": VIDEO_TEXT.vocab_size,
        "hidden_size": VIDEO_TEXT.hidden_size, "num_hidden_layers": VIDEO_TEXT.num_layers,
        "num_attention_heads": VIDEO_TEXT.num_heads,
        "intermediate_size": VIDEO_TEXT.intermediate_size,
        "max_position_embeddings": VIDEO_TEXT.max_length, "hidden_act": "quick_gelu"}))


def build_weights(w: pathlib.Path) -> pathlib.Path:
    """The tiny weights directory of the module docstring under `w`."""
    from tests.synthetic_weights import build_clip_tokenizer, build_llama_lora_clip

    build_llama_lora_clip(w, "tiny")
    build_clip_tokenizer(w)
    seem_cfg = tseem.SeemConfig.tiny()
    torch.save(synthetic.seem_state_dict(
        _numpy_tree(tseem.init_params(_gen(1), seem_cfg, "cpu"), 1), seem_cfg),
        w / "seem_focall_v1.pt")

    gcfg = gligen_pipeline.GligenConfig.tiny()
    (w / "gligen").mkdir()
    vae_tree = _live(vae.init_params(_gen(3), gcfg.vae, "cpu"), 3)
    text = _live(clip_text.init_params(_gen(4), gcfg.text, "cpu"), 4)
    for name, inpaint, seed in (("gligen_generation", False, 5), ("gligen_inpainting", True, 6)):
        ucfg = dataclasses.replace(gcfg.unet, in_channels=9 if inpaint else 4)
        unet = _live(unet2d.init_params(_gen(seed), ucfg, "cpu"), seed)
        torch.save(synthetic.gligen_bundle(unet, vae_tree, text, gcfg, inpaint),
                   w / "gligen" / f"{name}.pth")

    for name, seed in (("t2v", 7), ("i2vgen", 8)):
        ucfg = unet_sd_video.UNetSDVideoConfig.tiny(name)
        (w / name).mkdir()
        unet = _live(unet_sd_video.init_params(_gen(seed), ucfg, "cpu"), seed)
        torch.save(reference_state_dict(unet_sd_video.convert_torch(KeyMap(), ucfg), unet),
                   w / name / f"{name}_unet.pth")
        _write_text_encoder(w / name / "text_encoder", seed + 10)
    # t2v ships its own VAE, i2vgen shares GLIGEN's
    vcfg = vae.VAEConfig.tiny()
    torch.save(reference_state_dict(vae.convert_ldm_vae(KeyMap(), vcfg),
                                    _live(vae.init_params(_gen(9), vcfg, "cpu"), 9)),
               w / "t2v" / "vae.pth")

    sdir = w / "stablevideo"
    (sdir / "bear").mkdir(parents=True)
    ucfg = unet2d.UNetConfig.tiny()
    tcfg = clip_text.TextConfig.tiny(hidden_size=ucfg.context_dim, num_heads=2,
                                     intermediate_size=32)
    torch.save(synthetic.controlldm_state_dict(
        _live(unet2d.init_params(_gen(10), ucfg, "cpu", grounding=False), 10),
        _live(controlnet.init_params(_gen(11), ucfg, "cpu"), 11),
        _live(vae.init_params(_gen(12), vcfg, "cpu"), 12),
        _live(clip_text.init_params(_gen(13), tcfg, "cpu"), 13), ucfg, vcfg, tcfg),
        sdir / "control_sd15_canny.pth")
    torch.save(reference_state_dict(controlnet.convert_torch(KeyMap(), ucfg),
                                    _live(controlnet.init_params(_gen(14), ucfg, "cpu"), 14),
                                    "control_model."), sdir / "control_sd15_depth.pth")
    nets = {k: sv.imlp_init(_gen(15 + i), c, "cpu")
            for i, (k, c) in enumerate(tasm.nla_imlp_cfgs().items())}
    torch.save({"model_F_mapping1_state_dict": synthetic.imlp_state_dict(nets["fg"]),
                "model_F_mapping2_state_dict": synthetic.imlp_state_dict(nets["bg"]),
                "model_F_alpha_state_dict": synthetic.imlp_state_dict(nets["alpha"]),
                "F_atlas_state_dict": synthetic.imlp_state_dict(nets["atlas"])},
               sdir / "bear" / "checkpoint")
    (sdir / "bear" / "config.json").write_text(json.dumps({"maximum_number_of_frames": 8}))
    return w


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return build_weights(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def built(weights):
    """(JAX system, JAX report, port system, port report) on the full dir."""
    from vitron_tpu.runtime import assembly as jasm

    jsys, jrep = jasm.build_system_from_weights(str(weights), geometry="tiny")
    tsys, trep = tasm.build_system_from_weights(str(weights), geometry="tiny", device="cpu",
                                                memory_plan=MemoryPlan(budget_bytes=8 << 30))
    return jsys, jrep, tsys, trep


def test_report_and_tasks_match_jax(built):
    jsys, jrep, tsys, trep = built
    assert trep.rows == jrep.rows and trep.summary() == jrep.summary()
    assert set(trep.loaded()) == ALL, trep.summary()
    assert set(tsys.registry.available()) == set(jsys.registry.available()) == set("ABCDEFG")
    assert trep.rows["t2v"]["detail"].endswith("(own vae.pth)")
    assert trep.rows["i2vgen"]["detail"].endswith("(shared GLIGEN KL-f8 VAE)")
    plan = tsys.memory_plan.entries
    assert {"llm+towers", "seem", "gligen", "text2video", "image2video",
            "video_editor"} <= set(plan) and all(plan.values())


def _without(weights: pathlib.Path, dst: pathlib.Path, drop: str) -> pathlib.Path:
    """A dir of symlinks to `weights` without the relative path `drop`."""
    def link(src: pathlib.Path, out: pathlib.Path, rel: str) -> None:
        out.mkdir(parents=True, exist_ok=True)
        for child in src.iterdir():
            r = f"{rel}{child.name}"
            if r == drop:
                continue
            if child.is_dir() and drop.startswith(r + "/"):
                link(child, out / child.name, r + "/")
            else:
                (out / child.name).symlink_to(child)

    link(weights, dst, "")
    return dst


REMOVED = ["seem_focall_v1.pt", "gligen", "gligen/gligen_inpainting.pth", "t2v",
           "t2v/text_encoder", "t2v/vae.pth", "i2vgen", "stablevideo/control_sd15_canny.pth",
           "stablevideo/bear", "stablevideo/control_sd15_depth.pth", "clip_tokenizer",
           "languagebind_video", "vitron_lora"]


@pytest.mark.parametrize("drop", REMOVED)
def test_component_removed_matches_jax(weights, tmp_path, drop):
    """Each component removed in turn: JAX's rows and registered tasks."""
    from vitron_tpu.runtime import assembly as jasm

    w = _without(weights, tmp_path / "w", drop)
    jsys, jrep = jasm.build_system_from_weights(str(w), geometry="tiny")
    tsys, trep = tasm.build_system_from_weights(str(w), geometry="tiny", device="cpu",
                                                memory_plan=MemoryPlan(budget_bytes=8 << 30))
    assert trep.rows == jrep.rows
    assert set(tsys.registry.available()) == set(jsys.registry.available())
    assert len(trep.loaded()) < len(ALL) or drop.endswith(("vae.pth", "inpainting.pth",
                                                          "depth.pth"))


def test_refusals(weights, tmp_path, monkeypatch):
    """No dir, no CLIP tower (JAX's refusal; allow_random_towers builds), a
    clip_tokenizer/ dir without transformers (a MissingWeightsError naming
    the package, before anything is read), a given CLIP tokenizer."""
    from vitron_tpu.runtime import assembly as jasm

    with pytest.raises(tasm.MissingWeightsError, match="does not exist"):
        tasm.build_system_from_weights(str(tmp_path / "absent"), device="cpu", memory_plan=HOST)
    w = _without(weights, tmp_path / "w", "clip_vit_l14")
    with pytest.raises(jasm.MissingWeightsError, match="clip"):
        jasm.build_system_from_weights(str(w), geometry="tiny")
    with pytest.raises(tasm.MissingWeightsError, match="HF CLIP vision tower"):
        tasm.build_system_from_weights(str(w), geometry="tiny", device="cpu", memory_plan=HOST)
    _, jrep = jasm.build_system_from_weights(str(w), geometry="tiny", allow_random_towers=True)
    _, trep = tasm.build_system_from_weights(str(w), geometry="tiny", device="cpu",
                                             memory_plan=HOST, allow_random_towers=True)
    assert trep.rows == jrep.rows and trep.rows["image_tower"]["status"] == "missing"
    stub = synthetic.StubClipTokenizer(128)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(tasm.MissingWeightsError, match="transformers"):
        tasm.build_system_from_weights(str(weights), geometry="tiny", device="cpu",
                                       memory_plan=HOST, tokenizer=tcli.DemoTokenizer())
    tsys, trep = tasm.build_system_from_weights(
        str(weights), geometry="tiny", device="cpu", memory_plan=HOST,
        tokenizer=tcli.DemoTokenizer(), clip_tokenizer=stub,
        image_embedder=synthetic.StubImageEmbedder(16))
    assert trep.rows["clip_tokenizer"] == {"status": "loaded", "detail": "given"}
    assert set(trep.loaded()) == ALL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tasm.build_system_from_weights(str(weights), geometry="tiny")


IMAGE = np.random.RandomState(0).randint(0, 256, (64, 64, 3), np.uint8)


def test_task_b_matches_jax(built, monkeypatch):
    """Task B (text) on the loaded SEEM: JAX's mask but where the port's
    logit is within 1e-4 of 0, the same overlay."""
    from vitron_tpu.runtime.router import route_model_output

    jsys, _, tsys, _ = built
    reply = "<module>B</module><instruction>the main object</instruction>"
    want = route_model_output(jsys.registry, reply, image=IMAGE)
    logits = _logit_guard(monkeypatch)
    with torch.no_grad():
        got = tsys.route(reply, image=IMAGE)
    assert got["status"] == want["status"] == "ok" and got["task"] == want["task"]
    _same_mask(got["mask"], np.asarray(want["mask"]), logits[-1])
    assert got["mask"].shape == IMAGE.shape[:2]


def test_task_e_matches_jax(built):
    from vitron_tpu.runtime.router import route_model_output

    jsys, _, tsys, _ = built
    rs = np.random.RandomState(1)
    video = rs.randint(0, 256, (3, 64, 64, 3), np.uint8)
    stroke = np.zeros((64, 64), bool)
    stroke[16:44, 12:40] = True
    reply = "<module>E</module><instruction>track the object</instruction>"
    want = route_model_output(jsys.registry, reply, video=video, sketch_mask=stroke)
    with torch.no_grad():
        got = tsys.route(reply, video=video, sketch_mask=stroke)
    assert got["status"] == want["status"] == "ok"
    assert got["masks"].shape == np.asarray(want["masks"]).shape == (3, 16, 16)
    np.testing.assert_array_equal(got["masks"], np.asarray(want["masks"]))


ROUTES = {
    "A": ("<module>A</module><instruction>prompt: a red cube on grass</instruction>", {},
          "image", (32, 32, 3)),
    "C": ("<module>C</module><instruction>edit: a blue sky</instruction>", {"image": IMAGE},
          "image", (32, 32, 3)),
    "D": ("<module>D</module><instruction>prompt: a dog running</instruction>", {}, "video",
          (4, 16, 16, 3)),
    "F": ("<module>F</module><instruction>foreground: a polar bear</instruction>"
          "<instruction>background: on the moon</instruction>",
          {"video": np.stack([IMAGE[:32, :32], IMAGE[32:, 32:]])}, "video", (2, 32, 32, 3)),
    "G": ("<module>G</module><instruction>prompt: animate this</instruction>",
          {"image": IMAGE[:16, :16]}, "video", (4, 16, 16, 3)),
}


@pytest.mark.parametrize("task", list(ROUTES))
def test_route_runs_on_the_assembled_system(built, task):
    """A, C (SEEM's mask into the inpainting UNet), D (t2v's own VAE), F
    (the NLA store's atlases), G (the shared VAE): an answer of the task's
    shape."""
    _, _, tsys, _ = built
    reply, media, key, shape = ROUTES[task]
    with torch.no_grad():
        out = tsys.route(reply, **media)
    assert out["status"] == "ok", out
    assert out[key].shape == shape and out[key].dtype == np.uint8


def test_chat_on_the_assembled_system(built):
    from vitron_tpu_torch.runtime.generation import SamplingConfig

    _, _, tsys, _ = built
    out = tsys.chat("what is in this image ?", image=IMAGE,
                    sampling=SamplingConfig(greedy=True, max_new_tokens=4, eos_ids=()))
    assert out["status"] in ("chat", "ok") and isinstance(out["reply"]["raw"], str)


def test_nla_store_matches_jax(weights):
    """The atlas bundle of the stored checkpoint, at 2 frames of 24x24:
    JAX's within float32 noise; the same grid for both atlases (C4); the
    card by default."""
    from vitron_tpu.runtime import assembly as jasm

    want = jasm.NLAAtlasStore(weights / "stablevideo", atlas_res=16).bundle("bear", 2, 24, 24)
    store = tasm.NLAAtlasStore(weights / "stablevideo", atlas_res=16, device="cpu")
    if not torch.cuda.is_available():  # the store's device is the card unless asked otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tasm.NLAAtlasStore(weights / "stablevideo")
    got = store.bundle("bear", 2, 24, 24)
    assert store.bundle("bear", 2, 24, 24) is got and store.videos == ["bear"]
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["fg_atlas"], got["bg_atlas"])
    with pytest.raises(FileNotFoundError, match="unknown atlas"):
        store.provider()(None, {"atlas": "absent"})


def _cli_flags(w, *extra):
    return ["--weights", str(w), "--geometry", "tiny", "--mesh", "none", "--greedy",
            "--max-new-tokens", "4", "--prompt", "what is in this image ?", *extra]


def test_cli_and_serve_weights_exit_codes(weights, tmp_path, capsys, monkeypatch):
    """`--weights` through the port's CLI: exit 0 and a reply, as JAX's CLI;
    without the CLIP tower exit 2 naming it in both; the server's `main`
    exits 2 with the same reason."""
    from PIL import Image

    from vitron_tpu.apps import cli as jcli
    import vitron_tpu.utils.compile_cache as jcc

    monkeypatch.setattr(jcc, "enable_compile_cache", lambda *a, **k: None)
    np.save(tmp_path / "x.npy", IMAGE)
    Image.fromarray(IMAGE).save(tmp_path / "x.png")
    assert tcli.main(_cli_flags(weights, "--device", "cpu", "--image",
                                str(tmp_path / "x.npy"))) == 0
    out = capsys.readouterr()
    assert "[reply]" in out.out and "stablevideo" in out.err
    assert jcli.main(_cli_flags(weights, "--cpu", "--image", str(tmp_path / "x.png"))) == 0
    assert "[reply]" in capsys.readouterr().out
    w = _without(weights, tmp_path / "w", "clip_vit_l14")
    assert tcli.main(_cli_flags(w, "--device", "cpu")) == 2
    assert "HF CLIP vision tower" in capsys.readouterr().err
    assert jcli.main(_cli_flags(w, "--cpu")) == 2
    assert "clip" in capsys.readouterr().err.lower()
    assert tserve.main(["--weights", str(w), "--geometry", "tiny", "--device", "cpu"]) == 2
    assert "HF CLIP vision tower" in capsys.readouterr().err


def test_serve_weights_answers_health_and_chat(weights):
    """`serve --weights` (its flags through `build_serving_system`): /health
    lists A-G, POST /chat answers."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cpu")
    tserve.add_checkpoint_args(p)
    system, report = tserve.build_serving_system(p.parse_args(
        ["--weights", str(weights), "--geometry", "tiny"]))
    assert set(report.loaded()) == ALL and report.rows["mesh"]["status"] == "skipped"
    assert system.memory_plan.budget_bytes == tserve.host_memory_bytes()
    srv = tserve.serve(system, host="127.0.0.1", port=0, background=True)
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        body = json.dumps({"prompt": "hi", "greedy": True, "max_new_tokens": 4}).encode()
        req = urllib.request.Request(base + "/chat", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            reply = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        srv.pipeline.close()
    assert set(health["backends"]) == set("ABCDEFG")
    assert reply["status"] in ("chat", "ok"), reply


def test_system_config_json_round_trip(tmp_path):
    """JAX's `test_system_config_roundtrip` on the port's copy, the same
    JSON as JAX's file, unknown keys refused; a torch dtype by its name."""
    from vitron_tpu.core.config import SystemConfig as JSystemConfig

    from vitron_tpu_torch.models.llm.llama import LlamaConfig

    cfg = tconfig.SystemConfig(base_model="/ckpt/vicuna", quantize_llm="int8",
                               mesh_shape={"fsdp": 8})
    cfg.save(tmp_path / "sys.json")
    loaded = tconfig.SystemConfig.load(tmp_path / "sys.json")
    assert loaded == cfg and loaded.enable == ("A", "B", "C", "D", "E", "F", "G")
    JSystemConfig(base_model="/ckpt/vicuna", quantize_llm="int8",
                  mesh_shape={"fsdp": 8}).save(str(tmp_path / "jax.json"))
    assert (tmp_path / "sys.json").read_text() == (tmp_path / "jax.json").read_text()
    assert JSystemConfig.load(str(tmp_path / "sys.json")) == JSystemConfig(
        base_model="/ckpt/vicuna", quantize_llm="int8", mesh_shape={"fsdp": 8})
    (tmp_path / "bad.json").write_text(json.dumps({"base_model": "x", "typo_key": 1}))
    with pytest.raises(ValueError, match="typo_key"):
        tconfig.SystemConfig.load(tmp_path / "bad.json")
    llm = LlamaConfig.tiny(param_dtype=torch.bfloat16)
    d = tconfig.to_dict(llm)
    assert d["param_dtype"] == "bfloat16"
    assert tconfig.from_dict(LlamaConfig, json.loads(json.dumps(d))) == llm


def _rows(report):
    return {k: (v.get("status"), v.get("pass")) for k, v in report.items() if isinstance(v, dict)}


def test_acceptance_suite_matches_jax(weights):
    """`run_acceptance_suite(geometry="tiny")`: JAX's rows, statuses and
    verdicts, every present row passing; without the NLA and the SEEM
    files, the same missing rows."""
    from vitron_tpu.apps import eval_suite as jeval

    want = jeval.run_acceptance_suite(str(weights), geometry="tiny")
    got = teval.run_acceptance_suite(str(weights), geometry="tiny", device="cpu")
    assert _rows(got) == _rows(want) and got["all_present_pass"] and want["all_present_pass"]
    assert got["failed_rows"] == want["failed_rows"] == []
    assert all(v["pass"] for k, v in got.items() if isinstance(v, dict)), got
    rows = [line.split()[0] for line in jeval.ACCEPTANCE_MANIFEST.splitlines()
            if line.startswith("  ") and line.split()[0].endswith(("/", ".pt", ".pth"))]
    assert rows and all(r in teval.ACCEPTANCE_MANIFEST for r in rows)


def test_acceptance_suite_missing_and_red_rows_match_jax(tmp_path):
    """Only a corrupt seem_focall_v1.pt: every other row missing (pass
    None), SEEM's red (pass False, its error named), as in JAX's report."""
    from vitron_tpu.apps import eval_suite as jeval

    (tmp_path / "seem_focall_v1.pt").write_bytes(b"not a checkpoint")
    want = jeval.run_acceptance_suite(str(tmp_path), geometry="tiny")
    got = teval.run_acceptance_suite(str(tmp_path), geometry="tiny", device="cpu")
    assert _rows(got) == _rows(want)
    assert got["failed_rows"] == want["failed_rows"] == ["3_seem_text_seg"]
    assert "error" in got["3_seem_text_seg"] and not got["all_present_pass"]
    assert sum(v.get("status") == "missing" for v in got.values() if isinstance(v, dict)) == 7


def test_eval_suite_main(weights, capsys):
    assert teval.main(["--manifest"]) == 0
    assert "seem_focall_v1.pt" in capsys.readouterr().out
    assert teval.main(["--demo", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["5_video_gen_edit"]["t2v_frames"] == [4, 16, 16, 3]
    assert teval.main([]) == 2
    if not torch.cuda.is_available():
        assert teval.main(["--demo"]) == 2


# ------------------------------------------------------------------- ASR


def _tiny_whisper(d: pathlib.Path) -> pathlib.Path:
    """A tiny random Whisper model and processor saved to `d` (built here:
    nothing is fetched)."""
    import transformers

    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>",
                "<|translate|>", "<|notimestamps|>", "<|nocaptions|>", "<|startofprev|>",
                "<|startoflm|>"]
    vocab = {t: i for i, t in enumerate(["a", "b", "c", "d", "e", "Ġ", "Ġa", "ab", "cd", "Ġab"]
                                        + specials)}
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\na b\nc d\nĠ a\nĠa b\n")
    end = "<|endoftext|>"
    tok = transformers.WhisperTokenizer(str(d / "vocab.json"), str(d / "merges.txt"),
                                        unk_token=end, bos_token=end, eos_token=end,
                                        pad_token=end)
    transformers.WhisperProcessor(transformers.WhisperFeatureExtractor(feature_size=80),
                                  tok).save_pretrained(d)
    cfg = transformers.WhisperConfig(
        vocab_size=len(vocab), num_mel_bins=80, encoder_layers=1, decoder_layers=1, d_model=16,
        encoder_attention_heads=2, decoder_attention_heads=2, encoder_ffn_dim=32,
        decoder_ffn_dim=32, max_source_positions=1500, max_target_positions=448,
        decoder_start_token_id=vocab["<|startoftranscript|>"], eos_token_id=vocab[end],
        pad_token_id=vocab[end], bos_token_id=vocab[end])
    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(cfg).save_pretrained(d)
    return d


def test_whisper_asr_matches_jax(tmp_path, monkeypatch):
    """A tiny random Whisper from a local dir: the port's transcript of a
    waveform and of a WAV file equals JAX's; construction imports nothing
    (no transformers, no error until the first transcribe)."""
    import wave

    from vitron_tpu.media import asr as jasr

    d = _tiny_whisper(tmp_path / "whisper")
    wav = (np.random.RandomState(0).randn(16000) * 0.1).astype(np.float32)
    got, want = tasr.WhisperASR(str(d), device="cpu"), jasr.WhisperASR(str(d))
    assert got.transcribe(wav) == want.transcribe(wav)
    assert got.transcribe(wav)["text"]
    path = tmp_path / "x.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((wav * 32767).astype("<i2").tobytes())
    assert got.transcribe(path) == want.transcribe(str(path))
    assert tasr.WhisperASR(str(d)).device == "cuda"
    monkeypatch.setitem(sys.modules, "transformers", None)
    lazy = tasr.WhisperASR(str(d), device="cpu")
    with pytest.raises(ImportError):
        lazy.transcribe(wav)


def test_asr_hook_installed_from_the_environment(monkeypatch, tmp_path):
    """Unset VITRON_WHISPER: no hook, in both packages; set, a WhisperASR on
    the system's device; a hub id resolves only from local files."""
    from vitron_tpu.media import asr as jasr

    monkeypatch.delenv("VITRON_WHISPER", raising=False)
    assert tasr.default_asr() is None and jasr.default_asr() is None
    assert VitronSystem(None, memory_plan=HOST, device="cpu").asr is None
    monkeypatch.setenv("VITRON_WHISPER", str(tmp_path / "whisper"))
    hook = VitronSystem(None, memory_plan=HOST, device="cpu").asr
    assert isinstance(hook, tasr.WhisperASR) and hook.device == torch.device("cpu")
    assert hook.model_id == str(tmp_path / "whisper") and hook._pipe is None
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    with pytest.raises(OSError):
        tasr.WhisperASR("openai/whisper-base", device="cpu").transcribe(np.zeros(16000,
                                                                                np.float32))


# ------------------------------------------------------- the system's device


def test_engine_less_system_plans_against_its_own_device(monkeypatch, built):
    """A CPU system never plans against a card (no budget is known there:
    it names one), a card system never against the host, whether or not a
    card is present; with an engine, the engine's device, and another one
    is refused."""
    with pytest.raises(ValueError, match="no memory budget is known for device cpu"):
        VitronSystem(None, device="cpu")
    system = VitronSystem(None, device="cpu", memory_plan=HOST)
    assert system.device == torch.device("cpu")
    seen = []

    def budget(device):
        seen.append(torch.device(device))
        return 80 << 30

    monkeypatch.setattr(memory_plan, "device_budget_bytes", budget)
    card = VitronSystem(None)
    assert card.device == torch.device("cuda") and seen == [torch.device("cuda")]
    assert card.memory_plan.budget_bytes == 80 << 30
    _, _, tsys, _ = built
    engine = tsys.engine
    assert VitronSystem(engine, memory_plan=HOST).device == torch.device("cpu")
    assert VitronSystem(engine, memory_plan=HOST, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="the engine's is cpu"):
        VitronSystem(engine, memory_plan=HOST, device="cuda")
