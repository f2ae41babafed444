"""Parity of the port's checkpoint converters with the JAX package's on the
CPU: the safetensors reader, `convert_hf_llama` / `load_pretrained_llama`
(fp16 and float32 safetensors, an index json, `.bin` shards, tied
embeddings), the LoRA merge (`lora_pairs` + `merged` against JAX's
`merge_lora`, a `.safetensors` and a `.bin` adapter, with and without
`adapter_config.json`), `quantize_host` (int4 and int8),
`convert_hf_clip_vision` (CLIP and LanguageBind), both projector forms, the
region extractor and `fold_normalization_into_patch_proj`.

The state dicts carry HF's key names and are made with numpy from seeded
RandomStates at tiny widths, then written with `safetensors` and
`torch.save`. Loaded leaves are held bit for bit (the port converts through
float32 to the param dtype, then quantizes, in JAX's order); merged LoRA
weights before any cast within one float32 ulp (B @ A is summed in another
order); embeddings of raw pixels at 1e-5 of their largest.
"""
import json

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

import chip_smoke
from vitron_tpu_torch.models.convert import from_jax, to_numpy
from vitron_tpu_torch.models.llm import llama as tllama
from vitron_tpu_torch.models.llm import loader as tloader
from vitron_tpu_torch.models.vision import loader as tvloader
from vitron_tpu_torch.models.vision import projector as tproj
from vitron_tpu_torch.models.vision import region_extractor as treg
from vitron_tpu_torch.models.vision import vit as tvit
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

H, FF, L, V = 16, 32, 2, 48  # the tiny Llama: hidden, intermediate, layers, vocab


def _llama_sd(rs, dtype=np.float32, tied=False):
    """An HF LlamaForCausalLM state dict of numpy arrays."""
    sd = {"model.embed_tokens.weight": rs.randn(V, H), "model.norm.weight": 1 + 0.1 * rs.randn(H)}
    if not tied:
        sd["lm_head.weight"] = rs.randn(V, H)
    for i in range(L):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + 0.1 * rs.randn(H)
        sd[p + "post_attention_layernorm.weight"] = 1 + 0.1 * rs.randn(H)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + f"self_attn.{n}.weight"] = rs.randn(H, H)
        sd[p + "mlp.gate_proj.weight"] = rs.randn(FF, H)
        sd[p + "mlp.up_proj.weight"] = rs.randn(FF, H)
        sd[p + "mlp.down_proj.weight"] = rs.randn(H, FF)
    return {k: (0.3 * v).astype(dtype) for k, v in sd.items()}


def _save_st(path, sd):
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, str(path))


def _cfgs(param_dtype="bfloat16"):
    import jax.numpy as jnp

    from vitron_tpu.models.llm import llama as jllama

    kw = dict(vocab_size=V, hidden_size=H, intermediate_size=FF, num_layers=L, num_heads=4,
              num_kv_heads=4)
    return (jllama.LlamaConfig(**kw, param_dtype=getattr(jnp, param_dtype)),
            tllama.LlamaConfig(**kw, param_dtype=getattr(torch, param_dtype)))


def _np_tree(tree):
    """JAX leaves as numpy (bf16 as float32, as `to_numpy` gives the port's)."""
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype.name == "bfloat16"
                        else np.asarray(a), tree)


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}.{k}")
    else:
        yield pre, tree


def _assert_bit_equal(got, want):
    got, want = dict(_flat(to_numpy(got))), dict(_flat(_np_tree(want)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------------------ the reader

ST_DTYPES = [(torch.float32, "F32"), (torch.float16, "F16"), (torch.bfloat16, "BF16"),
             (torch.int8, "I8"), (torch.uint8, "U8"), (torch.int32, "I32"), (torch.int64, "I64")]


@pytest.mark.parametrize("dtype,name", ST_DTYPES, ids=[n for _, n in ST_DTYPES])
def test_reader_matches_safetensors(tmp_path, dtype, name):
    """Every dtype the reader takes, at a few shapes (a scalar and an empty
    tensor too), against `safe_open`: the same values, bf16 widened to
    float32 (ROADMAP C16)."""
    g = torch.Generator().manual_seed(len(name))
    tensors = {}
    for i, shape in enumerate([(3, 5), (7,), (), (0, 4), (2, 3, 4)]):
        t = torch.randn(shape, generator=g) * 50
        tensors[f"t{i}"] = t.to(dtype)
    save_file(tensors, str(tmp_path / "model.safetensors"), metadata={"format": "pt"})
    got = tloader.load_safetensors_dir(tmp_path)
    with safe_open(str(tmp_path / "model.safetensors"), framework="pt") as sf:
        assert sorted(got) == sorted(sf.keys())
        for k in sf.keys():
            want = sf.get_tensor(k)
            want = want.float() if dtype == torch.bfloat16 else want
            assert got[k].dtype == want.dtype and torch.equal(got[k], want), k
    header, start = tloader.read_safetensors_header(tmp_path / "model.safetensors")
    assert {e["dtype"] for e in header.values()} == {name}


def test_bf16_shards_load_as_jax_loads_them(tmp_path):
    """C16: safetensors' numpy reader knows bf16 only once ml_dtypes has
    registered it (the JAX package's loader imports jax, which does), and
    then keeps a bf16 shard in bf16, where the port widens it to float32 as
    both packages widen a bf16 `.bin`. At the default bf16 params a bf16
    base merged with a LoRA adapter loads to the same bits either way."""
    import ml_dtypes  # noqa: F401  (registered by jax already)

    from vitron_tpu.models.llm import loader as jloader

    rs = np.random.RandomState(8)
    base, lora = tmp_path / "base", tmp_path / "lora"
    base.mkdir()
    lora.mkdir()
    sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _llama_sd(rs).items()}
    save_file(sd, str(base / "model.safetensors"))
    _save_st(lora / "adapter_model.safetensors", _adapter(rs))
    (lora / "adapter_config.json").write_text(json.dumps({"r": 4, "lora_alpha": 8}))
    read = jloader.load_safetensors_dir(str(base))
    assert read["model.norm.weight"].dtype.name == "bfloat16"
    got = tloader.load_safetensors_dir(base)
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], sd[k].float()) for k in sd)
    torch.save(sd, tmp_path / "w.bin")
    assert all(np.array_equal(tloader.load_torch_bin(tmp_path / "w.bin")[k].numpy(), v)
               for k, v in jloader.load_torch_bin(str(tmp_path / "w.bin")).items())
    jcfg, tcfg = _cfgs()
    for quantize in ("", "int4"):
        _assert_bit_equal(
            tloader.load_pretrained_llama(base, tcfg, lora_path=lora, quantize=quantize),
            jloader.load_pretrained_llama(str(base), jcfg, lora_path=str(lora),
                                          quantize=quantize))


def test_reader_reads_the_smokes_writer(tmp_path):
    """The smoke's streaming writer against `safe_open` and the port's reader,
    every dtype."""
    g = torch.Generator().manual_seed(3)
    tensors = {f"x.{name}": (torch.randn((3, 4), generator=g) * 40).to(dtype)
               for dtype, name in ST_DTYPES}
    entries = {k: (t.dtype, tuple(t.shape), lambda t=t: t) for k, t in tensors.items()}
    n = chip_smoke.write_safetensors(tmp_path / "w.safetensors", entries)
    assert n == (tmp_path / "w.safetensors").stat().st_size
    got = tloader.load_safetensors_dir(tmp_path)
    with safe_open(str(tmp_path / "w.safetensors"), framework="pt") as sf:
        for k, t in tensors.items():
            assert torch.equal(sf.get_tensor(k), t), k
            want = t.float() if t.dtype == torch.bfloat16 else t
            assert torch.equal(got[k], want), k


def test_index_json_names_the_shards(tmp_path):
    """With `model.safetensors.index.json` only the files it names are read."""
    sd = _llama_sd(np.random.RandomState(1))
    keys = sorted(sd)
    half = len(keys) // 2
    _save_st(tmp_path / "a.safetensors", {k: sd[k] for k in keys[:half]})
    _save_st(tmp_path / "b.safetensors", {k: sd[k] for k in keys[half:]})
    _save_st(tmp_path / "stray.safetensors", {"stray": np.zeros(3, np.float32)})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {
        k: ("a.safetensors" if i < half else "b.safetensors") for i, k in enumerate(keys)}}))
    got = tloader.load_safetensors_dir(tmp_path)
    assert sorted(got) == keys
    assert all(np.array_equal(got[k].numpy(), sd[k]) for k in keys)


# ------------------------------------------------------------ the LLM


@pytest.mark.parametrize("case", ["fp16", "float32-index", "bin-shards", "tied"])
def test_load_pretrained_llama_matches_jax(tmp_path, case):
    """The whole loader on the same dir in both packages, bf16 params:
    every leaf bit-equal."""
    from vitron_tpu.models.llm import loader as jloader

    rs = np.random.RandomState(2)
    sd = _llama_sd(rs, np.float16 if case == "fp16" else np.float32, tied=case == "tied")
    keys = sorted(sd)
    if case == "bin-shards":
        for j, part in enumerate((keys[::2], keys[1::2])):
            torch.save({k: torch.from_numpy(sd[k]) for k in part},
                       tmp_path / f"pytorch_model-0000{j + 1}-of-00002.bin")
    elif case == "float32-index":
        _save_st(tmp_path / "model-00001-of-00002.safetensors", {k: sd[k] for k in keys[:9]})
        _save_st(tmp_path / "model-00002-of-00002.safetensors", {k: sd[k] for k in keys[9:]})
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {
            k: f"model-0000{1 + (i >= 9)}-of-00002.safetensors" for i, k in enumerate(keys)}}))
    else:
        _save_st(tmp_path / "model.safetensors", sd)
    jcfg, tcfg = _cfgs()
    want = jloader.load_pretrained_llama(str(tmp_path), jcfg)
    got = tloader.load_pretrained_llama(tmp_path, tcfg)
    _assert_bit_equal(got, want)
    if case == "tied":
        assert torch.equal(got["lm_head"], got["embed"].t())


def _adapter(rs, r=4):
    out = {}
    for i in range(L):
        for mod, (o, n) in (("self_attn.q_proj", (H, H)), ("self_attn.v_proj", (H, H)),
                            ("mlp.down_proj", (H, FF))):
            stem = f"base_model.model.model.layers.{i}.{mod}"
            out[f"{stem}.lora_A.weight"] = (0.2 * rs.randn(r, n)).astype(np.float32)
            out[f"{stem}.lora_B.weight"] = (0.2 * rs.randn(o, r)).astype(np.float32)
    return out


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("with_config", [True, False])
def test_lora_merge_matches_jax(tmp_path, fmt, with_config):
    """A peft adapter merged at load: `lora_pairs` + `merged` on the state
    dict within one float32 ulp of JAX's `merge_lora` (fp16 weights:
    bit-equal after the round to fp16), and the loaded int4 leaves
    bit-equal; alpha / r from adapter_config.json, or a scale of 1
    without it."""
    from vitron_tpu.models.llm import loader as jloader

    rs = np.random.RandomState(4)
    base, lora = tmp_path / "base", tmp_path / "lora"
    base.mkdir()
    lora.mkdir()
    sd = _llama_sd(rs, np.float16)
    _save_st(base / "model.safetensors", sd)
    adapter = _adapter(rs)
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in adapter.items()},
                   lora / "adapter_model.bin")
    else:
        _save_st(lora / "adapter_model.safetensors", adapter)
    if with_config:
        (lora / "adapter_config.json").write_text(json.dumps({"r": 4, "lora_alpha": 16}))
    jcfg, tcfg = _cfgs()
    want = jloader.load_pretrained_llama(str(base), jcfg, lora_path=str(lora), quantize="int4")
    got = tloader.load_pretrained_llama(base, tcfg, lora_path=lora, quantize="int4")
    _assert_bit_equal(got, want)

    scaling = 4.0 if with_config else 1.0
    for dtype in (np.float16, np.float32):
        base_sd = {k: v.astype(dtype) for k, v in sd.items()}
        jm = jloader.merge_lora(dict(base_sd), adapter, scaling=scaling)
        tm = {k: torch.from_numpy(v) for k, v in base_sd.items()}
        tadapter = {k: torch.from_numpy(v) for k, v in adapter.items()}
        for target, (ka, kb, s) in tloader.lora_pairs(tm, tadapter, scaling=scaling).items():
            tm[target] = tloader.merged(tm[target], tadapter[ka], tadapter[kb], s)
        changed = [k for k in sd if not np.array_equal(jm[k], base_sd[k])]
        assert len(changed) == 3 * L
        for k in sd:
            g, w = tm[k].numpy(), jm[k]
            assert g.dtype == w.dtype, k
            if dtype == np.float16:
                assert np.array_equal(g, w), k
            else:
                assert np.all(np.abs(g - w) <= np.spacing(np.abs(w))), k


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_host_matches_jax(bits):
    """`quantize_host` bit-equal to JAX's, lm_head included, on bf16 weights
    with exact halves of a step (round half to even) and an all-zero column
    (the 1e-8 floor)."""
    import jax.numpy as jnp

    from vitron_tpu.models.llm import loader as jloader

    rs = np.random.RandomState(bits)
    qmax = 7 if bits == 4 else 127
    layers = {}
    for t in ("wq", "wk", "wv", "wo", "gate", "up", "down"):
        w = rs.randn(L, 2 * H, H).astype(np.float32)
        w[:, :, 0] = 0.0                                  # amax floored at 1e-8
        w[:, 0, 1], w[:, 1:6, 1] = qmax, [0.5, 1.5, 2.5, -0.5, -3.5]  # s = 1: halves
        layers[t] = w
    layers["attn_norm"] = rs.randn(L, 2 * H).astype(np.float32)
    params = {"embed": rs.randn(V, 2 * H).astype(np.float32), "layers": layers,
              "lm_head": rs.randn(2 * H, V).astype(np.float32)}
    jparams = {k: (jnp.asarray(v, jnp.bfloat16) if not isinstance(v, dict) else
                   {kk: jnp.asarray(vv, jnp.bfloat16) for kk, vv in v.items()})
               for k, v in params.items()}
    tparams = {k: (torch.from_numpy(v).to(torch.bfloat16) if not isinstance(v, dict) else
                   {kk: torch.from_numpy(vv).to(torch.bfloat16) for kk, vv in v.items()})
               for k, v in params.items()}
    want = jloader.quantize_host(_np_tree(jparams), bits=bits)
    got = tloader.quantize_host(tparams, bits=bits)
    assert np.array_equal(to_numpy(got["layers"]["wq"]["s"])[:, :, 1], np.ones((L, 1)))
    _assert_bit_equal(got, want)


# ------------------------------------------------------------ the towers


def _clip_sd(rs, h=16, layers=2, p=4, image=8, ff=32, temporal=False, frames=8):
    n = (image // p) ** 2 + 1
    sd = {"vision_model.embeddings.class_embedding": rs.randn(h),
          "vision_model.embeddings.patch_embedding.weight": rs.randn(h, 3, p, p),
          "vision_model.embeddings.position_embedding.weight": rs.randn(n, h),
          "vision_model.pre_layrnorm.weight": 1 + 0.1 * rs.randn(h),
          "vision_model.pre_layrnorm.bias": rs.randn(h),
          "vision_model.post_layernorm.weight": 1 + 0.1 * rs.randn(h),
          "vision_model.post_layernorm.bias": rs.randn(h)}
    for i in range(layers):
        stem = f"vision_model.encoder.layers.{i}"
        for a in ("self_attn", "temporal_attn") if temporal else ("self_attn",):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{stem}.{a}.{proj}.weight"] = rs.randn(h, h)
                sd[f"{stem}.{a}.{proj}.bias"] = rs.randn(h)
        for ln in ("layer_norm1", "layer_norm2") + (("temporal_layer_norm1",) if temporal else ()):
            sd[f"{stem}.{ln}.weight"] = 1 + 0.1 * rs.randn(h)
            sd[f"{stem}.{ln}.bias"] = rs.randn(h)
        sd[f"{stem}.mlp.fc1.weight"], sd[f"{stem}.mlp.fc1.bias"] = rs.randn(ff, h), rs.randn(ff)
        sd[f"{stem}.mlp.fc2.weight"], sd[f"{stem}.mlp.fc2.bias"] = rs.randn(h, ff), rs.randn(h)
        if temporal:
            sd[f"{stem}.temporal_embedding"] = rs.randn(1, frames, h)
    return {k: (0.2 * v).astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("temporal", [False, True], ids=["clip", "languagebind"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_hf_clip_vision_matches_jax(temporal, dtype):
    import jax.numpy as jnp

    from vitron_tpu.models.vision import loader as jvloader
    from vitron_tpu.models.vision import vit as jvit

    # a float32 tower, or an fp16 one served in bf16 (the real geometry's)
    sd = {k: torch.from_numpy(v).to(torch.float32 if dtype == "float32" else torch.float16)
          for k, v in _clip_sd(np.random.RandomState(5), temporal=temporal).items()}
    kw = dict(image_size=8, patch_size=4, hidden_size=16, num_layers=2, num_heads=4,
              intermediate_size=32, add_time_attn=temporal)
    want = jvloader.convert_hf_clip_vision(sd, jvit.ViTConfig(**kw,
                                                              param_dtype=getattr(jnp, dtype)))
    got = tvloader.convert_hf_clip_vision(sd, tvit.ViTConfig(**kw,
                                                             param_dtype=getattr(torch, dtype)))
    _assert_bit_equal(got, want)
    assert ("t_attn" in got["layers"]) == temporal


def _region_sd(rs, v=12, h=16):
    p = "model.region_extractor."
    sd = {p + "region_linear.layers.0.weight": rs.randn(h, v)}
    for j in range(3):
        sd[p + f"region_linear.layers.{j}.bias"] = rs.randn(h)
    for j in (1, 2):
        sd[p + f"region_linear.layers.{j}.weight"] = rs.randn(h, h)
    sd.update({p + "loc_encoder.loc_encoder.0.weight": rs.randn(h // 2, 4),
               p + "loc_encoder.loc_encoder.0.bias": rs.randn(h // 2),
               p + "loc_encoder.loc_encoder.2.weight": rs.randn(h, h // 2),
               p + "loc_encoder.loc_encoder.2.bias": rs.randn(h)})
    return {k: torch.from_numpy(0.3 * v).to(torch.bfloat16) for k, v in sd.items()}


@pytest.mark.parametrize("form", ["mlp2x_gelu", "linear", "numpy"])
def test_projector_and_region_convert_match_jax(form):
    """Both projector forms from torch tensors (as float32) and numpy arrays
    (in their type), the region extractor; then each applied to bf16 tower
    features, promoted to the float32 weights as jnp promotes."""
    import jax.numpy as jnp

    from vitron_tpu.models.vision import projector as jproj
    from vitron_tpu.models.vision import region_extractor as jreg

    rs = np.random.RandomState(6)
    p = "model.mm_projector."
    if form == "linear":
        nl = {p + "weight": torch.from_numpy(rs.randn(16, 12)), p + "bias": torch.randn(16)}
    else:
        nl = {p + "0.weight": rs.randn(16, 12), p + "0.bias": rs.randn(16),
              p + "2.weight": rs.randn(16, 16), p + "2.bias": rs.randn(16)}
        nl = {k: (v.astype(np.float32) if form == "numpy" else torch.from_numpy(v).half())
              for k, v in nl.items()}
    nl.update(_region_sd(rs))
    jp, tp = jproj.convert_hf(nl), tproj.convert_hf(nl)
    jr, tr = jreg.convert_hf(nl), treg.convert_hf(nl)
    _assert_bit_equal(tp, jp)
    _assert_bit_equal(tr, jr)
    x = rs.randn(2, 16, 12).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jproj.apply(_jnp_tree(jp), xb)
    got = tproj.apply(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()
    boxes = np.array([[2.0, 3.0, 20.0, 25.0], [0.0, 0.0, 27.0, 14.0]], np.float32)
    want = jreg.apply(_jnp_tree(jr), xb, jnp.asarray(boxes), image_size=28)
    got = treg.apply(tr, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(boxes),
                     image_size=28)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * np.abs(np.asarray(want)).max()


def _jnp_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


def test_fold_normalization_matches_jax():
    """An embed of raw [0, 255] pixels through the folded patch projection
    equals JAX's embed of the CLIP-normalised pixels (and JAX's own fold)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.vision import vit as jvit

    mean, std = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
    kw = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=3, num_heads=4,
              intermediate_size=64)
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = from_jax(_np_tree(jparams), "cpu")
    pixels = np.random.RandomState(7).randint(0, 256, (2, 28, 28, 3)).astype(np.float32)
    normed = (pixels / 255.0 - np.array(mean, np.float32)) / np.array(std, np.float32)
    want = np.asarray(jvit.embed(jparams, jcfg, jnp.asarray(normed)))
    folded = tvit.fold_normalization_into_patch_proj(tparams, tcfg, mean, std)
    got = tvit.embed(folded, tcfg, torch.from_numpy(pixels)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    jfold = jvit.fold_normalization_into_patch_proj(jparams, jcfg, mean, std)
    for k in ("patch_proj", "patch_bias"):
        w = np.asarray(jfold[k])
        assert np.abs(folded[k].numpy() - w).max() <= 1e-6 * np.abs(w).max(), k
