"""The port stands alone: no module of `vitron_tpu_torch/` and nothing in
`chip_smoke.py` imports `vitron_tpu` (the JAX package), `jax` or `cv2`
(OpenCV, which the card's machine lacks: the port carries its own Canny),
at module level or inside a function; every port module imports with the
three made unimportable; and the host modules the port keeps its own copies of
(constants, conversation templates, protocol, tokenization, sketch, the
splice planner, the router, moderation, the program-cache telemetry, the
weight tools) agree with their JAX-package originals. The copies that keep
the original's text (moderation, telemetry, the weight tools) are held to
the same code, docstrings aside.
"""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from vitron_tpu_torch import constants as tconst
from vitron_tpu_torch.apps.cli import DemoTokenizer
from vitron_tpu_torch.mm import conversation as tconv
from vitron_tpu_torch.mm import protocol as tproto
from vitron_tpu_torch.mm import sketch as tsketch
from vitron_tpu_torch.mm import splice as tsplice
from vitron_tpu_torch.mm import tokenization as ttok
from vitron_tpu_torch.runtime import router as trouter
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "vitron_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    """Every module named by an import statement anywhere in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "vitron_tpu", "cv2")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imported_modules(path)
           if _forbidden(name)]
    assert not bad, bad


def _module_level_imports(path: pathlib.Path):
    """The modules that the file's top-level statements import."""
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_safetensors_and_no_module_level_transformers(path):
    """The card's machine has neither package: the port reads safetensors
    with its own reader, and imports transformers (the tokenizer seam of
    `runtime/assembly.py`) only inside the function that needs it."""
    bad = [name for _, name in _imported_modules(path) if name.split(".")[0] == "safetensors"]
    bad += [name for name in _module_level_imports(path)
            if name.split(".")[0] == "transformers"]
    assert not bad, bad


def test_every_port_module_imports_without_safetensors_or_transformers():
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                     for p in (REPO / "vitron_tpu_torch").rglob("*.py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    script = ("import importlib, sys\n"
              "sys.modules['safetensors'] = sys.modules['transformers'] = None\n"
              f"for m in {modules!r}:\n"
              "    importlib.import_module(m)\n"
              "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_scan_sees_function_level_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\n\ndef g():\n    from vitron_tpu.mm import splice\n"
                 "    import jax.numpy as jnp\n")
    assert [n for _, n in _imported_modules(f) if _forbidden(n)] == ["vitron_tpu.mm", "jax.numpy"]


def test_the_scan_sees_opencv(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def canny(x):\n    import cv2\n    return cv2.Canny(x, 100, 200)\n")
    assert [n for _, n in _imported_modules(f) if _forbidden(n)] == ["cv2"]


def test_every_port_module_imports_without_jax():
    modules = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                     for p in (REPO / "vitron_tpu_torch").rglob("*.py"))
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    script = ("import importlib, sys\n"
              "sys.modules['vitron_tpu'] = sys.modules['jax'] = sys.modules['cv2'] = None\n"
              f"for m in {modules!r}:\n"
              "    importlib.import_module(m)\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'vitron_tpu', 'cv2')\n"
              "       and sys.modules[m] is not None]\n"
              "assert not bad, bad\n"
              "print('ok', len(" + repr(modules) + "))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith("ok")


# ------------------------------------------------------- the vendored copies

# the smoke's replies, and malformed ones
REPLIES = [getattr(chip_smoke, name) for name in sorted(dir(chip_smoke))
           if name.endswith("_REPLY")] + [
    "<module>E</module><instruction>track: the dog</instruction> and more",
    "plain chat, no tags",
    "<module>B</module><instruction>unclosed",
    "<module></module><instruction>a</instruction><instruction>b: c</instruction>",
    "<region>[1, 2, 3]</region><region>[5,6,7,8]</region> <b>x</b>",
]


def test_constants_match_jax_package():
    from vitron_tpu import constants as jconst

    names = [n for n in dir(jconst) if n.isupper()]
    assert names and names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n


@pytest.mark.parametrize("reply", REPLIES)
def test_protocol_and_router_match_jax_package(reply):
    from vitron_tpu.mm import protocol as jproto
    from vitron_tpu.runtime import router as jrouter

    assert tproto.parse_model_output(reply) == jproto.parse_model_output(reply)
    assert tproto.TASK_NAMES == jproto.TASK_NAMES
    region = tproto.find_region_instruction_content(reply)
    assert trouter.parse_region_boxes(region) == jrouter.parse_region_boxes(region)
    tr, jr = trouter.BackendRegistry(), jrouter.BackendRegistry()
    for reg in (tr, jr):
        reg.register("B", lambda req: {"module": req.module, "instructions": req.instructions,
                                       "region": req.region})
    want = jrouter.route_model_output(jr, reply)
    got = trouter.route_model_output(tr, reply)
    for d in (got, want):
        d.pop("seconds", None)
    assert got == want


def test_region_boxes_match_jax_package():
    from vitron_tpu.runtime import router as jrouter

    for region in (None, "", "[0.1,0.2,0.6,0.8]", "[1;2;3;4] [x,1,2,3] [5, 6, 7, 8]",
                   "[[0.1,0.2,0.3,0.4]]", "[1,2,3,4,5]"):
        assert trouter.parse_region_boxes(region) == jrouter.parse_region_boxes(region)


@pytest.mark.parametrize("name", sorted(tconv.conv_templates))
def test_conversation_prompts_match_jax_package(name):
    from vitron_tpu.mm import conversation as jconv

    prompts = []
    for templates in (tconv.conv_templates, jconv.conv_templates):
        for last in ("It moved.", None):  # a finished turn, and one for the model
            conv = templates[name].copy()
            conv.append_message(conv.roles[0], "<image>\nWhat is in the <objs> region?")
            if conv.sep_style.name != "PLAIN":  # plain has no sep2 for a reply
                conv.append_message(conv.roles[1], "A dog.")
                conv.append_message(conv.roles[0], "And now?")
                conv.append_message(conv.roles[1], last)
            prompts.append((conv.get_prompt(), conv.sep, conv.sep2))
    half = len(prompts) // 2
    assert prompts[:half] == prompts[half:]


def test_tokenization_matches_jax_package():
    from vitron_tpu.mm import tokenization as jtok

    tok = DemoTokenizer()
    for prompt in ("<image>\nwhat is <objs> doing?", "no media at all",
                   "<image><image> two <objs> and <objs>", "<objs> first"):
        assert (ttok.tokenizer_image_region_token(prompt, tok)
                == jtok.tokenizer_image_region_token(prompt, tok))
        assert ttok.tokenizer_image_token(prompt, tok) == jtok.tokenizer_image_token(prompt, tok)
    for region, size, target in (([60.0, 40.0, 300.0, 260.0], (448, 336), (224, 224)),
                                 ([0, 0, 10, 10], (10, 20), (336, 336))):
        assert (ttok.preprocess_region(region, size, target)
                == jtok.preprocess_region(region, size, target))
    img = np.random.RandomState(0).randint(0, 256, (5, 9, 3), np.uint8)
    np.testing.assert_array_equal(ttok.expand2square_array(img, (1, 2, 3)),
                                  jtok.expand2square_array(img, (1, 2, 3)))
    ids = tok("a b c ###").input_ids
    ts, js = ttok.KeywordStopper(["###"], tok, 0), jtok.KeywordStopper(["###"], tok, 0)
    for n in range(1, len(ids) + 1):
        assert ts.should_stop(ids[:n]) == js.should_stop(ids[:n])


@pytest.mark.parametrize("layout", ["image", "video", "region", "text_only", "mixed"])
def test_plan_splice_matches_jax_package(layout):
    from vitron_tpu.mm import splice as jsplice

    I, O = tconst.IMAGE_TOKEN_INDEX, tconst.OBJS_TOKEN_INDEX
    rows, kinds, kw = {
        "image": ([[1, 5, I, 6, 7]], ["image"], {}),
        "video": ([[1] + [I] * 4 + [9, 9]], ["video"], {"num_video_frames": 4}),
        "region": ([[1, I, 5, O, 6], [1, 2, I, O]], ["image", "image"],
                   {"labels": [[-100, 3, 4, 5, 6], [1, 2, 3, 4]]}),
        "text_only": ([[1, 2, 3], [4, 5]], ["image"], {"padding_side": "left"}),
        "mixed": ([[1, I, 2, I, I, O, 3]], ["image", "video"],
                  {"num_video_frames": 2, "max_len": 20}),
    }[layout]
    got = tsplice.plan_splice(rows, kinds, 32, image_len=3, **kw)
    want = jsplice.plan_splice(rows, kinds, 32, image_len=3, **kw)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), f.name)


def test_sketch_helpers_match_jax_package():
    from vitron_tpu.mm import sketch as jsketch

    m = np.zeros((20, 30), bool)
    m[5:10, 8:16] = True
    m[12, 2] = True
    for mask in (m, np.zeros((4, 4), bool)):
        assert tsketch.mask_to_bbox(mask) == jsketch.mask_to_bbox(mask)
    np.testing.assert_array_equal(tsketch.bbox_to_mask([2, 3, 9.7, 15], (20, 30)),
                                  jsketch.bbox_to_mask([2, 3, 9.7, 15], (20, 30)))
    states = []
    for mod in (tsketch, jsketch):
        st = mod.ImageBoxState((20, 30))
        st.add_stroke(m)
        st.add_box([1, 1, 4, 4])
        states.append((st.boxes[:], st.merged_mask()))
    assert states[0][0] == states[1][0]
    np.testing.assert_array_equal(states[0][1], states[1][1])
    assert tsketch.order_pick_k(list(range(10)), 4) == jsketch.order_pick_k(list(range(10)), 4)


# the port's copies that keep the original's code as it is (docstrings aside)
TEXT_COPIES = ["mm/moderation.py", "runtime/telemetry.py", "models/weight_tools.py"]


def _code(path: pathlib.Path) -> str:
    """The module's syntax tree without its docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", TEXT_COPIES)
def test_text_copies_keep_the_original_code(rel):
    assert _code(REPO / "vitron_tpu_torch" / rel) == _code(REPO / "vitron_tpu" / rel)


def test_the_code_comparison_sees_a_changed_line(tmp_path):
    a, b = tmp_path / "a.py", tmp_path / "b.py"
    a.write_text('"""doc a"""\ndef f(x):\n    """one"""\n    return x + 1\n')
    b.write_text('"""doc b"""\ndef f(x):\n    """two"""\n    return x + 1\n')
    assert _code(a) == _code(b)
    b.write_text('"""doc b"""\ndef f(x):\n    return x + 2\n')
    assert _code(a) != _code(b)


def test_moderation_matches_jax_package(monkeypatch):
    """Fail-open and the injected transport, on both copies; nothing posts."""
    from vitron_tpu.mm import moderation as jmod
    from vitron_tpu_torch.mm import moderation as tmod

    calls = []

    def flagged(url, data, headers, timeout):
        calls.append((url, data, headers["Content-Type"], timeout))
        return {"results": [{"flagged": b"bad" in data}]}

    def broken(*a):
        raise OSError("no route")

    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    for mod in (tmod, jmod):
        assert mod.violates_moderation("anything") is False  # no key, no transport
        assert mod.violates_moderation("a bad\nword", post=flagged) is True
        assert mod.violates_moderation("fine", post=flagged) is False
        assert mod.violates_moderation("bad", post=broken) is False  # fails open
        assert mod.violates_moderation("bad", post=lambda *a: {"results": []}) is False
    assert calls[0] == calls[2] and calls[1] == calls[3]
    assert calls[0][0] == tmod.MODERATION_URL == jmod.MODERATION_URL


def test_weight_tools_match_jax_package():
    """apply_delta / make_delta (with vocab growth) and consolidate give the
    same dicts on both copies."""
    from vitron_tpu.models import weight_tools as jwt
    from vitron_tpu_torch.models import weight_tools as twt

    rs = np.random.RandomState(0)
    base = {"embed": rs.randn(5, 3), "w": rs.randn(2, 4), "only_base": rs.randn(3)}
    target = {"embed": rs.randn(7, 3), "w": rs.randn(2, 4), "new": rs.randn(2)}
    for mod in (twt, jwt):
        delta = mod.make_delta(base, target)
        back = mod.apply_delta(base, delta)
        assert sorted(back) == sorted(target)
        for k in target:
            np.testing.assert_allclose(back[k], target[k], rtol=1e-12, atol=1e-12)
    got, want = twt.make_delta(base, target), jwt.make_delta(base, target)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    shards = [{"a": rs.randn(2)}, {"b": rs.randn(3), "a": rs.randn(2)}]
    got, want = twt.consolidate(shards), jwt.consolidate(shards)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
