"""The port's W4A8 / W8A8 quantized variants against the JAX package on the
CPU, and Q1 / Q2 (the hand int8 kernels) against their plain versions on a
card.

Inputs are numpy arrays from seeded RandomStates handed to both packages.
The integer forms are held by their int32 sums: each side's integer product
is captured where it is made (JAX's `jax.lax.dot_general` /
`conv_general_dilated`, the port's `int_dot` / `exact_int_dot` /
`conv_sums_plain`) and the sums must be equal. Their float outputs then
differ only by the two packages' float32 epilogues, which are the same
operations in the same order: held bit-equal (0 ulps) in float32 and in
bf16. Whole quantized UNets are held within a stated tolerance, chosen as
said at `QUANT_UNET_TOL`. JAX is imported inside the parity tests, so the
`cuda` tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import conv2d_w8a8 as tcw
from vitron_tpu_torch.kernels import quantization as tq
from vitron_tpu_torch.kernels import temporal_conv as ttc
from vitron_tpu_torch.kernels import w4a8_matmul as tw
from vitron_tpu_torch.kernels.int4_matmul import unpack_int4
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jq():
    from vitron_tpu.kernels import quantization

    return quantization


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(dtype)


def _walk(tree, path=()):
    """(key path, leaf) of every tensor / array leaf, a quantized dict as one leaf."""
    if isinstance(tree, dict):
        if any(k in tree for k in ("qc", "q8", "q8t", "qa8", "q4", "q")) and "s" in tree:
            yield path, tree
            return
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _quantized_paths(tree):
    return {p: sorted(k for k in leaf if k != "s") for p, leaf in _walk(tree)
            if isinstance(leaf, dict)}


class _Capture:
    """Wraps a function and keeps what each call returned."""

    def __init__(self, fn):
        self.fn, self.out = fn, []

    def __call__(self, *a, **kw):
        r = self.fn(*a, **kw)
        self.out.append(r)
        return r


def _capture_jax(monkeypatch, name):
    import jax

    cap = _Capture(getattr(jax.lax, name))
    monkeypatch.setattr(jax.lax, name, cap)
    return cap


# ------------------------------------------------------------ the quantizers

@pytest.mark.parametrize("name,shape", [
    ("quantize_int8_a8", (48, 40)), ("quantize_int8_a8", (2, 32, 24)),
    ("quantize_tconv", (3, 32, 24)), ("quantize_tconv", (3, 1, 32, 24)),
    ("quantize_conv2d", (3, 3, 16, 24)), ("quantize_conv2d", (1, 1, 16, 8)),
])
def test_quantizers_bit_equal_to_jax(jq, name, shape):
    """Every leaf of each quantizer's dict, from the same float32 weights
    (one column scaled 1e-9 so the 1e-8 floor is taken)."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w[..., 0] *= 1e-9
    want = getattr(jq, name)(_j(w))
    got = getattr(tq, name)(_t(w))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"s": torch.float32}.get(k, torch.int8)
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


# ------------------------------------------------------------- the int32 sums

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8, 20])
def test_w8a8_matmul_sums_and_output_equal_jax(jq, monkeypatch, dtype, m):
    rs = np.random.RandomState(m)
    x = rs.randn(m, 48).astype(np.float32) * 3
    w = jq.quantize_int8_a8(_j(rs.randn(48, 40)))
    jcap = _capture_jax(monkeypatch, "dot_general")
    want = jq._w8a8_matmul(_j(x, dtype), w)
    monkeypatch.undo()
    pcap = _Capture(tq.int_dot)
    monkeypatch.setattr(tq, "int_dot", pcap)
    got = tq._w8a8_matmul(_t(x).to(getattr(torch, dtype)),
                          {k: _t(np.asarray(v)) for k, v in w.items()})
    (jacc,), (pacc,) = jcap.out, pcap.out
    assert pacc.dtype == torch.int32
    np.testing.assert_array_equal(pacc.numpy(), np.asarray(jacc))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))  # 0 ulps


def _w4a8_pair(jq, rs, k, n):
    """(JAX's promoted {"qa8": s4, "s"}, the port's {"qa8": packed, "s"})."""
    import jax

    w = jq.quantize_int4(_j(rs.randn(k, n)))
    jw = jq.promote_int4({"w": w}, a8=True)["w"]
    tw_ = tq.promote_int4({"w": {"q4": _t(np.asarray(w["q4"])), "s": _t(np.asarray(w["s"]))}},
                          a8=True)["w"]
    return jax.tree.map(lambda a: a, jw), tw_


@pytest.mark.parametrize("static", [None, "0.05"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 3, 8, 20])
def test_w4a8_matmul_sums_and_output_equal_jax(jq, monkeypatch, m, dtype, static):
    """M 1/3/8/20 (JAX pads the first three to 8 rows: the same sums per
    row), the absmax and the VITRON_W4A8_STATIC scale."""
    if static is None:
        monkeypatch.delenv("VITRON_W4A8_STATIC", raising=False)
    else:
        monkeypatch.setenv("VITRON_W4A8_STATIC", static)
    rs = np.random.RandomState(10 + m)
    x = rs.randn(2, m, 64).astype(np.float32) * 2  # a leading dim, flattened as JAX does
    jw, pw = _w4a8_pair(jq, rs, 64, 48)
    assert ("sx" in pw) == (static is not None)
    jcap = _capture_jax(monkeypatch, "dot_general")
    want = jq._w4a8_matmul(_j(x, dtype), jw)
    pcap = _Capture(tw.exact_int_dot)
    monkeypatch.setattr(tw, "exact_int_dot", pcap)
    got = tq._w4a8_matmul(_t(x).to(getattr(torch, dtype)), pw)
    (jacc,), (pacc,) = jcap.out, pcap.out
    np.testing.assert_array_equal(pacc.numpy(), np.asarray(jacc)[:2 * m])
    assert got.shape == (2, m, 48) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))  # 0 ulps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,padding", [(1, 1), (1, 0), (2, 1), (2, 0)])
def test_conv2d_w8a8_sums_and_output_equal_jax(jq, monkeypatch, stride, padding, dtype):
    """Stride 1/2 and padding 0/1 on a ragged 9 x 7 image, float32 and bf16."""
    rs = np.random.RandomState(stride * 10 + padding)
    x = rs.randn(2, 9, 7, 32).astype(np.float32) * 2
    w = jq.quantize_conv2d(_j(rs.randn(3, 3, 32, 24) * 0.1))
    jcap = _capture_jax(monkeypatch, "conv_general_dilated")
    want = jq.conv2d_w8a8(_j(x, dtype), w, stride=stride, padding=padding)
    pcap = _Capture(tcw.conv_sums_plain)
    monkeypatch.setattr(tcw, "conv_sums_plain", pcap)
    got = tq.conv2d_w8a8(_t(x).to(getattr(torch, dtype)),
                         {k: _t(np.asarray(v)) for k, v in w.items()}, stride, padding)
    (jacc,), (pacc,) = jcap.out, pcap.out
    np.testing.assert_array_equal(pacc.to(torch.int32).numpy(), np.asarray(jacc))
    assert got.shape == np.asarray(want).shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))  # 0 ulps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tconv_w8a8_sums_and_output_equal_jax(jq, monkeypatch, dtype):
    """The three tap products of the q8t route (x [B, F, H, W, C]), with the bias."""
    from vitron_tpu.kernels import temporal_conv as jtc

    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 3, 4, 32).astype(np.float32)
    w = jq.quantize_tconv(_j(rs.randn(3, 1, 32, 24) * 0.2))
    bias = rs.randn(24).astype(np.float32)
    jcap = _capture_jax(monkeypatch, "dot_general")
    want = jtc.temporal_conv_k3(_j(x, dtype), w, _j(bias, dtype))
    pcap = _Capture(tq.int_dot)
    monkeypatch.setattr(tq, "int_dot", pcap)
    got = ttc.temporal_conv_k3(_t(x).to(getattr(torch, dtype)),
                               {k: _t(np.asarray(v)) for k, v in w.items()},
                               _t(bias).to(getattr(torch, dtype)))
    assert len(jcap.out) == len(pcap.out) == 3
    for j, p in zip(jcap.out, pcap.out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    assert got.shape == (2, 5, 3, 4, 24) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))  # 0 ulps


def test_int_dot_pads_rows_for_int_mm(monkeypatch):
    """On the card `int_dot` is `torch._int_mm`, which takes more than 16
    rows: fewer are padded with zero rows and sliced off (checked here with
    `_int_mm`'s CPU form standing in and a tensor that reports cuda)."""
    calls = []

    def fake_int_mm(a, b):
        calls.append(a.shape[0])
        return a.to(torch.int32) @ b.to(torch.int32)

    class Dev:
        type = "cuda"

    class X(torch.Tensor):
        @property
        def device(self):
            return Dev()

    monkeypatch.setattr(torch, "_int_mm", fake_int_mm)
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.randint(-127, 128, (3, 16)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-127, 128, (16, 8)).astype(np.int8))
    got = tq.int_dot(a.as_subclass(X), b)
    assert calls == [17] and tuple(got.shape) == (3, 8)
    np.testing.assert_array_equal(torch.Tensor(got).numpy(),
                                  (a.to(torch.int32) @ b.to(torch.int32)).numpy())


# ------------------------------------------------------------- promote_int4

@pytest.mark.parametrize("mode", ["a8", "no_a8", "env_on", "env_off"])
def test_promote_int4_matches_jax(jq, monkeypatch, mode):
    """a8 True / False / from VITRON_W4A8: W4A8 leaves where JAX makes
    them, on the same packed tensor; without a8 the port's tree is returned
    as it is (B1 reads the packing; JAX expands it to s4 "q"). Every leaf
    dequantizes bit-equal to JAX's, LoRA factors and plain leaves kept."""
    import jax

    monkeypatch.delenv("VITRON_W4A8_STATIC", raising=False)
    if mode.startswith("env"):
        monkeypatch.setenv("VITRON_W4A8", "1" if mode == "env_on" else "0")
    a8 = {"a8": True, "no_a8": False}.get(mode)
    rs = np.random.RandomState(1)
    w = jq.quantize_int4(_j(rs.randn(2, 32, 16)))  # a stacked leaf
    lora = rs.randn(32, 4).astype(np.float32)
    jtree = {"layers": {"wq": {**w, "lora_a": _j(lora)}}, "embed": _j(rs.randn(8, 4)),
             "blocks": [jq.quantize_int4(_j(rs.randn(16, 8)))]}
    ttree = jax.tree.map(lambda a: _t(np.asarray(a)), jtree)
    want = jq.promote_int4(jtree, a8=a8)
    got = tq.promote_int4(ttree, a8=a8)
    on = mode in ("a8", "env_on")
    assert tq.w4a8_default() == (mode == "env_on")
    if not on:
        assert got is ttree
    for (pp, g), (jp, j) in zip(_walk(got), _walk(want)):
        assert pp == jp
        if isinstance(g, dict):
            assert ("qa8" in g) == ("qa8" in j) == on and ("q4" in g) != on
            np.testing.assert_array_equal(tq.dequantize(g).numpy(),
                                          np.asarray(jq.dequantize(j)))
            assert (g["qa8"] if on else g["q4"]) is next(
                leaf for p, leaf in _walk(ttree) if p == pp)["q4"]
            if "lora_a" in j:
                np.testing.assert_array_equal(g["lora_a"].numpy(), np.asarray(j["lora_a"]))
        else:
            np.testing.assert_array_equal(_np(g), np.asarray(j))


def test_promote_int4_static_scale_is_read_once(monkeypatch):
    """VITRON_W4A8_STATIC is read when the tree is promoted: a float32
    [..., 1, 1] "sx" the stacked layers index like "s"."""
    monkeypatch.setenv("VITRON_W4A8_STATIC", "0.03125")
    w = tq.quantize_int4(torch.randn(3, 32, 16, generator=torch.Generator().manual_seed(0)))
    got = tq.promote_int4({"w": w}, a8=True)["w"]
    monkeypatch.setenv("VITRON_W4A8_STATIC", "9")
    assert got["sx"].shape == (3, 1, 1) and got["sx"].dtype == torch.float32
    assert (got["sx"] == 0.03125).all()


# ------------------------------------------------------------------ dispatch

@pytest.mark.parametrize("key", ["q8", "qa8", "qa8_stacked", "qa8_lora", "q4", "q4_stacked",
                                 "q"])
def test_matmul_maybe_quantized_dispatch_matches_jax(jq, key):
    """Every key of `matmul_maybe_quantized`, the stacked "qa8" convert path
    and a LoRA bypass on a W4A8 base included, against JAX's dispatch."""
    import jax

    rs = np.random.RandomState(2)
    stacked = key.endswith("stacked")
    x = rs.randn(*((3, 5, 32) if stacked else (2, 5, 32))).astype(np.float32)
    w = rs.randn(*((3, 32, 16) if stacked else (32, 16)))
    if key == "q8":
        jw = jq.quantize_int8_a8(_j(w))
    elif key == "q":
        jw = jq.quantize_int8(_j(w))
    else:
        jw = jq.quantize_int4(_j(w))
        if key.startswith("qa8"):
            jw = jq.promote_int4({"w": jw}, a8=True)["w"]
    if key == "qa8_lora":
        jw = {**jw, "lora_a": _j(rs.randn(32, 4)), "lora_b": _j(rs.randn(4, 16)),
              "lora_scale": 0.5}
    want = jq.matmul_maybe_quantized(_j(x), jw)
    if key.startswith("qa8"):  # the port's W4A8 leaf keeps the packed nibbles
        base = jq.quantize_int4(_j(w))
        tw_ = {**{k: _t(np.asarray(v)) for k, v in jw.items()
                  if k not in ("qa8", "lora_scale")},
               "qa8": _t(np.asarray(base["q4"]))}
        if "lora_scale" in jw:
            tw_["lora_scale"] = 0.5
    else:
        tw_ = jax.tree.map(lambda a: _t(np.asarray(a)), jw)
    got = tq.matmul_maybe_quantized(_t(x), tw_)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_geglu_ff_on_q8_weights_matches_jax(jq):
    """`geglu_ff` with {"q8"} projections takes JAX's plain form."""
    from vitron_tpu.models.diffusion import layers as jl
    from vitron_tpu_torch.models.diffusion import layers as tl

    rs = np.random.RandomState(3)
    jp = {"proj_w": jq.quantize_int8_a8(_j(rs.randn(32, 128) * 0.2)),
          "proj_b": _j(rs.randn(128) * 0.1),
          "out_w": jq.quantize_int8_a8(_j(rs.randn(64, 32) * 0.2)),
          "out_b": _j(rs.randn(32) * 0.1)}
    x = rs.randn(2, 6, 32).astype(np.float32)
    want = jl.geglu_ff(jp, _j(x))
    tp = {k: ({kk: _t(np.asarray(vv)) for kk, vv in v.items()} if isinstance(v, dict)
              else _t(np.asarray(v))) for k, v in jp.items()}
    got = tl.geglu_ff(tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- quantize_params

def _unet_trees(which):
    """(JAX numpy tree, port tree) of a tiny live UNet."""
    import jax

    from vitron_tpu.models.diffusion import unet2d as ju
    from vitron_tpu.models.diffusion import unet_sd_video as jv
    from vitron_tpu_torch.models.convert import from_jax
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    if which == "sd":
        p = ju.init_params(jax.random.PRNGKey(0), ju.UNetConfig.tiny())
    else:
        p = jv.init_params(jax.random.PRNGKey(1), jv.UNetSDVideoConfig.tiny("t2v"))
    t = fill_zero_leaves(from_jax(jax.tree.map(np.asarray, p), "cpu"),
                         torch.Generator().manual_seed(5))
    return _to_jax(t), t


def _to_jax(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _assert_same_quantization(got, want):
    assert _quantized_paths(got) == _quantized_paths(want)
    for (pp, g), (jp, j) in zip(_walk(got), _walk(want)):
        assert pp == jp
        if isinstance(g, dict):
            for k in g:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("which,kw", [
    ("sd", {}), ("sd", {"min_channels": 32}),
    ("t2v", {}), ("t2v", {"min_dot_dim": 32}), ("t2v", {"min_tconv_dim": 32}),
    ("t2v", {"min_channels": 32, "min_dot_dim": 16, "min_tconv_dim": 32}),
])
def test_quantize_params_match_jax_and_are_idempotent(which, kw):
    """The same key paths quantized, to the same bits, as JAX's
    `quantize_params`; a second application changes nothing."""
    from vitron_tpu.models.diffusion import unet2d as ju
    from vitron_tpu.models.diffusion import unet_sd_video as jv
    from vitron_tpu_torch.models.diffusion import unet2d as tu
    from vitron_tpu_torch.models.diffusion import unet_sd_video as tv

    jmod, tmod = (ju, tu) if which == "sd" else (jv, tv)
    jtree, ttree = _unet_trees(which)
    want = jmod.quantize_params(jtree, **kw)
    got = tmod.quantize_params(ttree, **kw)
    paths = _quantized_paths(got)
    kinds = {"qc"} | ({"q8"} if "min_dot_dim" in kw else set()) | (
        {"q8t"} if "min_tconv_dim" in kw else set())
    assert {k for v in paths.values() for k in v} == kinds
    _assert_same_quantization(got, want)
    again = tmod.quantize_params(got, **kw)
    assert _quantized_paths(again) == paths
    for (_, a), (_, b) in zip(_walk(again), _walk(got)):
        assert a is b  # the very leaves: nothing re-quantized


# The quantized tiny UNets against JAX's quantized forwards. The int32 sums
# are exact on both sides (the module tests above), but the float32
# activations that reach each quantization differ by an ulp or so (the float
# layers sum in other orders), and an ulp can move x / sx across a rounding
# boundary: one int8 level of one activation. Measured max |port - JAX| /
# max |JAX| of a tiny SD UNet call over 6 inputs: 6e-7 (no flip) or
# 3.7e-3 / 5.0e-3 (a per-tensor flip); the SD and the served t2v nets
# (convs only) are held at 2^-7, which passes two flips and fails a
# dropped tap or a 1% scale error.
QUANT_UNET_TOL = 2 ** -7
# Every class of the t2v net quantized (convs at 32 channels, the
# transformer products per row, the 32 temporal convs' taps): a per-row
# flip at one site changes the next sites' inputs by ~1e-3, which flips
# more of them, and the tiny net compounds that to 3.7e-2 (a 1% error in
# one class's scales adds ~3e-2 to it, a dropped tap reaches 0.5). Held at
# 2^-4: this case proves the routes and their parity to within the flips;
# their exact sums are the module tests above.
QUANT_ALL_CLASSES_TOL = 2 ** -4


def _rel(got, want):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_quantized_sd_unet_forward_matches_jax():
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet2d as ju
    from vitron_tpu_torch.models.diffusion import unet2d as tu

    jtree, ttree = _unet_trees("sd")
    jq_, tq_ = ju.quantize_params(jtree, min_channels=32), tu.quantize_params(ttree,
                                                                              min_channels=32)
    rs = np.random.RandomState(6)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    t = np.asarray([981, 21], np.int32)
    ctx = rs.randn(2, 16, 16).astype(np.float32)
    objs = rs.randn(2, 4, 16).astype(np.float32)
    fwd = jax.jit(lambda p, *a: ju.forward(p, ju.UNetConfig.tiny(), *a, gate_scale=0.6))
    want = fwd(jq_, *(jnp.asarray(a) for a in (x, t, ctx, objs)))
    got = tu.forward(tq_, tu.UNetConfig.tiny(), _t(x), _t(t).long(), _t(ctx), _t(objs),
                     gate_scale=0.6)
    assert np.abs(np.asarray(want)).max() > 1.0  # a live net
    assert _rel(got, want) <= QUANT_UNET_TOL


@pytest.mark.parametrize("classes", ["served", "all"])
def test_quantized_t2v_unet_forward_matches_jax(classes):
    """The served quantization (convs at the default 64 channels) and every
    class quantized (convs at 32, transformer products, temporal taps)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jv
    from vitron_tpu_torch.models.diffusion import unet_sd_video as tv

    kw = {} if classes == "served" else dict(min_channels=32, min_dot_dim=16, min_tconv_dim=32)
    jtree, ttree = _unet_trees("t2v")
    jq_, tq_ = jv.quantize_params(jtree, **kw), tv.quantize_params(ttree, **kw)
    cfg = jv.UNetSDVideoConfig.tiny("t2v")
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3, 8, 8, 4).astype(np.float32)
    t = np.asarray([501.0, 17.0], np.float32)
    ctx = rs.randn(2, 5, cfg.context_dim).astype(np.float32)
    want = jax.jit(lambda p, *a: jv.forward(p, cfg, *a[:2], y=a[2]))(
        jq_, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    got = tv.forward(tq_, tv.UNetSDVideoConfig.tiny("t2v"), _t(x), _t(t), y=_t(ctx))
    assert np.abs(np.asarray(want)).max() > 0.1  # a live net
    assert _rel(got, want) <= (QUANT_UNET_TOL if classes == "served" else QUANT_ALL_CLASSES_TOL)


# ---------------------------------------------------- the pipelines' knobs

# The quantized tiny GLIGEN's image against JAX's: 4 PLMS steps of a CFG
# pair (guidance 7.5) through UNets whose single calls agree exactly or
# differ by a flipped activation level (measured over 6 inputs: 6e-7 or
# 3.7e-3 / 5.0e-3 of the output's largest value). The steps and the
# guidance compound the flips: measured max 12 and mean 2.18 uint8 levels
# (the float pipeline agrees within 1); held at twice that.
GLIGEN_W8A8_MAX_LEVELS = 24
GLIGEN_W8A8_MEAN_LEVELS = 4.5

def test_gligen_pipeline_under_unet_quant_routes_a_as_jax(monkeypatch):
    """VITRON_UNET_QUANT=w8a8: both GLIGEN constructors quantize both UNets
    at the same key paths; task A through `route` gives JAX's status, task
    and image shape, and the port's `run` on JAX's own x_T gives JAX's image
    within GLIGEN_W8A8_*_LEVELS."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import clip_text, gligen_pipeline as jgp, unet2d, vae
    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu.runtime.system import VitronSystem as JSystem
    from vitron_tpu_torch.models.convert import from_jax
    from vitron_tpu_torch.models.diffusion import gligen_pipeline as tgp
    from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
    from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
    from vitron_tpu_torch.runtime.system import VitronSystem

    monkeypatch.setenv("VITRON_UNET_QUANT", "w8a8")
    # the tiny UNet at 64 and 128 channels, so the default min_channels (64) takes most convs
    ucfg = unet2d.UNetConfig.tiny(model_channels=64)
    cfg = jgp.GligenConfig.tiny(unet=ucfg)
    ks = jax.random.split(jax.random.PRNGKey(0), 4)

    def live(p, seed):
        t = fill_zero_leaves(from_jax(jax.tree.map(np.asarray, p), "cpu"),
                             torch.Generator().manual_seed(seed))
        return _to_jax(t), t

    u = live(unet2d.init_params(ks[0], ucfg), 1)
    u9 = live(unet2d.init_params(ks[1], dataclasses.replace(ucfg, in_channels=9)), 2)
    v = live(vae.init_params(ks[2], cfg.vae), 3)
    tx = live(clip_text.init_params(ks[3], cfg.text), 4)
    tok = StubClipTokenizer(cfg.text.vocab_size)
    jpipe = jgp.GligenPipeline(cfg, u[0], v[0], tx[0], inpaint_unet_params=u9[0], tokenizer=tok)
    tcfg = tgp.GligenConfig.tiny(unet=tgp.unet2d.UNetConfig.tiny(model_channels=64))
    tpipe = tgp.GligenPipeline(tcfg, u[1], v[1], tx[1], inpaint_unet_params=u9[1], tokenizer=tok)
    for name in ("unet_params", "inpaint_unet_params"):
        paths = _quantized_paths(getattr(tpipe, name))
        assert len(paths) >= 10 and all(k == ["qc"] for k in paths.values())
        _assert_same_quantization(getattr(tpipe, name), getattr(jpipe, name))

    reply = ("<module>A</module><instruction>a red car on a street</instruction>"
             "<region>[0.1,0.2,0.6,0.8]</region>")
    jsys = JSystem(None)
    jsys.register_gligen(jpipe)
    want = route_model_output(jsys.registry, reply)
    tsys = VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30))
    tsys.register_gligen(tpipe)
    with torch.no_grad():
        got = tsys.route(reply)
    for key in ("status", "task", "text"):
        assert got[key] == want[key], key
    assert got["status"] == "ok" and got["image"].shape == want["image"].shape == (32, 32, 3)

    rng2, k = jax.random.split(jax.random.PRNGKey(0))
    x_t = _t(np.asarray(jax.random.normal(k, (1, cfg.latent_size, cfg.latent_size, 4))))
    inputs = tpipe.prepare("a red car on a street", [[0.1, 0.2, 0.6, 0.8]],
                           ["a red car on a street"])
    with torch.no_grad():
        img = tpipe.run(**inputs, x_t=x_t, steps=cfg.steps, guidance_scale=7.5,
                        alpha_type=(0.3, 0.0, 0.7)).numpy()
    jimg = np.asarray(want["image"]).astype(np.int32)
    assert jimg.std() > 10
    d = np.abs(img.astype(np.int32) - jimg)
    assert d.max() <= GLIGEN_W8A8_MAX_LEVELS and d.mean() <= GLIGEN_W8A8_MEAN_LEVELS
    del jnp


@pytest.mark.parametrize("kind", ["t2v", "i2v"])
def test_video_pipelines_under_vunet_quant_match_jax(monkeypatch, kind):
    """VITRON_VUNET_QUANT=w8a8: the T2V and I2V constructors quantize their
    UNet's convs at JAX's key paths (the defaults: convs only); unset, they
    leave the tree as it is."""
    import jax

    from vitron_tpu.models.diffusion import unet_sd_video as jv
    from vitron_tpu.models.diffusion import video_pipelines as jvp
    from vitron_tpu_torch.models.convert import from_jax
    from vitron_tpu_torch.models.diffusion import video_pipelines as tvp

    jcls, tcls = {"t2v": (jvp.Text2VideoConfig, tvp.Text2VideoConfig),
                  "i2v": (jvp.Image2VideoConfig, tvp.Image2VideoConfig)}[kind]
    variant = "t2v" if kind == "t2v" else "i2vgen"
    jcfg = jcls.tiny(unet=jv.UNetSDVideoConfig.tiny(variant, context_dim=16, y_dim=16, dim=64))
    tcfg = tcls.tiny(unet=tvp.unet_sd_video.UNetSDVideoConfig.tiny(variant, context_dim=16,
                                                                    y_dim=16, dim=64))
    unet = jax.tree.map(np.asarray, jv.init_params(jax.random.PRNGKey(2), jcfg.unet))
    tunet = from_jax(unet, "cpu")
    pipe_j = {"t2v": jvp.Text2VideoPipeline, "i2v": jvp.Image2VideoPipeline}[kind]
    pipe_t = {"t2v": tvp.Text2VideoPipeline, "i2v": tvp.Image2VideoPipeline}[kind]
    text = {"token_emb": torch.zeros(4, 16)}
    monkeypatch.delenv("VITRON_VUNET_QUANT", raising=False)
    assert pipe_t(tcfg, tunet, None, text).unet_params is tunet
    monkeypatch.setenv("VITRON_VUNET_QUANT", "w8a8")
    jp = pipe_j(jcfg, _to_jax(tunet), None, None)
    tp = pipe_t(tcfg, tunet, None, text)
    paths = _quantized_paths(tp.unet_params)
    assert len(paths) >= 8 and all(k == ["qc"] for k in paths.values())
    _assert_same_quantization(tp.unet_params, jp.unet_params)


def test_llama_greedy_stream_under_w4a8_matches_jax(monkeypatch):
    """VITRON_W4A8=1: a tiny Vitron system's int4 LLM decodes its greedy
    stream through the W4A8 path (`generate_scan`: the prefill and every
    decode step), identical to JAX's, and the port took Q1's plain version."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.quantization import quantize_llama
    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.runtime.generation import generate_scan as jax_scan
    from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from vitron_tpu_torch.mm.splice import plan_splice
    from vitron_tpu_torch.models import vitron_model as tvm
    from vitron_tpu_torch.models.convert import from_jax
    from vitron_tpu_torch.runtime import generation as tgen

    monkeypatch.setenv("VITRON_W4A8", "1")
    monkeypatch.delenv("VITRON_W4A8_STATIC", raising=False)
    cfg = jvm.VitronConfig.tiny()
    params = jax.tree.map(np.asarray, jvm.init_params(jax.random.PRNGKey(4), cfg))
    params["llm"] = jax.tree.map(np.asarray, quantize_llama(
        jax.tree.map(jnp.asarray, params["llm"]), bits=4, head=True))
    plan = plan_splice([[1, 5, 9, IMAGE_TOKEN_INDEX, 7, 11, 3]], ["image"], 32, image_len=16)
    arrays = (plan.token_ids, plan.media_idx, plan.use_media, plan.position_ids,
              plan.attention_mask, plan.seq_lens)
    px = np.random.RandomState(0).randn(1, 28, 28, 3).astype(np.float32)
    want = np.asarray(jax_scan(jax.tree.map(jnp.asarray, params), cfg,
                               tuple(jnp.asarray(a) for a in arrays), 16,
                               jax.random.PRNGKey(0), images=jnp.asarray(px)))
    calls = _Capture(tw.w4a8_matmul_plain)
    monkeypatch.setattr(tw, "w4a8_matmul_plain", calls)
    gen_ = tgen.Generator(from_jax(params, "cpu"), tvm.VitronConfig.tiny())
    got = gen_.scan(arrays, 16, images=torch.from_numpy(px))
    assert got.tolist() == want.tolist()
    # 7 projections a layer and the head, for the prefill and 15 decode steps
    layers = cfg.llm.num_layers
    assert len(calls.out) == (7 * layers + 1) * 16
    # the per-token path and the plain prefill keep B1's int4 leaves, as JAX's do
    assert "q4" in gen_.params["llm"]["layers"]["wq"]
    assert "qa8" in gen_.decode_params["llm"]["layers"]["wq"]


@pytest.mark.parametrize("which", ["sd", "t2v"])
def test_w8a8_site_enumeration_counts_the_forward(monkeypatch, which):
    """`chip_smoke.sd_w8a8_sites` / `video_w8a8_sites` (which the smoke's
    launch counts and Q2 rows read) list every conv a quantized forward
    sends to Q2, with its count: the full block structure (4 levels, 2 res
    blocks, the downs, the ups) at 32 channels and a 16 x 24 latent, all
    convs of 32 channels or more quantized."""
    import collections

    import chip_smoke
    from vitron_tpu_torch.models.diffusion import unet2d as tu
    from vitron_tpu_torch.models.diffusion import unet_sd_video as tv
    from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves

    seen = collections.Counter()
    plain = tcw.conv_s8_plain

    def record(xq, qc, ssx, stride, padding, dtype):
        seen[(tuple(xq.shape), qc.shape[-1], stride, padding)] += 1
        return plain(xq, qc, ssx, stride, padding, dtype)

    monkeypatch.setattr(tcw, "conv_s8_plain", record)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        if which == "sd":
            cfg = tu.UNetConfig.sd_v1(model_channels=32, num_heads=2, context_dim=16)
            p = tu.quantize_params(fill_zero_leaves(tu.init_params(g, cfg, "cpu"), g), 32)
            tu.forward(p, cfg, torch.randn(2, 16, 16, 4), torch.tensor([3, 5]),
                       torch.randn(2, 7, 16), torch.randn(2, 3, 16))
            want = chip_smoke.sd_w8a8_sites(cfg, 16, 2, 32)
        else:
            cfg = tv.UNetSDVideoConfig.t2v(dim=32, num_heads=2, head_dim=16, context_dim=16,
                                           y_dim=16)
            p = tv.quantize_params(fill_zero_leaves(tv.init_params(g, cfg, "cpu"), g), 32)
            tv.forward(p, cfg, torch.randn(1, 2, 16, 24, 4), torch.tensor([3.0]),
                       y=torch.randn(1, 7, 16))
            want = chip_smoke.video_w8a8_sites(cfg, 16, 24, 2, 32)
    assert seen == want and sum(want.values()) >= 20


# ------------------------------------------------------- Q1 / Q2 on the card

CHAT_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
# per output row: the int32 sums are exact on both sides, so float32 is
# bit-equal and a bf16 output may flip one rounding at most: 2^-7 of a row's largest
Q_ROW_REL = {torch.float32: 0.0, torch.bfloat16: 2 ** -7}


def _row_rel(got, want) -> float:
    diff = (got.float() - want.float()).abs().amax(-1)
    return (diff / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", CHAT_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 5, 8, 384])
def test_w4a8_kernel_matches_plain(cuda, m, k, n, dtype, static):
    """Q1 at the chat's four (K, N) shapes and M 1/4/5/8/384: the same
    xq and sums as the plain version (bit-equal in float32), the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=g, device=cuda) * 3).to(dtype)
    q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8, device=cuda)
    s = torch.rand((1, n), generator=g, device=cuda) * 1e-2 + 1e-3
    sx = torch.full((1, 1), 0.02, device=cuda) if static else None
    before = tw.launches
    got = tw.w4a8_matmul(x, q4, s, sx)
    again = tw.w4a8_matmul(x, q4, s, sx)
    torch.cuda.synchronize()
    assert tw.launches == before + 2 and got.dtype == dtype and got.shape == (m, n)
    want = tw.w4a8_matmul_plain(x, q4, s, sx)
    assert _row_rel(got, want) <= Q_ROW_REL[dtype]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2, 16, 16), (9, 48, 32), (70, 1040, 528), (3, 2064, 4112)])
def test_w4a8_kernel_ragged_shapes(cuda, m, k, n):
    """Ragged M (GEMV and GEMM), K one 16-row group past a tile, N one
    16-column group past a strip: float32, bit-equal to plain."""
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn((m, k), generator=g, device=cuda)
    q4 = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8, device=cuda)
    s = torch.rand((1, n), generator=g, device=cuda) + 0.5
    got = tw.w4a8_matmul(x, q4, s)
    torch.cuda.synchronize()
    assert torch.equal(got, tw.w4a8_matmul_plain(x, q4, s))


def test_w4a8_matmul_checks_and_never_falls_back_off_cpu():
    with pytest.raises(ValueError):
        tw.w4a8_matmul(torch.zeros(2, 8), torch.zeros(3, 8, dtype=torch.int8), torch.ones(1, 8))
    with pytest.raises(ValueError):
        tw.w4a8_matmul(torch.zeros(2, 8), torch.zeros(4, 8, dtype=torch.int8), torch.ones(1, 7))
    with pytest.raises(ValueError, match="one CUDA device"):
        tw.w4a8_matmul(torch.zeros(2, 8, device="meta"), torch.zeros(4, 8, dtype=torch.int8),
                       torch.ones(1, 8))


def w8a8_sites():
    """(x shape, C, Co, stride, padding) of every eligible W8A8 conv of the
    SD UNet (task A's CFG batch at 64x64) and the t2v UNet (task D's 48
    frames at 40x72), from chip_smoke's block-plan enumeration."""
    import chip_smoke

    return [(x, co, st, pad) for x, co, st, pad in sorted(chip_smoke.w8a8_sites())]


@pytest.mark.cuda
def test_conv2d_w8a8_kernel_matches_plain_at_every_site(cuda):
    """Q2 at every eligible conv of both UNets, in float32 and bf16: each
    output pixel within Q_ROW_REL of its largest |plain| (float32
    bit-equal), and the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for xs, co, stride, pad in w8a8_sites():
        xq = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8, device=cuda)
        qc = torch.randint(-127, 128, (3, 3, xs[-1], co), generator=g, dtype=torch.int8,
                           device=cuda)
        ssx = torch.rand((co,), generator=g, device=cuda) * 1e-5
        for dtype in (torch.float32, torch.bfloat16):
            got = tcw.conv_s8(xq, qc, ssx, stride, pad, dtype)
            again = tcw.conv_s8(xq, qc, ssx, stride, pad, dtype)
            want = tcw.conv_s8_plain(xq, qc, ssx, stride, pad, dtype)
            torch.cuda.synchronize()
            assert got.shape == want.shape, (xs, co, stride, pad)
            assert _row_rel(got, want) <= Q_ROW_REL[dtype], (xs, co, stride, pad, dtype)
            assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("xs,co,stride,pad", [((1, 5, 7, 16), 4, 1, 1), ((2, 9, 6, 48), 20, 2, 1),
                                              ((1, 11, 13, 80), 68, 2, 0),
                                              ((3, 4, 4, 32), 132, 1, 0)])
def test_conv2d_w8a8_kernel_ragged_shapes(cuda, xs, co, stride, pad):
    """C not a multiple of the 64-channel stage, Co not of the 64-column
    tile, odd sizes at stride 2, padding 0: bit-equal to plain in float32."""
    g = torch.Generator(device=cuda).manual_seed(co)
    xq = torch.randint(-127, 128, xs, generator=g, dtype=torch.int8, device=cuda)
    qc = torch.randint(-127, 128, (3, 3, xs[-1], co), generator=g, dtype=torch.int8, device=cuda)
    ssx = torch.rand((co,), generator=g, device=cuda)
    got = tcw.conv_s8(xq, qc, ssx, stride, pad, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, tcw.conv_s8_plain(xq, qc, ssx, stride, pad, torch.float32))


def test_conv2d_w8a8_checks():
    xq = torch.zeros(1, 4, 4, 16, dtype=torch.int8)
    qc = torch.zeros(3, 3, 16, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="scale"):
        tcw.conv_s8(xq, qc, torch.ones(7), 1, 1, torch.float32)
    with pytest.raises(NotImplementedError, match="stride 3"):
        tcw.conv_s8(xq, qc, torch.ones(8), 3, 1, torch.float32)
    with pytest.raises(ValueError, match="one CUDA device"):
        tcw.conv_s8(xq.to("meta"), qc, torch.ones(8), 1, 1, torch.float32)
    assert tcw.conv_s8(xq, qc, torch.ones(8), 2, 0, torch.float32).shape == (1, 1, 1, 8)
