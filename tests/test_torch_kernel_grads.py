"""Gradients of the port's kernels against the JAX package's custom VJPs.

On the CPU each wrapper's `torch.autograd.Function` wraps the kernel's plain
version, so these tests hold the Functions' backward formulas against
`jax.vjp` of the JAX entry points, whose forwards (and, for B6 and B4, whose
dx) go through the Pallas kernels in interpret mode, as the JAX package's own
tests run them: B8 `group_norm_sums`, B3 `geglu_ff`, B7 `frame_attention`,
B6 `temporal_conv_k3`, B4 `depthwise_conv2d`. Then the plain flash backward
and LSE at the SD UNet's head dims 40/80/160 (non-causal, softmax shift 0,
the diffusion trainers' sites) against `_flash_forward` / `jax.grad` of the
Pallas kernels in interpret mode. Every case gives both packages the same
numpy inputs from a seeded RandomState; errors are max |port - JAX| / max
|JAX|: 1e-5 in float32 (the order of float32 sums differs), 2e-2 in
bfloat16 (flash only; both sides round q * scale, p and ds to bf16 at other
sums).

The `cuda` tests hold each Function on the card: its output under grad has
a `grad_fn` and counts one launch (B6's and B4's backward one more, for dx),
and its gradients match the plain autograd within the smoke's limits.
"""
import functools

import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import depthwise_conv as tdw
from vitron_tpu_torch.kernels import flash_attention as tfa
from vitron_tpu_torch.kernels import geglu_ff as tgf
from vitron_tpu_torch.kernels import group_norm as tgn
from vitron_tpu_torch.kernels import temporal_attention as tta
from vitron_tpu_torch.kernels import temporal_conv as ttc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port_vjp(fn, inputs, g):
    """fn's output and the gradients of sum(out * g) for each input."""
    xs = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn(*xs)
    assert out.grad_fn is not None
    out.backward(torch.tensor(g))
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


def _jax_vjp(fn, inputs, g):
    import jax
    import jax.numpy as jnp

    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _interpret(monkeypatch, module, name):
    """Route the JAX module's Pallas entry `name` through interpret mode."""
    monkeypatch.setattr(module, name, functools.partial(getattr(module, name), interpret=True))


def _check(got, want, names, out_tol=TOL["float32"]):
    (out, grads), (want_out, want_grads) = got, want
    if out_tol is not None:
        assert _rel(out, want_out) <= out_tol
    for name, a, w in zip(names, grads, want_grads):
        assert np.abs(w).max() > 0, name
        assert _rel(a, w) <= TOL["float32"], (name, _rel(a, w))


def test_group_norm_sums_grad_matches_jax_vjp(monkeypatch):
    from vitron_tpu.kernels import group_norm as jgn

    _interpret(monkeypatch, jgn, "_sums_pallas")
    rs = np.random.RandomState(0)
    x = rs.randn(2, 64, 128).astype(np.float32)
    g = rs.randn(2, 2, 128).astype(np.float32)
    got = _port_vjp(tgn.group_norm_sums, [x], g)
    want = _jax_vjp(lambda a: jgn.group_norm_sums(a, use_pallas=True), [x], g)
    _check(got, want, ["dx"])


def test_geglu_ff_grad_matches_jax_vjp(monkeypatch):
    """The JAX forward is the Pallas kernel's tanh gelu (ROADMAP C2), so the
    output is held against the XLA form; the gradients are both packages'
    VJP of that erf form."""
    from vitron_tpu.kernels import geglu_ff as jgf

    _interpret(monkeypatch, jgf, "_geglu_ff_fwd")
    rs = np.random.RandomState(1)
    c, f = 128, 512
    args = [rs.randn(2, 256, c), rs.randn(c, 2 * f) / c ** 0.5, 0.1 * rs.randn(2 * f),
            rs.randn(f, c) / f ** 0.5, 0.1 * rs.randn(c)]
    args = [a.astype(np.float32) for a in args]
    g = rs.randn(2, 256, c).astype(np.float32)
    got = _port_vjp(tgf.geglu_ff, args, g)
    want = _jax_vjp(jgf.geglu_ff_fused, args, g)
    _check(got, want, ["dx", "dW1", "db1", "dW2", "db2"], out_tol=None)
    xla = _jax_vjp(lambda x, *w: jgf._xla_geglu(x.reshape(-1, c), *w), args, g.reshape(-1, c))
    assert _rel(got[0].reshape(-1, c), xla[0]) <= TOL["float32"]


def test_frame_attention_grad_matches_jax_vjp(monkeypatch):
    from vitron_tpu.kernels import temporal_attention as jta

    _interpret(monkeypatch, jta, "_fwd")
    rs = np.random.RandomState(2)
    heads, d = 2, 64
    q, k, v = (0.5 * rs.randn(2, 6, 128, heads * d).astype(np.float32) for _ in range(3))
    g = rs.randn(*q.shape).astype(np.float32)
    scale = d ** -0.5
    got = _port_vjp(lambda a, b, c: tta.frame_attention(a, b, c, heads, scale), [q, k, v], g)
    want = _jax_vjp(lambda a, b, c: jta.frame_attention(a, b, c, heads, scale), [q, k, v], g)
    _check(got, want, ["dq", "dk", "dv"])


def test_temporal_conv_grad_matches_jax_vjp(monkeypatch):
    """JAX's dx runs the Pallas kernel on the flipped taps, as the port's dx
    runs B6 on the card; the bias gradient is a sum on both sides."""
    from vitron_tpu.kernels import temporal_conv as jtc

    _interpret(monkeypatch, jtc, "_tconv_pallas")
    rs = np.random.RandomState(3)
    x = rs.randn(1, 5, 3, 4, 32).astype(np.float32)
    w = (0.1 * rs.randn(3, 32, 48)).astype(np.float32)
    bias = rs.randn(48).astype(np.float32)
    g = rs.randn(1, 5, 3, 4, 48).astype(np.float32)
    got = _port_vjp(ttc.temporal_conv_k3, [x, w, bias], g)
    want = _jax_vjp(lambda a, b, c: jtc.temporal_conv_k3(a, b, c, use_pallas=True),
                    [x, w, bias], g)
    _check(got, want, ["dx", "dw", "dbias"])


def test_depthwise_conv_grad_matches_jax_vjp(monkeypatch):
    """JAX's dx runs the Pallas kernel with the flipped filter, as the port's
    dx runs B4 on the card."""
    from vitron_tpu.kernels import depthwise_conv as jdw

    _interpret(monkeypatch, jdw, "_dw_pallas")
    rs = np.random.RandomState(4)
    x = rs.randn(2, 12, 10, 64).astype(np.float32)
    w = (0.2 * rs.randn(5, 5, 64)).astype(np.float32)
    bias = rs.randn(64).astype(np.float32)
    g = rs.randn(2, 12, 10, 64).astype(np.float32)
    got = _port_vjp(tdw.depthwise_conv2d, [x, w, bias], g)
    want = _jax_vjp(lambda a, b, c: jdw.depthwise_conv2d(a, b, c, use_pallas=True),
                    [x, w, bias], g)
    _check(got, want, ["dx", "dw", "dbias"])


def test_no_grad_builds_no_graph():
    """Without grad mode, or with no input needing a gradient, the wrappers
    return plain outputs."""
    x = torch.randn(1, 3, 4, 8)
    w = torch.randn(3, 3, 8, requires_grad=True)
    assert tdw.depthwise_conv2d(x, w.detach()).grad_fn is None
    with torch.no_grad():
        assert tdw.depthwise_conv2d(x, w).grad_fn is None
    assert tgn.group_norm_sums(x.reshape(1, 12, 8)).grad_fn is None
    assert tta.frame_attention(x, x, x, 2, 0.5).grad_fn is None


# ----------------------------------------------- flash at the UNet's head dims

FLASH_SHAPES = [  # (S, T, N, D): ragged against the interpret kernels' 8-row blocks
    (20, 20, 2, 40), (13, 21, 2, 80), (11, 11, 1, 160)]


def _flash_inputs(s, t, n, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32)
            for shape in ((2, s, n, d), (2, t, n, d), (2, t, n, d), (2, s, n, d))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: f"d{s[3]}")
def test_plain_lse_at_shift_zero_matches_jax(shape, dtype):
    """The LSE the diffusion backward reads: shift 0 + log(sum of
    exp(min(logit, 60))), non-causal."""
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import _flash_forward

    s, t, n, d = shape
    q, k, v, _ = _flash_inputs(s, t, n, d, 5)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v))
    want_out, want_lse = _flash_forward(jq, jk, jv, None, 0, d ** -0.5, 8, 8, interpret=True,
                                        causal=False, save_lse=True, softmax_shift=0.0)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    got_out, got_lse = tfa.flash_attention_plain(tq, tk, tv, None, 0, d ** -0.5, False, 0.0,
                                                 return_lse=True)
    assert _rel(got_lse.numpy(), np.asarray(want_lse)[:, :, :s]) <= TOL[dtype]
    assert _rel(got_out.float().numpy(), np.asarray(want_out.astype(jnp.float32))) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: f"d{s[3]}")
def test_plain_backward_at_unet_head_dims_matches_jax(shape, dtype):
    """The plain backward (B5a's and B5b's plain versions) and the
    autograd.Function on the CPU against jax.grad of the Pallas flash
    attention in interpret mode, non-causal at shift 0."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import flash_attention as jax_flash

    s, t, n, d = shape
    q, k, v, g = _flash_inputs(s, t, n, d, 6)
    jq, jk, jv, jg = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v, g))

    def loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, block_q=8, block_k=8, interpret=True, causal=False,
                        softmax_shift=0.0)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = [np.asarray(w.astype(jnp.float32))
            for w in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    tq, tk, tv, tg = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, g))
    scale = d ** -0.5
    out, lse = tfa.flash_attention_plain(tq, tk, tv, None, 0, scale, False, 0.0,
                                         return_lse=True)
    plain = tfa.flash_attention_bwd_plain(tq, tk, tv, None, 0, scale, False, out, lse, tg)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    auto = torch.autograd.grad(tfa.flash_attention(*leaves, causal=False, softmax_shift=0.0),
                               leaves, tg)
    for what, got in (("plain", plain), ("autograd", auto)):
        for name, a, w in zip("qkv", got, want):
            assert _rel(a.float().numpy(), w) <= TOL[dtype], (what, "d" + name)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _card_cases():
    """(name, module, fn, input shapes, dtype): one small site each."""
    return [
        ("group_norm_sums", tgn, tgn.group_norm_sums, [(2, 1024, 320)]),
        ("geglu_ff", tgf, tgf.geglu_ff, [(2, 256, 320), (320, 2560), (2560,), (1280, 320),
                                         (320,)]),
        ("frame_attention", tta, lambda q, k, v: tta.frame_attention(q, k, v, 8, 64 ** -0.5),
         [(1, 8, 256, 512)] * 3),
        ("temporal_conv_k3", ttc, ttc.temporal_conv_k3, [(1, 8, 16, 16, 512), (3, 512, 512),
                                                         (512,)]),
        ("depthwise_conv2d", tdw, tdw.depthwise_conv2d, [(1, 56, 56, 96), (7, 7, 96), (96,)]),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5), ids=[c[0] for c in _card_cases()])
def test_functions_on_the_card(cuda, case):
    """Under grad each kernel output carries a grad_fn and counts one
    launch; the backward launches B6 and B4 once more (their dx) and the
    others not at all; the card's gradients match the CPU's autograd of the
    plain version (float32, 1e-4 of the largest) and come out the same bits
    twice."""
    name, mod, fn, shapes = _card_cases()[case]
    g = torch.Generator().manual_seed(case)
    inputs = [0.5 * torch.randn(s, generator=g) for s in shapes]

    def run(device):
        xs = [a.to(device).requires_grad_(True) for a in inputs]
        before = mod.launches
        out = fn(*xs)
        fwd = mod.launches - before
        assert out.grad_fn is not None, name
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)).to(device)
        out.backward(cot)
        return fwd, mod.launches - before - fwd, [x.grad.cpu() for x in xs]

    fwd, bwd, grads = run(cuda)
    _, _, again = run(cuda)
    assert fwd == 1 and bwd == (1 if name in ("temporal_conv_k3", "depthwise_conv2d") else 0)
    xs = [a.clone().requires_grad_(True) for a in inputs]
    plain = {"group_norm_sums": tgn.group_norm_sums_plain,
             "geglu_ff": lambda x, *w: tgf.geglu_ff_plain(x.reshape(-1, x.shape[-1]), *w),
             "frame_attention": lambda q, k, v: tta.frame_attention_plain(q, k, v, 8,
                                                                          64 ** -0.5),
             "temporal_conv_k3": lambda x, w, b: ttc.temporal_conv_k3_plain(
                 x.reshape(1, 8, 256, 512), w, b),
             "depthwise_conv2d": lambda x, w, b: tdw.depthwise_conv2d_plain(x, w) + b}[name]
    out = plain(*xs)
    out.backward(torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
                 .reshape(out.shape))
    for i, (a, b, x) in enumerate(zip(grads, again, xs)):
        assert torch.equal(a, b), (name, i)
        assert _rel(a.numpy(), x.grad.numpy()) <= 1e-4, (name, i)
