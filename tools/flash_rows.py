#!/usr/bin/env python3
"""Time the port's flash-attention forward (B2), or with `--bwd` its
backward (B5a + B5b), at the shapes that `chip_smoke.py` holds it at, for
one checkout of the repo.

    python3 tools/flash_rows.py [--bwd] [--root CHECKOUT] [--label NAME] [--out FILE.json]

The shapes, the timers and the bound are the smoke's (`b2_shapes`,
`cuda_ms`, `graph_ms`, `sdpa_ms`, `row`), from the checkout this script
lies in; `--root` names the checkout whose `vitron_tpu_torch` is imported
(default: this one), so two versions of the kernel can be timed in turns
on one card (parent, change, change, parent: one process each). For each
shape it prints the wrapper's median CUDA-event time (host launch cost
included, as a caller meets it), the device time of one call from
CUDA-graph replay (the host's cost left out),
F.scaled_dot_product_attention's on the same inputs (the yardstick; the
port never calls it), the bound (bytes read and written once, or the FLOP
of the visible (query, key) pairs at the peak for the type, whichever is
larger), the rate, max |kernel - plain| and the smoke's per-row relative
error; `--out` writes the rows as JSON. Needs one CUDA device.

With `--bwd` the shapes are the smoke's training rows (`TRAIN_FLASH_CASES`,
bf16 and float32: phase 18) and each row gives B5a's and B5b's CUDA-event
times (the wrappers as the autograd backward calls them, sharing one
delta), the SDPA backward's (dq, dk and dv in one call), the bound of the
five products a fused backward needs and of the seven these kernels run
(FLOP of the visible pairs at the peak for the type, or the bytes, the
larger), the seven products' rate, and each output's max |kernel - plain| /
max |plain| and per-row error (`flash_row_rel` with
FLASH_BWD_ROW_FLOOR).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def fwd_rows(torch, fa, smoke, card: str, label: str) -> list:
    """B2 at every shape of `b2_shapes`."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    out_rows = []
    for sh in smoke.b2_shapes():
        b, s, t, n, kh, d = (sh[x] for x in ("b", "s", "t", "n", "kh", "d"))
        dt = getattr(torch, sh["dtype"])
        q = torch.randn((b, s, n, d), generator=g, device=dev).to(dt)
        k, v = (torch.randn((b, t, kh, d), generator=g, device=dev).to(dt) for _ in range(2))
        mask = None
        if sh["valid"] is not None:
            mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
            valid = sh["valid"] * b if len(sh["valid"]) == 1 else sh["valid"]
            for i, j in enumerate(valid):
                mask[i, :j] = True
        call = (q, k, v, mask, sh["q_offset"], d ** -0.5, sh["causal"], sh["shift"], sh["lse"])
        got = fa._forward(*call)[0]
        want = fa.flash_attention_plain(*call[:-1])
        err, rel = smoke.rel_err(got, want)
        row_rel = smoke.flash_row_rel(got, want)
        del want
        ms = smoke.cuda_ms(torch, lambda: fa._forward(*call), iters=10)
        dev_ms = smoke.graph_ms(torch, lambda: fa._forward(*call), calls=10, replays=3)
        visible = fa._visible(b, s, t, dev, mask, sh["q_offset"], sh["causal"])[:, 0, 0]
        pairs = int(visible.expand(b, s, t).sum()) * n
        sdpa = smoke.sdpa_ms(torch, q, k, v,
                             visible[:, None] if (sh["causal"] or mask is not None) else None)
        lse_bytes = 4 * b * n * s if sh["lse"] else 0
        r = smoke.row(err, rel, ms, None, smoke.nbytes(q, k, v, got, *(
            () if mask is None else (mask,))) + lse_bytes, 4 * d * pairs,
            "bf16_tensor" if dt == torch.bfloat16 else "fp32", sdpa)
        bound = max(r["bytes_ms"], r["ops_ms"])
        out = {"name": sh["label"], "dtype": sh["dtype"], "ms": ms, "graph_ms": dev_ms,
               "sdpa_ms": sdpa, "bound_ms": bound, "tflops": 4 * d * pairs / (ms * 1e-3) / 1e12,
               "max_abs_err": err, "row_rel_err": row_rel}
        out_rows.append(out)
        print(f"{label} {sh['label']} keys {t} {sh['dtype']}: kernel "
              f"{ms:.4f} ms ({out['tflops']:.1f} TFLOP/s), graph-replayed {dev_ms:.4f} ms, SDPA "
              f"{sdpa:.4f} ms, bound {bound:.4f} ms, max abs err {err:.3e}, row rel err "
              f"{row_rel:.3e} [{card}]", flush=True)
        del q, k, v, got, mask, visible
        torch.cuda.empty_cache()
    return out_rows


def bwd_rows(torch, fa, smoke, card: str, label: str) -> list:
    """B5a + B5b at the smoke's training rows, bf16 and float32."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    out_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tn = str(dtype).split(".")[1]
        peak = "bf16_tensor" if dtype == torch.bfloat16 else "fp32"
        for name, b, s, t, n, kh, d, off, causal, valid in smoke.TRAIN_FLASH_CASES:
            mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
            for i, j in enumerate(valid):
                mask[i, :j] = True
            q, dout = (torch.randn((b, s, n, d), generator=g, device=dev).to(dtype)
                       for _ in range(2))
            k, v = (torch.randn((b, t, kh, d), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            args = (q, k, v, mask, off, d ** -0.5, causal)
            out, lse = fa._forward(*args, None, True)
            delta = fa._delta(out, dout)
            dk, dv = fa.flash_attention_bwd_kv(*args, out, lse, dout, delta)
            dq = fa.flash_attention_bwd_q(*args, out, lse, dout, delta)
            want_dk, want_dv = fa.flash_attention_bwd_kv_plain(*args, out, lse, dout)
            want_dq = fa.flash_attention_bwd_q_plain(*args, out, lse, dout)
            floor = smoke.FLASH_BWD_ROW_FLOOR
            errs = {w: (smoke.rel_err(x, y)[1], smoke.flash_row_rel(x, y, floor))
                    for w, x, y in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))}
            del want_dk, want_dv, want_dq
            ms_kv = smoke.cuda_ms(torch, lambda: fa.flash_attention_bwd_kv(
                *args, out, lse, dout, delta), iters=10)
            ms_q = smoke.cuda_ms(torch, lambda: fa.flash_attention_bwd_q(
                *args, out, lse, dout, delta), iters=10)
            visible = fa._visible(b, s, t, dev, mask, off, causal)[:, 0, 0]
            pairs = int(visible.sum()) * n
            sdpa = smoke.sdpa_bwd_ms(torch, q, k, v, visible[:, None], dout)
            nb = smoke.nbytes(q, k, v, mask, out, dout, lse, dq, dk, dv) / smoke.HBM_BYTES_PER_S
            five, seven = (max(nb, m * 2 * d * pairs / smoke.PEAK_FLOPS[peak]) * 1e3
                           for m in (5, 7))
            r = {"name": f"train {name} [{b},{s},{n}/{kh},{d}] T {t}", "dtype": tn,
                 "b5a_ms": ms_kv, "b5b_ms": ms_q, "ms": ms_kv + ms_q, "sdpa_bwd_ms": sdpa,
                 "bound5_ms": five, "bound7_ms": seven,
                 "tflops7": 7 * 2 * d * pairs / ((ms_kv + ms_q) * 1e-3) / 1e12,
                 "pairs": pairs, "rel_err": {w: e[0] for w, e in errs.items()},
                 "row_rel_err": {w: e[1] for w, e in errs.items()}}
            out_rows.append(r)
            print(f"{label} {r['name']} {tn}: B5a {ms_kv:.4f} ms + B5b {ms_q:.4f} ms = "
                  f"{r['ms']:.4f} ms ({r['tflops7']:.1f} TFLOP/s of seven products), SDPA "
                  f"backward {sdpa:.4f} ms, bound five {five:.4f} / seven {seven:.4f} ms; rel "
                  + " ".join(f"{w}={e[0]:.3e}" for w, e in errs.items()) + ", row rel "
                  + " ".join(f"{w}={e[1]:.3e}" for w, e in errs.items()) + f" [{card}]",
                  flush=True)
            del q, k, v, dout, out, lse, delta, dq, dk, dv, mask, visible
            torch.cuda.empty_cache()
    return out_rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bwd", action="store_true", help="time B5a + B5b, not B2")
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from vitron_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_rows: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    card = smoke.nvidia_smi_line()
    print(f"{args.label}: {fa.__file__} on {card}", flush=True)
    out_rows = (bwd_rows if args.bwd else fwd_rows)(torch, fa, smoke, card, args.label)
    if args.out:
        Path(args.out).write_text(json.dumps({"label": args.label, "card": card,
                                              "rows": out_rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
