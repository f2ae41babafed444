#!/usr/bin/env python3
"""Registers and spills of each kernel in the port's CUDA sources, as ptxas
reports them.

    python3 tools/ptxas_regs.py [--root CHECKOUT] [--out FILE.json] [SOURCE ...]

Compiles each named source of `vitron_tpu_torch/csrc/` (default:
`flash_attention_bwd`) with the flags of the port's build
(`_build.NVCC_FLAGS`) and `-Xptxas -v`, all sources at once, and prints one
line per kernel: its name (demangled by `cu++filt` where the toolkit has
it), registers, stack frame and spill stores and loads. Writes the same
rows, and ptxas's own output, to `--out` when given. Exits 1 when any
kernel spills or a source fails to compile. Needs `nvcc`; no device.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse(text: str) -> list:
    """ptxas -v output -> [{kernel, registers, stack, spill_stores,
    spill_loads}] in the order ptxas reports the kernels."""
    rows, cur = [], None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1)}
            rows.append(cur)
        elif cur is not None and (m := _FRAME.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
    return rows


def demangle(names: list) -> list:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*", default=["flash_attention_bwd"])
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    from vitron_tpu_torch.kernels import _build

    nvcc = _build._nvcc()
    report, failed = {}, False
    with tempfile.TemporaryDirectory() as tmp:
        procs = {name: subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(_build.CSRC / f"{name}.cu"),
             "-o", str(Path(tmp) / f"{name}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name in args.sources}
        for name, proc in procs.items():
            text, _ = proc.communicate()
            rows = parse(text)
            for row, pretty in zip(rows, demangle([r["kernel"] for r in rows])):
                row["name"] = pretty
            report[name] = {"rc": proc.returncode, "kernels": rows, "ptxas": text}
            if proc.returncode != 0:
                failed = True
                print(f"{name}: nvcc exit {proc.returncode}\n{text}")
    for name, entry in report.items():
        for row in entry["kernels"]:
            spills = row.get("spill_stores", 0) + row.get("spill_loads", 0)
            failed |= spills > 0
            print(f"{name}: {row['name']}: {row.get('registers')} registers, "
                  f"stack {row.get('stack')} B, spill stores {row.get('spill_stores')} B, "
                  f"spill loads {row.get('spill_loads')} B")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print("ptxas: " + ("FAILED (a spill or a failed compile)" if failed else "no spills"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
