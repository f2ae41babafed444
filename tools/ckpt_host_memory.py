"""The host memory that moving a mapped checkpoint's tensors to the card adds.

Writes a float32 `.pth` state dict of about `--gib` GiB (a few 256 MiB
tensors and many 1 MiB ones), then, each in a fresh process, maps it with
`torch.load(mmap=True)` and reads every tensor one way:
- `to`: `tensor.to("cuda")` straight from the mapping;
- `loader`: `layers.OnDevice`, the port's diffusion converters' reader;
- `host`: a host-only pass (`tensor.sum()`), no card.
While it runs, a thread samples the resident set (/proc/self/statm), its
part that statm does not call shared (resident less shared), and its
anonymous part (`chip_smoke.anon_bytes`, the `Anonymous:` lines of
/proc/self/smaps, which leave a mapped file's own pages out). Prints one
JSON line per way: seconds, the peak growth of each, the milliseconds of one
smaps read, and the card's name and power limit.

    python3 tools/ckpt_host_memory.py [--gib 2] [--ways to loader host]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def memory() -> tuple:
    """(resident, resident less shared, anonymous) bytes of this process."""
    from chip_smoke import anon_bytes

    with open("/proc/self/statm") as fh:
        resident, shared = (int(f) for f in fh.read().split()[1:3])
    page = os.sysconf("SC_PAGE_SIZE")
    return resident * page, (resident - shared) * page, anon_bytes()


def one_way(path: str, way: str) -> dict:
    import torch

    from vitron_tpu_torch.models.diffusion.layers import OnDevice
    from vitron_tpu_torch.models.llm.loader import load_torch_pth

    if way != "host":
        torch.zeros(1, device="cuda")  # the context, before the count starts
        torch.cuda.synchronize()
    memory()  # imports chip_smoke
    t0 = time.perf_counter()
    before = memory()
    smaps_ms = (time.perf_counter() - t0) * 1e3
    peak = list(before)
    stop = threading.Event()

    def sample():
        while not stop.wait(0.02):
            peak[:] = map(max, peak, memory())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    t0 = time.perf_counter()
    sd = load_torch_pth(path)
    if way == "host":
        kept = [float(v.sum()) for v in sd.values()]
    elif way == "to":
        kept = [v.to("cuda") for v in sd.values()]
    else:
        view = OnDevice(sd, torch.device("cuda"))
        kept = [view[k] for k in sd]
    if way != "host":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stop.set()
    th.join()
    peak[:] = map(max, peak, memory())
    del kept, sd
    growth = [(p - b) / 2**30 for p, b in zip(peak, before)]
    return {"way": way, "seconds": seconds, "rss_growth_gib": growth[0],
            "statm_unshared_growth_gib": growth[1], "smaps_anon_growth_gib": growth[2],
            "smaps_read_ms": smaps_ms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=2.0)
    ap.add_argument("--ways", nargs="+", default=["to", "loader", "host"])
    ap.add_argument("--one", nargs=2, metavar=("PATH", "WAY"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_way(*args.one)), flush=True)
        return 0
    import torch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        path = os.path.join(d, "probe.pth")
        big = int(args.gib * 3)  # 256 MiB tensors: three quarters of it
        small = int(args.gib * 256)  # 1 MiB tensors: the rest
        g = torch.Generator().manual_seed(0)
        sd = {f"big.{i}": torch.randn(2**26, generator=g) for i in range(big)}
        sd.update({f"small.{i}": torch.randn(2**18, generator=g) for i in range(small)})
        torch.save(sd, path)
        del sd
        size = os.path.getsize(path)
        rc = 0
        for way in args.ways:
            out = subprocess.run([sys.executable, __file__, "--one", path, way],
                                 capture_output=True, text=True)
            rc = rc or out.returncode
            row = (json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0
                   else {"way": way, "error": out.stderr.strip().splitlines()[-1:]})
            print(json.dumps({**row, "file_gib": size / 2**30, "card": card}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
