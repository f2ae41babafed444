"""Run a function on n CPU processes joined by a gloo process group.

The port's multi-rank tests: `run(n, "module:function", *args, tmp=...)`
spawns n processes (one torch thread each), joins them into one group by a
`file://` store under `tmp`, calls the function on every rank and returns
its results by rank. The function lives in a module that imports torch and
the port only (the children import no JAX); arguments and results are
pickled (numpy arrays, numbers). A rank that raises ends the run: the
other ranks are killed and the traceback is raised here.
"""
import importlib
import os
import queue
import time
import traceback
import uuid

import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 120.0


def _child(rank, n, init, target, args, out):
    import torch

    torch.set_num_threads(1)
    from vitron_tpu_torch.core import distributed as vd

    try:
        vd.initialize(vd.DistributedConfig(num_processes=n, process_id=rank, init_method=init),
                      backend="gloo", timeout_s=GROUP_TIMEOUT_S)
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)(*args)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        vd.shutdown()


def run(n, target, *args, tmp, timeout=300.0):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    init = f"file://{os.path.join(str(tmp), 'pg_' + uuid.uuid4().hex)}"
    procs = [ctx.Process(target=_child, args=(r, n, init, target, args, out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n and not errors:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results and p.exitcode is not None]
                if dead:
                    errors.append(f"ranks {dead} exited without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout} s with ranks {sorted(results)} done")
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
            if p.is_alive():
                p.kill()
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(n)]
