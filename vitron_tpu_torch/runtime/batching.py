"""Continuous-batching serving: concurrent chat requests co-batch decode.

Port of `vitron_tpu/runtime/batching.py`. Single-token decode is bound by
the weight stream: a step reads every weight to produce ONE token per
sequence, so decoding B sequences in one program reads the weights once
for B tokens. `ContinuousBatcher` turns that into a serving loop:

- handler threads `submit()` prepared requests (splice plan + media, on
  the host) and block on a Future;
- ONE device loop thread owns all LLM device work: it moves requests to the
  device, admits them (a multimodal spliced prefill into a dense cache,
  copied into `PagedServer` pool blocks), then decodes `chunk` tokens for
  every active sequence in one program (`PagedServer.step_n`, a CUDA graph
  replay on the card, with per-row temperature/top_p/greedy sampling);
- sequences join/leave at chunk boundaries; EOS / keyword-stop / budget are
  enforced on the host between chunks, as on the single-stream chunked path
  (runtime/generation.py `_generate_chunked`);
- a prompt whose pad bucket is longer than `prefill_chunk` is admitted in
  stages, one device step a loop iteration, with a decode chunk between
  them: the spliced embeddings (media encode + splice), then the decoder
  prefill in `prefill_chunk`-token chunks at the cache's offset
  (`llama.forward`'s cache path: the flash kernel with `q_offset` and a
  partial `kv_mask`), the last chunk running to the end of the pad bucket.
  Prompts that fit in one chunk keep the fused admission (encode + splice +
  prefill + sample). Admission-stall telemetry (`admit_step_s_max`, the
  longest single admission device step) is in `stats()`.

Three faults of the JAX loop are not carried over: its prefill chunk is
`gcd(pad_len, prefill_chunk)` (a 384-slot bucket with chunk 256 became
three chunks of 128; here 256 + 128); a short prompt queued behind a long
one waits until the whole staged admission ends (here short prompts are
admitted while a staged admission advances, one staged admission at a
time); and `close()` fails the futures while the loop thread may still run
(here it joins the thread first).

Sampling: a request's first token and its decode columns draw their
uniforms from the request's own `torch.Generator` when it gives one (else
from the batcher's, seeded with `seed`), so a sampled request gives the
same tokens whichever requests share its chunks. Speculative decode is not
used here.

On a mesh (`mesh=`, `runtime/sharded_serving.install_mesh`'s params) the
pool holds this rank's KV heads, and with more than one rank every rank
runs its own batcher in lockstep: rank 0 runs the loop thread and, before
each device step, broadcasts one fixed-size int64 control tensor
(`sharded_serving.Lockstep`) that names the step (an admission with its
token ids, sampling state and first uniform, then its plan and media
tensors; a staged admission's step; a decode chunk with its rows' sampling
state and uniforms) and the sequences that finished since the last one;
the other ranks run `follow()`, which repeats each step on the same inputs
and so issues the same collectives. Rank 0's loop sends a no-op when it has
been idle for `HEARTBEAT_S` (the followers' broadcast would time out
otherwise) and a stop when it ends.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vitron_tpu_torch.core.mesh import Mesh
from vitron_tpu_torch.kernels.quantization import promote_int4
from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.models.llm import llama
from vitron_tpu_torch.models.llm.paged_cache import PagedServer, sample_token_batched
from vitron_tpu_torch.runtime.generation import SamplingConfig, uniforms
from vitron_tpu_torch.runtime.sharded_serving import Lockstep, f64_bits, from_f64_bits

HEARTBEAT_S = 1.0
# lockstep ops (slot 0 of the control tensor)
NOOP, STOP, ADMIT, STAGE, STEP, DECODE = range(6)
_MEDIA_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.uint8)
_MEDIA_DIMS = 6
_JOB_HEADER = 8 + 2 * (_MEDIA_DIMS + 2)  # `_job_header`'s slots


@dataclasses.dataclass
class _Job:
    arrays: Dict[str, Any]
    seq_len: int
    sampling: Any
    stopper: Any
    gen: Optional[torch.Generator]
    future: "concurrent.futures.Future"
    sid: Optional[int] = None
    out: Optional[List[int]] = None
    u0: Optional[torch.Tensor] = None  # the first token's uniform [1]

    @property
    def pad_len(self) -> int:
        return self.arrays["token_ids"].shape[1]


@dataclasses.dataclass
class _Admission:
    """In-flight staged admission: the spliced embeddings once `embeds` is
    set, then the prefill advancing one cache-offset chunk per step."""
    job: _Job
    cache: Any           # llama.KVCache, index at the chunk frontier
    n_chunks: int        # ceil(seq_len / chunk): padding-only chunks skipped
    embeds: Any = None   # [1, pad_len, H] on the device
    i: int = 0


class ContinuousBatcher:
    """Owns the LLM device loop for a serving process.

    params/cfg are the full Vitron tree + config (the LLM sub-tree drives
    the paged decode pool). Thread-safe `submit`; one daemon loop thread,
    on rank 0 of a mesh (the other ranks call `follow`)."""

    def __init__(self, params, cfg, num_blocks: int = 512, block_size: int = 16,
                 chunk: int = 16, max_active: int = 8, seed: int = 0, mesh=None,
                 prefill_chunk: int = 256, device=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a core.mesh.Mesh, got {type(mesh).__name__}")
        self.params = params
        # the admission programs' tree: W4A8 leaves when VITRON_W4A8=1 (read
        # here, once), where the JAX package promotes inside them
        self._promoted = promote_int4(params)
        self.cfg = cfg
        llm_params = params["llm"] if "llm" in params else params
        self.device = torch.device(device) if device is not None else llm_params["embed"].device
        self.server = PagedServer(llm_params, cfg.llm, num_blocks=num_blocks,
                                  block_size=block_size, device=self.device)
        self.chunk = chunk
        self.max_active = max_active
        self.prefill_chunk = prefill_chunk
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        self._long: "collections.deque[_Job]" = collections.deque()  # waiting to be staged
        self._active: Dict[int, _Job] = {}
        self._admitting: Optional[_Admission] = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._trace: List[str] = []       # device-loop event log (tests, the smoke)
        self._lock = threading.Lock()
        self._stats = {"chunks": 0, "slot_tokens": 0, "emitted_tokens": 0,
                       "admitted": 0, "finished": 0, "batch_sum": 0,
                       "admit_steps": 0, "admit_step_s_sum": 0.0,
                       "admit_step_s_max": 0.0}
        self._stop = threading.Event()
        # the lockstep of a mesh's ranks: finished sids wait for the next op
        # (at most the active sequences and the staged one)
        self._fin_slots = max_active + 1
        self._finished: List[int] = []
        self._lockstep = None
        if mesh is not None:
            self._lockstep = Lockstep(2 + self._fin_slots + max(
                _JOB_HEADER, 1 + (3 + chunk) * max_active), self.device)
        self.leader = self._lockstep is None or self._lockstep.primary
        self._thread = threading.Thread(target=self._loop, daemon=True, name="vitron-batcher")
        if self.leader:
            self._thread.start()

    # --------------------------------------------------------- device fns

    def _sample0(self, job: _Job, logits: torch.Tensor) -> int:
        """The first token from the prefill's next-token logits [1, V], by
        the uniform drawn for it (`_draw_u0`)."""
        s = job.sampling
        greedy = bool(s.greedy or s.temperature == 0.0)
        f = lambda v: torch.tensor([v], dtype=torch.float32, device=self.device)  # noqa: E731
        tok = sample_token_batched(logits, f(s.temperature), f(s.top_p),
                                   torch.tensor([greedy], device=self.device), job.u0)
        return int(tok[0])

    def _draw_u0(self, job: _Job) -> None:
        if job.u0 is None:
            job.u0 = self._uniforms(job, 1)

    def _prefill_fn(self, job: _Job):
        """Fused admission: encode + splice + prefill into a dense cache of
        the pad bucket + sample the first token."""
        a = job.arrays
        cache = llama.KVCache.create(self.cfg.llm, 1, max_len=job.pad_len, device=self.device,
                                     kv_heads=self.server.kv_heads)
        logits, cache = vitron_model.forward(
            self._promoted, self.cfg, a["token_ids"], a["media_idx"], a["use_media"],
            a["positions"], a["attn_mask"], images=a["images"], videos=a["videos"],
            block_perm=a["block_perm"], region_boxes=a["region_boxes"],
            region_block_idx=a["region_block_idx"], cache=cache)
        return self._sample0(job, logits[:, job.seq_len - 1]), cache

    def _embed_fn(self, job: _Job) -> torch.Tensor:
        """Stage 1 of a staged admission: the spliced embeddings (towers +
        projector + splice, no decoder)."""
        a = job.arrays
        return vitron_model.spliced_embeds(
            self._promoted, self.cfg, a["token_ids"], a["media_idx"], a["use_media"],
            images=a["images"], videos=a["videos"], block_perm=a["block_perm"],
            region_boxes=a["region_boxes"], region_block_idx=a["region_block_idx"])

    def _chunk_prefill(self, adm: _Admission) -> Optional[int]:
        """Stage 2: prefill slots [start, end) of the pad bucket at the
        cache's offset; on the last chunk, sample the first token."""
        job, p = adm.job, self.prefill_chunk
        start, end = adm.i * p, min((adm.i + 1) * p, job.pad_len)
        a = job.arrays
        llm = self._promoted["llm"] if "llm" in self._promoted else self._promoted
        logits, _ = llama.forward(llm, self.cfg.llm, adm.embeds[:, start:end],
                                  a["positions"][:, start:end],
                                  attn_mask=a["attn_mask"][:, start:end], cache=adm.cache)
        if adm.i + 1 < adm.n_chunks:
            return None
        return self._sample0(job, logits[:, job.seq_len - 1 - start])

    def _uniforms(self, job: _Job, n: int) -> torch.Tensor:
        return uniforms((n,), job.gen if job.gen is not None else self._gen, self.device)

    # -------------------------------------------------------------- API

    def submit(self, plan, images=None, videos=None, block_perm=None, region_boxes=None,
               sampling=None, stopper=None, gen=None) -> "concurrent.futures.Future":
        """Enqueue one single-row generation; the Future resolves to the new
        token ids (stop semantics identical to Generator._generate_chunked).
        Nothing here touches the device: the loop thread moves the request."""
        sampling = sampling or SamplingConfig()
        if plan.token_ids.shape[0] != 1:
            raise ValueError("ContinuousBatcher co-batches single-row requests; "
                             "pass rows separately")
        arrays = dict(token_ids=plan.token_ids, media_idx=plan.media_idx,
                      use_media=plan.use_media, positions=plan.position_ids,
                      attn_mask=plan.attention_mask, images=images, videos=videos,
                      block_perm=block_perm, region_boxes=None, region_block_idx=None)
        if (plan.region_blocks is not None and len(plan.region_blocks)
                and region_boxes is not None):
            arrays["region_boxes"] = np.asarray(region_boxes, np.float32)
            arrays["region_block_idx"] = plan.region_blocks
        job = _Job(arrays=arrays, seq_len=int(plan.seq_lens[0]), sampling=sampling,
                   stopper=stopper, gen=gen, future=concurrent.futures.Future())
        with self._lock:  # close() drains the queue only after it stops taking jobs
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            self._queue.put(job)
        return job.future

    def stats(self) -> Dict[str, Any]:
        """Occupancy telemetry for /stats: mean co-batched sequences per
        chunk and slot efficiency (emitted / decoded slots)."""
        with self._lock:
            s = dict(self._stats)
        chunks = max(s["chunks"], 1)
        return {
            **s,
            "active": len(self._active),
            "queued": self._queue.qsize() + len(self._long),
            "chunk_size": self.chunk,
            "mean_batch_occupancy": round(s["batch_sum"] / chunks, 2),
            "slot_efficiency": round(s["emitted_tokens"] / max(s["slot_tokens"], 1), 3),
            "admit_step_s_mean": round(s["admit_step_s_sum"] / max(s["admit_steps"], 1), 4),
            "admit_step_s_max": round(s["admit_step_s_max"], 4),
        }

    def close(self) -> None:
        """Stop the loop, wait for its thread to end, then fail every
        request it did not finish."""
        with self._lock:
            self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
        jobs = list(self._active.values()) + list(self._long)
        if self._admitting is not None:
            jobs.append(self._admitting.job)
        self._admitting = None
        while True:
            try:
                jobs.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for job in jobs:
            if not job.future.done():
                job.future.set_exception(RuntimeError("batcher closed"))

    # ------------------------------------------------------------- loop

    def _loop(self) -> None:
        try:
            self._serve()
        finally:
            self._publish(STOP)

    def _serve(self) -> None:
        idle_since = time.monotonic()
        with torch.no_grad():
            while not self._stop.is_set():
                admitted = self._admit_pending()
                staged = self._admitting is not None
                if staged:
                    self._admit_step()
                if self._active:
                    try:
                        self._decode_chunk()
                    except Exception as e:  # fail active jobs, keep serving
                        for sid, job in list(self._active.items()):
                            if not job.future.done():
                                job.future.set_exception(e)
                            self.server.finish(sid)
                        self._active.clear()
                elif not (staged or admitted):
                    try:
                        job = self._queue.get(timeout=0.05)
                    except queue.Empty:
                        if (self._lockstep is not None
                                and time.monotonic() - idle_since > HEARTBEAT_S):
                            self._publish(NOOP)
                            idle_since = time.monotonic()
                        continue
                    self._take(job)
                idle_since = time.monotonic()

    def _room(self) -> bool:
        return len(self._active) + (self._admitting is not None) < self.max_active

    def _admit_pending(self) -> bool:
        """Admit queued jobs up to capacity: a prompt that fits in one
        prefill chunk at once (fused), a longer one into the wait for the
        one staged admission, which starts here when none is in progress.
        A short prompt never waits behind a long one."""
        admitted = False
        while self._room():
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            admitted |= self._take(job)
        if self._admitting is None and self._long and self._room():
            self._start_admission(self._long.popleft())
            admitted = True
        return admitted

    def _take(self, job: _Job) -> bool:
        """Admit a short prompt now (-> True) or queue a long one for
        staging (-> False)."""
        if job.pad_len > self.prefill_chunk:
            self._long.append(job)
            return False
        self._admit(job)
        return True

    def _to_device(self, job: _Job) -> None:
        a, dev = job.arrays, self.device
        for name, dtype in (("token_ids", torch.int64), ("media_idx", torch.int64),
                            ("use_media", torch.bool), ("positions", torch.int64),
                            ("attn_mask", torch.bool), ("block_perm", torch.int64),
                            ("region_boxes", torch.float32),
                            ("region_block_idx", torch.int64)):
            if a[name] is not None:
                a[name] = torch.as_tensor(np.asarray(a[name]), dtype=dtype, device=dev)
        for name in ("images", "videos"):
            if a[name] is not None:
                a[name] = torch.as_tensor(a[name]).to(dev)

    def _timed_admit_step(self, tag: str, fn):
        """Run one admission device step to its end and record its wall
        time as admission-stall telemetry."""
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        with self._lock:
            self._stats["admit_steps"] += 1
            self._stats["admit_step_s_sum"] += dt
            self._stats["admit_step_s_max"] = max(self._stats["admit_step_s_max"], dt)
        self._trace_event(tag)
        return out

    def _trace_event(self, tag: str) -> None:
        self._trace.append(tag)
        if len(self._trace) > 2048:
            del self._trace[:1024]

    def _admit(self, job: _Job) -> None:
        try:
            if self.leader:
                self._to_device(job)
                self._draw_u0(job)
                self._publish(ADMIT, job)
            tok0, cache = self._timed_admit_step("admit_fused", lambda: self._prefill_fn(job))
            self._activate(job, tok0, cache.k, cache.v)
        except Exception as e:
            if not job.future.done():
                job.future.set_exception(e)

    def _start_admission(self, job: _Job) -> None:
        """Stage a long-prompt admission: its steps run on later loop
        iterations, one at a time."""
        try:
            if self.leader:
                self._to_device(job)
                self._publish(STAGE, job)
            cache = llama.KVCache.create(self.cfg.llm, 1, max_len=job.pad_len,
                                         device=self.device, kv_heads=self.server.kv_heads)
            self._admitting = _Admission(job=job, cache=cache,
                                         n_chunks=max(1, -(-job.seq_len // self.prefill_chunk)))
        except Exception as e:
            if not job.future.done():
                job.future.set_exception(e)

    def _admit_step(self) -> None:
        """Advance the staged admission by ONE device step: the embeddings,
        then one prefill chunk; the last chunk samples the first token and
        activates the sequence."""
        adm = self._admitting
        job = adm.job
        try:
            if self.leader:
                last = adm.embeds is not None and adm.i + 1 >= adm.n_chunks
                if last:
                    self._draw_u0(job)
                self._publish(STEP, u0=job.u0 if last else None)
            if adm.embeds is None:
                adm.embeds = self._timed_admit_step("admit_embed", lambda: self._embed_fn(job))
                return
            tok = self._timed_admit_step("admit_chunk", lambda: self._chunk_prefill(adm))
            adm.i += 1
            if adm.i >= adm.n_chunks:
                self._admitting = None
                self._activate(job, tok, adm.cache.k, adm.cache.v)
        except Exception as e:
            self._admitting = None
            if not job.future.done():
                job.future.set_exception(e)

    def _activate(self, job: _Job, tok0: int, ck, cv) -> None:
        sid = self.server.add_from_cache(ck, cv, job.seq_len, tok0)
        job.sid = sid
        job.out = [tok0]
        with self._lock:
            self._stats["admitted"] += 1
        if not self.leader:  # rank 0 decides when a sequence finishes
            return
        if self._job_done_after(job, tok0):
            self._finish(job)
        else:
            self._active[sid] = job

    def _job_done_after(self, job: _Job, tok: int) -> bool:
        s = job.sampling
        if tok in s.eos_ids:
            return True
        if job.stopper is not None and job.stopper.should_stop(job.out):
            return True
        return len(job.out) >= s.max_new_tokens

    def _finish(self, job: _Job) -> None:
        if job.sid in self._active:
            del self._active[job.sid]
        self.server.finish(job.sid)
        if self._lockstep is not None:
            self._finished.append(job.sid)
        with self._lock:
            self._stats["finished"] += 1
        if not job.future.done():
            job.future.set_result(list(job.out))

    def _decode_chunk(self) -> None:
        ids = sorted(self._active)
        b = len(ids)
        sampling: Dict[Any, Any] = {}
        for sid in ids:
            s = self._active[sid].sampling
            sampling[sid] = (s.temperature, s.top_p, bool(s.greedy or s.temperature == 0.0))
        sampling["uniforms"] = torch.stack(
            [self._uniforms(self._active[sid], self.chunk) for sid in ids], dim=1)
        self._publish(DECODE, sampling=(ids, sampling))
        toks = self.server.step_n(self.chunk, sampling=sampling)
        emitted = 0
        for sid, ts in toks.items():
            job = self._active.get(sid)
            if job is None:
                continue
            for t in ts:
                job.out.append(int(t))
                emitted += 1
                if self._job_done_after(job, int(t)):
                    self._finish(job)
                    break
        with self._lock:
            self._stats["chunks"] += 1
            self._stats["batch_sum"] += b
            self._stats["slot_tokens"] += b * self.chunk
            self._stats["emitted_tokens"] += emitted
        self._trace_event("decode")

    # --------------------------------------------------------- lockstep

    def _publish(self, op: int, job: Optional[_Job] = None, u0=None, sampling=None) -> None:
        """Rank 0: broadcast the next device step (and the sequences that
        finished since the last one) to the following ranks."""
        if self._lockstep is None:
            return
        fin, self._finished = self._finished, []
        if len(fin) > self._fin_slots:
            raise RuntimeError(f"lockstep: {len(fin)} finished sequences in one message")
        head = [op, len(fin)] + fin + [0] * (self._fin_slots - len(fin))
        if op in (ADMIT, STAGE):
            self._lockstep.send(head + self._job_header(job))
            self._send_job(job)
        elif op == STEP:
            self._lockstep.send(head + ([1, int(f64_bits(u0.cpu())[0])] if u0 is not None
                                        else [0, 0]))
        elif op == DECODE:
            ids, smp = sampling
            rows = []
            for sid in ids:
                t, p, g = smp[sid]
                rows += f64_bits([t, p]).tolist() + [int(g)]
            rows += [0] * (3 * (self.max_active - len(ids)))
            u = f64_bits(smp["uniforms"].cpu().numpy()).tolist()
            self._lockstep.send(head + [len(ids)] + rows + u)
        else:
            self._lockstep.send(head)

    def _job_header(self, job: _Job) -> List[int]:
        a, s = job.arrays, job.sampling
        greedy = bool(s.greedy or s.temperature == 0.0)
        head = [job.pad_len, job.seq_len, *f64_bits([s.temperature, s.top_p]).tolist(),
                int(greedy), int(f64_bits(job.u0.cpu())[0]) if job.u0 is not None else 0,
                -1 if a["block_perm"] is None else int(a["block_perm"].shape[0]),
                -1 if a["region_boxes"] is None else int(a["region_boxes"].shape[0])]
        for name in ("images", "videos"):
            t = a[name]
            if t is None:
                head += [0] * (_MEDIA_DIMS + 2)
            else:
                head += ([t.dim()] + list(t.shape) + [0] * (_MEDIA_DIMS - t.dim())
                         + [_MEDIA_DTYPES.index(t.dtype)])
        return head

    def _send_job(self, job: _Job) -> None:
        a, send = job.arrays, self._lockstep.send_tensor
        send(torch.stack([a[k].reshape(-1).to(torch.int64) for k in
                          ("token_ids", "media_idx", "use_media", "positions", "attn_mask")]))
        for name in ("block_perm", "region_boxes", "region_block_idx", "images", "videos"):
            if a[name] is not None:
                send(a[name])

    def _recv_job(self, args) -> _Job:
        """A follower's copy of the job rank 0 published (arrays on the device)."""
        pad_len, seq_len, temp, top_p, greedy, u0, n_perm, n_region = (int(v) for v in args[:8])
        recv = self._lockstep.recv_tensor
        plan = recv((5, pad_len), torch.int64)
        a = dict(token_ids=plan[0][None], media_idx=plan[1][None],
                 use_media=plan[2].bool()[None], positions=plan[3][None],
                 attn_mask=plan[4].bool()[None], block_perm=None, region_boxes=None,
                 region_block_idx=None, images=None, videos=None)
        if n_perm >= 0:
            a["block_perm"] = recv((n_perm,), torch.int64)
        if n_region >= 0:
            a["region_boxes"] = recv((n_region, 4), torch.float32)
            a["region_block_idx"] = recv((n_region,), torch.int64)
        off = 8
        for name in ("images", "videos"):
            nd = int(args[off])
            if nd:
                a[name] = recv(args[off + 1:off + 1 + nd],
                               _MEDIA_DTYPES[int(args[off + 1 + _MEDIA_DIMS])])
            off += _MEDIA_DIMS + 2
        temp, top_p = from_f64_bits([temp, top_p]).tolist()
        job = _Job(arrays=a, seq_len=seq_len,
                   sampling=SamplingConfig(temperature=temp, top_p=top_p, greedy=bool(greedy)),
                   stopper=None, gen=None, future=concurrent.futures.Future())
        job.u0 = self._uniform_of(u0)
        return job

    def _uniform_of(self, bits) -> torch.Tensor:
        return torch.as_tensor(from_f64_bits([bits]).astype(np.float32), device=self.device)

    def follow(self) -> None:
        """A following rank's loop: repeat each device step rank 0
        broadcasts, on the same inputs, until rank 0 stops."""
        if self.leader:
            raise RuntimeError("follow() runs on the ranks after rank 0 of a mesh")
        args0 = 2 + self._fin_slots
        with torch.no_grad():
            while True:
                ctrl = self._lockstep.recv()
                for sid in ctrl[2:2 + int(ctrl[1])]:
                    self.server.finish(int(sid))
                op, args = int(ctrl[0]), ctrl[args0:]
                if op == STOP:
                    return
                if op == ADMIT:
                    self._admit(self._recv_job(args))
                elif op == STAGE:
                    self._start_admission(self._recv_job(args))
                elif op == STEP:
                    if args[0]:
                        self._admitting.job.u0 = self._uniform_of(args[1])
                    self._admit_step()
                elif op == DECODE:
                    self._follow_decode(args)

    def _follow_decode(self, args) -> None:
        b = int(args[0])
        ids = sorted(self.server.seqs)
        if len(ids) != b:
            raise RuntimeError(f"lockstep lost: {len(ids)} sequences here, {b} on rank 0")
        sampling: Dict[Any, Any] = {}
        for r, sid in enumerate(ids):
            t, p = from_f64_bits(args[1 + 3 * r: 3 + 3 * r]).tolist()
            sampling[sid] = (t, p, bool(args[3 + 3 * r]))
        u0 = 1 + 3 * self.max_active
        u = from_f64_bits(args[u0:u0 + self.chunk * b]).astype(np.float32)
        sampling["uniforms"] = torch.as_tensor(u.reshape(self.chunk, b), device=self.device)
        try:
            self.server.step_n(self.chunk, sampling=sampling)
        except Exception:  # rank 0 fails its active jobs and drops them
            for sid in list(self.server.seqs):
                self.server.finish(sid)
