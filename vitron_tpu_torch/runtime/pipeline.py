"""Host/device pipelining: overlap media preprocessing with device work.

Port of `vitron_tpu/runtime/pipeline.py`. The reference runs everything
serially in one Python thread — decode, transforms, then the GPU forward
(SURVEY §3.1 "CPU hot loop"); the accelerator idles during host work. Here
a thread pool prepares the next requests' media while the device is busy
generating for the current one.
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import Any, Callable, Iterable, Iterator


class HostPrefetcher:
    """Ordered prefetching map: `prepare` runs in worker threads up to
    `depth` items ahead of the consumer."""

    def __init__(self, prepare: Callable[[Any], Any], num_workers: int = 4,
                 depth: int = 4):
        self.prepare = prepare
        self.pool = concurrent.futures.ThreadPoolExecutor(num_workers)
        self.depth = depth

    def map(self, items: Iterable[Any]) -> Iterator[Any]:
        it = iter(items)
        queue: collections.deque = collections.deque()
        try:
            for _ in range(self.depth):
                try:
                    queue.append(self.pool.submit(self.prepare, next(it)))
                except StopIteration:
                    break
            while queue:
                fut = queue.popleft()
                try:
                    queue.append(self.pool.submit(self.prepare, next(it)))
                except StopIteration:
                    pass
                yield fut.result()
        finally:
            for f in queue:
                f.cancel()

    def close(self):
        self.pool.shutdown(wait=False)


class PipelinedRunner:
    """Two-stage pipeline: host `prepare` overlaps device `compute`.

    While compute(batch_i) runs, prepare(item_{i+1..i+depth}) runs in worker
    threads. Results are yielded in order."""

    def __init__(self, prepare: Callable[[Any], Any],
                 compute: Callable[[Any], Any],
                 num_workers: int = 4, depth: int = 2):
        self.prefetcher = HostPrefetcher(prepare, num_workers, depth)
        self.compute = compute

    def run(self, items: Iterable[Any]) -> Iterator[Any]:
        for prepared in self.prefetcher.map(items):
            yield self.compute(prepared)

    def close(self):
        self.prefetcher.close()


class ServingPipeline:
    """Request pipeline for serve.py: host preprocessing of request N+1
    overlaps device generation for request N, and (batched=True, the
    default) concurrent requests CO-BATCH their decode through one paged-KV
    program (runtime/batching.py ContinuousBatcher) instead of serializing
    single-stream generations.

    - `prepare` (system.prepare: resize, prompt assembly) runs in a worker
      pool, one task per incoming request;
    - LLM prefill + decode run on the batcher's device loop, which admits
      new sequences between decode chunks;
    - backend routing (after the protocol parse) runs on a small executor,
      so routing for request N does not block request N+1's decode.

    batched=False: ONE device thread serializes chat_prepared calls."""

    def __init__(self, system, num_workers: int = 4, batched: bool = True,
                 max_active: int = 8, decode_chunk: int = 16,
                 num_kv_blocks: int = 512):
        self.system = system
        self.batcher = None
        gen = getattr(getattr(system, "engine", None), "generator", None)
        if batched and getattr(gen, "params", None) is not None:
            from vitron_tpu_torch.runtime.batching import ContinuousBatcher

            self.batcher = ContinuousBatcher(
                gen.params, gen.cfg, chunk=decode_chunk, max_active=max_active,
                num_blocks=num_kv_blocks, device=gen.device,
                mesh=getattr(system, "serving_mesh", None))
            system.engine.batcher = self.batcher
        self._prep = concurrent.futures.ThreadPoolExecutor(
            num_workers, thread_name_prefix="vitron-prep")
        # without a ContinuousBatcher the device threads would only contend
        # for the card: concurrency pays when decode co-batches
        self._device = concurrent.futures.ThreadPoolExecutor(
            max_active if self.batcher is not None else 1,
            thread_name_prefix="vitron-device")

    def submit(self, user_message: str, image=None, video=None,
               sketch_mask=None, region_box=None, history=None,
               sampling=None, gen=None, extra=None) -> "concurrent.futures.Future":
        """Enqueue one chat turn; returns a Future of the chat() result."""
        from vitron_tpu_torch.runtime.generation import SamplingConfig

        sampling = sampling or SamplingConfig()
        prep_fut = self._prep.submit(self.system.prepare, user_message,
                                     image, video, region_box)

        def run_device():
            prepared = prep_fut.result()
            return self.system.chat_prepared(
                prepared, sketch_mask=sketch_mask, history=history,
                sampling=sampling, gen=gen, extra=extra)

        return self._device.submit(run_device)

    def chat(self, *args, **kw):
        """Blocking convenience: submit + wait."""
        return self.submit(*args, **kw).result()

    def close(self):
        self._prep.shutdown(wait=False)
        self._device.shutdown(wait=False)
        if self.batcher is not None:
            self.batcher.close()
            self.system.engine.batcher = None


class MediaPrefetcher:
    """Dataset media loader for the trainer: decodes images/videos and
    resizes them in worker threads, keeping the train step fed. The JAX
    package resizes with its g++-built batch resize (`media/native.py`);
    this uses the same arithmetic in the port's `media/preprocess.py`
    (`resize_normalize_batch`)."""

    def __init__(self, tower_size: int, num_workers: int = 4):
        self.tower_size = tower_size
        self.pool = concurrent.futures.ThreadPoolExecutor(num_workers)

    def load(self, kind: str, path: str):
        from vitron_tpu_torch.media.preprocess import (load_image, load_video_frames,
                                                       resize_normalize_batch)

        if kind == "image":
            return resize_normalize_batch(load_image(path)[None], self.tower_size)[0]
        return resize_normalize_batch(load_video_frames(path), self.tower_size)

    def submit(self, kind: str, path: str) -> concurrent.futures.Future:
        return self.pool.submit(self.load, kind, path)

    def close(self) -> None:
        self.pool.shutdown(wait=False)
