"""(cfg, frames)-sharded steps of the video diffusion UNets.

Port of `vitron_tpu/distributed/video_sharding.py`. The latent of a step is
[B(=2 CFG), F, H, W, C]: the `cfg` axis (size 2) takes the two halves of the
classifier-free-guidance pair, which are independent until the guided
combine, and the `frames` axis splits F. Spatial ops fold F into the batch
and run on a rank's frames alone; the temporal ops need their neighbours.
JAX's GSPMD derives those collectives; here they are written out inside the
video UNet, and only while a frames group of more than one rank is installed
(`shard_video_step` installs it for the step; `frames_group()` reads it):

- B6, the temporal k=3 conv (`temporal_conv`): each rank takes a one-frame
  halo from either neighbour by `batch_isend_irecv` (zeros past the video's
  first and last frames, the conv's own padding) and runs B6 over its
  frames with the halo (`halo_conv`);
- group norms with statistics over (F, H, W) (`layers.group_norm(...,
  frames=)`, at `video_unet.temporal_conv_block` and
  `unet_sd_video.temporal_transformer`) all-reduce B8's per-channel sums over
  the group before the mean and variance; the res blocks' group norms fold
  F into the batch and stay local;
- B7, attention over the frames at each pixel (`frame_attention`), gathers
  its q, k and v over the group, runs on all F and keeps this rank's rows.

The i2vgen image streams give each frame its global position and run their
adapter transformer (attention over the frames) on the gathered frames
(`unet_sd_video._image_streams`). Parameters are replicated.
`shard_video_step` returns the whole eps: the CFG pair is gathered once,
for the guided combine. Like JAX, nothing wires it into the task D / G
handlers.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist

from vitron_tpu_torch.core.mesh import Mesh, all_gather
from vitron_tpu_torch.kernels import temporal_attention, temporal_conv

CFG_AXIS = "cfg"
FRAME_AXIS = "frames"


def create_video_mesh(n_devices: Optional[int] = None, cfg_parallel: bool = True) -> Mesh:
    """(cfg=2, frames=n/2) when n is even, else (1, n), over the world's n
    ranks."""
    n = n_devices or dist.get_world_size()
    cfg_size = 2 if (cfg_parallel and n % 2 == 0) else 1
    return Mesh((CFG_AXIS, FRAME_AXIS), (cfg_size, n // cfg_size))


@dataclasses.dataclass(frozen=True)
class FramesGroup:
    """This rank's frames group: the process group, its size, this rank's
    place and the global ranks of the neighbours (None past the ends)."""

    group: object
    size: int
    index: int
    prev: Optional[int]
    next: Optional[int]

    @staticmethod
    def of(mesh: Mesh) -> "FramesGroup":
        g, n, i = mesh.group(FRAME_AXIS), mesh.shape[FRAME_AXIS], mesh.index(FRAME_AXIS)
        return FramesGroup(g, n, i, dist.get_global_rank(g, i - 1) if i > 0 else None,
                           dist.get_global_rank(g, i + 1) if i + 1 < n else None)


_installed: Optional[FramesGroup] = None


def frames_group() -> Optional[FramesGroup]:
    """The frames group of the step running now (None: all frames here)."""
    return _installed


@contextlib.contextmanager
def _install(fg: Optional[FramesGroup]):
    global _installed
    before, _installed = _installed, fg
    try:
        yield
    finally:
        _installed = before


def halo_frames(x: torch.Tensor, fg: FramesGroup):
    """(the previous rank's last frame, the next rank's first frame) of x
    [B, F, ...], each [B, 1, ...]; zeros where there is no neighbour."""
    first, last = x[:, :1].contiguous(), x[:, -1:].contiguous()
    prev, nxt = torch.zeros_like(first), torch.zeros_like(last)
    ops = []
    if fg.next is not None:
        ops += [dist.P2POp(dist.isend, last, fg.next, group=fg.group),
                dist.P2POp(dist.irecv, nxt, fg.next, group=fg.group)]
    if fg.prev is not None:
        ops += [dist.P2POp(dist.isend, first, fg.prev, group=fg.group),
                dist.P2POp(dist.irecv, prev, fg.prev, group=fg.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return prev, nxt


def halo_conv(x: torch.Tensor, w, b, prev: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """B6 over x [B, F, ...] with one frame either side (`prev`, `nxt`):
    the rows of these F frames of the conv over the whole video."""
    return temporal_conv.temporal_conv_k3(torch.cat([prev, x, nxt], dim=1), w, b)[:, 1:-1]


def temporal_conv_k3(x: torch.Tensor, w, b) -> torch.Tensor:
    """The UNets' temporal conv: B6, with the neighbours' halo under a
    frames group."""
    fg = frames_group()
    if fg is None:
        return temporal_conv.temporal_conv_k3(x, w, b)
    return halo_conv(x, w, b, *halo_frames(x, fg))


def local_frames(x: torch.Tensor, fg: FramesGroup) -> torch.Tensor:
    n = x.shape[1] // fg.size
    return x[:, fg.index * n:(fg.index + 1) * n]


def frame_attention(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """The UNets' frame attention: B7, on every frame of the group."""
    fg = frames_group()
    if fg is None:
        return temporal_attention.frame_attention(q, k, v, heads, scale)
    q, k, v = (all_gather(t, fg.group, dim=1) for t in (q, k, v))
    return local_frames(temporal_attention.frame_attention(q, k, v, heads, scale), fg)


def shard_video_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """`step_fn(params, x, *cond)` with x [B, F, ...] split (cfg, frames):
    each rank runs it on its block of B and F, with the cond tensors whose
    leading dim is B split alike (the rest replicated) and its frames group
    installed; the ranks' eps blocks are gathered into the whole eps."""
    n_cfg, n_fr = mesh.shape[CFG_AXIS], mesh.shape[FRAME_AXIS]
    i_cfg, i_fr = mesh.index(CFG_AXIS), mesh.index(FRAME_AXIS)
    fg = FramesGroup.of(mesh) if n_fr > 1 else None

    def call(params, x, *cond):
        b, f = x.shape[:2]
        if b % n_cfg or f % n_fr:
            raise ValueError(f"video step: batch {b} / frames {f} do not divide over "
                             f"cfg={n_cfg} / frames={n_fr}")
        bl, fl = b // n_cfg, f // n_fr
        rows = slice(i_cfg * bl, (i_cfg + 1) * bl)
        xl = x[rows, i_fr * fl:(i_fr + 1) * fl]
        cl = [c[rows] if torch.is_tensor(c) and c.dim() and c.shape[0] == b else c
              for c in cond]
        with _install(fg):
            eps = step_fn(params, xl, *cl)
        eps = all_gather(eps, mesh.group(FRAME_AXIS), dim=1)
        return all_gather(eps, mesh.group(CFG_AXIS), dim=0)

    return call
