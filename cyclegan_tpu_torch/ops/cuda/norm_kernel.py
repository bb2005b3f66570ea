"""Instance norm forward and backward: the CUDA kernels' wrappers and
their plain versions.

The forward kernel (``csrc/instance_norm.cu``) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/norm_kernel.py:_forward``. Both versions take an
NHWC f32 ``x`` and return ``(y, mean, inv)``: ``y`` as ``x``, ``mean`` and
``inv = 1/sqrt(var + eps)`` as [N, C] f32. On the card it is one launch,
on a plan from ``forward_plan``, which the epilogue forward (K3) shares.

The backward kernel (``csrc/norm_backward.cu``) replaces
``cyclegan_tpu/ops/pallas/norm_kernel.py:_backward``. Both versions take
``x``, ``scale``, the forward's ``mean`` and ``inv`` and the cotangent
``g`` of ``y``, and return ``(dx, dscale_nc, dbias_nc)``: ``dx`` as ``x``,
the per-(n, c) partials of dscale and dbias as [N, C] f32, which the caller
sums over N.

This module also holds what the other wrappers share with it: the input
checks, the launch plans of the forward kernel (``forward_plan``, K1 and
K3) and of the backward kernel (``backward_plan``, K2 and K4), and the
per-stream scratch (``stream_scratch``) of the kernels whose blocks meet
through device memory.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from cyclegan_tpu_torch.ops.cuda import LAUNCHES, build

def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-3):
    """Plain PyTorch instance norm with the kernel's outputs."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = centered * inv * scale + bias
    return y, mean[:, 0, 0, :], inv[:, 0, 0, :]


def instance_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                                 mean: torch.Tensor, inv: torch.Tensor,
                                 g: torch.Tensor):
    """Plain PyTorch instance-norm VJP with the kernel's outputs:
    dx = scale * inv * (g - mean_hw(g) - xhat * mean_hw(g * xhat))."""
    mean, inv = mean[:, None, None, :], inv[:, None, None, :]
    xhat = (x - mean) * inv
    dbias_nc = g.sum(dim=(1, 2))
    dscale_nc = (g * xhat).sum(dim=(1, 2))
    hw = x.shape[1] * x.shape[2]
    dx = scale * inv * (g - dbias_nc[:, None, None, :] / hw
                        - xhat * (dscale_nc[:, None, None, :] / hw))
    return dx, dscale_nc, dbias_nc


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The backward kernel (csrc/norm_backward.cu): threads a block, the widest
# channel tile and the largest cluster it takes, the elements a thread
# stages ahead when its band does not stay on chip, and the shared memory
# its static arrays hold (per-warp and per-rank [*, 64] tables of the two
# sums, the [2, 64] totals and an 8-byte mbarrier).
BACKWARD_THREADS = 256
# Blocks an SM holds at once: __launch_bounds__(256, 3) caps the registers.
BACKWARD_BLOCKS_PER_SM = 3
BACKWARD_MAX_TILE = 64
BACKWARD_MAX_CLUSTER = 16
BACKWARD_RING = 2
BACKWARD_STATIC_SMEM = 4 * 2 * 64 * (BACKWARD_THREADS // 32
                                     + BACKWARD_MAX_CLUSTER + 1) + 8
# The narrowest channel tile where C allows it: 8 floats, one 32-byte
# sector of a pixel, so that no load reads half a sector.
SECTOR_FLOATS = 8
# Hopper (sm_90): shared memory one block may opt in to, what one SM holds,
# and what the runtime reserves for each block.
SMEM_PER_BLOCK = 232_448
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How one call of the backward kernel splits its work. Each (sample,
    channel tile) is a cluster of ``cluster`` blocks; block ``r`` owns the
    pixels ``[r * band, (r + 1) * band)`` of H*W (clipped to H*W; a block
    past the end has none). ``keep`` says what of a block's band stays in
    its shared memory between the kernel's two passes: 2, g2 and xhat (4
    bytes each an element); 1, g2 alone, x being read again for xhat; 0,
    nothing, x and g being read again. ``smem_bytes`` is the dynamic shared
    memory a block takes for that, with the ring through which it stages x
    and g when keep < 2."""
    vec: int
    tile: int
    cluster: int
    band: int
    keep: int
    smem_bytes: int
    blocks: int

    def launch_args(self) -> tuple:
        """The C launchers' trailing plan arguments, in their order."""
        return (self.vec, self.tile, self.cluster, self.band,
                self.smem_bytes, self.keep)


def backward_plan(n: int, hw: int, c: int, vec: int,
                  sm_count: int) -> BackwardPlan:
    """The backward kernel's plan for x [n, H, W, c] with hw = H * W on a
    card of ``sm_count`` SMs, with ``vec`` channels a load (4 or 1).

    The whole grid must be on the card at once: a cluster waits for its
    slowest block, so a cluster left for a second wave holds back the
    launch's end. The kernel's registers let three blocks share an SM, so
    a block takes at most a third of an SM's shared memory. The channel
    tile is the widest power of two (from 64 down to one 32-byte sector of
    8 floats, or C where that is narrower) for which a cluster of at most
    16 blocks gives every SM a block; the cluster is the smallest such
    power of two; where no tile does, the narrowest tile with the largest
    cluster. A block keeps the most of its band that fits (g2 and xhat,
    else g2)."""
    if vec not in (1, 4) or c % vec:
        raise ValueError(f"backward_plan: vec {vec} does not divide C={c}")
    widest = max(vec, min(BACKWARD_MAX_TILE, 1 << (c - 1).bit_length()))
    narrowest = max(vec, min(widest, SECTOR_FLOATS))
    tiles = [t for t in (64, 32, 16, 8, 4, 2, 1) if narrowest <= t <= widest]
    clusters = [k for k in (1, 2, 4, 8, 16) if k <= max(1, hw)]
    tile, cluster = tiles[-1], clusters[-1]
    for t in tiles:
        fits = [k for k in clusters if n * -(-c // t) * k >= sm_count]
        if fits:
            tile, cluster = t, fits[0]
            break
    band = -(-hw // cluster)
    ring = 2 * BACKWARD_RING * BACKWARD_THREADS * vec * 4
    budget = (SMEM_PER_SM // BACKWARD_BLOCKS_PER_SM - SMEM_RESERVED_PER_BLOCK
              - BACKWARD_STATIC_SMEM)
    keep, smem = 0, ring
    for level, need in ((2, 8 * band * tile), (1, 4 * band * tile + ring)):
        if need <= budget:
            keep, smem = level, need
            break
    return BackwardPlan(vec=vec, tile=tile, cluster=cluster, band=band,
                        keep=keep, smem_bytes=smem,
                        blocks=n * -(-c // tile) * cluster)


def backward_vec(c: int, *tensors: torch.Tensor) -> int:
    """4 (16-byte loads along C) where C % 4 == 0 and every tensor starts
    on a 16-byte boundary, else 1."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if c % 4 == 0 and aligned else 1


def launch_backward_plan(x: torch.Tensor, g: torch.Tensor,
                         dx: torch.Tensor) -> BackwardPlan:
    """The plan of a backward wrapper's launch over x [N, H, W, C] on x's
    card."""
    n, h, w, c = x.shape
    return backward_plan(n, h * w, c, backward_vec(c, x, g, dx),
                         _sm_count(x.device.index))


# The forward kernel (csrc/instance_norm.cu): threads a block, the widest
# channel tile, and the shared memory its static arrays hold (the warps'
# [8, 64] sums and the [2, 64] statistics).
FORWARD_THREADS = 256
FORWARD_MAX_TILE = 64
FORWARD_STATIC_SMEM = 4 * (FORWARD_THREADS // 32 + 2) * FORWARD_MAX_TILE
# Dynamic shared memory a forward block may take: the grid has at most one
# block an SM.
FORWARD_SMEM_BUDGET = (min(SMEM_PER_BLOCK, SMEM_PER_SM - SMEM_RESERVED_PER_BLOCK)
                       - FORWARD_STATIC_SMEM)


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """How one call of the forward kernel (K1, K3) splits its work. Each
    (sample, channel tile of ``tile`` channels) is a group of ``group``
    blocks; block ``r`` of a group owns the pixels ``[r * band, (r + 1) *
    band)`` of H*W (clipped to H*W; none is empty) and keeps them in
    ``smem_bytes`` of shared memory from the one read of x to the write of
    y. The grid holds ``slabs`` groups (``blocks`` blocks, at most one an
    SM, so all on the card at once) and takes the N * tiles groups in
    ``waves`` turns: 1 keeps every slab on chip at once, more run them in
    waves. ``exchange`` is how a group's blocks meet: always ``grid``,
    through device memory, with every block of the launch on the card at
    once. (Thread-block clusters exchanging over distributed shared memory
    were slower on the card at every shape where a group fits one:
    PERF.md, Findings, PR 9.)"""
    vec: int
    tile: int
    group: int
    band: int
    slabs: int
    waves: int
    exchange: str
    smem_bytes: int
    blocks: int

    def launch_args(self) -> tuple:
        """The C launchers' trailing plan arguments, in their order."""
        return (self.vec, self.tile, self.group, self.band, self.slabs,
                self.waves, self.smem_bytes)

    def scratch(self, n: int, c: int) -> tuple[int, int]:
        """(float2 partials, int32 counters) of device memory the launch
        needs: a (mean, M2) row a block of every group, and a counter a
        group."""
        groups = n * -(-c // self.tile)
        return groups * self.group * self.tile, groups


def forward_smem(band: int, tile: int, vec: int, group: int) -> int:
    """Bytes of dynamic shared memory a forward block takes: its band of
    ``band`` pixels of a ``tile``-channel tile (a thread's elements are laid
    out at a stride of the block's threads, so the band rounds up to whole
    steps of the block's pixel slots), then the group's table of ``group``
    (mean, M2) rows of the tile, merged from there."""
    slots = FORWARD_THREADS * vec // tile
    return 4 * -(-band // slots) * slots * tile + 8 * group * tile


def forward_plan(n: int, h: int, w: int, c: int, pad: int, vec: int,
                 sm_count: int) -> ForwardPlan:
    """The forward kernel's plan for x [n, h, w, c] with a reflect pad of
    ``pad`` (0 for K1) on a card of ``sm_count`` SMs, with ``vec`` channels
    a copy (4 or 1).

    The channel tile is the widest power of two up to 64 (C rounded up,
    where that is narrower, but at least 2, so that a table row is whole
    16-byte copies); at 64 a warp's 16-byte copies cover whole 128-byte
    lines, C = 64 included. The waves are the fewest for which each
    group's band and table fit one block's shared memory, with the groups
    of a wave spread over the SMs, a block an SM: ``group`` = SMs // groups
    a wave, no more than H*W. Only where no wave count fits does the tile
    narrow; where even a ``vec``-channel tile of one group does not fit the
    card's shared memory, there is no plan."""
    if vec not in (1, 4) or c % vec:
        raise ValueError(f"forward_plan: vec {vec} does not divide C={c}")
    if pad < 0 or (pad and pad >= min(h, w)):
        raise ValueError(f"forward_plan: reflect pad {pad} needs "
                         f"0 <= pad < min(H, W) = {min(h, w)}")
    hw = h * w
    narrowest = max(vec, 2)
    widest = max(narrowest,
                 min(FORWARD_MAX_TILE, 1 << (c - 1).bit_length()))
    for tile in (64, 32, 16, 8, 4, 2):
        if not narrowest <= tile <= widest:
            continue
        total = n * -(-c // tile)
        for waves in range(1, total + 1):
            slabs = -(-total // waves)
            if slabs > sm_count or -(-total // slabs) != waves:
                continue
            group = min(sm_count // slabs, hw)
            band = -(-hw // group)
            group = -(-hw // band)
            smem = forward_smem(band, tile, vec, group)
            if smem <= FORWARD_SMEM_BUDGET:
                return ForwardPlan(vec=vec, tile=tile, group=group, band=band,
                                   slabs=slabs, waves=waves, exchange="grid",
                                   smem_bytes=smem, blocks=group * slabs)
    raise ValueError(
        f"forward_plan: a [{h}, {w}] slab of even {narrowest} channels does "
        f"not fit the shared memory of {sm_count} SMs")


def launch_forward_plan(x: torch.Tensor, y: torch.Tensor,
                        pad: int) -> ForwardPlan:
    """The plan of a forward wrapper's launch over x [N, H, W, C] on x's
    card, with 16-byte copies where x and y allow them."""
    n, h, w, c = x.shape
    return forward_plan(n, h, w, c, pad, backward_vec(c, x, y),
                        _sm_count(x.device.index))


# Per (device, stream, name): scratch that kernels on that stream share.
# Launches on one stream never overlap, and a kernel that needs its scratch
# zeroed leaves it zeroed on return, so none needs a memset of its own.
_SCRATCH: dict = {}


def stream_scratch(x: torch.Tensor, name: str, count: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """At least ``count`` elements of ``dtype`` on x's card for the current
    stream, zero when first made; grown (zeroed anew) when too small."""
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
           name)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 64), device=x.device, dtype=dtype)
        _SCRATCH[key] = buf
    return buf


def forward_launch(name: str, x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, y: torch.Tensor, pad: int,
                   shape_args: tuple):
    """Plan and launch a forward kernel, K1 (``cg_instance_norm_forward``)
    or K3 (``cg_epilogue_forward``), from x into y; ``shape_args`` are the
    entry's arguments from n to eps. Returns (mean, inv), [N, C] each."""
    n, _, _, c = x.shape
    plan = launch_forward_plan(x, y, pad)
    parts, groups = plan.scratch(n, c)
    mean, inv = torch.empty((2, n, c), device=x.device, dtype=torch.float32)
    status = getattr(build.library(), name)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), inv.data_ptr(),
        stream_scratch(x, "forward_partials", 2 * parts,
                       torch.float32).data_ptr(),
        stream_scratch(x, "forward_counters", groups, torch.int32).data_ptr(),
        *shape_args, *plan.launch_args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, name)
    return mean, inv


def check_activation(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is what the kernels take: a 4-D NHWC-contiguous
    f32 tensor on the current CUDA device, with fewer than 2**31
    elements."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: kernel input must be on a CUDA device, "
                         f"got {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernels take float32 (bfloat16 comes "
                        f"with a later slice of the port), got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected [N, H, W, C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be NHWC-contiguous")
    if x.numel() == 0 or x.numel() >= 2**31:
        raise ValueError(f"{name}: unsupported size {tuple(x.shape)}")


def check_param(v: torch.Tensor, shape: tuple, like: torch.Tensor,
                name: str) -> None:
    if (tuple(v.shape) != tuple(shape) or v.dtype != torch.float32
            or v.device != like.device or not v.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous float32 {tuple(shape)} on "
            f"{like.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def check_backward_inputs(x: torch.Tensor, scale: torch.Tensor,
                          mean: torch.Tensor, inv: torch.Tensor,
                          g: torch.Tensor, g_shape: tuple, name: str) -> None:
    """The checks of a backward wrapper: ``x`` and ``g`` as the kernels take
    activations, ``g`` of ``g_shape``, [C] ``scale`` and [N, C] ``mean`` and
    ``inv``."""
    check_activation(x, name)
    check_activation(g, f"{name} cotangent")
    if tuple(g.shape) != tuple(g_shape):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)}, expected "
                         f"{tuple(g_shape)}")
    n, c = x.shape[0], x.shape[3]
    check_param(scale, (c,), x, f"{name} scale")
    check_param(mean, (n, c), x, f"{name} mean")
    check_param(inv, (n, c), x, f"{name} inv")


def instance_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-3):
    """Launch the instance-norm kernel on the current stream."""
    check_activation(x, "instance_norm")
    n, h, w, c = x.shape
    check_param(scale, (c,), x, "instance_norm scale")
    check_param(bias, (c,), x, "instance_norm bias")
    y = torch.empty_like(x)
    mean, inv = forward_launch("cg_instance_norm_forward", x, scale, bias, y,
                               0, (n, h * w, c, float(eps)))
    LAUNCHES["instance_norm"] += 1
    return y, mean, inv


def instance_norm_backward_cuda(x: torch.Tensor, scale: torch.Tensor,
                                mean: torch.Tensor, inv: torch.Tensor,
                                g: torch.Tensor):
    """Launch the instance-norm backward kernel on the current stream."""
    check_backward_inputs(x, scale, mean, inv, g, x.shape,
                          "instance_norm_backward")
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    dscale_nc, dbias_nc = torch.empty((2, n, c), device=x.device,
                                      dtype=torch.float32)
    plan = launch_backward_plan(x, g, dx)
    lib = build.library()
    status = lib.cg_instance_norm_backward(
        x.data_ptr(), scale.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        g.data_ptr(), dx.data_ptr(), dscale_nc.data_ptr(),
        dbias_nc.data_ptr(), n, h * w, c, *plan.launch_args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "cg_instance_norm_backward")
    LAUNCHES["instance_norm_backward"] += 1
    return dx, dscale_nc, dbias_nc
