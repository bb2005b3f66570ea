"""Instance norm forward and backward: the CUDA kernels' wrappers and
their plain versions.

The forward kernel (``csrc/instance_norm.cu``) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/norm_kernel.py:_forward``. Both versions take an
NHWC f32 or bf16 ``x`` and return ``(y, mean, inv)``: ``y`` as ``x``,
``mean`` and ``inv = 1/sqrt(var + eps)`` as [N, C] f32. On the card it is
one launch, on a plan from ``forward_plan``, which the epilogue forward
(K3) shares.

The backward kernel (``csrc/norm_backward.cu``) replaces
``cyclegan_tpu/ops/pallas/norm_kernel.py:_backward``. Both versions take
``x``, ``scale``, the forward's ``mean`` and ``inv`` and the cotangent
``g`` of ``y``, and return ``(dx, dscale_nc, dbias_nc)``: ``dx`` as ``x``,
the per-(n, c) partials of dscale and dbias as [N, C] f32, which the caller
sums over N.

bf16 (the JAX package's bfloat16 compute) has the JAX kernels' cast points:
x (and g) are widened to f32, every statistic and sum is f32, and each
bf16 output (y, dx) is rounded once, at the end; scale, bias, mean and inv
stay f32. Each kernel has a bf16 form of its own and counts its launches
under its name with ``_bf16`` (``LAUNCHES``); a bf16 call takes 16-byte
accesses only (C a multiple of 8, 16-byte aligned tensors) and raises
where it cannot.

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

def widened(t: torch.Tensor) -> torch.Tensor:
    """A bf16 tensor widened to f32, the type the kernels compute in; an
    f32 (or, for references, float64) tensor as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def instance_norm_compute(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-3):
    """The plain instance norm in the computing type (f32 for bf16 x), not
    yet rounded to x's type: (y, mean, inv)."""
    x = widened(x)
    mean = x.mean(dim=(1, 2), keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = centered * inv * scale + bias
    return y, mean[:, 0, 0, :], inv[:, 0, 0, :]


def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-3):
    """Plain PyTorch instance norm with the kernel's outputs."""
    y, mean, inv = instance_norm_compute(x, scale, bias, eps)
    return y.to(x.dtype), mean, inv


def instance_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                                 mean: torch.Tensor, inv: torch.Tensor,
                                 g: torch.Tensor):
    """Plain PyTorch instance-norm VJP with the kernel's outputs:
    dx = scale * inv * (g - mean_hw(g) - xhat * mean_hw(g * xhat)), in f32
    for bf16 x and g, dx rounded to x's type."""
    dtype = x.dtype
    x, g = widened(x), widened(g)
    mean, inv = mean[:, None, None, :], inv[:, None, None, :]
    xhat = (x - mean) * inv
    dbias_nc = g.sum(dim=(1, 2))
    dscale_nc = (g * xhat).sum(dim=(1, 2))
    hw = x.shape[1] * x.shape[2]
    dx = scale * inv * (g - dbias_nc[:, None, None, :] / hw
                        - xhat * (dscale_nc[:, None, None, :] / hw))
    return dx.to(dtype), dscale_nc, dbias_nc


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# SMs of an H100 SXM: the card the eligibility of a kernel site is decided
# for, before any launch (epilogue_kernel.py epilogue_eligible).
H100_SM_COUNT = 132

# Bytes of an activation's element, by type: the kernels take f32 and bf16.
ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}

# The backward kernel (csrc/norm_backward.cu): threads a block, the widest
# channel tile and the largest cluster it takes, the elements a thread
# stages ahead when its band does not stay on chip, and the shared memory
# its static arrays hold (per-warp and per-rank [*, 64] tables of the two
# sums, the [2, 64] totals and an 8-byte mbarrier).
BACKWARD_THREADS = 256
# Blocks an SM holds at once, by element bytes: __launch_bounds__(256, 3)
# caps an f32 thread's registers, (256, 2) a bf16 one's (8 channels a
# thread where f32 has 4).
BACKWARD_BLOCKS_PER_SM = {4: 3, 2: 2}
BACKWARD_MAX_TILE = 64
BACKWARD_MAX_CLUSTER = 16
BACKWARD_RING = 2
BACKWARD_STATIC_SMEM = 4 * 2 * 64 * (BACKWARD_THREADS // 32
                                     + BACKWARD_MAX_CLUSTER + 1) + 8
# The narrowest channel tile where C allows it: one 32-byte sector of a
# pixel (8 floats, 16 bf16), so that no load reads half a sector.
SECTOR_BYTES = 32
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
    bytes each an element; in bf16 the raw g and x, 2 bytes each, from
    which the second pass forms g2 and xhat again); 1, g2 alone (bf16: g),
    x being read again for xhat; 0, nothing, x and g being read again.
    ``smem_bytes`` is the dynamic shared memory a block takes for that,
    with the ring through which it stages x and g when keep < 2. ``esize``
    is the bytes of an element of x, g and dx (4 f32, 2 bf16)."""
    vec: int
    tile: int
    cluster: int
    band: int
    keep: int
    smem_bytes: int
    blocks: int
    esize: int = 4

    def launch_args(self) -> tuple:
        """The C launchers' trailing plan arguments, in their order."""
        return (self.vec, self.tile, self.cluster, self.band,
                self.smem_bytes, self.keep, self.esize)


def check_vec(vec: int, c: int, esize: int, name: str) -> None:
    """A kernel's access width: 16 bytes (4 floats, 8 bf16), or one f32."""
    widths = (16 // esize, 1) if esize == 4 else (16 // esize,)
    if esize not in (2, 4) or vec not in widths or c % vec:
        raise ValueError(f"{name}: vec {vec} is no access width of a "
                         f"{esize}-byte element over C={c}")


def backward_plan(n: int, hw: int, c: int, vec: int, sm_count: int,
                  esize: int = 4) -> BackwardPlan:
    """The backward kernel's plan for x [n, H, W, c] with hw = H * W on a
    card of ``sm_count`` SMs, with ``vec`` channels a load (4 or 1 for f32,
    8 for bf16) and ``esize`` bytes an element.

    The whole grid must be on the card at once: a cluster waits for its
    slowest block, so a cluster left for a second wave holds back the
    launch's end. The kernel's registers let three blocks share an SM (two
    in bf16), so a block takes at most that share of an SM's shared
    memory. The channel tile is the widest power of two (from 64 down to
    one 32-byte sector, 8 floats or 16 bf16, or C where that is narrower)
    for which a cluster of at most 16 blocks gives every SM a block; the
    cluster is the smallest such power of two; where no tile does, the
    narrowest tile with the largest cluster. A block keeps the most of its
    band that fits (g2 and xhat, else g2; in bf16 g and x, else g)."""
    check_vec(vec, c, esize, "backward_plan")
    widest = max(vec, min(BACKWARD_MAX_TILE, 1 << (c - 1).bit_length()))
    narrowest = max(vec, min(widest, SECTOR_BYTES // esize))
    tiles = [t for t in (64, 32, 16, 8, 4, 2, 1) if narrowest <= t <= widest]
    clusters = [k for k in (1, 2, 4, 8, 16) if k <= max(1, hw)]
    tile, cluster = tiles[-1], clusters[-1]
    for t in tiles:
        fits = [k for k in clusters if n * -(-c // t) * k >= sm_count]
        if fits:
            tile, cluster = t, fits[0]
            break
    band = -(-hw // cluster)
    ring = 2 * BACKWARD_RING * BACKWARD_THREADS * vec * esize
    budget = (SMEM_PER_SM // BACKWARD_BLOCKS_PER_SM[esize]
              - SMEM_RESERVED_PER_BLOCK - BACKWARD_STATIC_SMEM)
    keep, smem = 0, ring
    for level, need in ((2, 2 * esize * band * tile),
                        (1, esize * band * tile + ring)):
        if need <= budget:
            keep, smem = level, need
            break
    return BackwardPlan(vec=vec, tile=tile, cluster=cluster, band=band,
                        keep=keep, smem_bytes=smem,
                        blocks=n * -(-c // tile) * cluster, esize=esize)


def backward_vec(c: int, *tensors: torch.Tensor) -> int:
    """The channels of a 16-byte access along C (4 floats, 8 bf16) where C
    is a multiple of them and every tensor starts on a 16-byte boundary;
    else 1 for f32. A bf16 tensor that takes no 16-byte access has no
    kernel form and raises."""
    esize = ELEMENT_BYTES[tensors[0].dtype]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if c % (16 // esize) == 0 and aligned:
        return 16 // esize
    if esize == 2:
        raise ValueError(
            f"no bf16 plan for C={c}"
            + ("" if aligned else " (a tensor not on a 16-byte boundary)")
            + ": the bf16 kernels take 8 channels a 16-byte access, so C "
            "must be a multiple of 8")
    return 1


def launch_backward_plan(x: torch.Tensor, g: torch.Tensor,
                         dx: torch.Tensor) -> BackwardPlan:
    """The plan of a backward wrapper's launch over x [N, H, W, C] on x's
    card."""
    n, h, w, c = x.shape
    return backward_plan(n, h * w, c, backward_vec(c, x, g, dx),
                         _sm_count(x.device.index), ELEMENT_BYTES[x.dtype])


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
    waves. ``esize`` is the bytes of an element of x and y (4 f32, 2 bf16:
    a bf16 slab takes half the shared memory of an f32 one).
    ``exchange`` is how a group's blocks meet: always ``grid``,
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
    esize: int = 4

    def launch_args(self) -> tuple:
        """The C launchers' trailing plan arguments, in their order."""
        return (self.vec, self.tile, self.group, self.band, self.slabs,
                self.waves, self.smem_bytes, self.esize)

    def scratch(self, n: int, c: int) -> tuple[int, int]:
        """(float2 partials, int32 counters) of device memory the launch
        needs: a (mean, M2) row a block of every group, and a counter a
        group."""
        groups = n * -(-c // self.tile)
        return groups * self.group * self.tile, groups


def forward_smem(band: int, tile: int, vec: int, group: int,
                 esize: int = 4) -> int:
    """Bytes of dynamic shared memory a forward block takes: its band of
    ``band`` pixels of a ``tile``-channel tile, ``esize`` bytes an element
    (a thread's elements are laid out at a stride of the block's threads,
    so the band rounds up to whole steps of the block's pixel slots), then
    the group's table of ``group`` (mean, M2) f32 rows of the tile, merged
    from there."""
    slots = FORWARD_THREADS * vec // tile
    return esize * -(-band // slots) * slots * tile + 8 * group * tile


def forward_plan(n: int, h: int, w: int, c: int, pad: int, vec: int,
                 sm_count: int, esize: int = 4) -> ForwardPlan:
    """The forward kernel's plan for x [n, h, w, c] with a reflect pad of
    ``pad`` (0 for K1) on a card of ``sm_count`` SMs, with ``vec`` channels
    a copy (4 or 1 for f32, 8 for bf16) and ``esize`` bytes an element.

    The channel tile is the widest power of two up to 64 (C rounded up,
    where that is narrower, but at least 2, so that a table row is whole
    16-byte copies); at 64 a warp's 16-byte copies cover whole 128-byte
    lines, C = 64 included. The waves are the fewest for which each
    group's band and table fit one block's shared memory, with the groups
    of a wave spread over the SMs, a block an SM: ``group`` = SMs // groups
    a wave, no more than H*W. Only where no wave count fits does the tile
    narrow; where even a ``vec``-channel tile of one group does not fit the
    card's shared memory, there is no plan."""
    check_vec(vec, c, esize, "forward_plan")
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
            smem = forward_smem(band, tile, vec, group, esize)
            if smem <= FORWARD_SMEM_BUDGET:
                return ForwardPlan(vec=vec, tile=tile, group=group, band=band,
                                   slabs=slabs, waves=waves, exchange="grid",
                                   smem_bytes=smem, blocks=group * slabs,
                                   esize=esize)
    raise ValueError(
        f"forward_plan: a [{h}, {w}] slab of even {narrowest} channels does "
        f"not fit the shared memory of {sm_count} SMs")


def launch_forward_plan(x: torch.Tensor, y: torch.Tensor,
                        pad: int) -> ForwardPlan:
    """The plan of a forward wrapper's launch over x [N, H, W, C] on x's
    card, with 16-byte copies where x and y allow them."""
    n, h, w, c = x.shape
    return forward_plan(n, h, w, c, pad, backward_vec(c, x, y),
                        _sm_count(x.device.index), ELEMENT_BYTES[x.dtype])


# Per (device, stream, name): scratch that kernels on that stream share.
# Launches on one stream never overlap, and a kernel that needs its scratch
# zeroed leaves it zeroed on return, so none needs a memset of its own (nor
# does a CUDA graph's replay: each replay leaves it zeroed for the next).
_SCRATCH: dict = {}


def stream_scratch(x: torch.Tensor, name: str, count: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """At least ``count`` elements of ``dtype`` on x's card for the current
    stream, zero when first made; grown (zeroed anew) when too small.

    Under CUDA graph capture a buffer made here would come from the graph's
    private pool, so there it must already exist (``adopt_scratch``): a
    miss raises."""
    stream = torch.cuda.current_stream(x.device)
    key = (x.device.index, stream.cuda_stream, name)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"stream_scratch: no {name} buffer of {count} elements for "
                "the capturing stream; run the captured code once on "
                "another stream and adopt its scratch first "
                "(adopt_scratch)")
        buf = torch.zeros(max(count, 64), device=x.device, dtype=dtype)
        _SCRATCH[key] = buf
    return buf


def adopt_scratch(device: torch.device, source: torch.cuda.Stream,
                  target: torch.cuda.Stream) -> list:
    """Give ``target`` zeroed scratch of every name and size ``source`` has
    on ``device`` (where it has none as large), before code that warmed up
    on ``source`` is captured on ``target``. Returns ``target``'s buffers:
    a graph that captured them keeps them alive."""
    index = device.index
    for (dev, handle, name), buf in list(_SCRATCH.items()):
        if dev != index or handle != source.cuda_stream:
            continue
        key = (index, target.cuda_stream, name)
        have = _SCRATCH.get(key)
        if have is None or have.numel() < buf.numel():
            _SCRATCH[key] = torch.zeros_like(buf)
    return [buf for (dev, handle, _), buf in _SCRATCH.items()
            if dev == index and handle == target.cuda_stream]


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


def check_activation(x: torch.Tensor, name: str,
                     dtypes: tuple = (torch.float32, torch.bfloat16)) -> None:
    """Raise unless ``x`` is what the kernels take: a 4-D NHWC-contiguous
    tensor of one of ``dtypes`` (f32 or bf16 by default) on the current
    CUDA device, with fewer than 2**31 elements."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: kernel input must be on a CUDA device, "
                         f"got {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: this kernel takes "
                        f"{' or '.join(str(d) for d in dtypes)}, got "
                        f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected [N, H, W, C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be NHWC-contiguous")
    if x.numel() == 0 or x.numel() >= 2**31:
        raise ValueError(f"{name}: unsupported size {tuple(x.shape)}")


def check_param(v: torch.Tensor, shape: tuple, like: torch.Tensor,
                name: str, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``v`` is a contiguous ``dtype`` (f32 by default: norm
    parameters and statistics stay f32 under bf16) tensor of ``shape`` on
    ``like``'s device."""
    if (tuple(v.shape) != tuple(shape) or v.dtype != dtype
            or v.device != like.device or not v.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on "
            f"{like.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def check_backward_inputs(x: torch.Tensor, scale: torch.Tensor,
                          mean: torch.Tensor, inv: torch.Tensor,
                          g: torch.Tensor, g_shape: tuple, name: str) -> None:
    """The checks of a backward wrapper: ``x`` and ``g`` as the kernels take
    activations, of one type, ``g`` of ``g_shape``, [C] ``scale`` and
    [N, C] ``mean`` and ``inv`` (f32 whatever x's type)."""
    check_activation(x, name)
    check_activation(g, f"{name} cotangent", (x.dtype,))
    if tuple(g.shape) != tuple(g_shape):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)}, expected "
                         f"{tuple(g_shape)}")
    n, c = x.shape[0], x.shape[3]
    check_param(scale, (c,), x, f"{name} scale")
    check_param(mean, (n, c), x, f"{name} mean")
    check_param(inv, (n, c), x, f"{name} inv")


def launch_name(name: str, x: torch.Tensor) -> str:
    """A kernel's key in ``LAUNCHES`` for a call on ``x``: its bf16 form
    counts apart."""
    return f"{name}_bf16" if x.dtype == torch.bfloat16 else name


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
    LAUNCHES[launch_name("instance_norm", x)] += 1
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
    LAUNCHES[launch_name("instance_norm_backward", x)] += 1
    return dx, dscale_nc, dbias_nc
