"""The launch plans of the forward kernels K1 and K3, of the backward
kernels K2 and K4 and of the upsample kernels K5 and K6, and the upsample
kernels' split-TF32 arithmetic, on the CPU.

``forward_plan`` (``ops/cuda/norm_kernel.py``) is checked for every K1/K3
shape of the full-width serving forward (batch 1 and 4) and train step
(the discriminator's included), of the reduced engines and train step of
the card tests, and of the card tests' own cases, on a 132-SM H100: the
kernel's walk over the plan, emulated here with its own index arithmetic,
reads every pixel and channel of x into exactly one block's band and
writes every element of the padded y exactly once; a block stays within
its shared memory and the grid within one block an SM (so the whole grid
is on the card at once); every batch-1 full-width slab stays on chip in
one wave, and the batch-4 shapes that do not fit say how many waves they
take.

``backward_plan`` (``cyclegan_tpu_torch/ops/cuda/norm_kernel.py``) is
computed in Python and passed to ``csrc/norm_backward.cu``, so its
guarantees are checked here without a card: for every K2/K4 shape of the
full-width batch-1 train step, of the reduced train step and of the card
tests, on a 132-SM H100, the bands of a cluster cover every pixel of H*W
exactly once; a block stays within the 232,448 bytes of shared memory
sm_90 lets it opt in to, and two blocks within an SM's; a cluster has at
most 16 blocks; and the grid gives every SM a block wherever N*C*H*W
allows it with channel tiles of at least one 32-byte sector. Also the
choice of the vector width and the parsing of ptxas's ``-v`` report.

``upsample_plan`` (``ops/cuda/upsample_kernel.py``) likewise, for every
K5/K6 shape of the full-width serving forward (batch 1 and 4) and train
step, of the reduced train step and engines of the card tests, and of the
card tests' own cases: its patches cover every input pixel of every sample
exactly once and never reach into another sample, a block stays within
232,448 bytes of shared memory, and the partial buffer has a row for
every (sample, patch, channel). The split's arithmetic is emulated in
torch: tf32 rounds to nearest, ties away from zero, to 10 mantissa bits.
"""

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.ops.cuda import build
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    FORWARD_MAX_TILE,
    FORWARD_SMEM_BUDGET,
    FORWARD_STATIC_SMEM,
    FORWARD_THREADS,
    SMEM_RESERVED_PER_BLOCK,
    forward_plan,
    forward_smem,
    BACKWARD_MAX_CLUSTER,
    BACKWARD_MAX_TILE,
    BACKWARD_RING,
    BACKWARD_STATIC_SMEM,
    SECTOR_FLOATS,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    backward_plan,
    backward_vec,
)
from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
    UPSAMPLE_STATIC_SMEM,
    UPSAMPLE_TILE,
    upsample_plan,
    upsample_vec,
)

SM_COUNT = 132

# (n, h, w, c) of x at each site, per kernel (neither the pad nor, beyond
# H*W, the image's shape enters the plan).
FULL_WIDTH_K2 = [(1, 256, 256, 64), (1, 128, 128, 128), (1, 64, 64, 256)]
FULL_WIDTH_K4 = [(1, 64, 64, 256), (1, 128, 128, 128), (1, 256, 256, 64),
                 (1, 64, 64, 128), (1, 32, 32, 256), (1, 32, 32, 512)]
# The reduced train step of the card tests (filters 8, 64^2, batch 2).
REDUCED_TRAIN_K2 = [(2, 64, 64, 8), (2, 32, 32, 16), (2, 16, 16, 32)]
REDUCED_TRAIN_K4 = [(2, 16, 16, 32), (2, 32, 32, 16), (2, 64, 64, 8),
                    (2, 32, 32, 8), (2, 16, 16, 16), (2, 8, 8, 32)]
CARD_TEST_K2 = [(2, 16, 16, 8), (1, 9, 7, 40), (1, 64, 64, 64), (2, 8, 8, 256),
                (1, 12, 10, 6), (3, 16, 16, 64), (1, 5, 6, 8)]
CARD_TEST_K4 = [(2, 16, 16, 8), (1, 9, 7, 40), (1, 5, 6, 8), (2, 16, 16, 64),
                (1, 8, 8, 256), (2, 12, 12, 40), (1, 16, 16, 256),
                (1, 64, 64, 64), (1, 12, 10, 6), (3, 16, 16, 64)]

CASES = ([("K2", s) for s in FULL_WIDTH_K2 + REDUCED_TRAIN_K2 + CARD_TEST_K2]
         + [("K4", s) for s in FULL_WIDTH_K4 + REDUCED_TRAIN_K4 + CARD_TEST_K4])


def _most_blocks(n, hw, c, vec):
    """The most blocks any plan the kernel takes could give: the narrowest
    tile it takes (one 32-byte sector of 8 floats, or C rounded up to a
    power of two where that is narrower, at least vec) and the largest
    cluster, with at least one pixel a block."""
    tile = max(vec, min(SECTOR_FLOATS, 1 << (c - 1).bit_length()))
    return n * -(-c // tile) * min(BACKWARD_MAX_CLUSTER, hw)


@pytest.mark.parametrize("kind,shape", CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}" for k, s in CASES])
def test_backward_plan_fits_and_covers(kind, shape):
    n, h, w, c = shape
    hw = h * w
    vec = 4 if c % 4 == 0 else 1
    plan = backward_plan(n, hw, c, vec, SM_COUNT)
    # Every pixel of H*W in exactly one block's band.
    covered = [0] * hw
    for rank in range(plan.cluster):
        start = rank * plan.band
        for q in range(start, min(start + plan.band, hw)):
            covered[q] += 1
    assert covered == [1] * hw
    # Within a block's shared memory, and a cluster's size.
    assert plan.smem_bytes + BACKWARD_STATIC_SMEM <= SMEM_PER_BLOCK
    assert 1 <= plan.cluster <= BACKWARD_MAX_CLUSTER
    # Three blocks fit an SM, so the whole grid is on the card at once.
    assert 3 * (plan.smem_bytes + BACKWARD_STATIC_SMEM + 1024) <= SMEM_PER_SM
    # The tile the kernel takes: a power of two, whole vectors, <= 64.
    assert plan.tile & (plan.tile - 1) == 0
    assert plan.vec == vec and plan.tile % vec == 0
    assert plan.tile <= BACKWARD_MAX_TILE
    assert plan.blocks == n * -(-c // plan.tile) * plan.cluster
    # On chip: g2 and xhat of the whole band, or g2 alone beside the ring
    # that stages x and g, or the ring alone.
    ring = 2 * BACKWARD_RING * 256 * vec * 4
    assert plan.smem_bytes == {2: 8 * plan.band * plan.tile,
                               1: 4 * plan.band * plan.tile + ring,
                               0: ring}[plan.keep]
    # Every SM has a block wherever the shape allows it.
    if _most_blocks(n, hw, c, vec) >= SM_COUNT:
        assert plan.blocks >= SM_COUNT


def test_backward_plan_keeps_the_band_on_chip_where_it_fits():
    """[1, 64, 64, 256]: g2 and xhat (8.4 MB) stay in shared memory, so x
    and g cross memory once. [1, 128, 128, 128]: g2 and xhat of a block's
    band would take more than a third of an SM, so g2 stays and dx reads x
    again. [1, 256, 256, 64] and larger: not even g2 fits, so dx reads x
    and g again."""
    for (n, h, w, c), keep in (((1, 64, 64, 256), 2), ((1, 128, 128, 128), 1),
                               ((1, 256, 256, 64), 0), ((1, 512, 512, 64), 0)):
        plan = backward_plan(n, h * w, c, 4, SM_COUNT)
        assert plan.keep == keep, ((n, h, w, c), plan)


def test_backward_plan_tiles_are_never_narrower_than_a_sector():
    """[1, 256, 256, 64] would need 4-channel tiles (half a 32-byte sector
    a pixel) for 132 blocks; the plan keeps 8 and takes 128 blocks."""
    plan = backward_plan(1, 256 * 256, 64, 4, SM_COUNT)
    assert (plan.tile, plan.cluster, plan.blocks) == (8, 16, 128)
    plan = backward_plan(1, 64 * 64, 256, 4, SM_COUNT)
    assert (plan.tile, plan.cluster, plan.blocks) == (16, 16, 256)


def test_backward_plan_rejects_a_vector_width_that_does_not_divide_c():
    with pytest.raises(ValueError, match="vec"):
        backward_plan(1, 64, 6, 4, SM_COUNT)


def test_backward_vec_needs_whole_vectors_and_16_byte_alignment():
    buf = torch.zeros(1 + 2 * 4 * 4 * 8)
    aligned = buf[:-1].view(2, 4, 4, 8)
    shifted = buf[1:].view(2, 4, 4, 8)
    assert aligned.data_ptr() % 16 == 0
    assert backward_vec(8, aligned, aligned) == 4
    assert backward_vec(8, aligned, shifted) == 1
    assert backward_vec(6, torch.zeros(1, 2, 2, 6)) == 1


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2cg12_GLOBAL__N_120norm_backward_kernelILb1ELb1ELi4EEEvNS0_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN2cg12_GLOBAL__N_120norm_backward_kernelILb1ELb1ELi4EEEvNS0_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 5120 bytes smem, 512 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, 380 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_stack_and_spills(tmp_path):
    lib = tmp_path / "libk.so"
    (tmp_path / "libk.so.ptxas.txt").write_text(PTXAS)
    report = build.ptxas_report(str(lib))
    assert report == {
        "_ZN2cg12_GLOBAL__N_120norm_backward_kernelILb1ELb1ELi4EEEvNS0_4ArgsE":
            dict(registers=64, smem_bytes=5120, stack_bytes=0,
                 spill_store_bytes=0, spill_load_bytes=0),
        "_Z3fooPf": dict(registers=255, smem_bytes=0, stack_bytes=16,
                         spill_store_bytes=8, spill_load_bytes=4)}


# (n, h, w, cin, cout) of x and the kernel at each upsample site, per use.
FULL_WIDTH_UPSAMPLE = [(n, 64, 64, 256, 128) for n in (1, 4)] + [
    (n, 128, 128, 128, 64) for n in (1, 4)]
# The reduced train step (filters 8, 64^2, batch 2) and the reduced engines
# (filters 16, 64^2, buckets 1 and 2) of the card tests.
REDUCED_UPSAMPLE = [(2, 16, 16, 32, 16), (2, 32, 32, 16, 8)] + [
    (n, 16, 16, 64, 32) for n in (1, 2)] + [(n, 32, 32, 32, 16) for n in (1, 2)]
CARD_TEST_UPSAMPLE = [(2, 8, 8, 64, 32), (1, 7, 5, 24, 40),
                      (1, 16, 16, 128, 64), (1, 4, 4, 8, 160),
                      (3, 9, 20, 32, 48), (1, 3, 5, 16, 24), (2, 6, 7, 6, 9)]
UPSAMPLE_CASES = [(int8, s) for int8 in (False, True)
                  for s in FULL_WIDTH_UPSAMPLE + REDUCED_UPSAMPLE
                  + CARD_TEST_UPSAMPLE]


@pytest.mark.parametrize(
    "int8,shape", UPSAMPLE_CASES,
    ids=[f"{'K6' if i else 'K5'}-{'x'.join(map(str, s))}"
         for i, s in UPSAMPLE_CASES])
def test_upsample_plan_covers_fits_and_sizes_its_partials(int8, shape):
    n, h, w, cin, cout = shape
    plan = upsample_plan(n, h, w, cin, cout, SM_COUNT, int8)
    # Every input pixel of every sample in exactly one patch, and every
    # patch inside one sample.
    covered = np.zeros((n, h, w), np.int64)
    for block in range(plan.grid[0]):
        sample, row0, col0 = plan.patch_origin(block)
        assert 0 <= sample < n and 0 <= row0 < h and 0 <= col0 < w
        covered[sample, row0:row0 + plan.patch_rows,
                col0:col0 + plan.patch_cols] += 1
    assert (covered == 1).all()
    assert plan.grid[0] == n * plan.patches
    # Every output channel in one tile; within a block's shared memory.
    assert plan.grid[1] * plan.tile >= cout > (plan.grid[1] - 1) * plan.tile
    assert plan.smem_bytes + UPSAMPLE_STATIC_SMEM <= SMEM_PER_BLOCK
    # A partial row for every (sample, patch, channel), a ticket for every
    # (sample, channel tile).
    assert plan.partial_shape == (n, plan.patches, cout)
    assert plan.tickets == n * plan.grid[1]
    assert plan.waves == -(-plan.grid[0] * plan.grid[1] // SM_COUNT)


def test_upsample_plan_at_the_generator_blocks():
    """[1, 64, 64, 256] -> 128: 32 patches of 8 x 16 pixels, 4 tiles of 32
    channels, 128 blocks, one wave; [1, 128, 128, 128] -> 64: 256 blocks.
    K5 stages f32 kernel rows, K6 int8 ones, so K6 takes less memory."""
    plan = upsample_plan(1, 64, 64, 256, 128, SM_COUNT)
    assert (plan.patch_rows, plan.patch_cols, plan.tile) == (8, 16, UPSAMPLE_TILE)
    assert (plan.grid, plan.waves) == ((32, 4), 1)
    plan = upsample_plan(1, 128, 128, 128, 64, SM_COUNT)
    assert (plan.grid, plan.waves) == ((128, 2), 2)
    assert upsample_plan(1, 64, 64, 256, 128, SM_COUNT, int8=True).smem_bytes \
        < upsample_plan(1, 64, 64, 256, 128, SM_COUNT).smem_bytes


def test_upsample_vec_needs_whole_chunks_and_16_byte_alignment():
    buf = torch.zeros(1 + 4 * 4 * 32)
    aligned, shifted = buf[:-1].view(1, 4, 4, 32), buf[1:].view(1, 4, 4, 32)
    assert upsample_vec(32, 64, False, aligned) == 4
    assert upsample_vec(32, 40, False, aligned) == 4
    assert upsample_vec(32, 40, True, aligned) == 1   # int8 rows of 16 bytes
    assert upsample_vec(6, 64, False, aligned) == 1
    assert upsample_vec(32, 64, False, shifted) == 1


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to tf32 (10 mantissa bits), to nearest with ties away
    from zero: add half of the dropped bits' weight to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def test_tf32_rounding_matches_its_definition():
    x = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11), 1 + 2**-12,
                      3.0, -0.0, 2**-126])
    assert _tf32(x).tolist() == [1 + 2**-10, 1 + 4 * 2**-11, -(1 + 2**-10),
                                 1.0, 3.0, -0.0, 2**-126]


def test_split_of_every_int8_value_is_exact():
    """An int8 weight (|q| <= 128 < 2^11) is exact in tf32: hi = q and
    lo = 0, so K6 needs no hi_a * lo_b pass."""
    q = torch.arange(-128, 128, dtype=torch.int8).to(torch.float32)
    hi, lo = _split(q)
    assert torch.equal(hi, q) and not lo.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_tf32_product_is_nearer_float64_than_an_f32_matmul(seed):
    """At full depth (Cin 256 over all 9 taps, 2304 terms), for a few
    pixels: hi*hi + hi*lo + lo*hi summed in float64 lies nearer the
    float64 product than the f32 matmul of the same operands, by relative
    L2. (The kernel sums in f32 on the tensor cores; this checks the
    split's representation error alone.)"""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.standard_normal((8, 9 * 256)) * 2 + 0.5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((9 * 256, 16)) / 48)
                         .astype(np.float32))
    exact = a.double() @ b.double()
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    split = (a_hi.double() @ b_hi.double() + a_hi.double() @ b_lo.double()
             + a_lo.double() @ b_hi.double())

    def rel(x):
        return ((x.double() - exact).norm() / exact.norm()).item()
    assert rel(split) < rel(a @ b)


# (n, h, w, c, pad) of x at each K1 (pad 0) and K3 site, per use. The
# full-width serving forward at buckets 1 and 4; the train step's
# discriminator tails (pad 0, slope 0.2) at batch 1.
FULL_WIDTH_FORWARD = [(n, h, h, c, 0) for n in (1, 4)
                      for h, c in ((256, 64), (128, 128), (64, 256))] + [
    (n, 64, 64, 256, 1) for n in (1, 4)] + [
    (1, 64, 64, 128, 0), (1, 32, 32, 256, 0), (1, 32, 32, 512, 0),
    (4, 32, 32, 512, 0)]
# The reduced engines (filters 16, 64^2, buckets 1 and 2) and train step
# (filters 8, 64^2, batch 2) of the card tests.
REDUCED_FORWARD = [(n, h, h, c, 0) for n in (1, 2)
                   for h, c in ((64, 16), (32, 32), (16, 64))] + [
    (n, 16, 16, 64, 1) for n in (1, 2)] + [
    (2, 64, 64, 8, 0), (2, 32, 32, 16, 0), (2, 16, 16, 32, 0),
    (2, 16, 16, 32, 1), (2, 32, 32, 8, 0), (2, 16, 16, 16, 0), (2, 8, 8, 32, 0)]
CARD_TEST_FORWARD = [(2, 16, 16, 64, 0), (1, 9, 7, 40, 0), (3, 64, 64, 8, 0),
                     (2, 16, 16, 64, 1), (1, 9, 7, 40, 3), (2, 8, 8, 96, 0),
                     (1, 12, 10, 6, 2), (3, 16, 16, 64, 1), (1, 5, 6, 8, 3),
                     (4, 128, 128, 128, 0), (2, 64, 64, 256, 1)]
FORWARD_CASES = FULL_WIDTH_FORWARD + REDUCED_FORWARD + CARD_TEST_FORWARD


def _forward_walk(plan, n, h, w, c, pad):
    """The forward kernel's walk over ``plan``, with its own index
    arithmetic: how many times each element of x is copied into a band,
    and how many times each element of y is written. Block ``rank`` of the
    group of wave ``wave`` and grid row ``s`` takes (sample, tile) =
    divmod(wave * slabs + s, tiles) and the pixels [rank * band, ...) of
    H*W; each pixel goes to its own padded place and to the place of each
    reflect-pad mirror of its row and of its column."""
    hw, tiles = h * w, -(-c // plan.tile)
    reads = np.zeros((n, hw, c), np.int64)
    writes = np.zeros((n, h + 2 * pad, w + 2 * pad, c), np.int64)
    for wave in range(plan.waves):
        for s in range(plan.slabs):
            gi = wave * plan.slabs + s
            if gi >= n * tiles:
                break
            sample, tile_i = divmod(gi, tiles)
            channels = slice(tile_i * plan.tile, (tile_i + 1) * plan.tile)
            for rank in range(plan.group):
                q0 = min(rank * plan.band, hw)
                q = np.arange(q0, min(q0 + plan.band, hw))
                reads[sample, q, channels] += 1
                row, col = q // w, q % w
                rows = [(row + pad, np.ones_like(q, bool)),
                        (pad - row, (row >= 1) & (row <= pad)),
                        (2 * h - 2 - row + pad,
                         (row >= h - 1 - pad) & (row <= h - 2))]
                cols = [(col + pad, np.ones_like(q, bool)),
                        (pad - col, (col >= 1) & (col <= pad)),
                        (2 * w - 2 - col + pad,
                         (col >= w - 1 - pad) & (col <= w - 2))]
                for r, r_ok in rows:
                    for k, k_ok in cols:
                        ok = r_ok & k_ok
                        np.add.at(writes[sample, :, :, channels],
                                  (r[ok], k[ok]), 1)
    return reads, writes


@pytest.mark.parametrize("shape", FORWARD_CASES,
                         ids=["x".join(map(str, s[:4])) + f"-p{s[4]}"
                              for s in FORWARD_CASES])
def test_forward_plan_covers_fits_and_is_co_resident(shape):
    n, h, w, c, pad = shape
    vec = 4 if c % 4 == 0 else 1
    plan = forward_plan(n, h, w, c, pad, vec, SM_COUNT)
    reads, writes = _forward_walk(plan, n, h, w, c, pad)
    # Every pixel and channel of x in one band; every element of y once.
    assert (reads == 1).all()
    assert (writes == 1).all()
    # No block is empty, and the band fits its shared memory.
    assert (plan.group - 1) * plan.band < h * w <= plan.group * plan.band
    assert plan.smem_bytes == forward_smem(plan.band, plan.tile, vec,
                                           plan.group)
    assert plan.smem_bytes <= FORWARD_SMEM_BUDGET
    assert plan.smem_bytes + FORWARD_STATIC_SMEM + SMEM_RESERVED_PER_BLOCK \
        <= SMEM_PER_SM
    # At most one block an SM: the grid is on the card at once.
    assert plan.blocks == plan.group * plan.slabs <= SM_COUNT
    # The waves take every (sample, tile) group, the last wave not empty.
    groups = n * -(-c // plan.tile)
    assert plan.slabs * (plan.waves - 1) < groups <= plan.slabs * plan.waves
    # The tile the kernel takes: a power of two, whole vectors, even (whole
    # 16-byte copies of its table), <= 64, and a warp's lanes on whole
    # 128-byte lines wherever C allows it.
    assert plan.tile & (plan.tile - 1) == 0 and plan.tile % vec == 0
    assert plan.tile % 2 == 0
    assert plan.vec == vec and plan.tile <= FORWARD_MAX_TILE
    assert FORWARD_THREADS % (plan.tile // vec) == 0
    if c >= 32 and c % 32 == 0:
        assert plan.tile >= 32
    assert plan.exchange == "grid"
    n_scratch, n_counters = plan.scratch(n, c)
    assert (n_scratch, n_counters) == (groups * plan.group * plan.tile, groups)


def test_forward_plan_keeps_every_batch_1_full_width_slab_on_chip():
    """One wave at every batch-1 shape of the full-width generator and
    discriminator: x is read once, kept in shared memory across the whole
    card, and y written from there."""
    for n, h, w, c, pad in FULL_WIDTH_FORWARD:
        plan = forward_plan(n, h, w, c, pad, 4, SM_COUNT)
        if n == 1:
            assert plan.waves == 1, (h, w, c, plan)
    # [1, 256, 256, 64]: a whole 256-byte pixel a lane group, all 132 SMs.
    plan = forward_plan(1, 256, 256, 64, 0, 4, SM_COUNT)
    assert (plan.tile, plan.group, plan.slabs, plan.blocks) == (64, 132, 1, 132)


def test_forward_plan_runs_batch_4_slabs_that_do_not_fit_in_waves():
    """[4, 256, 256, 64] (67 MB) and [4, 128, 128, 128] (33.5 MB) exceed
    the 30 MB of shared memory of 132 SMs: the plan takes their groups in
    waves, one sample's (16.8 MB) and two samples' at a time; the smaller
    batch-4 shapes keep every slab on chip at once."""
    waves = {(h, c, pad): forward_plan(n, h, w, c, pad, 4, SM_COUNT).waves
             for n, h, w, c, pad in FULL_WIDTH_FORWARD if n == 4}
    assert waves == {(256, 64, 0): 4, (128, 128, 0): 2, (64, 256, 0): 1,
                     (64, 256, 1): 1, (32, 512, 0): 1}
    slab = 4 * 256 * 256 * 64
    assert 4 * slab > SM_COUNT * FORWARD_SMEM_BUDGET > slab


@pytest.mark.parametrize("vec", [4, 1])
def test_forward_plan_copy_width(vec):
    """The copy width is the wrapper's choice (16 bytes where C % 4 == 0
    and x and y are 16-byte aligned, else 4), and the plan takes it as
    given: the same kernel with narrower copies, with as many lanes as the
    tile has vectors. A width that does not divide C has no plan."""
    for n, h, w, c, pad in ((1, 64, 64, 256, 1), (1, 9, 7, 40, 3),
                            (2, 16, 16, 64, 0)):
        plan = forward_plan(n, h, w, c, pad, vec, SM_COUNT)
        assert plan.vec == vec
        assert plan.launch_args()[0] == vec
    with pytest.raises(ValueError, match="vec"):
        forward_plan(1, 8, 8, 6, 0, 4, SM_COUNT)


def test_forward_plan_rejects_a_pad_the_reflect_cannot_take_and_oversized_slabs():
    with pytest.raises(ValueError, match="pad"):
        forward_plan(1, 4, 8, 16, 4, 4, SM_COUNT)
    # 2048^2 x 64 channels: even one 4-channel tile (67 MB) exceeds the
    # card's shared memory.
    with pytest.raises(ValueError, match="does not fit"):
        forward_plan(1, 2048, 2048, 64, 0, 4, SM_COUNT)
