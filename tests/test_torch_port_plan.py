"""The launch plan of the backward kernels K2 and K4, on the CPU.

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
"""

import pytest
import torch

from cyclegan_tpu_torch.ops.cuda import build
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
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
