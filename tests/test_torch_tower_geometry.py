"""The coarse towers' launch geometry on the CPU: which depths of a chain run
grid-wide and which in one block's shared memory (`coarse_tower.
tower_geometry`), where the outputs lie in the call's one buffer
(`buffer_layout`), and that the Python constants agree with the CUDA source
(csrc/tower.cu). No device is needed: the geometry is plain Python handed to
the kernels' C entry points."""

import math
import os
import re
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mg_ic_code_tpu_torch.grid.boxes import Box  # noqa: E402
from mg_ic_code_tpu_torch.ops import coarse_tower as tct  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mg_ic_code_tpu_torch", "csrc")
SMEM_PER_BLOCK = 232448  # bytes of shared memory one H100 block may use
CAPACITY = 132  # one block of 512 threads on each SM


def chain(shape):
    """The depth chain make_level_spec builds: coarsen while the box stays
    2-coarsenable with every side >= 4."""
    boxes = [Box.from_shape(tuple(shape))]
    while boxes[-1].coarsenable(2) and min(boxes[-1].coarsen(2).shape) >= 4:
        boxes.append(boxes[-1].coarsen(2))
    return [tuple(b.shape) for b in boxes]


# (top shape, depths, first depth of the one-block tail, grid blocks at
# CAPACITY (512 threads a block: the top depth's colour pass, a z pair a
# thread, in whole x planes of pairs where the capacity allows), the tail's
# cells: 3 * its own + the next depth's); the chains of the paths: the
# canonical base, the periodic box from 128^3, the sharded paths' 16^3, the
# 7-level hierarchy's 176x64x64 CF level, a mixed-face box that is no cube
PATH_CHAINS = [
    ((64, 64, 64), 5, 2, 132, 3 * 4096 + 512),
    ((128, 128, 128), 6, 3, 128, 3 * 4096 + 512),
    ((16, 16, 16), 3, 0, 1, 3 * 4096 + 512),
    ((176, 64, 64), 5, 3, 132, 3 * 1408 + 176),
    ((32, 48, 40), 4, 2, 60, 3 * 960 + 120),
]


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("top,ndep,tail,blocks,cells", PATH_CHAINS,
                         ids=["64", "128_P", "16", "176x64x64",
                              "32x48x40"])
def test_path_chains_split(top, ndep, tail, blocks, cells, itemsize):
    shapes = chain(top)
    assert len(shapes) == ndep
    assert tct.tower_geometry(shapes, itemsize, CAPACITY) == (
        blocks, tail, cells * itemsize)


def _random_chains(n=300, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        shape = tuple(int(4 * rng.integers(1, 48)) for _ in range(3))
        shapes = chain(shape)
        if len(shapes) >= 2:
            out.append(shapes)
    return out


@pytest.mark.parametrize("itemsize", [4, 8])
def test_tail_fits_the_budget_and_starts_first(itemsize):
    """The tail is the first depth whose arrays fit, never more than the
    budget, which a block can have; blocks within the capacity, one when the
    whole chain is the tail."""
    budget = tct.TOWER_SMEM[itemsize]
    assert budget <= SMEM_PER_BLOCK
    for shapes in _random_chains():
        cells = [math.prod(s) for s in shapes] + [0]
        need = [(3 * cells[k] + cells[k + 1]) * itemsize
                for k in range(len(shapes))]
        for capacity in (1, 7, CAPACITY, 396):
            blocks, tail, smem = tct.tower_geometry(shapes, itemsize,
                                                    capacity)
            assert 0 <= tail <= len(shapes)
            assert smem <= budget
            assert all(n > budget for n in need[:tail])
            if tail < len(shapes):
                assert smem == need[tail]
            else:
                assert smem == 0
            assert 1 <= blocks <= capacity
            if tail == 0:
                assert blocks == 1
            else:  # whole x planes of z pairs where the capacity allows
                nx, ny, nz = shapes[0]
                plane = ny * -(-nz // 2)
                threads = blocks * tct.TOWER_THREADS
                q = plane // math.gcd(plane, tct.TOWER_THREADS)
                if q <= capacity:
                    assert threads % plane == 0


def test_buffer_layout_is_dense_and_in_c_order():
    """The states of every depth, then the restricted rhs of depths 1..end,
    back to back with no gap or overlap (csrc/tower.cu places them so)."""
    for shapes in _random_chains(60) + [chain((64, 64, 64))]:
        ndep = len(shapes)
        views, down_cells, up_cells = tct.buffer_layout(shapes)
        assert len(views) == 2 * ndep - 1
        assert [v[0] for v in views] == shapes + shapes[1:]
        offset = 0
        for shape, stride, off in views:
            assert off == offset
            assert stride == (shape[1] * shape[2], shape[2], 1)
            offset += math.prod(shape)
        assert offset == down_cells
        assert up_cells == sum(math.prod(s) for s in shapes[:-1])


def test_constants_agree_with_the_source():
    with open(os.path.join(CSRC, "tower.cu")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == tct.TOWER_THREADS
    assert const("kMaxDepths") == tct.MAX_DEPTHS
    # the canonical chains from 512^3 down fit the deepest chain
    assert len(chain((512, 512, 512))) <= tct.MAX_DEPTHS
