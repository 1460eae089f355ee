"""The whole-level march's launch geometry on the CPU: which tile width
(`fused_sweeps.march_tile`) and which x segments (`march_segments`) a level
gets, and that the Python table of tiles agrees with the forms the CUDA
source builds (csrc/multisweep.cu, MARCH_FORMS). No device is needed: the
geometry is plain Python handed to the kernel's C entry."""

import math
import os
import re
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mg_ic_code_tpu_torch.ops import fused_sweeps as tfs  # noqa: E402

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mg_ic_code_tpu_torch", "csrc")
H100_SMS = 132
SMEM_PER_BLOCK = 232448  # bytes of shared memory one block may use

# the main path's levels and awkward ones: (nx, ny, nz)
SHAPES = [(960, 144, 144), (512, 96, 96), (256, 256, 256), (472, 64, 64),
          (512, 512, 512), (272, 80, 80), (37, 18, 10), (2, 12, 8),
          (66, 40, 24), (62, 40, 24), (130, 24, 40), (6, 44, 36),
          (20, 144, 144), (40, 72, 36)]
FORMS = [(isz, ns) for isz, ns in tfs.MARCH_TILES]


def march_forms():
    """(type, NP, W, D) of every line of the source's MARCH_FORMS."""
    with open(os.path.join(CSRC, "multisweep.cu")) as f:
        src = f.read()
    block = re.search(r"#define MARCH_FORMS\(X\)((?:.*\\\n)*.*\n)", src)
    return [(t, int(a), int(b), int(d)) for t, a, b, d in
            re.findall(r"X\((float|double), (\d+), (\d+), (\d+)\)",
                       block.group(1))]


def header_march_segments(nx, tiles, capacity, NP):
    """csrc/multisweep_march.cuh's march_segments, line by line (the shard
    forms still cut their segments with it)."""
    most = nx // (8 * NP) if nx // (8 * NP) > 1 else 1
    nseg, xseg, best = 1, nx, -1
    for n in range(1, most + 1):
        length = (nx + n - 1) // n
        segs = (nx + length - 1) // length
        rounds = (tiles * segs + capacity - 1) // capacity
        cost = rounds * (length + 3 * NP)
        if best < 0 or cost < best:
            best, nseg, xseg = cost, segs, length
    return nseg, xseg


def wave_plane(W):
    """WaveLayout<W, W>::PLANE of csrc/multisweep_march.cuh."""
    hz = W // 2
    hp = hz + 2
    pz = 2 * hp + ((hz - 2 * hp) % 32 + 32) % 32
    return (W + 2) * pz


def test_python_tiles_are_the_forms_the_source_builds():
    built = {}
    for t, np_, w, _ in march_forms():
        built.setdefault((4 if t == "float" else 8, np_ // 2), []).append(w)
    assert {k: tuple(v) for k, v in built.items()} == tfs.MARCH_TILES


@pytest.mark.parametrize("form", march_forms(), ids=lambda f: "_".join(
    map(str, f)))
def test_every_form_fits_a_block_and_its_chunks(form):
    """Shared memory of the rings (R = NP + D + 1 planes of u and of a, rhs)
    under the block's limit; rows that split into 16-byte chunks whose
    starts in the level are chunk-aligned (tile starts at a multiple of
    W - 2*NP, less NP)."""
    t, np_, w, d = form
    isz = 4 if t == "float" else 8
    ring = (np_ + d + 1) * (wave_plane(w) + 2 * w * w) * isz
    assert ring <= SMEM_PER_BLOCK
    chunk = 16 // isz
    assert w % chunk == 0 and (w - 2 * np_) % chunk == 0 and np_ % chunk == 0
    assert w * w // 2 <= 1024  # one thread per z-pair


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"isz{f[0]}_ns{f[1]}")
def test_written_tiles_cover_the_level(shape, form):
    isz, ns = form
    nx, ny, nz = shape
    tile, nseg, xseg = tfs.march_geometry(shape, ns, isz, H100_SMS)
    assert tile in tfs.MARCH_TILES[form]
    inner = tile - 4 * ns
    for n in (ny, nz):
        count = -(-n // inner)
        assert count * inner >= n > (count - 1) * inner
    # the segments cover x once, and none is shorter than 8*NP planes
    # unless the level is
    assert nseg == -(-nx // xseg) and (nseg - 1) * xseg < nx <= nseg * xseg
    assert xseg >= min(nx, 8 * 2 * ns)
    assert nseg <= 65535


@pytest.mark.parametrize("n, tile", [(144, 44), (96, 40), (256, 40),
                                     (64, 40), (512, 40), (72, 44)])
def test_tile_width_at_two_sweeps(n, tile):
    """144 = 4 x 36 takes the 44-wide tile (1.49 columns computed per
    written one against 1.93 with 40); 64, 96, 256, 512 the 40-wide one
    (32 written)."""
    assert tfs.march_tile(n, n, 2, 4) == tile


def test_tile_width_counts_both_axes():
    # 72 x 36: 2 x 1 tiles of 44 (3872 columns) against 3 x 2 of 40 (9600)
    assert tfs.march_tile(72, 36, 2, 4) == 44
    # 18 x 10: one tile either way, the smaller wins
    assert tfs.march_tile(18, 10, 2, 4) == 40
    # the forms with one width
    assert tfs.march_tile(144, 144, 4, 4) == 36
    assert tfs.march_tile(144, 144, 2, 8) == 32


def test_main_path_geometry_on_132_blocks():
    # 960x144x144: 16 tiles of 44 x 8 segments of 120 planes, one round
    assert tfs.march_geometry((960, 144, 144), 2, 4, H100_SMS) == (44, 8, 120)
    # 256^3: 64 tiles x 2 segments of 128
    assert tfs.march_geometry((256, 256, 256), 2, 4, H100_SMS) == (40, 2, 128)
    # 512x96x96: 9 tiles x 14 segments of 37
    assert tfs.march_geometry((512, 96, 96), 2, 4, H100_SMS) == (40, 14, 37)


@pytest.mark.parametrize("capacity", [1, 7, 66, 132, 264, 1000])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_capacity_drives_the_segments_as_the_header_does(shape, capacity):
    for (isz, ns) in FORMS:
        tile = tfs.march_tile(shape[1], shape[2], ns, isz)
        inner = tile - 4 * ns
        tiles = -(-shape[1] // inner) * -(-shape[2] // inner)
        want = header_march_segments(shape[0], tiles, capacity, 2 * ns)
        assert tfs.march_segments(shape[0], tiles, capacity, ns) == want
        assert tfs.march_geometry(shape, ns, isz, capacity)[1:] == want


def test_more_capacity_never_means_fewer_segments_on_a_long_level():
    segs = [tfs.march_segments(960, 16, cap, 2)[0]
            for cap in (16, 32, 64, 128, 256)]
    assert segs == sorted(segs)
    # a card with room for every tile once runs x in one segment per block
    assert tfs.march_segments(960, 16, 16, 2) == (1, 960)
    assert math.prod(tfs.march_segments(960, 16, 128, 2)) == 960
