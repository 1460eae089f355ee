"""The march's launch geometry on the CPU: which tile width
(`fused_sweeps.march_tile`) and which x segments (`march_segments`, the one
rule of both bodies) a whole level or one shard of a sharded level gets
(`march_geometry`; a shard's through `shard_geometry_on`), and that the
Python table of tiles agrees with the forms the CUDA sources build
(csrc/multisweep.cu, MARCH_FORMS; csrc/multisweep_halo.cu, SHARD_FORMS). No
device is needed: the geometry is plain Python handed to the kernels' C
entries."""

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


def march_forms(source="multisweep.cu", macro="MARCH_FORMS"):
    """(type, NP, W, D) of every line of a source's forms macro."""
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    block = re.search(r"#define " + macro + r"\(X\)((?:.*\\\n)*.*\n)",
                      src)
    return [(t, int(a), int(b), int(d)) for t, a, b, d in
            re.findall(r"X\((float|double), (\d+), (\d+), (\d+)\)",
                       block.group(1))]


def shard_forms():
    return march_forms("multisweep_halo.cu", "SHARD_FORMS")


def brute_force_segments(nx, tiles, capacity, NP):
    """The segment rule stated plainly: every segment length L from 1 to
    nx, its ceil(nx / L) segments (all L long but the last), allowed when
    there is one segment or no more than nx // (8*NP) of them; the cost of a
    split is its rounds of `capacity` blocks times the steps of a block, L
    + 3*NP. Returns the least cost and every (segments, L) that has it."""
    costs = {}
    for length in range(1, nx + 1):
        segs = -(-nx // length)
        if segs > 1 and segs > nx // (8 * NP):
            continue
        costs[(segs, length)] = -(-tiles * segs // capacity) * (length
                                                                + 3 * NP)
    best = min(costs.values())
    return best, {k for k, v in costs.items() if v == best}


def wave_plane(W):
    """WaveLayout<W, W>::PLANE of csrc/multisweep_march.cuh."""
    hz = W // 2
    hp = hz + 2
    pz = 2 * hp + ((hz - 2 * hp) % 32 + 32) % 32
    return (W + 2) * pz


@pytest.mark.parametrize("forms", [march_forms, shard_forms],
                         ids=["whole_level", "shard"])
def test_python_tiles_are_the_forms_the_source_builds(forms):
    """Both bodies build MARCH_TILES' widths: a shard's tile is chosen by
    the whole level's rule."""
    built = {}
    for t, np_, w, _ in forms():
        built.setdefault((4 if t == "float" else 8, np_ // 2), []).append(w)
    assert {k: tuple(v) for k, v in built.items()} == tfs.MARCH_TILES


def test_one_segment_rule_in_the_sources():
    """The x segments are cut in Python only: no CUDA source or header
    defines a rule of its own (a function of that name)."""
    for name in os.listdir(CSRC):
        with open(os.path.join(CSRC, name)) as f:
            assert not re.search(r"\w+\s+march_segments\s*\(", f.read()), \
                name


@pytest.mark.parametrize("form", march_forms() + shard_forms(),
                         ids=lambda f: "_".join(map(str, f)))
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
    """The segments `march_segments` cuts for a capacity are a split of
    least cost under the rule stated by brute force (the C copy of the rule
    in csrc/multisweep_march.cuh is gone; the name stays), and
    `march_geometry` hands them on."""
    nx = shape[0]
    for (isz, ns) in FORMS:
        tile = tfs.march_tile(shape[1], shape[2], ns, isz)
        inner = tile - 4 * ns
        tiles = -(-shape[1] // inner) * -(-shape[2] // inner)
        nseg, xseg = tfs.march_segments(nx, tiles, capacity, ns)
        best, splits = brute_force_segments(nx, tiles, capacity, 2 * ns)
        assert (nseg, xseg) in splits
        assert (nseg - 1) * xseg < nx <= nseg * xseg
        assert nseg == 1 or nseg <= nx // (8 * 2 * ns)
        assert tfs.march_geometry(shape, ns, isz, capacity)[1:] == (nseg,
                                                                    xseg)


def test_more_capacity_never_means_fewer_segments_on_a_long_level():
    segs = [tfs.march_segments(960, 16, cap, 2)[0]
            for cap in (16, 32, 64, 128, 256)]
    assert segs == sorted(segs)
    # a card with room for every tile once runs x in one segment per block
    assert tfs.march_segments(960, 16, 16, 2) == (1, 960)
    assert math.prod(tfs.march_segments(960, 16, 128, 2)) == 960


# the shards the sharded paths hand the shard march (written extent; a
# pencil without its pads): the periodic box on 4 x-slabs and on (2, 2)
# pencils, the 7-level finest level's and 64^3 base's slabs, and the odd
# shapes of chip_smoke.SHARD_CASES (odd offsets, misaligned nz, several x
# segments, one shard)
SHARD_SHAPES = [(64, 256, 256, False), (240, 144, 144, False),
                (128, 128, 256, True), (16, 64, 64, False),
                (21, 40, 36, False), (24, 56, 48, False), (21, 23, 36, True),
                (16, 40, 37, False), (24, 22, 37, True), (132, 40, 36, False),
                (48, 40, 36, False)]


@pytest.mark.parametrize("shard", SHARD_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3]))
                         + ("_pre" if s[3] else "_slab"))
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"isz{f[0]}_ns{f[1]}")
def test_shard_tiles_cover_the_shard(shard, form):
    """The written tiles cover the shard's written y-z extent once, and
    their computed columns (a rind of NP = 2*nsweeps on every side) cover
    a pencil's y pads (H = NP rows a side); the segments cover x."""
    isz, ns = form
    nx, ny, nz, pre = shard
    tile, nseg, xseg = tfs.march_geometry((nx, ny, nz), ns, isz, H100_SMS)
    assert tile in tfs.MARCH_TILES[form]
    np_ = 2 * ns
    inner = tile - 2 * np_
    for n in (ny, nz):
        count = -(-n // inner)
        assert count * inner >= n > (count - 1) * inner
        # tile b computes [b*inner - NP, b*inner + inner + NP)
        covered = set()
        for b in range(count):
            covered.update(range(b * inner - np_, b * inner + inner + np_))
        assert set(range(-np_ if pre else 0, n + (np_ if pre else 0))) \
            <= covered
    assert nseg == -(-nx // xseg) and (nseg - 1) * xseg < nx <= nseg * xseg
    assert nseg <= 65535


def test_shard_geometry_on_the_main_shards():
    # 64x256x256 P slab: 64 tiles of 40 x 2 segments of 32, one round
    assert tfs.march_geometry((64, 256, 256), 2, 4, H100_SMS) == (40, 2, 32)
    # 240x144x144: 16 tiles of 44 x 7 segments of 35
    assert tfs.march_geometry((240, 144, 144), 2, 4, H100_SMS) == (44, 7, 35)
    # 128x128x256 P pencil: 32 tiles of 40 x 4 segments of 32
    assert tfs.march_geometry((128, 128, 256), 2, 4, H100_SMS) == (40, 4, 32)
    # 16x64x64: 4 tiles of 40, one segment (16 < 8*NP)
    assert tfs.march_geometry((16, 64, 64), 2, 4, H100_SMS) == (40, 1, 16)


@pytest.mark.parametrize("pre", [False, True], ids=["slab", "pre"])
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"isz{f[0]}_ns{f[1]}")
def test_shard_geometry_on_is_the_level_rule_at_the_shard_capacity(
        monkeypatch, form, pre):
    """`shard_geometry_on` asks the shard body's capacity for the whole
    level's tile of the shard, then cuts the whole level's segments for it
    (the capacity query stands in for the card)."""
    isz, ns = form
    asked = []

    def capacity(device, itemsize, nsweeps, tile, pre_form, compute):
        asked.append((device.index, itemsize, nsweeps, tile, pre_form,
                      compute))
        return 66

    monkeypatch.setattr(tfs, "shard_capacity", capacity)
    shape = (240, 144, 144)
    got = tfs.shard_geometry_on.__wrapped__(shape, ns, isz, 3, pre)
    assert got == tfs.march_geometry(shape, ns, isz, 66)
    assert asked == [(3, isz, ns, tfs.march_tile(144, 144, ns, isz), pre,
                      0)]


@pytest.mark.parametrize("pre", [False, True], ids=["slab", "pre"])
@pytest.mark.parametrize("ns", [2, 4])
def test_shard_geometry_on_asks_the_tier_forms_capacity(monkeypatch, ns,
                                                        pre):
    """In the bf16 tier (compute 1) the shard geometry is cut for the
    capacity of the tier's own form (its kernel's registers may differ),
    with the f32 form's tile; the whole level's likewise
    (march_geometry_on through march_capacity)."""
    asked = []

    def capacity(*args):
        asked.append(args[1:])
        return 33

    monkeypatch.setattr(tfs, "shard_capacity", capacity)
    monkeypatch.setattr(tfs, "march_capacity", capacity)
    shape = (240, 144, 144)
    tile = tfs.march_tile(144, 144, ns, 4)
    got = tfs.shard_geometry_on.__wrapped__(shape, ns, 4, 3, pre, 1)
    assert got == tfs.march_geometry(shape, ns, 4, 33)
    got = tfs._geometry_on.__wrapped__(shape, ns, 4, 3, 1)
    assert got == tfs.march_geometry(shape, ns, 4, 33)
    assert asked == [(4, ns, tile, pre, 1), (4, ns, tile, 1)]


def test_build_line_names_every_tier_form():
    """chip_smoke.py's build line reports registers and spill stores of the
    bf16 tier's forms of both march units (tier_forms): it reads each
    instantiation the sources build from its mangled name, keeps the tier's
    (C = __nv_bfloat16) and leaves the f32 / f64 ones out."""
    import chip_smoke
    regs, spills, want = {}, {}, {}
    for t, np_, w, d in march_forms():
        for v in (0, 1):
            for c in ("f", "d", "13__nv_bfloat16"):
                if (t == "double") != (c == "d"):
                    continue
                name = (f"_ZN46_GLOBAL__N__0_13_multisweep_cu_012march_"
                        f"kernelI{t[0]}Li{np_}ELi{w}ELi{d}ELb{v}E{c}EEvPKT_"
                        f"S4_S4_PS2_11LevelParamsIS2_Eii")
                regs[name], spills[name] = 64 + v, 4 * v
                if c != "d" and c != "f":
                    want[f"whole NP{np_} W{w} V{v}"] = {
                        "D": d, "registers": 64 + v, "spill_stores": 4 * v}
    for t, np_, w, d in shard_forms():
        for v in (0, 1):
            for src, where in ((1, "slab"), (2, "pre")):
                for c in ("f", "d", "13__nv_bfloat16"):
                    if (t == "double") != (c == "d"):
                        continue
                    name = (f"_ZN51_GLOBAL__N__0_18_multisweep_halo_cu_018"
                            f"shard_march_kernelI{t[0]}Li{np_}ELi{w}ELi{d}"
                            f"ELb{v}ELi{src}E{c}EEvPKT_S4_S4_S4_S4_S4_PS2_"
                            f"NS_9ShardGeomE11LevelParamsIS2_Eii")
                    regs[name], spills[name] = 72, src
                    if c.endswith("bfloat16"):
                        want[f"{where} NP{np_} W{w} V{v}"] = {
                            "D": d, "registers": 72, "spill_stores": src}
    got = chip_smoke.tier_forms(regs, spills)
    assert got == want
    # every float form of both units, with and without 16-byte chunks
    floats = [f for f in march_forms() if f[0] == "float"]
    assert len(got) == 2 * len(floats) * 3
