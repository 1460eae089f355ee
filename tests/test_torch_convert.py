"""convert.py: plain host data -> the port's structures, and back out
unchanged."""

import numpy as np
import pytest
import torch

from mg_ic_code_tpu_torch import convert as cv
from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import HierarchyGeom

torch.set_num_threads(1)

BC = dict(bc_lo=(0, 1, 0), bc_hi=(1, 0, 0), bc_value=0.25, periodic=False)


def test_geom_from_plain_roundtrip():
    boxes = [((0, 0, 0), (15, 15, 15)), ((8, 8, 8), (23, 23, 23))]
    doms = [((0, 0, 0), (15, 15, 15)), ((0, 0, 0), (31, 31, 31))]
    g = cv.geom_from_plain(boxes, (-1, 0), (1.0, 0.5), BC, doms,
                           (16.0, 16.0, 16.0))
    assert isinstance(g, HierarchyGeom)
    assert g.boxes == (Box((0, 0, 0), (15, 15, 15)),
                       Box((8, 8, 8), (23, 23, 23)))
    assert g.parent == (-1, 0) and g.dx == (1.0, 0.5) and g.ref_ratio == 2
    assert g.bc.bc_lo == (0, 1, 0) and g.bc.bc_value == 0.25
    assert not g.bc.periodic
    # numpy integers and Box objects are accepted; parent None = the chain
    g2 = cv.geom_from_plain(
        [Box(*boxes[0]), (np.array([8, 8, 8]), np.array([23, 23, 23]))],
        None, np.array([1.0, 0.5]), BC, doms, np.array([16.0] * 3))
    assert g2 == g and hash(g2) == hash(g)
    assert all(type(v) is int for v in g2.boxes[1].lo)


def test_geom_from_plain_validates():
    boxes = [((0, 0, 0), (15, 15, 15)), ((0, 0, 0), (40, 7, 7))]
    doms = [((0, 0, 0), (15, 15, 15)), ((0, 0, 0), (31, 31, 31))]
    with pytest.raises(ValueError, match="invalid hierarchy"):
        cv.geom_from_plain(boxes, (-1, 0), (1.0, 0.5), BC, doms, (16.0,) * 3)


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.float64])
def test_level_list_from_numpy(dtype):
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal((4, 3, 2)), None,
            np.asfortranarray(rng.standard_normal((3, 3, 3)))]
    arrs[0].setflags(write=False)  # exported arrays are often read-only
    out = cv.level_list_from_numpy(arrs, "cpu", dtype)
    assert out[1] is None
    for t, a in ((out[0], arrs[0]), (out[2], arrs[2])):
        assert t.dtype == (dtype or torch.float64)
        assert t.is_contiguous() and t.device.type == "cpu"
        np.testing.assert_allclose(t.numpy(), a.astype(t.numpy().dtype))
    out[0][0, 0, 0] = 5.0  # a copy: writing does not touch the source
    assert arrs[0][0, 0, 0] != 5.0


def test_fields_and_coefs_from_numpy():
    rng = np.random.default_rng(1)
    sh = (4, 4, 4)
    fields = [{
        "phi": rng.standard_normal(sh), "rho_grad": rng.standard_normal(sh),
        "aij2": rng.standard_normal(sh), "psi_bh": rng.standard_normal(sh),
        "aij": {(0, 0): rng.standard_normal(sh),
                (1, 2): rng.standard_normal(sh)},
    }]
    (tf,) = cv.fields_from_numpy(fields, "cpu")
    assert set(tf) == set(fields[0]) and set(tf["aij"]) == {(0, 0), (1, 2)}
    np.testing.assert_array_equal(tf["aij"][(1, 2)].numpy(),
                                  fields[0]["aij"][(1, 2)])
    a64 = [rng.standard_normal(sh), rng.standard_normal((2, 2, 2))]
    coefs = ({
        "a": a64, "b": [None, None], "lam": a64,
        "binv": rng.standard_normal((8, 8)),
        "lp": {"a": [x.astype(np.float32) for x in a64], "b": [None, None],
               "lam": [x.astype(np.float32) for x in a64],
               "binv": rng.standard_normal((8, 8)).astype(np.float32)},
    }, {"a": a64[:1], "b": [rng.standard_normal(sh)], "lam": a64[:1]})
    out = cv.coefs_from_numpy(coefs, "cpu")
    assert isinstance(out, tuple) and len(out) == 2
    assert isinstance(out[0]["a"], tuple) and out[0]["b"] == (None, None)
    assert out[0]["a"][1].dtype == torch.float64
    assert out[0]["lp"]["a"][0].dtype == torch.float32
    assert out[0]["lp"]["binv"].dtype == torch.float32
    assert "binv" not in out[1] and "lp" not in out[1]
    np.testing.assert_array_equal(out[1]["b"][0].numpy(), coefs[1]["b"][0])


def test_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cv.level_list_from_numpy([np.zeros((2, 2, 2))])
