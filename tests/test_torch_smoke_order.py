"""chip_smoke.py's redesign order weighs every launch at the shape it runs
at: a whole picture of its own size and chroma format, a lane's shard, or
the inter encode's preselection call.  The chip run cannot be repeated
here, so the rule is held on hand-filled timed cases."""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def CS():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HD, SMALL, D = "picture 1920x1080 420", "picture 208x120 420", "picture 416x240 420"


def checker(CS):
    """A KernelCheck whose timed cases are filled by hand: per shape, (summed
    device ms, bytes, operations, launches) of its cases."""
    chk = CS.KernelCheck(torch)
    chk.rows["vtm_rmd_angular"]["shapes"] = {
        HD: [7.4, 0, 17 * 1e9, 17],  # 17 launches timed, int32 operations
        SMALL: [0.34, 0, 17 * 1e7, 17]}
    chk.rows["vtm_mc_tiles"]["shapes"] = {
        CS.ENCODE: [4.6, int(3.35e9 * 0.027e-3 * 1000), 0.0, 1000],
        "shard": [0.2, int(3.35e9 * 0.01), 0.0, 4]}
    return chk


def per_launch(chk, name, shape):
    ms, nb, ops, n = chk.rows[name]["shapes"][shape]
    bound = max(nb / 3.35e12, ops / chk.rows[name]["peak"]) * 1e3
    return ms / n, bound / n


def test_size_keys(CS):
    y, c = np.zeros((120, 208)), np.zeros((60, 104))
    assert CS.planes_key([y, c, c]) == SMALL
    assert CS.planes_key([y, np.zeros((120, 104))] * 2) == "picture 208x120 422"
    assert CS.planes_key([y, y, y]) == "picture 208x120 444"
    assert CS.planes_key([y]) == "picture 208x120 400"
    assert CS.size_key(1920, 1080, "420") == HD


def test_each_size_weighed_at_its_own_cases(CS):
    chk = checker(CS)
    order = CS.redesign_order(chk, {"vtm_rmd_angular": {HD: 34, SMALL: 85},
                                    "vtm_mc_tiles": {CS.ENCODE: 12252, "shard": 21}})
    got = {name: (gap, parts) for gap, name, parts in order}
    hd, small = per_launch(chk, "vtm_rmd_angular", HD), per_launch(chk, "vtm_rmd_angular", SMALL)
    want = 34 * (hd[0] - hd[1]) + 85 * (small[0] - small[1])
    assert got["vtm_rmd_angular"][0] == pytest.approx(want)
    # the small pictures' launches are not charged at the 1080p cases
    assert got["vtm_rmd_angular"][0] < 119 * (hd[0] - hd[1]) / 2
    parts = got["vtm_rmd_angular"][1]
    assert len(parts) == 2
    assert any(p.startswith(f"34 x ({hd[0]:.6f} - {hd[1]:.6f}) ms at {HD}") for p in parts)
    assert any(p.startswith(f"85 x ({small[0]:.6f} - {small[1]:.6f}) ms at {SMALL}")
               for p in parts)
    assert [name for _, name, _ in order] == ["vtm_mc_tiles", "vtm_rmd_angular"]


def test_encode_and_shard_shapes_unchanged(CS):
    assert CS.ENCODE == "encode"
    chk = checker(CS)
    (gap, name, parts), = CS.redesign_order(chk, {"vtm_mc_tiles": {CS.ENCODE: 10, "shard": 3}})
    enc, shard = per_launch(chk, "vtm_mc_tiles", "encode"), per_launch(chk, "vtm_mc_tiles", "shard")
    assert gap == pytest.approx(10 * (enc[0] - enc[1]) + 3 * (shard[0] - shard[1]))
    assert [p.rsplit(" at ", 1)[1] for p in parts] == ["encode", "shard"]


def test_launch_at_a_size_with_no_timed_case_fails(CS):
    chk = checker(CS)
    with pytest.raises(AssertionError, match="416x240"):
        CS.redesign_order(chk, {"vtm_rmd_angular": {HD: 17, D: 17}})
    # no launch there: no case needed
    CS.redesign_order(chk, {"vtm_rmd_angular": {HD: 17, D: 0}})


def test_every_launch_of_a_phase_has_a_shape(CS):
    by = {}
    CS.attribute(by, SMALL, {"vtm_mc_tiles": 2, "vtm_alf_filter": 3})
    CS.attribute_encode(by, SMALL, {"vtm_mc_tiles": 40, "vtm_rmd_angular": 17},
                        {"vtm_mc_tiles": 1, "vtm_alf_filter": 0})
    assert by == {SMALL: {"vtm_mc_tiles": 3, "vtm_alf_filter": 3, "vtm_rmd_angular": 17},
                  "encode": {"vtm_mc_tiles": 40}}
    CS.check_attributed(by, {"vtm_mc_tiles": 43, "vtm_alf_filter": 3,
                             "vtm_rmd_angular": 17}, "phase")
    with pytest.raises(AssertionError, match="phase"):
        CS.check_attributed(by, {"vtm_mc_tiles": 44, "vtm_alf_filter": 3,
                                 "vtm_rmd_angular": 17}, "phase")


def test_covering_pictures(CS, monkeypatch):
    """Pictures are picked until they run every stage any picture runs."""
    flags = {0: (1,) + (1,) * 6 + (0,) * 8,  # deblocking only
             1: (0,) * 7 + (1, 0, 0, 1, 0, 0, 0, 0),  # luma SAO and ALF
             2: (1,) * 7 + (0,) * 3 + (1, 1, 1, 0, 0)}  # deblocking, ALF
    monkeypatch.setattr(CS, "chain_flags", lambda pic: flags[pic])
    assert CS.covering_pictures([0, 1, 2]) == [2, 1]
    assert CS.covering_pictures([0]) == [0]
