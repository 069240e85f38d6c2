"""Unit tests for analysis-script helpers (scripts/)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


def test_boundary_distance_stats():
    from golden_diff import boundary_distance_stats

    status = np.zeros((16, 16), np.int32)
    status[:, 8:] = 2  # boundary pixels: cols 7 and 8
    mism = np.zeros((16, 16), bool)
    mism[4, 7] = True  # on the boundary
    assert boundary_distance_stats(status, mism) == (0, 1.0)
    mism[4, 11] = True  # Chebyshev distance 3 from col 8
    md, f2 = boundary_distance_stats(status, mism)
    assert md == 3 and f2 == 0.5
    # no mismatches -> trivial pass
    assert boundary_distance_stats(status, np.zeros_like(mism)) == (0, 1.0)
    # mismatch in a uniform-status field -> flagged at the cap
    md, f2 = boundary_distance_stats(np.zeros((8, 8), np.int32), mism[:8, :8])
    assert md == 64 and f2 == 0.0


def test_golden_diff_explained_criterion():
    """Round-4 localization criterion: a large mismatch is explained by a
    status FLIP (oracle != kernel at the pixel) or by <= 2 px proximity to
    the UNION of the two programs' status boundaries."""
    from golden_diff import (
        _within2_mask,
        boundary_distance_stats_mask,
        status_boundary_mask,
    )

    st_k = np.zeros((16, 16), np.int32)
    st_k[:, 8:] = 2
    st_o = st_k.copy()
    st_o[4:7, 2:5] = 2  # a blob that flipped status between the programs
    union = status_boundary_mask(st_k) | status_boundary_mask(st_o)
    large = np.zeros((16, 16), bool)
    large[5, 3] = True  # blob interior: far from the KERNEL boundary...
    mdk, _ = boundary_distance_stats_mask(status_boundary_mask(st_k), large)
    assert mdk == 4
    # ...but a flip pixel, hence explained
    flips = st_o != st_k
    explained = ~large | flips | _within2_mask(union)
    assert explained.all()
    # an interior large mismatch with NO flip and no nearby boundary in
    # either program stays unexplained (a true numerics bug)
    large2 = np.zeros((16, 16), bool)
    large2[12, 13] = True
    explained2 = ~large2 | flips | _within2_mask(union)
    assert not explained2.all()
    # _within2_mask is a 2-step Chebyshev dilation
    b = np.zeros((9, 9), bool)
    b[4, 4] = True
    w = _within2_mask(b)
    assert w[2, 2] and w[6, 6] and not w[1, 4] and not w[4, 7]


def test_bench_suite_listing_and_compare(tmp_path, capsys):
    import bench_compare
    import bench_suite

    # every suite row must set only env knobs bench.py documents
    documented = {
        "BHR_BENCH_W", "BHR_BENCH_H", "BHR_BENCH_STEPS", "BHR_BENCH_FRAMES",
        "BHR_BENCH_REPEATS", "BHR_BENCH_TEXTURE", "BHR_BENCH_TEXSUB",
        "BHR_BENCH_MULTIRES", "BHR_BENCH_MODEL", "BHR_BENCH_DISK",
        "BHR_BENCH_INTEGRATOR", "BHR_BENCH_ADAPTIVE", "BHR_BENCH_SPIN",
        "BHR_BENCH_ORACLE", "BHR_BENCH_NEURAL_WEIGHTS",
        "BHR_BENCH_NEURAL_PRECISION", "BHR_BENCH_PLUGIN",
    }
    bench_doc = open(os.path.join(os.path.dirname(__file__), "..", "bench.py")).read()
    for knob in documented - {"BHR_BENCH_REPEATS", "BHR_BENCH_FRAMES"}:
        stem = knob.replace("BHR_BENCH_", "")
        assert stem.split("_")[0] in bench_doc, knob
    names = set()
    for name, overrides, _quick in bench_suite.SUITE:
        assert name not in names, f"duplicate suite row {name}"
        names.add(name)
        assert set(overrides) <= documented
    assert bench_suite.main(["--list"]) == 0
    capsys.readouterr()

    def suite_json(values):
        return {
            "rows": [
                {"name": n, "env": {}, "result": {"value": v}}
                for n, v in values.items()
            ]
        }

    import json

    old_p, new_p = str(tmp_path / "old.json"), str(tmp_path / "new.json")
    json.dump(suite_json({"a": 10.0, "b": 20.0, "gone": 5.0}), open(old_p, "w"))
    json.dump(suite_json({"a": 10.5, "b": 20.0, "new": 7.0}), open(new_p, "w"))
    assert bench_compare.main([old_p, new_p]) == 0  # +5% under threshold
    out = capsys.readouterr().out
    assert "only in old: gone" in out and "only in new: new" in out
    json.dump(suite_json({"a": 13.0}), open(new_p, "w"))
    assert bench_compare.main([old_p, new_p]) == 1  # +30% regression
    assert "REGRESSED" in capsys.readouterr().out

    # a zero/garbage old value must not abort the comparison (advisor r3)
    json.dump(suite_json({"a": 0.0, "b": 20.0}), open(old_p, "w"))
    json.dump(suite_json({"a": 13.0, "b": 20.0}), open(new_p, "w"))
    assert bench_compare.main([old_p, new_p]) == 0
    assert "incomparable" in capsys.readouterr().out


def test_bench_suite_env_hygiene(monkeypatch):
    """Inherited BHR_* shell knobs must not leak into row subprocess envs
    (a stray BHR_BENCH_ORACLE=1 would silently change every row)."""
    import bench_suite

    monkeypatch.setenv("BHR_BENCH_ORACLE", "1")
    monkeypatch.setenv("BHR_TEX_SCRAMBLE", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/keep/this")
    monkeypatch.setenv("PATH_UNRELATED", "keepme")
    env, dropped = bench_suite._clean_env({"BHR_BENCH_W": "64"})
    assert "BHR_BENCH_ORACLE" not in env
    assert "BHR_TEX_SCRAMBLE" not in env
    assert env["BHR_BENCH_W"] == "64"
    assert env["PATH_UNRELATED"] == "keepme"
    assert env["JAX_COMPILATION_CACHE_DIR"] == "/keep/this"
    assert set(dropped) == {"BHR_BENCH_ORACLE", "BHR_TEX_SCRAMBLE"}


def test_ssim_identity_and_sensitivity():
    from multires_diff import ssim

    rng = np.random.RandomState(0)
    a = rng.rand(64, 64) * 255.0
    assert ssim(a, a) > 0.9999
    assert ssim(a, np.roll(a, 3, axis=0)) < 0.9
