"""Two-sided bounds geometry in the embed (round-3 item: mmdg smooths a
bounds MATRIX with distinct lo/hi, chromosome3D.pl:1471-1489; midpoint
completion alone can push a restrained pair below its lower bound)."""

import jax.numpy as jnp
import numpy as np
import pytest

from chromosome3d.ops.energy import DenseRestraints
from chromosome3d.solver.init import (
    mds_init,
    smooth_bounds,
    smooth_bounds_two_sided,
)

BOND = 3.8


def make_windowed(L, entries):
    """DenseRestraints from {(i, j): (lo, hi)} (symmetric)."""
    lo = np.zeros((L, L), np.float32)
    hi = np.zeros((L, L), np.float32)
    mask = np.zeros((L, L), np.float32)
    for (i, j), (a, b) in entries.items():
        for p, q in ((i, j), (j, i)):
            lo[p, q], hi[p, q], mask[p, q] = a, b, 1.0
    return DenseRestraints(
        lo=jnp.asarray(lo), hi=jnp.asarray(hi),
        mask=jnp.asarray(mask), weight=jnp.asarray(mask),
    )


def test_shortcut_cannot_undercut_lower_bound():
    """A short path through an intermediate must not push a restrained
    pair's embed target below its lower bound."""
    L = 10
    r = make_windowed(L, {
        (0, 9): (9.0, 12.0),   # wide window
        (0, 5): (3.0, 5.0),
        (5, 9): (3.0, 5.0),    # path 0-5-9 has upper 10, midpoint sum 8
    })
    d_mid = np.asarray(smooth_bounds(r, BOND))
    assert d_mid[0, 9] < 9.0  # the round-2 failure mode: below lo
    d_two = np.asarray(smooth_bounds_two_sided(r, BOND))
    assert d_two[0, 9] >= 9.0 - 1e-4
    assert d_two[0, 9] <= 12.0 + 1e-4


def test_lower_bound_propagates():
    """Inverse triangle: lo_ij >= lo_ik - up_kj must raise unrestrained
    pairs near a long restraint."""
    L = 10
    r = make_windowed(L, {
        (0, 9): (20.0, 22.0),
        (5, 9): (3.0, 4.0),
    })
    d_two = np.asarray(smooth_bounds_two_sided(r, BOND))
    # lo(0,5) >= lo(0,9) - up(5,9) = 20 - 4 = 16
    assert d_two[0, 5] >= 16.0 - 1e-4


def test_exact_restraints_unchanged():
    """With lo == hi everywhere the two-sided smoothing equals the
    single-matrix completion (the pipeline's own case)."""
    L = 12
    rng = np.random.RandomState(0)
    entries = {}
    for i in range(L):
        for j in range(i + 2, L):
            if rng.rand() < 0.5:
                d = float(rng.uniform(4, 20))
                entries[(i, j)] = (d, d)
    r = make_windowed(L, entries)
    d1 = np.asarray(smooth_bounds(r, BOND))
    d2 = np.asarray(smooth_bounds_two_sided(r, BOND))
    np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-5)


def test_mds_init_two_sided_flag():
    L = 10
    r = make_windowed(L, {
        (0, 9): (9.0, 12.0),
        (0, 5): (3.0, 5.0),
        (5, 9): (3.0, 5.0),
    })
    x_mid = np.asarray(mds_init(r, bond_length=BOND))
    x_two = np.asarray(mds_init(r, bond_length=BOND, two_sided=True))
    assert np.isfinite(x_two).all()
    d_mid = np.linalg.norm(x_mid[0] - x_mid[9])
    d_two = np.linalg.norm(x_two[0] - x_two[9])
    # the two-sided embed starts the restrained pair nearer its window
    assert d_two > d_mid


def test_landmark_targets_respect_lower_bounds():
    """Round-4 item: the landmark relaxation (the init the at-scale path
    ALWAYS uses) must give two-sided semantics too — no restrained landmark
    pair's embed target below its lower bound."""
    from chromosome3d.solver.init import landmark_init, landmark_targets

    # triangle gadgets (a,b)/(b,c)/(a,c) with lo(a,c) strictly between the
    # MIDPOINT path (what the one-sided relaxation walks — undercuts) and
    # the HI path (a valid upper bound — doesn't): consistent bounds, real
    # failure mode. Disjoint index ranges so gadgets can't shortcut each
    # other; chain-walk paths are far longer than every gadget distance.
    L = 40
    entries = {}
    for a, b, c in ((0, 6, 13), (14, 20, 26), (27, 32, 39)):
        entries[(a, b)] = (8.0, 12.0)    # mid 10, hi 12
        entries[(b, c)] = (8.0, 12.0)
        entries[(a, c)] = (21.0, 23.0)   # mid-path 20 < lo 21 < hi-path 24
    r = make_windowed(L, entries)

    d_mid, lidx = landmark_targets(r, BOND, k=L, n_iters=6)
    d_two, _ = landmark_targets(r, BOND, k=L, n_iters=6, two_sided=True)
    d_mid, d_two, lidx = map(np.asarray, (d_mid, d_two, lidx))
    lo = np.asarray(r.lo)
    mask = np.asarray(r.mask) > 0
    # with k = L every bead is a landmark: check every restrained pair
    violations_mid = violations_two = 0
    for a, l in enumerate(lidx):
        for j in range(L):
            if mask[l, j]:
                if d_mid[a, j] < lo[l, j] - 1e-4:
                    violations_mid += 1
                if d_two[a, j] < lo[l, j] - 1e-4:
                    violations_two += 1
    assert violations_mid > 0      # the gap being closed is real
    assert violations_two == 0     # and closed
    # exact restraints: two_sided is a no-op
    exact_entries = {k_: (v[0], v[0]) for k_, v in entries.items()}
    re_ = make_windowed(L, exact_entries)
    t1, _ = landmark_targets(re_, BOND, k=16)
    t2, _ = landmark_targets(re_, BOND, k=16, two_sided=True)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-5)
    # and the embedding is finite
    x = np.asarray(landmark_init(r, BOND, k=16, two_sided=True))
    assert np.isfinite(x).all()


def test_sharded_landmark_two_sided_matches_single():
    """The sharded two-sided landmark init (pmax-reduced inverse-triangle
    sweep) must reproduce the single-device solve on the CPU mesh."""
    import dataclasses

    import jax
    from jax.sharding import Mesh

    from chromosome3d.config import AnnealConfig, fast_anneal
    from chromosome3d.solver.anneal import solve_ensemble
    from chromosome3d.solver.sharded import solve_ensemble_sharded

    L = 16 * len(jax.devices())
    rng = np.random.RandomState(6)
    entries = {}
    for _ in range(L * 4):
        i, j = sorted(rng.choice(L, 2, replace=False))
        if j - i >= 2:
            d = float(rng.uniform(6, 30))
            entries[(i, j)] = (d - 1.5, d + 1.5)
    r = make_windowed(L, entries)
    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()),
        init="landmark", embed_two_sided=True, use_pallas=False,
    )
    key = jax.random.PRNGKey(9)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    rs = jax.jit(lambda d, k: solve_ensemble_sharded(mesh, d, cfg, k, 2))(r, key)
    rd = solve_ensemble(r, cfg, key, 2)
    np.testing.assert_allclose(
        np.asarray(rs.coords), np.asarray(rd.coords), rtol=1e-4, atol=1e-3
    )


def test_restraints_pipeline_auto_enables(tmp_path, monkeypatch):
    """run_restraints_pipeline on a tbl with real deviation windows must
    auto-enable embed_two_sided (and still solve)."""
    import chromosome3d.pipeline as pl

    L = 12
    lines = [
        f"assign (resid {i:3d} and name ca) (resid {i + 1:3d} and name ca)"
        f"  3.80 0.50 0.50"
        for i in range(1, L)
    ]
    lines.append(
        "assign (resid 1 and name ca) (resid 10 and name ca) 10.00 2.00 2.00"
    )
    tbl = tmp_path / "win.tbl"
    tbl.write_text("\n".join(lines) + "\n")

    seen = {}
    real = pl._aot_solve

    def spy(dense, anneal_cfg, key, n_models, bm, or_groups=None):
        seen["two_sided"] = anneal_cfg.embed_two_sided
        return real(dense, anneal_cfg, key, n_models, bm, or_groups=or_groups)

    monkeypatch.setattr(pl, "_aot_solve", spy)
    from chromosome3d.config import AnnealConfig, PipelineConfig, fast_anneal

    cfg = PipelineConfig(
        model_count=2, anneal=fast_anneal(AnnealConfig()),
        length_buckets=(16,),
    )
    summary = pl.run_restraints_pipeline(str(tbl), str(tmp_path / "out"), cfg)
    assert seen["two_sided"] is True
    assert summary["restraints"] == L  # L-1 chain + 1 long


def test_landmark_chain_only_does_not_explode():
    """Regression: a chain-only restraint graph (collinear landmark
    geometry) used to explode landmark_triangulate — 1/sqrt(lambda ~ 0)
    amplified degenerate eigendirections ~1000x. Degenerate dims must be
    dropped (matching classical MDS), leaving a sane line-like init."""
    from chromosome3d.solver.init import landmark_init

    L = 64
    entries = {(i, i + 1): (3.8, 3.8) for i in range(L - 1)}
    r = make_windowed(L, entries)
    x = np.asarray(landmark_init(r, BOND, k=32))
    assert np.isfinite(x).all()
    # span is chain-scale, not noise-amplified
    assert np.abs(x).max() < L * BOND
    # consecutive beads land near bond length on the dominant axis
    d = np.linalg.norm(np.diff(x, axis=0), axis=1)
    assert np.median(d) < 3.0 * BOND


def test_landmark_targets_row_blocked_bitwise_equal():
    """The row-blocked landmark relaxation (edge rows rebuilt per strip —
    no persistent (L, L) f32 edge matrix) must be BITWISE equal to the
    whole-matrix sweep at any block size: min/max relaxation is exact and
    order-independent, and each cand element is computed identically."""
    import numpy as np

    from chromosome3d.config import RestraintConfig
    from chromosome3d.ops.energy import (
        auto_weight_exponent,
        exact_restraints_from_numpy,
    )
    from chromosome3d.restraints import build_restraints
    import chromosome3d.solver.init as ini

    rng = np.random.RandomState(0)
    L = 200
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig())
    e = exact_restraints_from_numpy(r, "relative", auto_weight_exponent(L))
    for ts in (False, True):
        full, _ = ini.landmark_targets(e, k=32, two_sided=ts)
        orig = ini._pick_init_row_block
        try:
            # 40 divides L=200 (5 strips); 48 does NOT (5 strips, the last
            # clamped to start 152 and overlapping the fourth — idempotent
            # min/max must make the overlap invisible)
            for strip in (40, 48):
                ini._pick_init_row_block = lambda LL, cap=4096, s=strip: s
                blk, _ = ini.landmark_targets(e, k=32, two_sided=ts)
                np.testing.assert_array_equal(
                    np.asarray(blk), np.asarray(full)
                )
        finally:
            ini._pick_init_row_block = orig
