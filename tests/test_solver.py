"""Solver tests: MDS init quality, annealer end-to-end on shipped inputs
(beating the published models' Spearman), determinism, enantomer handling."""

import os

import jax
import numpy as np
import pytest

from chromosome3d.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d.metrics import spearman_if_inv_d
from chromosome3d.ops.energy import dense_restraints_from_numpy
from chromosome3d.restraints import build_restraints
from chromosome3d.solver.anneal import build_schedule, solve_ensemble
from chromosome3d.solver.init import mds_init, random_init, smooth_bounds, spiral_init

REF = "/root/reference"


def test_schedule_shape_and_ramps():
    cfg = AnnealConfig()
    s = build_schedule(cfg)
    T = cfg.total_steps
    assert s.lr.shape == (T,) and s.sigma.shape == (T,)
    # hot phase: full noise; final phase: zero noise
    assert float(s.sigma[0]) == pytest.approx(cfg.noise_scale, rel=1e-5)
    assert float(s.sigma[-1]) == 0.0
    # vdw ramps up to the final weight; repel shrinks to 0.85
    cool_end = cfg.hot_steps + cfg.cool_steps - 1
    assert float(s.vdw_weight[cool_end]) == pytest.approx(cfg.vdw_weight_final, rel=1e-3)
    assert float(s.repel_scale[cool_end]) == pytest.approx(cfg.repel_end, rel=1e-5)
    assert float(s.lr[-1]) == pytest.approx(0.0, abs=1e-6)


def test_smooth_bounds_shortest_path(tiny_matrix):
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    w = np.asarray(smooth_bounds(dense, bond_length=3.8))
    L = w.shape[0]
    # symmetric, zero diagonal, triangle inequality holds
    np.testing.assert_allclose(w, w.T, atol=1e-3)
    np.testing.assert_allclose(np.diag(w), 0.0, atol=1e-6)
    # chain bound: no pair farther than |i-j| * bond_length
    idx = np.arange(L)
    chain = np.abs(idx[:, None] - idx[None, :]) * 3.8
    assert (w <= chain + 1e-3).all()


def test_mds_init_embeds_exact_distances():
    """A chain with all-pairs exact Euclidean restraints embeds exactly."""
    rng = np.random.RandomState(0)
    pts = rng.randn(12, 3) * 5
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    from chromosome3d.ops.energy import DenseRestraints
    import jax.numpy as jnp

    mask = 1.0 - np.eye(12)
    dense = DenseRestraints(
        lo=jnp.asarray(d, jnp.float32),
        hi=jnp.asarray(d, jnp.float32),
        mask=jnp.asarray(mask, jnp.float32),
        weight=jnp.asarray(mask, jnp.float32),
    )
    x = np.asarray(mds_init(dense, bond_length=100.0))  # bond bound inactive
    got = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    np.testing.assert_allclose(got, d, atol=0.05)


def test_inits_shapes():
    key = jax.random.PRNGKey(0)
    assert random_init(key, 20).shape == (20, 3)
    sp = spiral_init(20)
    assert sp.shape == (20, 3)
    steps = np.linalg.norm(np.diff(np.asarray(sp), axis=0), axis=1)
    np.testing.assert_allclose(steps, steps[0], rtol=1e-4)  # uniform spacing


def test_solver_deterministic(tiny_matrix):
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    cfg = fast_anneal(AnnealConfig())
    a = solve_ensemble(dense, cfg, jax.random.PRNGKey(5), 2)
    b = solve_ensemble(dense, cfg, jax.random.PRNGKey(5), 2)
    np.testing.assert_allclose(np.asarray(a.coords), np.asarray(b.coords))
    c = solve_ensemble(dense, cfg, jax.random.PRNGKey(6), 2)
    assert np.abs(np.asarray(a.coords) - np.asarray(c.coords)).max() > 1e-3


def test_solver_centers_models(tiny_matrix):
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    cfg = fast_anneal(AnnealConfig())
    res = solve_ensemble(dense, cfg, jax.random.PRNGKey(0), 2)
    centroids = np.asarray(res.coords).mean(axis=1)
    np.testing.assert_allclose(centroids, 0.0, atol=1e-3)


def test_energy_decreases_over_anneal(tiny_matrix):
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    cfg = fast_anneal(AnnealConfig())
    res = solve_ensemble(dense, cfg, jax.random.PRNGKey(0), 1)
    h = np.asarray(res.history[0])
    assert h[-1] < h[0]
    # final-min phase ends lower than the hot phase's end
    assert h[-1] <= h[cfg.hot_steps] * 1.01


@pytest.mark.slow
def test_beats_reference_chr21_1mb(chr21_1mb_matrix):
    """End-to-end quality: our best model must beat the published
    chr21_1mb model's Spearman(IF, 1/d) (BASELINE.md north star)."""
    from chromosome3d.io.pdb import read_ca_pdb

    path = os.path.join(REF, "output_models", "chr21_1mb_rank07_a11.pdb")
    if not os.path.exists(path):
        pytest.skip("reference not available")
    ref_score = spearman_if_inv_d(chr21_1mb_matrix, read_ca_pdb(path))

    r = build_restraints(chr21_1mb_matrix, RestraintConfig(alpha=1.1))
    dense = dense_restraints_from_numpy(r)
    res = solve_ensemble(dense, AnnealConfig(), jax.random.PRNGKey(82364), 4)
    ours = max(
        spearman_if_inv_d(chr21_1mb_matrix, c) for c in np.asarray(res.coords)
    )
    assert ours > ref_score, f"ours {ours:.4f} <= reference {ref_score:.4f}"
    assert ours > 0.9


def test_absolute_weighting_mode(tiny_matrix):
    """The CNS-parity configuration (absolute weights + soft-square tail)
    must still solve sanely — it is a documented option (PARITY.md)."""
    r = build_restraints(tiny_matrix, RestraintConfig(weighting="absolute"))
    dense = dense_restraints_from_numpy(r, "absolute")
    cfg = fast_anneal(AnnealConfig(noe_rswitch=1.0))
    res = solve_ensemble(dense, cfg, jax.random.PRNGKey(0), 2)
    coords = np.asarray(res.coords)
    assert np.isfinite(coords).all()
    h = np.asarray(res.history[0])
    assert h[-1] < h[0]


def test_runtime_schedule_override(tiny_matrix):
    """The schedule is a runtime input: same cfg + different table must
    change the result without recompilation (sweep support)."""
    import jax.numpy as jnp

    from chromosome3d.solver.anneal import Schedule

    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    cfg = fast_anneal(AnnealConfig())
    base = build_schedule(cfg)
    hot = Schedule(
        lr=base.lr * 3.0, sigma=base.sigma, vdw_weight=base.vdw_weight,
        repel_scale=base.repel_scale,
    )
    a = solve_ensemble(dense, cfg, jax.random.PRNGKey(1), 2, None, None, base)
    b = solve_ensemble(dense, cfg, jax.random.PRNGKey(1), 2, None, None, hot)
    assert np.abs(np.asarray(a.coords) - np.asarray(b.coords)).max() > 1e-3


def test_gradient_clip_per_bead():
    """AnnealConfig.gradient_clip bounds each bead's raw-gradient norm."""
    from chromosome3d.solver.anneal import _clip_per_bead

    rng = np.random.RandomState(3)
    g = jax.numpy.asarray(rng.normal(0, 50.0, size=(4, 16, 3)), jax.numpy.float32)
    clipped = np.asarray(_clip_per_bead(g, 1.5))
    norms = np.linalg.norm(clipped, axis=-1)
    assert (norms <= 1.5 + 1e-4).all()
    # direction preserved
    small = np.linalg.norm(np.asarray(g), axis=-1) < 1.4
    np.testing.assert_allclose(clipped[small], np.asarray(g)[small], rtol=1e-5)
    # None is the identity
    assert _clip_per_bead(g, None) is g


def test_gradient_clip_changes_solve(tiny_matrix):
    """The knob must be live: a tight clip alters the trajectory."""
    import dataclasses

    rc = RestraintConfig()
    dense = dense_restraints_from_numpy(build_restraints(tiny_matrix, rc), rc.weighting)
    base = fast_anneal(AnnealConfig(), 0.1)
    key = jax.random.PRNGKey(0)
    r_off = solve_ensemble(dense, base, key, 2)
    r_on = solve_ensemble(dense, dataclasses.replace(base, gradient_clip=0.01), key, 2)
    assert np.isfinite(np.asarray(r_on.coords)).all()
    assert not np.allclose(np.asarray(r_off.coords), np.asarray(r_on.coords))


def test_mds_unknown_fill_modes(tiny_matrix):
    """mds_unknown_fill selects the bounds-completion mode (and is live)."""
    import dataclasses

    rc = RestraintConfig()
    dense = dense_restraints_from_numpy(build_restraints(tiny_matrix, rc), rc.weighting)
    sp = np.asarray(smooth_bounds(dense, 3.8, unknown_fill="shortest_path"))
    mt = np.asarray(smooth_bounds(dense, 3.8, unknown_fill="max_target"))
    assert np.isfinite(sp).all() and np.isfinite(mt).all()
    # max_target leaves unrestrained pairs at the max target, shortest_path
    # tightens them below it
    assert mt.max() >= sp.max()
    assert not np.allclose(sp, mt)
    with pytest.raises(ValueError, match="mds_unknown_fill"):
        smooth_bounds(dense, 3.8, unknown_fill="bogus")

    x_sp = np.asarray(mds_init(dense, unknown_fill="shortest_path"))
    x_mt = np.asarray(mds_init(dense, unknown_fill="max_target"))
    assert np.isfinite(x_mt).all()
    assert not np.allclose(x_sp, x_mt)

    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1),
                              mds_unknown_fill="max_target")
    res = solve_ensemble(dense, cfg, jax.random.PRNGKey(0), 2)
    assert np.isfinite(np.asarray(res.coords)).all()


def test_landmark_init_quality_parity(chr21_1mb_matrix):
    """The at-scale landmark init must land within noise of the full MDS
    init after annealing (measured equal at L=455: 0.9466 both, see
    DESIGN.md; this guards the small-L regime in CI)."""
    import dataclasses

    rc = RestraintConfig()
    dense = dense_restraints_from_numpy(
        build_restraints(chr21_1mb_matrix, rc), rc.weighting
    )
    base = fast_anneal(AnnealConfig())
    scores = {}
    for init in ("mds", "landmark"):
        cfg = dataclasses.replace(base, init=init, landmark_count=16)
        res = solve_ensemble(dense, cfg, jax.random.PRNGKey(82364), 4)
        scores[init] = max(
            spearman_if_inv_d(chr21_1mb_matrix, c)
            for c in np.asarray(res.coords)
        )
    assert scores["landmark"] > scores["mds"] - 0.03, scores


def test_auto_init_dispatch():
    """init='auto' resolves to classical MDS below 2048 beads and landmark
    MDS at/above (the O(L^3 log L) smoothing dominates large-L solves)."""
    import dataclasses

    import jax
    import numpy as np

    from chromosome3d.config import AnnealConfig, RestraintConfig, fast_anneal
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints
    from chromosome3d.solver.anneal import solve_ensemble_impl

    rng = np.random.RandomState(0)
    L = 24
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    dense = dense_restraints_from_numpy(build_restraints(m, RestraintConfig()))
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.05), enantiomer=False)
    assert cfg.init == "auto"
    # below the threshold, auto == mds: identical trajectories
    r_auto = solve_ensemble_impl(dense, cfg, jax.random.PRNGKey(1), 2)
    r_mds = solve_ensemble_impl(
        dense, dataclasses.replace(cfg, init="mds"), jax.random.PRNGKey(1), 2
    )
    np.testing.assert_array_equal(
        np.asarray(r_auto.coords), np.asarray(r_mds.coords)
    )


def test_resolve_use_pallas_semantics():
    """use_pallas=None resolves by backend (the GPU kernel on GPU, the
    plain path here); False forces the plain path; True on a backend the
    kernel cannot compile for raises instead of running the interpreter."""
    from chromosome3d.config import AnnealConfig
    from chromosome3d.solver.anneal import resolve_use_pallas

    import jax

    auto = resolve_use_pallas(AnnealConfig())
    assert auto == (jax.default_backend() == "gpu")
    assert resolve_use_pallas(AnnealConfig(use_pallas=False)) is False
    if jax.default_backend() == "gpu":
        assert resolve_use_pallas(AnnealConfig(use_pallas=True)) is True
    else:
        with pytest.raises(ValueError, match="GPU"):
            resolve_use_pallas(AnnealConfig(use_pallas=True))


def test_chunked_final_terms_gate(tiny_matrix, monkeypatch):
    """Beyond _CHUNKED_TERMS_MIN_L the final canonical-terms pass runs the
    row-chunked evaluation; its reported energies must match the dense pass
    to float-reassociation tolerance on the same solved coordinates."""
    import chromosome3d.solver.anneal as anneal_mod

    dense = dense_restraints_from_numpy(
        build_restraints(tiny_matrix, RestraintConfig())
    )
    cfg = fast_anneal(AnnealConfig())
    ref = anneal_mod.solve_ensemble_impl(dense, cfg, jax.random.PRNGKey(3), 2)
    monkeypatch.setattr(anneal_mod, "_CHUNKED_TERMS_MIN_L", 1)
    got = anneal_mod.solve_ensemble_impl(dense, cfg, jax.random.PRNGKey(3), 2)
    np.testing.assert_allclose(got.coords, ref.coords, rtol=1e-6, atol=1e-6)
    for k in ref.energies:
        np.testing.assert_allclose(got.energies[k], ref.energies[k], rtol=1e-4)
