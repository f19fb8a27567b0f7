"""The TWO-tensor ExactRestraints form must be a drop-in for DenseRestraints
everywhere the exact production path runs: same energies, same gradients,
same solves, half the uploaded/live restraint tensors. (At scale the
single-device ceiling is set by the live (L, L) tensor count.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chromosome3d.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d.ops.energy import (
    EnergyWeights,
    dense_restraints_from_numpy,
    energy_terms,
    exact_restraints_from_numpy,
    violation_stats,
)
from chromosome3d.restraints import build_restraints


def _both_forms(matrix, weighting="relative"):
    rc = RestraintConfig()
    r = build_restraints(matrix, rc)
    dense = dense_restraints_from_numpy(r, weighting)
    ex = exact_restraints_from_numpy(r, weighting)
    return r, dense, ex


def test_exact_form_tensors(tiny_matrix):
    r, dense, ex = _both_forms(tiny_matrix)
    # folded weight equals mask * weight of the dense form, bitwise
    np.testing.assert_array_equal(
        np.asarray(ex.w), np.asarray(dense.mask * dense.weight)
    )
    # target matches wherever a restraint exists; zero elsewhere
    m = np.asarray(dense.mask) > 0
    np.testing.assert_array_equal(np.asarray(ex.target)[m], np.asarray(dense.lo)[m])
    assert (np.asarray(ex.target)[~m] == 0.0).all()
    # duck-typed properties
    np.testing.assert_array_equal(np.asarray(ex.lo), np.asarray(ex.target))
    np.testing.assert_array_equal(np.asarray(ex.hi), np.asarray(ex.target))
    np.testing.assert_array_equal(np.asarray(ex.mask), m.astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(ex.mask * ex.weight), np.asarray(ex.w)
    )


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_energy_and_stats_equal(tiny_matrix, weighting):
    r, dense, ex = _both_forms(tiny_matrix, weighting)
    L = np.asarray(dense.lo).shape[0]
    x = jnp.asarray(np.random.RandomState(0).randn(L, 3) * 8, jnp.float32)
    w = EnergyWeights(
        noe=jnp.float32(10.0), bond=jnp.float32(1.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.2),
    )
    td = energy_terms(x, dense, w)
    te = energy_terms(x, ex, w)
    for k in td:
        np.testing.assert_allclose(float(td[k]), float(te[k]), rtol=1e-6)
    gd = jax.grad(lambda c: energy_terms(c, dense, w)["overall"])(x)
    ge = jax.grad(lambda c: energy_terms(c, ex, w)["overall"])(x)
    np.testing.assert_allclose(np.asarray(gd), np.asarray(ge), rtol=1e-5, atol=1e-5)
    sd = violation_stats(x, dense)
    se = violation_stats(x, ex)
    for a, b in zip(sd, se):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_solve_ensemble_equal(tiny_matrix, use_pallas, request):
    """Same key, same schedule: the two forms must produce identical
    structures through the plain analytic path AND the GPU pair kernel
    (interpret mode on CPU)."""
    from chromosome3d.solver.anneal import solve_ensemble

    if use_pallas:
        request.getfixturevalue("interpret_kernel")

    r, dense, ex = _both_forms(tiny_matrix)
    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig(), 0.2),
        exact_restraints=True, use_pallas=use_pallas,
    )
    key = jax.random.PRNGKey(7)
    rd = solve_ensemble(dense, cfg, key, 2)
    re = solve_ensemble(ex, cfg, key, 2)
    np.testing.assert_allclose(
        np.asarray(rd.coords), np.asarray(re.coords), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(rd.energies["overall"]),
        np.asarray(re.energies["overall"]), rtol=1e-5,
    )


@pytest.mark.parametrize("use_kernel", [False, True])
def test_pair_path_accepts_exact_form(use_kernel, request):
    """The pair terms fed ExactRestraints tiles (aliases of the stored
    tensors) match the dense-form call, on the plain path and the GPU pair
    kernel (interpret mode)."""
    from chromosome3d.ops.pair import (
        exact_pair_tiles,
        pair_energy_grad_batched,
        pair_tiles,
    )

    rc = RestraintConfig()
    rng = np.random.RandomState(1)
    L = 300
    m = np.abs(rng.randn(L, L)) + 0.1
    m = (m + m.T) / 2
    r = build_restraints(m, rc)
    dense = dense_restraints_from_numpy(r)
    ex = exact_restraints_from_numpy(r)
    # alias check: the exact form's tiles ARE its stored tensors
    t0, w0 = exact_pair_tiles(ex)
    assert t0 is ex.target and w0 is ex.w

    x = jnp.asarray(rng.randn(2, L, 3) * 6, jnp.float32)
    w = EnergyWeights(
        noe=jnp.float32(10.0), bond=jnp.float32(0.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(2.0),
        vdw_radius=jnp.float32(3.2),
    )
    bm = jnp.ones((L,), jnp.float32)
    if use_kernel:
        request.getfixturevalue("interpret_kernel")
    kw = dict(use_kernel=use_kernel)
    ed, gd = pair_energy_grad_batched(x, pair_tiles(dense, True), bm, w, **kw)
    ee, ge = pair_energy_grad_batched(x, pair_tiles(ex, True), bm, w, **kw)
    np.testing.assert_allclose(np.asarray(ed), np.asarray(ee), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gd), np.asarray(ge), rtol=1e-6, atol=1e-6)


def test_sharded_ensemble_accepts_exact_form():
    """solve_ensemble_sharded fed the two-tensor form must match the dense
    form on the CPU mesh — the at-scale sharded solve's memory-lean path."""
    from jax.sharding import Mesh

    from chromosome3d.solver.sharded import solve_ensemble_sharded

    rng = np.random.RandomState(3)
    L = 16 * len(jax.devices())
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    ex = exact_restraints_from_numpy(r)
    cfg = dataclasses.replace(fast_anneal(AnnealConfig()), exact_restraints=True)
    key = jax.random.PRNGKey(11)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    rd = jax.jit(lambda d, k: solve_ensemble_sharded(mesh, d, cfg, k, 2))(dense, key)
    re_ = jax.jit(lambda d, k: solve_ensemble_sharded(mesh, d, cfg, k, 2))(ex, key)
    np.testing.assert_allclose(
        np.asarray(rd.coords), np.asarray(re_.coords), rtol=1e-5, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(rd.energies["overall"]),
        np.asarray(re_.energies["overall"]), rtol=1e-5,
    )


def test_genome_bucket_stacks_exact_form(tmp_path):
    """_stack_bucket routes pipeline-generated (exact) restraints to the
    two-tensor batched form, and solve_bucket consumes it."""
    from chromosome3d.config import PipelineConfig
    from chromosome3d.ops.energy import ExactRestraints
    from chromosome3d.parallel.genome import (
        GenomeJob,
        _stack_bucket,
        solve_bucket,
    )

    rng = np.random.RandomState(4)
    jobs = []
    for i, L in enumerate((20, 24)):
        base = np.abs(rng.randn(L, L)) + 0.1
        m = (base + base.T) / 2
        path = tmp_path / f"chr{i + 1}_1mb_matrix.txt"
        np.savetxt(path, m, fmt="%.4f")
        jobs.append(GenomeJob(name=f"chr{i + 1}_1mb", path=str(path)))
    cfg = PipelineConfig(model_count=2, anneal=fast_anneal(AnnealConfig()))
    batched, masks, matrices, raw = _stack_bucket(jobs, 32, cfg)
    assert isinstance(batched, ExactRestraints)
    assert np.asarray(batched.target).shape == (2, 32, 32)
    res = solve_bucket(batched, masks, cfg)
    assert np.asarray(res.coords).shape[0] == 2


def test_pipeline_builds_exact_form(tmp_path):
    """auto_exact + _padded_dense: the pipeline's own restraints route to
    the two-tensor form; a windowed (two-sided) set keeps the dense form."""
    from chromosome3d.config import PipelineConfig
    from chromosome3d.ops.energy import DenseRestraints, ExactRestraints
    from chromosome3d.pipeline import _exact_provable, _padded_dense, auto_exact

    rng = np.random.RandomState(2)
    m = np.abs(rng.randn(24, 24)) + 0.1
    m = (m + m.T) / 2
    rc = RestraintConfig()
    r = build_restraints(m, rc)
    cfg = auto_exact(PipelineConfig(), r)
    assert _exact_provable(cfg)
    built, _ = _padded_dense(r, rc, 32, exact=_exact_provable(cfg))
    assert isinstance(built, ExactRestraints)
    assert np.asarray(built.target).shape == (32, 32)

    # a restraint set with real deviations must NOT prove exact
    r2 = dataclasses.replace(
        r, posdev=np.full_like(np.asarray(r.posdev), 0.5)
    )
    cfg2 = auto_exact(PipelineConfig(), r2)
    assert not _exact_provable(cfg2)
    built2, _ = _padded_dense(r2, rc, 32, exact=_exact_provable(cfg2))
    assert isinstance(built2, DenseRestraints)
