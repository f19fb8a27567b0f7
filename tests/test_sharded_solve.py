"""Sequence-parallel solve: the row-sharded annealer must reproduce the
single-device solve_single trajectory exactly (same RNG stream)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from chromosome3d.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d.ops.energy import dense_restraints_from_numpy
from chromosome3d.restraints import build_restraints
from chromosome3d.solver.anneal import solve_single
from chromosome3d.solver.init import mds_init
from chromosome3d.solver.sharded import solve_single_sharded


def make_case(L):
    rng = np.random.RandomState(0)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    return dense_restraints_from_numpy(build_restraints(m, RestraintConfig()))


def test_sharded_solve_matches_single():
    L = 16 * 8
    dense = make_case(L)
    cfg = fast_anneal(AnnealConfig())
    x0 = mds_init(dense)
    key = jax.random.PRNGKey(3)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    c_sharded, h_sharded = jax.jit(
        lambda d, k, x: solve_single_sharded(mesh, d, cfg, k, x)
    )(dense, key, x0)
    c_single, h_single = solve_single(dense, cfg, key, x0)
    np.testing.assert_allclose(
        np.asarray(h_sharded), np.asarray(h_single), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(c_sharded), np.asarray(c_single), atol=1e-3
    )


def test_sharded_solve_rejects_bad_length():
    dense = make_case(50)
    cfg = fast_anneal(AnnealConfig())
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    with pytest.raises(ValueError):
        solve_single_sharded(
            mesh, dense, cfg, jax.random.PRNGKey(0), jnp.zeros((50, 3))
        )


def test_sharded_ensemble_matches_dense_landmark():
    """solve_ensemble_sharded (row-sharded init + hot + enantiomer pick +
    cool/final) must match solve_ensemble_impl with init='landmark' on the
    same key — the sharded program IS the dense program, decomposed."""
    import dataclasses

    from chromosome3d.solver.anneal import solve_ensemble_impl
    from chromosome3d.solver.sharded import solve_ensemble_sharded

    L = 16 * 8
    dense = make_case(L)
    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()), init="landmark", landmark_count=16
    )
    key = jax.random.PRNGKey(7)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    sharded = jax.jit(
        lambda d, k: solve_ensemble_sharded(mesh, d, cfg, k, 2)
    )(dense, key)
    ref = jax.jit(
        lambda d, k: solve_ensemble_impl(d, cfg, k, 2),
    )(dense, key)
    np.testing.assert_allclose(
        np.asarray(sharded.history), np.asarray(ref.history), rtol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(sharded.coords), np.asarray(ref.coords), atol=5e-3
    )
    for k2 in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(
            np.asarray(sharded.energies[k2]), np.asarray(ref.energies[k2]),
            rtol=2e-3,
        )


def test_sharded_ensemble_padded_bead_mask():
    """Sharded ensemble on a padded problem (true L not divisible by the
    mesh): padding masked everywhere, coords zero on padding."""
    from chromosome3d.config import RestraintConfig
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints
    from chromosome3d.solver.sharded import (
        pad_restraints_to_multiple,
        solve_ensemble_sharded,
    )
    import dataclasses

    rng = np.random.RandomState(1)
    L = 50
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig())
    r_pad, bead = pad_restraints_to_multiple(r, 8)
    assert r_pad.length == 56
    dense = dense_restraints_from_numpy(r_pad, "relative", 2.0)
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.1), init="landmark")
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    res = jax.jit(
        lambda d, k, b: solve_ensemble_sharded(mesh, d, cfg, k, 2, b)
    )(dense, jax.random.PRNGKey(0), jnp.asarray(bead))
    coords = np.asarray(res.coords)
    assert coords.shape == (2, 56, 3)
    assert np.isfinite(coords).all()
    assert (coords[:, L:, :] == 0).all()
    assert np.abs(coords[:, :L, :]).max() > 1.0


def test_sharded_ensemble_pallas_matches_jnp(interpret_kernel):
    """use_pallas=True routes the sharded hot loop through the GPU pair
    kernel on each shard's row block (interpret mode on this CPU mesh);
    trajectories must track the plain row-block path on the same key."""
    import dataclasses

    from chromosome3d.solver.sharded import solve_ensemble_sharded

    L = 16 * 8
    dense = make_case(L)
    base_cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()), init="landmark", landmark_count=16,
    )
    key = jax.random.PRNGKey(11)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    r_jnp = jax.jit(
        lambda d, k: solve_ensemble_sharded(
            mesh, d, dataclasses.replace(base_cfg, use_pallas=False), k, 2
        )
    )(dense, key)
    r_pal = jax.jit(
        lambda d, k: solve_ensemble_sharded(
            mesh, d, dataclasses.replace(base_cfg, use_pallas=True), k, 2
        )
    )(dense, key)
    np.testing.assert_allclose(
        np.asarray(r_pal.history), np.asarray(r_jnp.history), rtol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(r_pal.coords), np.asarray(r_jnp.coords), atol=5e-3
    )
    for k2 in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(
            np.asarray(r_pal.energies[k2]), np.asarray(r_jnp.energies[k2]),
            rtol=2e-3,
        )


def _sharded_vs_single(cfg, dense, key, n_dev):
    from chromosome3d.solver.anneal import solve_ensemble_impl
    from chromosome3d.solver.sharded import solve_ensemble_sharded

    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("beads",))
    sharded = jax.jit(
        lambda d, k: solve_ensemble_sharded(mesh, d, cfg, k, 2)
    )(dense, key)
    ref = jax.jit(lambda d, k: solve_ensemble_impl(d, cfg, k, 2))(dense, key)
    np.testing.assert_allclose(
        np.asarray(sharded.history), np.asarray(ref.history), rtol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(sharded.coords), np.asarray(ref.coords), atol=5e-3
    )
    for k2 in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(
            np.asarray(sharded.energies[k2]), np.asarray(ref.energies[k2]),
            rtol=2e-3,
        )


def test_sharded_ensemble_fused_matches_single_chip(interpret_kernel):
    """The sharded kernel path (each shard's row block with its global row
    offset) must reproduce the single-device kernel solve on the same key:
    both draw the same threefry noise, so the trajectories coincide up to
    float reordering of the pair sums."""
    import dataclasses

    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()), init="landmark", landmark_count=16,
        use_pallas=True, exact_restraints=True,
    )
    _sharded_vs_single(cfg, make_case(16 * 8), jax.random.PRNGKey(13), 8)


def test_sharded_ensemble_fused_single_device_degenerate(interpret_kernel):
    """The n_dev=1 degenerate of the sharded kernel path (the shape of a
    one-card machine) must reproduce the single-device kernel solve."""
    import dataclasses

    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()), init="landmark", landmark_count=16,
        use_pallas=True, exact_restraints=True,
    )
    _sharded_vs_single(cfg, make_case(48), jax.random.PRNGKey(13), 1)


def test_sharded_ensemble_semi_general_matches_single_chip(interpret_kernel):
    """GENERAL (windowed) restraints: the sharded kernel path reads the
    (lo, hi, w) tiles and must reproduce the single-device kernel solve on
    the same key, noise ON."""
    import dataclasses

    dense = make_case(16 * 8)
    dense = dense._replace(lo=dense.lo * 0.8, hi=dense.hi * 1.2)
    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()), init="landmark", landmark_count=16,
        use_pallas=True, exact_restraints=False,
    )
    _sharded_vs_single(cfg, dense, jax.random.PRNGKey(19), 8)


def test_genome_sharded_2d_matches_1d():
    """solve_genome_sharded on a (2 chrom x 4 beads) mesh must reproduce
    each chromosome's solve_ensemble_sharded result from a 4-device beads
    mesh — the same shard body, vmapped and data-parallel over chromosomes."""
    import dataclasses

    from chromosome3d.ops.energy import DenseRestraints
    from chromosome3d.solver.sharded import (
        solve_ensemble_sharded,
        solve_genome_sharded,
    )

    L = 16 * 4
    d1 = make_case(L)
    rng = np.random.RandomState(9)
    base2 = rng.gamma(2.0, 40.0, size=(L, L))
    m2 = (base2 + base2.T) / 2
    np.fill_diagonal(m2, 4000.0)
    from chromosome3d.config import RestraintConfig
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints

    d2 = dense_restraints_from_numpy(build_restraints(m2, RestraintConfig()))
    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()), init="landmark", landmark_count=16
    )
    keys = jnp.stack([jax.random.PRNGKey(3), jax.random.PRNGKey(4)])
    batched = DenseRestraints(
        lo=jnp.stack([d1.lo, d2.lo]),
        hi=jnp.stack([d1.hi, d2.hi]),
        mask=jnp.stack([d1.mask, d2.mask]),
        weight=jnp.stack([d1.weight, d2.weight]),
    )

    devs = np.array(jax.devices()).reshape(2, 4)
    mesh2d = Mesh(devs, ("chrom", "beads"))
    res2d = jax.jit(
        lambda b, k: solve_genome_sharded(mesh2d, b, cfg, k, 2)
    )(batched, keys)
    assert res2d.coords.shape[0] == 2

    mesh1d = Mesh(np.array(jax.devices()[:4]), ("beads",))
    for i, d in enumerate((d1, d2)):
        ref = jax.jit(
            lambda dd, kk: solve_ensemble_sharded(mesh1d, dd, cfg, kk, 2)
        )(d, keys[i])
        np.testing.assert_allclose(
            np.asarray(res2d.history[i]), np.asarray(ref.history), rtol=2e-3
        )
        np.testing.assert_allclose(
            np.asarray(res2d.coords[i]), np.asarray(ref.coords), atol=5e-3
        )
        for k2 in ("noe", "bon", "vdw", "overall"):
            np.testing.assert_allclose(
                np.asarray(res2d.energies[k2][i]),
                np.asarray(ref.energies[k2]),
                rtol=2e-3,
            )


def test_sharded_ensemble_bf16_stored_tiles():
    """bf16-STORED tiles (device_prep out_dtype="bfloat16") through the
    row-sharded ensemble: the per-shard landmark init upcasts to f32
    (matching solve_ensemble_impl's whole-tile upcast) and the hot loop
    reads the tiles natively — the sharded result must track the
    single-chip solve on the SAME stored tiles."""
    import dataclasses

    from chromosome3d.ops.device_prep import exact_tiles_from_if_device
    from chromosome3d.ops.energy import auto_weight_exponent
    from chromosome3d.solver.anneal import solve_ensemble_impl
    from chromosome3d.solver.sharded import solve_ensemble_sharded

    L = 16 * 8
    rng = np.random.RandomState(2)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    rc = RestraintConfig()
    tiles = exact_tiles_from_if_device(
        m, L, rc, rc.weighting, auto_weight_exponent(L), out_dtype="bfloat16"
    )
    assert tiles.target.dtype == jnp.bfloat16
    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig(exact_restraints=True)),
        init="landmark", landmark_count=16, pair_bf16=True,
    )
    key = jax.random.PRNGKey(5)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    sharded = jax.jit(
        lambda d, k: solve_ensemble_sharded(mesh, d, cfg, k, 2)
    )(tiles, key)
    ref = jax.jit(lambda d, k: solve_ensemble_impl(d, cfg, k, 2))(tiles, key)
    np.testing.assert_allclose(
        np.asarray(sharded.history), np.asarray(ref.history), rtol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(sharded.coords), np.asarray(ref.coords), atol=5e-3
    )
    for k2 in ("noe", "bon", "vdw", "overall"):
        np.testing.assert_allclose(
            np.asarray(sharded.energies[k2]), np.asarray(ref.energies[k2]),
            rtol=2e-3,
        )
