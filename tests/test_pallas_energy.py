"""The GPU pair kernel (ops.pair_kernel, Pallas through Triton) and the
plain analytic pair path (ops.pair) against the jnp reference energy.

On CPU the kernel runs in the Pallas interpreter (`interpret=True`, passed
by the tests only); chip_smoke.py compiles it for the card and compares it
at real widths. The reference runs at HIGHEST matmul precision. Tolerances:
energies to ~2e-5 relative (float32 summation order differs: per-row
partials over column blocks vs one whole-matrix sum), gradients to 2e-4
relative plus an absolute term scaled to the gradient's size (rsqrt vs
sqrt-and-divide, and the same reassociation)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chromosome3d.config import AnnealConfig, RestraintConfig, fast_anneal
from chromosome3d.ops.energy import (
    EnergyWeights,
    dense_restraints_from_numpy,
    energy,
)
from chromosome3d.ops.pair import (
    bonded_energy,
    pair_energy,
    pair_energy_grad_batched,
    pair_tiles,
    row_block_energy_grad,
)
from chromosome3d.ops.pair_kernel import pair_kernel_energy_grad
from chromosome3d.restraints import build_restraints


def make_case(L=50, seed=0, alpha=1.1):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=alpha))
    dense = dense_restraints_from_numpy(r)
    x = jnp.asarray(rng.randn(L, 3) * 10, jnp.float32)
    w = EnergyWeights(
        noe=jnp.float32(10.0),
        bond=jnp.float32(10.0),
        bond_length=jnp.float32(3.8),
        vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.06),
        noe_rswitch=jnp.float32(1.0),
    )
    bead = jnp.ones((L,), jnp.float32)
    return x, dense, w, bead


def make_exact_case(L=50, seed=0):
    """Pipeline-realistic case: exact restraints (lo == hi), quadratic well."""
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=0.5))
    assert not r.negdev.any() and not r.posdev.any()
    dense = dense_restraints_from_numpy(r)
    x = jnp.asarray(rng.randn(L, 3) * 10, jnp.float32)
    w = EnergyWeights(
        noe=jnp.float32(10.0),
        bond=jnp.float32(10.0),
        bond_length=jnp.float32(3.8),
        vdw=jnp.float32(4.0),
        vdw_radius=jnp.float32(3.06),
        noe_rswitch=jnp.float32(1e9),
    )
    bead = jnp.ones((L,), jnp.float32)
    return x, dense, w, bead


def _pair_only(w):
    return w._replace(bond=jnp.float32(0.0))


def _reference(x, dense, w, bead):
    """Autodiff of the dense jnp reference, pair terms only, HIGHEST."""
    w0 = _pair_only(w)
    with jax.default_matmul_precision("highest"):
        e = energy(x, dense, w0, bead)
        g = jax.grad(energy)(x, dense, w0, bead)
    return float(e), np.asarray(g)


def _kernel_energy(x, dense, w, bead, exact=False):
    """Total energy through the kernel's custom_vjp wrapper (callers take
    the interpret_kernel fixture)."""
    tiles = pair_tiles(dense, exact)
    return pair_energy(x, tiles, bead, w, True) + bonded_energy(x, bead, w)


def _assert_grad_close(g, g_ref):
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(
        np.asarray(g), g_ref, rtol=2e-4, atol=2e-5 * np.abs(g_ref).max() + 2e-4
    )


@pytest.mark.parametrize("L", [16, 50, 130, 260])
def test_pallas_energy_matches_dense(L, interpret_kernel):
    x, dense, w, bead = make_case(L)
    e_ref = float(energy(x, dense, w, bead))
    e_pal = float(_kernel_energy(x, dense, w, bead))
    assert e_pal == pytest.approx(e_ref, rel=2e-5)


@pytest.mark.parametrize("L", [50, 130])
def test_pallas_grad_matches_dense(L, interpret_kernel):
    x, dense, w, bead = make_case(L)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.grad(energy)(x, dense, w, bead)
    g_pal = jax.grad(lambda c: _kernel_energy(c, dense, w, bead))(x)
    _assert_grad_close(g_pal, g_ref)


def test_pallas_padded_beads_ignored(interpret_kernel):
    """Padding beads (bead_mask 0) with garbage coordinates contribute
    nothing: the padded kernel call equals the unpadded one."""
    x, dense, w, bead = make_case(40)
    rng = np.random.RandomState(3)
    base = rng.gamma(2.0, 50.0, size=(40, 40))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    r = build_restraints(m, RestraintConfig(alpha=1.1))
    dense_p = dense_restraints_from_numpy(r.padded(56))
    dense_u = dense_restraints_from_numpy(r)
    xp = jnp.concatenate([x, jnp.asarray(rng.randn(16, 3) * 100, jnp.float32)])
    bead_p = jnp.asarray([1.0] * 40 + [0.0] * 16, jnp.float32)
    e_ref = float(_kernel_energy(x, dense_u, w, jnp.ones(40, jnp.float32)))
    e_pad = float(_kernel_energy(xp, dense_p, w, bead_p))
    assert e_pad == pytest.approx(e_ref, rel=2e-5)
    _, g_pad = pair_kernel_energy_grad(
        xp[None], pair_tiles(dense_p, False), bead_p, w, interpret=True
    )
    np.testing.assert_array_equal(np.asarray(g_pad)[0, 40:], 0.0)


def test_pallas_vmap(interpret_kernel):
    x, dense, w, bead = make_case(30)
    xs = jnp.stack([x, x * 1.1, x * 0.9])
    f = jax.vmap(lambda c: _kernel_energy(c, dense, w, bead))
    es = np.asarray(f(xs))
    singles = [float(_kernel_energy(c, dense, w, bead)) for c in xs]
    np.testing.assert_allclose(es, singles, rtol=2e-5)


def test_pallas_vmap_grad(interpret_kernel):
    x, dense, w, bead = make_case(30)
    xs = jnp.stack([x, x * 1.2])
    f = jax.vmap(jax.grad(lambda c: _kernel_energy(c, dense, w, bead)))
    gs = np.asarray(f(xs))
    for k, c in enumerate(xs):
        g = jax.grad(lambda cc: _kernel_energy(cc, dense, w, bead))(c)
        np.testing.assert_allclose(gs[k], np.asarray(g), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("L", [16, 50, 130])
def test_exact_kernel_matches_dense(L, interpret_kernel):
    """The exact-restraint kernel == the jnp reference on exact restraints."""
    x, dense, w, bead = make_exact_case(L)
    e_ref = float(energy(x, dense, w, bead))
    e_exact = float(_kernel_energy(x, dense, w, bead, exact=True))
    assert e_exact == pytest.approx(e_ref, rel=2e-5)
    with jax.default_matmul_precision("highest"):
        g_ref = jax.grad(energy)(x, dense, w, bead)
    g_exact = jax.grad(lambda c: _kernel_energy(c, dense, w, bead, True))(x)
    _assert_grad_close(g_exact, g_ref)


def test_exact_kernel_batched_matches_general():
    x, dense, w, bead = make_exact_case(40)
    xb = jnp.stack([x, x * 0.7 + 1.0])
    e_g, g_g = pair_kernel_energy_grad(
        xb, pair_tiles(dense, False), bead, w, interpret=True
    )
    e_x, g_x = pair_kernel_energy_grad(
        xb, pair_tiles(dense, True), bead, w, interpret=True
    )
    np.testing.assert_allclose(np.asarray(e_x), np.asarray(e_g), rtol=2e-5)
    np.testing.assert_allclose(np.asarray(g_x), np.asarray(g_g), rtol=2e-4, atol=2e-4)


def test_exact_solve_matches_general(tiny_matrix):
    """solve_ensemble with exact_restraints=True reproduces the general
    trajectories on pipeline restraints on the plain path (lo == hi, so the
    (target, w) tiles compute the same wells)."""
    from chromosome3d.solver.anneal import solve_ensemble

    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    base = dataclasses.replace(fast_anneal(AnnealConfig(), 0.05), use_pallas=False)
    key = jax.random.PRNGKey(5)
    ref = solve_ensemble(dense, base, key, 2)
    cfgx = dataclasses.replace(base, exact_restraints=True)
    got = solve_ensemble(dense, cfgx, key, 2)
    np.testing.assert_allclose(
        np.asarray(got.coords), np.asarray(ref.coords), rtol=1e-5, atol=1e-4
    )


def test_auto_exact_detection(tiny_matrix):
    from chromosome3d.config import PipelineConfig
    from chromosome3d.pipeline import auto_exact
    from chromosome3d.restraints import Restraints

    r = build_restraints(tiny_matrix, RestraintConfig())
    cfg = auto_exact(PipelineConfig(), r)
    assert cfg.anneal.exact_restraints
    # nonzero deviations -> stays off
    r2 = Restraints(
        target=r.target,
        negdev=np.where(r.mask, 0.1, 0.0).astype(np.float32),
        posdev=r.posdev,
        mask=r.mask,
    )
    assert not auto_exact(PipelineConfig(), r2).anneal.exact_restraints
    # soft-square tail active -> stays off
    cfg3 = PipelineConfig(anneal=AnnealConfig(noe_rswitch=2.0))
    assert not auto_exact(cfg3, r).anneal.exact_restraints


# ---------------------------------------------------------------------------
# The kernel, the plain analytic path and the autodiff reference agree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact", [True, False], ids=["exact", "general"])
@pytest.mark.parametrize("L", [16, 50, 130, 260, 456])
def test_kernel_plain_reference_agree(L, exact):
    mk = make_exact_case if exact else make_case
    x, dense, w, bead = mk(L, seed=L)
    xb = jnp.stack([x, -0.8 * x + 1.5])
    tiles = pair_tiles(dense, exact)
    e_k, g_k = pair_kernel_energy_grad(xb, tiles, bead, w, interpret=True)
    e_p, g_p = pair_energy_grad_batched(xb, tiles, bead, w)
    for k in range(2):
        e_ref, g_ref = _reference(xb[k], dense, w, bead)
        assert float(e_k[k]) == pytest.approx(e_ref, rel=2e-5)
        assert float(e_p[k]) == pytest.approx(e_ref, rel=2e-5)
        _assert_grad_close(g_k[k], g_ref)
        _assert_grad_close(g_p[k], g_ref)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "general"])
def test_plain_matches_autodiff_highest(exact):
    """The plain analytic path (the CPU and non-kernel route) against
    autodiff of the reference, with bead padding and a multi-chunk column
    scan (the chunk cap forced below L)."""
    import chromosome3d.ops.pair as pair_mod

    mk = make_exact_case if exact else make_case
    x, dense, w, bead = mk(384, seed=4)
    bead = bead.at[370:].set(0.0)
    orig = pair_mod._COL_CHUNK
    pair_mod._COL_CHUNK = 128
    try:
        assert pair_mod._pick_col_chunk(384) == 128
        e_p, g_p = pair_energy_grad_batched(
            x[None], pair_tiles(dense, exact), bead, w
        )
    finally:
        pair_mod._COL_CHUNK = orig
    e_ref, g_ref = _reference(x, dense, w, bead)
    assert float(e_p[0]) == pytest.approx(e_ref, rel=2e-5)
    _assert_grad_close(g_p[0], g_ref)


@pytest.mark.parametrize(
    "L,block_m,block_n", [(77, 16, 32), (45, 32, 16), (200, 64, 64)]
)
def test_kernel_ragged_blocks(L, block_m, block_n):
    """L not a multiple of either block: the masked loads and stores cover
    the ragged last row and column blocks."""
    x, dense, w, bead = make_exact_case(L, seed=2)
    tiles = pair_tiles(dense, True)
    e_k, g_k = pair_kernel_energy_grad(
        x[None], tiles, bead, w, interpret=True,
        block_m=block_m, block_n=block_n,
    )
    e_ref, g_ref = _reference(x, dense, w, bead)
    assert float(e_k[0]) == pytest.approx(e_ref, rel=2e-5)
    _assert_grad_close(g_k[0], g_ref)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "general"])
def test_kernel_row0_offset(exact):
    """A row block [row0, row0 + Lb) of the tiles with its global offset
    (the row-sharded solver's call) equals those rows of the plain path,
    including the |i - j| >= 2 vdw mask across the block boundary."""
    mk = make_exact_case if exact else make_case
    x, dense, w, bead = mk(72, seed=9)
    xb = jnp.stack([x, 0.9 * x])
    tiles = pair_tiles(dense, exact)
    row0, Lb = 24, 24
    rows = tuple(t[row0:row0 + Lb] for t in tiles)
    e_k, g_k = pair_kernel_energy_grad(
        xb, rows, bead, w, jnp.int32(row0), interpret=True, block_m=16
    )
    lo = rows[0]
    hi = rows[0] if exact else rows[1]
    for k in range(2):
        e_n, e_v, g_rows = row_block_energy_grad(
            xb[k], lo, hi, rows[-1], bead, row0, w
        )
        assert float(e_k[k]) == pytest.approx(float(e_n + e_v), rel=2e-5)
        _assert_grad_close(g_k[k], g_rows)
    # the row blocks of all shards sum to the whole-matrix call
    e_all, g_all = pair_kernel_energy_grad(xb, tiles, bead, w, interpret=True)
    parts = [
        pair_kernel_energy_grad(
            xb, tuple(t[r0:r0 + Lb] for t in tiles), bead, w, jnp.int32(r0),
            interpret=True,
        )
        for r0 in (0, 24, 48)
    ]
    np.testing.assert_allclose(
        sum(np.asarray(p[0]) for p in parts), np.asarray(e_all), rtol=2e-5
    )
    np.testing.assert_allclose(
        np.concatenate([np.asarray(p[1]) for p in parts], axis=1),
        np.asarray(g_all), rtol=1e-5, atol=1e-4,
    )


def test_kernel_batch_shares_tiles():
    """One call over B structures sharing the restraint tiles equals B
    single-structure calls (the grid's structure axis is independent)."""
    x, dense, w, bead = make_exact_case(90, seed=6)
    xb = jnp.stack([x, -x, 0.5 * x + 2.0, x[::-1]])
    tiles = pair_tiles(dense, True)
    e_b, g_b = pair_kernel_energy_grad(xb, tiles, bead, w, interpret=True)
    for k in range(xb.shape[0]):
        e_1, g_1 = pair_kernel_energy_grad(
            xb[k:k + 1], tiles, bead, w, interpret=True
        )
        np.testing.assert_array_equal(np.asarray(e_b[k]), np.asarray(e_1[0]))
        np.testing.assert_array_equal(np.asarray(g_b[k]), np.asarray(g_1[0]))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_pair_energy_custom_vjp(use_kernel, interpret_kernel):
    """pair_energy's gradient rule returns the gradient its forward pass
    computed, scaled by the cotangent; restraint cotangents are zero."""
    x, dense, w, bead = make_exact_case(40, seed=8)
    tiles = pair_tiles(dense, True)
    e, vjp = jax.vjp(
        lambda c, t: pair_energy(c, t, bead, w, use_kernel),
        x, tiles,
    )
    gx, gt = vjp(jnp.float32(2.5))
    e_b, g_b = pair_energy_grad_batched(
        x[None], tiles, bead, w, 0, use_kernel
    )
    np.testing.assert_allclose(float(e), float(e_b[0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gx), 2.5 * np.asarray(g_b[0]), rtol=1e-6)
    for t in gt:
        assert not np.asarray(t).any()


def test_bf16_tiles_close_to_f32():
    """AnnealConfig.pair_bf16: bf16 restraint tiles with f32 math track the
    f32-tile kernel to bf16 precision (~0.4% relative), and a short solve
    with bf16 tiles lands near the f32 solve's energy."""
    x, dense, w, bead = make_exact_case(300)
    xb = jnp.stack([x, x * 0.9])
    tiles = pair_tiles(dense, True)
    e32, g32 = pair_kernel_energy_grad(xb, tiles, bead, w, interpret=True)
    e16, g16 = pair_kernel_energy_grad(
        xb, tuple(t.astype(jnp.bfloat16) for t in tiles), bead, w,
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(e16), np.asarray(e32), rtol=2e-2)
    np.testing.assert_allclose(
        np.asarray(g16), np.asarray(g32),
        rtol=5e-2, atol=2e-2 * float(jnp.abs(g32).max()),
    )

    from chromosome3d.solver.anneal import solve_ensemble_impl

    _, dense_s, _, bead_s = make_exact_case(44)
    cfg32 = dataclasses.replace(
        fast_anneal(AnnealConfig(), 0.1), use_pallas=False,
        exact_restraints=True, noise_scale=0.0,
    )
    cfg16 = dataclasses.replace(cfg32, pair_bf16=True)
    key = jax.random.PRNGKey(3)
    r32 = solve_ensemble_impl(dense_s, cfg32, key, 2, bead_s)
    r16 = solve_ensemble_impl(dense_s, cfg16, key, 2, bead_s)
    e_a = np.asarray(r32.energies["overall"])
    e_b = np.asarray(r16.energies["overall"])
    assert np.isfinite(e_b).all()
    np.testing.assert_allclose(e_b, e_a, rtol=0.1)


def test_kernel_solve_matches_plain(interpret_kernel):
    """solve_ensemble_impl through the kernel (interpret mode) tracks the
    plain analytic solve with zero noise."""
    from chromosome3d.solver.anneal import solve_ensemble_impl

    _, dense, _, bead = make_exact_case(44)
    base = dataclasses.replace(
        fast_anneal(AnnealConfig(), 0.05), exact_restraints=True,
        noise_scale=0.0,
    )
    key = jax.random.PRNGKey(5)
    res_k = solve_ensemble_impl(
        dense, dataclasses.replace(base, use_pallas=True), key, 2, bead
    )
    res_p = solve_ensemble_impl(
        dense, dataclasses.replace(base, use_pallas=False), key, 2, bead
    )
    np.testing.assert_allclose(
        np.asarray(res_k.coords), np.asarray(res_p.coords), rtol=1e-3, atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_k.energies["overall"]),
        np.asarray(res_p.energies["overall"]), rtol=1e-4,
    )


def test_use_pallas_raises_off_gpu(tiny_matrix):
    """use_pallas=True on a backend the kernel cannot compile for raises;
    it never falls back to the Pallas interpreter in a product solve."""
    from chromosome3d.solver.anneal import solve_ensemble

    if jax.default_backend() == "gpu":
        pytest.skip("the kernel compiles on this backend")
    dense = dense_restraints_from_numpy(
        build_restraints(tiny_matrix, RestraintConfig())
    )
    cfg = dataclasses.replace(fast_anneal(AnnealConfig(), 0.05), use_pallas=True)
    with pytest.raises(ValueError, match="GPU"):
        solve_ensemble(dense, cfg, jax.random.PRNGKey(0), 2)


@pytest.mark.gpu
def test_kernel_compiled_matches_reference(gpu_device):
    """On the card: the compiled kernel (no interpreter) at the headline
    width against the HIGHEST-precision reference."""
    x, dense, w, bead = make_exact_case(456, seed=1)
    xb = jnp.stack([x, 0.7 * x])
    e_k, g_k = pair_kernel_energy_grad(xb, pair_tiles(dense, True), bead, w)
    for k in range(2):
        e_ref, g_ref = _reference(xb[k], dense, w, bead)
        assert float(e_k[k]) == pytest.approx(e_ref, rel=2e-5)
        _assert_grad_close(g_k[k], g_ref)
