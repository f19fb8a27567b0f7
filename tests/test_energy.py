"""Energy-model tests: hand values, finite-difference gradients, and the
physical invariances (rotation/translation/mirror) that the distance-only
energy must satisfy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chromosome3d.config import AnnealConfig, RestraintConfig
from chromosome3d.ops.energy import (
    DenseRestraints,
    EnergyWeights,
    dense_restraints_from_numpy,
    energy,
    energy_terms,
    violation_stats,
)
from chromosome3d.restraints import build_restraints


def simple_weights(**kw):
    base = dict(
        noe=jnp.float32(1.0),
        bond=jnp.float32(0.0),
        bond_length=jnp.float32(3.8),
        vdw=jnp.float32(0.0),
        vdw_radius=jnp.float32(3.6),
        noe_rswitch=jnp.float32(1e9),
    )
    base.update({k: jnp.float32(v) for k, v in kw.items()})
    return EnergyWeights(**base)


def two_bead_restraints(target=5.0):
    L = 2
    t = np.zeros((L, L), np.float32)
    t[0, 1] = t[1, 0] = target
    mask = t > 0
    return DenseRestraints(
        lo=jnp.asarray(t),
        hi=jnp.asarray(t),
        mask=jnp.asarray(mask, jnp.float32),
        weight=jnp.asarray(mask, jnp.float32),
    )


def test_noe_hand_value():
    r = two_bead_restraints(5.0)
    coords = jnp.asarray([[0.0, 0, 0], [7.0, 0, 0]])
    terms = energy_terms(coords, r, simple_weights(noe=2.0))
    # violation 2.0, E = 0.5 * w * sum(sym mask * v^2) = 0.5*2*(2*4) = 8
    assert float(terms["noe"]) == pytest.approx(8.0, rel=1e-5)
    assert float(terms["bon"]) == 0.0 and float(terms["vdw"]) == 0.0


def test_noe_zero_inside_well():
    L = 2
    t = np.zeros((L, L), np.float32)
    t[0, 1] = t[1, 0] = 5.0
    mask = t > 0
    r = DenseRestraints(
        lo=jnp.asarray(t - 1.0 * mask),
        hi=jnp.asarray(t + 1.0 * mask),
        mask=jnp.asarray(mask, jnp.float32),
        weight=jnp.asarray(mask, jnp.float32),
    )
    coords = jnp.asarray([[0.0, 0, 0], [5.5, 0, 0]])
    assert float(energy(coords, r, simple_weights())) == pytest.approx(0.0, abs=1e-6)


def test_soft_square_linear_tail():
    r = two_bead_restraints(5.0)
    w_hard = simple_weights()
    w_soft = simple_weights(noe_rswitch=1.0)
    far = jnp.asarray([[0.0, 0, 0], [105.0, 0, 0]])  # violation 100
    e_hard = float(energy(far, r, w_hard))
    e_soft = float(energy(far, r, w_soft))
    # hard: v^2 = 10000 per direction; soft: 1 + 2*99 = 199
    assert e_hard == pytest.approx(10000.0, rel=1e-4)
    assert e_soft == pytest.approx(199.0, rel=1e-4)


def test_bond_term():
    L = 3
    z = np.zeros((L, L), np.float32)
    r = DenseRestraints(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), jnp.asarray(z))
    coords = jnp.asarray([[0.0, 0, 0], [5.8, 0, 0], [11.6, 0, 0]])
    terms = energy_terms(coords, r, simple_weights(bond=3.0))
    # two bonds, each dev 2.0 -> 3 * (4 + 4) = 24
    assert float(terms["bon"]) == pytest.approx(24.0, rel=1e-5)


def test_vdw_term():
    L = 3
    z = np.zeros((L, L), np.float32)
    r = DenseRestraints(jnp.asarray(z), jnp.asarray(z), jnp.asarray(z), jnp.asarray(z))
    # beads 0 and 2 are 2.0 apart -> overlap 1.6 with radius 3.6
    coords = jnp.asarray([[0.0, 0, 0], [50.0, 0, 0], [2.0, 0, 0]])
    terms = energy_terms(coords, r, simple_weights(vdw=1.0))
    assert float(terms["vdw"]) == pytest.approx(1.6 ** 2, rel=1e-4)
    # bonded neighbours (|i-j|<2) are excluded from vdw
    coords2 = jnp.asarray([[0.0, 0, 0], [1.0, 0, 0], [50.0, 0, 0]])
    terms2 = energy_terms(coords2, r, simple_weights(vdw=1.0))
    assert float(terms2["vdw"]) == pytest.approx(0.0, abs=1e-6)


def test_gradient_matches_finite_difference(tiny_matrix):
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    w = simple_weights(noe=1.0, bond=2.0, vdw=0.5)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(16, 3) * 8, jnp.float32)
    g = jax.grad(energy)(x, dense, w)
    eps = 1e-2
    for (i, k) in [(0, 0), (5, 1), (15, 2), (8, 0)]:
        xp = x.at[i, k].add(eps)
        xm = x.at[i, k].add(-eps)
        fd = (float(energy(xp, dense, w)) - float(energy(xm, dense, w))) / (2 * eps)
        assert float(g[i, k]) == pytest.approx(fd, rel=2e-2, abs=2e-2)


def test_invariances(tiny_matrix):
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    w = simple_weights(noe=1.0, bond=2.0, vdw=0.5)
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(16, 3) * 8, jnp.float32)
    e0 = float(energy(x, dense, w))
    # translation
    assert float(energy(x + 13.0, dense, w)) == pytest.approx(e0, rel=1e-4)
    # rotation
    theta = 0.9
    rot = jnp.asarray(
        [
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ],
        jnp.float32,
    )
    assert float(energy(x @ rot.T, dense, w)) == pytest.approx(e0, rel=1e-4)
    # mirror (enantiomer) — the energy cannot distinguish hands
    assert float(energy(x * jnp.asarray([-1.0, 1, 1]), dense, w)) == pytest.approx(
        e0, rel=1e-4
    )


def test_bead_mask_padding_equivalence(tiny_matrix):
    """Energy of a padded system with masked beads == unpadded energy."""
    r = build_restraints(tiny_matrix, RestraintConfig())
    dense = dense_restraints_from_numpy(r)
    w = simple_weights(noe=1.0, bond=2.0, vdw=0.5)
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(16, 3) * 8, jnp.float32)
    e0 = float(energy(x, dense, w))

    rp = dense_restraints_from_numpy(r.padded(24))
    xp = jnp.concatenate([x, jnp.asarray(rng.randn(8, 3) * 100, jnp.float32)])
    bead = jnp.asarray([1.0] * 16 + [0.0] * 8, jnp.float32)
    ep = float(energy(xp, rp, w, bead))
    assert ep == pytest.approx(e0, rel=1e-4)


def test_violation_stats_semantics():
    r = two_bead_restraints(5.0)
    # satisfied (within +relax)
    sat, tot, dev = violation_stats(jnp.asarray([[0.0, 0, 0], [5.2, 0, 0]]), r)
    assert (int(sat), int(tot)) == (1, 1) and float(dev) == pytest.approx(0.0)
    # too long: not satisfied, sum_dev = d - hi
    sat, tot, dev = violation_stats(jnp.asarray([[0.0, 0, 0], [8.0, 0, 0]]), r)
    assert int(sat) == 0 and float(dev) == pytest.approx(3.0, rel=1e-4)
    # too short: the reference *decrements* (count can go negative, :447-485)
    sat, tot, dev = violation_stats(jnp.asarray([[0.0, 0, 0], [1.0, 0, 0]]), r)
    assert int(sat) == 0  # +1 for d < hi+relax, -1 for d < lo-relax
    assert float(dev) == pytest.approx(4.0, rel=1e-4)


def test_angle_term():
    """Chain-stiffness term: zero for a straight chain, positive for a bent
    one, and its gradient straightens the chain. Off (weight 0) it changes
    nothing."""
    import jax
    import jax.numpy as jnp

    from chromosome3d.ops.energy import (
        DenseRestraints,
        EnergyWeights,
        energy,
        energy_terms,
    )

    L = 8
    z = jnp.zeros((L, L), jnp.float32)
    r = DenseRestraints(lo=z, hi=z, mask=z, weight=z)
    w0 = EnergyWeights(
        noe=jnp.float32(0.0), bond=jnp.float32(0.0),
        bond_length=jnp.float32(3.8), vdw=jnp.float32(0.0),
        vdw_radius=jnp.float32(0.0), angle=jnp.float32(2.0),
    )
    straight = jnp.stack(
        [jnp.arange(L) * 3.8, jnp.zeros(L), jnp.zeros(L)], axis=-1
    ).astype(jnp.float32)
    assert float(energy(straight, r, w0)) == pytest.approx(0.0, abs=1e-5)

    rng = np.random.RandomState(0)
    bent = straight + jnp.asarray(rng.randn(L, 3) * 1.5, jnp.float32)
    e_bent = float(energy(bent, r, w0))
    assert e_bent > 0.1
    # gradient descent on the angle term alone reduces bending
    g = jax.grad(energy)(bent, r, w0)
    e_after = float(energy(bent - 0.1 * g, r, w0))
    assert e_after < e_bent
    # reported inside the bonded term; off at weight 0
    terms = energy_terms(bent, r, w0)
    assert float(terms["bon"]) == pytest.approx(e_bent, rel=1e-6)
    w_off = w0._replace(angle=jnp.float32(0.0))
    assert float(energy(bent, r, w_off)) == pytest.approx(0.0, abs=1e-5)


def test_chunked_terms_match_dense():
    """energy_terms_chunked == energy_terms on every restraint form / option
    combination the final-terms pass can see: dense windowed bounds, the
    two-tensor exact form, bead-mask padding, finite rswitch, or-groups, and
    a prime L (row_chunk falls back to the full width)."""
    from chromosome3d.ops.energy import (
        ExactRestraints,
        OrGroupRestraints,
        energy_terms_chunked,
    )

    rng = np.random.RandomState(7)

    def rand_dense(L, windowed):
        t = np.abs(rng.randn(L, L)).astype(np.float32) * 5 + 3
        t = (t + t.T) / 2
        mask = (rng.rand(L, L) < 0.4)
        mask = np.triu(mask, 1)
        mask = mask | mask.T
        t = np.where(mask, t, 0.0).astype(np.float32)
        dev = (np.abs(rng.randn(L, L)).astype(np.float32) * 0.5) if windowed else 0.0
        dev = (dev + np.transpose(dev)) / 2 if windowed else 0.0
        w = np.where(mask, 1.0 + rng.rand(L, L), 0.0).astype(np.float32)
        w = ((w + w.T) / 2 * mask).astype(np.float32)
        return DenseRestraints(
            lo=jnp.asarray(t - dev), hi=jnp.asarray(t + dev),
            mask=jnp.asarray(mask, jnp.float32), weight=jnp.asarray(w),
        )

    w_full = simple_weights(noe=2.0, bond=1.5, vdw=0.7, noe_rswitch=1.2)
    for L, chunk in [(24, 8), (13, 8)]:   # 13 is prime: full-width fallback
        coords = jnp.asarray(rng.randn(L, 3).astype(np.float32) * 4)
        bead = np.ones(L, np.float32)
        bead[-2:] = 0.0
        bead = jnp.asarray(bead)
        dense = rand_dense(L, windowed=True)
        og = OrGroupRestraints(
            idx_i=jnp.asarray([[0, 2], [1, 1]], jnp.int32),
            idx_j=jnp.asarray([[5, 7], [6, 6]], jnp.int32),
            member=jnp.asarray([[1.0, 1.0], [1.0, 0.0]], jnp.float32),
            lo=jnp.asarray([2.0, 3.0], jnp.float32),
            hi=jnp.asarray([4.0, 5.0], jnp.float32),
            weight=jnp.asarray([1.0, 2.0], jnp.float32),
        )
        ref = energy_terms(coords, dense, w_full, bead, og)
        got = energy_terms_chunked(
            coords, dense, w_full, bead, og, row_chunk=chunk
        )
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)

        # two-tensor exact form, pure-quadratic well
        w_exact = simple_weights(noe=2.0, bond=1.5, vdw=0.7)
        t = np.asarray(dense.lo) * np.asarray(dense.mask)
        ex = ExactRestraints(
            target=jnp.asarray(t),
            w=jnp.asarray(np.asarray(dense.mask) * np.asarray(dense.weight)),
        )
        dense_eq = DenseRestraints(
            lo=ex.target, hi=ex.target, mask=dense.mask, weight=dense.weight
        )
        ref = energy_terms(coords, dense_eq, w_exact, bead)
        got = energy_terms_chunked(coords, ex, w_exact, bead, row_chunk=chunk)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)
