"""Ambiguous (`or`-group) restraints as SOLVER inputs.

The reference only *assesses* or-group tbl rows (ssnoe_tbl_min_pdb_dist,
chromosome3D.pl:487-554) — CNS itself solves them. Here they are first-class
solver inputs: read_contact_tbl_full parses them, ops.energy.or_group_energy
wells the group-min distance, and the annealer pulls the closest alternative
toward the target (gradient to the argmin pair only).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from chromosome3d.config import AnnealConfig
from chromosome3d.ops.energy import (
    EnergyWeights,
    OrGroupRestraints,
    dense_or_groups_from_numpy,
    dense_restraints_from_numpy,
    energy,
    or_group_energy,
)
from chromosome3d.restraints import (
    Restraints,
    read_contact_tbl,
    read_contact_tbl_full,
)

TBL = """\
assign45 (resid   1 and name ca) (resid   7 and name ca)  10.00 0.00 0.00
assign ((resid 2 and name ca) or (resid 3 and name ca)) (resid 9 and name ca) 5.00 0.50 0.50
assign (resid 4 and name ca) ((resid 8 and name ca) or (resid 10 and name ca)) 6.00 0.00 1.00
"""


def _weights(noe=1.0, rswitch=1e9):
    return EnergyWeights(
        noe=jnp.float32(noe),
        bond=jnp.float32(0.0),
        bond_length=jnp.float32(3.8),
        vdw=jnp.float32(0.0),
        vdw_radius=jnp.float32(0.0),
        noe_rswitch=jnp.float32(rswitch),
    )


def test_parse_tbl_with_groups(tmp_path):
    p = tmp_path / "g.tbl"
    p.write_text(TBL)
    r, og = read_contact_tbl_full(p)
    # simple row -> dense tensors (symmetric)
    assert r.length == 10
    assert r.mask[0, 6] and r.mask[6, 0]
    assert r.target[0, 6] == pytest.approx(10.0)
    assert r.count == 1
    # two group rows, cross products {2,3}x{9} and {4}x{8,10}, 0-based
    assert og is not None and og.count == 2
    assert og.idx_i[0].tolist()[:2] == [1, 2]
    assert og.idx_j[0].tolist()[:2] == [8, 8]
    assert og.member[0].tolist() == [1.0, 1.0]
    assert og.lo[0] == pytest.approx(4.5) and og.hi[0] == pytest.approx(5.5)
    assert og.idx_i[1].tolist()[:2] == [3, 3]
    assert og.idx_j[1].tolist()[:2] == [7, 9]
    assert og.lo[1] == pytest.approx(6.0) and og.hi[1] == pytest.approx(7.0)


def test_read_contact_tbl_rejects_groups(tmp_path):
    p = tmp_path / "g.tbl"
    p.write_text(TBL)
    with pytest.raises(ValueError, match="or-group"):
        read_contact_tbl(p, 10)


def test_or_group_energy_wells_the_min():
    # bead 0 at origin; alternatives at distances 3 and 8; target [4.5, 5.5]
    x = jnp.zeros((3, 3), jnp.float32)
    x = x.at[1, 0].set(3.0)
    x = x.at[2, 0].set(8.0)
    og = OrGroupRestraints(
        idx_i=jnp.asarray([[0, 0]], jnp.int32),
        idx_j=jnp.asarray([[1, 2]], jnp.int32),
        member=jnp.asarray([[1.0, 1.0]], jnp.float32),
        lo=jnp.asarray([4.5], jnp.float32),
        hi=jnp.asarray([5.5], jnp.float32),
        weight=jnp.asarray([2.0], jnp.float32),
    )
    e = or_group_energy(x, og, _weights(noe=10.0))
    # min distance = 3 -> viol = 1.5 -> e = 10 * 2 * 1.5^2
    assert float(e) == pytest.approx(10.0 * 2.0 * 1.5**2, rel=1e-5)

    # gradient flows ONLY to the argmin pair (beads 0 and 1)
    g = jax.grad(or_group_energy)(x, og, _weights(noe=10.0))
    g = np.asarray(g)
    assert np.abs(g[2]).max() == 0.0
    assert np.abs(g[1]).max() > 0.0
    # pulling apart: bead 1 is too close, so its x-gradient is negative
    # (energy decreases as bead 1 moves to larger x)
    assert g[1, 0] < 0.0


def test_or_group_invalid_members_and_padding_rows():
    x = jnp.asarray(np.random.RandomState(0).normal(0, 5, (6, 3)), jnp.float32)
    # row 0: second alternative masked out; row 1: all-invalid (padding)
    og = OrGroupRestraints(
        idx_i=jnp.asarray([[0, 1], [0, 0]], jnp.int32),
        idx_j=jnp.asarray([[3, 4], [0, 0]], jnp.int32),
        member=jnp.asarray([[1.0, 0.0], [0.0, 0.0]], jnp.float32),
        lo=jnp.asarray([2.0, 2.0], jnp.float32),
        hi=jnp.asarray([2.0, 2.0], jnp.float32),
        weight=jnp.asarray([1.0, 1.0], jnp.float32),
    )
    d03 = float(jnp.linalg.norm(x[0] - x[3]))
    e = or_group_energy(x, og, _weights())
    assert float(e) == pytest.approx((d03 - 2.0) ** 2, rel=1e-4)
    g = jax.grad(or_group_energy)(x, og, _weights())
    assert np.isfinite(np.asarray(g)).all()


def test_energy_includes_group_term():
    rng = np.random.RandomState(1)
    L = 12
    x = jnp.asarray(rng.normal(0, 4, (L, 3)), jnp.float32)
    t = np.zeros((L, L), np.float32)
    m = np.zeros((L, L), bool)
    t[0, 6] = t[6, 0] = 9.0
    m[0, 6] = m[6, 0] = True
    dense = dense_restraints_from_numpy(
        Restraints(t, np.zeros_like(t), np.zeros_like(t), m), "absolute"
    )
    og = OrGroupRestraints(
        idx_i=jnp.asarray([[1, 2]], jnp.int32),
        idx_j=jnp.asarray([[8, 8]], jnp.int32),
        member=jnp.asarray([[1.0, 1.0]], jnp.float32),
        lo=jnp.asarray([5.0], jnp.float32),
        hi=jnp.asarray([5.0], jnp.float32),
        weight=jnp.asarray([1.0], jnp.float32),
    )
    w = _weights()
    base = energy(x, dense, w)
    withg = energy(x, dense, w, or_groups=og)
    assert float(withg) == pytest.approx(
        float(base) + float(or_group_energy(x, og, w)), rel=1e-5
    )


def test_solver_satisfies_group_restraint():
    """A chain with one ambiguous restraint: the anneal pulls the CLOSEST
    alternative into the well and leaves the other free."""
    from chromosome3d.solver.anneal import solve_ensemble_impl

    L = 14
    # chain-neighbor targets keep the backbone sane
    t = np.zeros((L, L), np.float32)
    m = np.zeros((L, L), bool)
    for i in range(L - 1):
        t[i, i + 1] = t[i + 1, i] = 3.8
        m[i, i + 1] = m[i + 1, i] = True
    dense = dense_restraints_from_numpy(
        Restraints(t, np.zeros_like(t), np.zeros_like(t), m), "absolute"
    )
    og_np_idx = ([[0, 0]], [[6, 13]])
    og = OrGroupRestraints(
        idx_i=jnp.asarray(og_np_idx[0], jnp.int32),
        idx_j=jnp.asarray(og_np_idx[1], jnp.int32),
        member=jnp.asarray([[1.0, 1.0]], jnp.float32),
        lo=jnp.asarray([4.0], jnp.float32),
        hi=jnp.asarray([4.0], jnp.float32),
        weight=jnp.asarray([50.0], jnp.float32),
    )
    cfg = AnnealConfig(
        hot_steps=40, cool_cycles=20, cool_steps_per_cycle=2,
        final_steps=60, use_pallas=False, enantiomer=False, init="spiral",
    )
    res = solve_ensemble_impl(dense, cfg, jax.random.PRNGKey(0), 2, or_groups=og)
    x = np.asarray(res.coords)
    best = int(np.argmin(np.asarray(res.energies["overall"])))
    d_alt = [np.linalg.norm(x[best, 0] - x[best, j]) for j in (6, 13)]
    assert min(d_alt) == pytest.approx(4.0, abs=0.8)


def test_restraints_pipeline_with_group_tbl(tmp_path):
    """End-to-end: solve directly from a tbl containing or-group rows."""
    from chromosome3d.config import PipelineConfig
    from chromosome3d.pipeline import run_restraints_pipeline

    L = 12
    lines = []
    for i in range(1, L):
        lines.append(
            f"assign45 (resid {i:3d} and name ca) (resid {i + 1:3d} and name ca)"
            f"  3.80 0.00 0.00"
        )
    lines.append(
        "assign ((resid 1 and name ca) or (resid 2 and name ca)) "
        "(resid 9 and name ca) 5.00 0.00 0.00"
    )
    p = tmp_path / "amb.tbl"
    p.write_text("\n".join(lines) + "\n")

    cfg = PipelineConfig(
        model_count=2, top_k=1,
        anneal=AnnealConfig(
            hot_steps=30, cool_cycles=10, cool_steps_per_cycle=2,
            final_steps=40, use_pallas=False, enantiomer=False, init="spiral",
        ),
        length_buckets=(L,),
    )
    out = tmp_path / "out"
    summary = run_restraints_pipeline(str(p), str(out), cfg, L=L)
    assert summary["or_groups"] == 1
    assert summary["restraints"] == L - 1
    # group row counted by the tbl assessor: total covers all rows
    assert summary["total"] == L
    assert (out / "amb_model1.pdb").exists()


def test_group_term_composes_with_pallas_kernel():
    """The annealer's kernel+or-group composition — kernel pair energy+grad
    plus the jnp group term's value_and_grad — must equal the jnp energy path
    with or_groups (same batch, interpret-mode kernel on CPU)."""
    import chromosome3d.ops.pair as pair_mod
    from chromosome3d.ops.pair import pair_tiles

    L = 16
    rng = np.random.RandomState(3)
    t = np.zeros((L, L), np.float32)
    m = np.zeros((L, L), bool)
    for i in range(L - 1):
        t[i, i + 1] = t[i + 1, i] = 3.8
        m[i, i + 1] = m[i + 1, i] = True
    for _ in range(6):
        i, j = rng.randint(0, L, 2)
        if abs(i - j) >= 3:
            t[i, j] = t[j, i] = rng.uniform(5, 12)
            m[i, j] = m[j, i] = True
    dense = dense_restraints_from_numpy(
        Restraints(t, np.zeros_like(t), np.zeros_like(t), m), "absolute"
    )
    og = OrGroupRestraints(
        idx_i=jnp.asarray([[2, 3]], jnp.int32),
        idx_j=jnp.asarray([[10, 10]], jnp.int32),
        member=jnp.asarray([[1.0, 1.0]], jnp.float32),
        lo=jnp.asarray([4.5], jnp.float32),
        hi=jnp.asarray([4.5], jnp.float32),
        weight=jnp.asarray([5.0], jnp.float32),
    )
    w = _weights(noe=2.0)
    xb = jnp.asarray(rng.normal(0, 4, (3, L, 3)), jnp.float32)
    bead = jnp.ones((L,), jnp.float32)

    e_pair, g_pair = pair_mod.pair_energy_grad_batched(
        xb, pair_tiles(dense, True), bead, w, 0, True, True
    )
    bond_vg = jax.vmap(jax.value_and_grad(pair_mod.bonded_energy),
                       in_axes=(0, None, None))
    e_b, g_b = bond_vg(xb, bead, w)
    e_pair, g_pair = e_pair + e_b, g_pair + g_b
    _og_vg = jax.value_and_grad(or_group_energy)
    e_og, g_og = jax.vmap(lambda c: _og_vg(c, og, w, bead))(xb)
    e_pal, g_pal = e_pair + e_og, g_pair + g_og

    _jnp_vg = jax.value_and_grad(energy)
    e_ref, g_ref = jax.vmap(
        lambda c: _jnp_vg(c, dense, w, bead, og)
    )(xb)
    np.testing.assert_allclose(np.asarray(e_pal), np.asarray(e_ref), rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(g_pal), np.asarray(g_ref), rtol=1e-4, atol=1e-4
    )


def test_dense_or_groups_roundtrip(tmp_path):
    p = tmp_path / "g.tbl"
    p.write_text(TBL)
    _, og_np = read_contact_tbl_full(p)
    og = dense_or_groups_from_numpy(og_np)
    assert og.idx_i.dtype == jnp.int32
    assert og.lo.shape == (2,)


def test_violation_report_includes_group_rows(tmp_path):
    """The violation report covers EVERY tbl row: simple rows from the dense
    writer plus appended group-min rows (ref :447-485, :487-554)."""
    from chromosome3d.config import PipelineConfig
    from chromosome3d.pipeline import run_restraints_pipeline

    L = 12
    lines = [
        f"assign45 (resid {i:3d} and name ca) (resid {i + 1:3d} and name ca)"
        f"  3.80 0.00 0.00"
        for i in range(1, L)
    ]
    lines.append(
        "assign ((resid 1 and name ca) or (resid 2 and name ca)) "
        "(resid 9 and name ca) 5.00 0.00 0.00"
    )
    p = tmp_path / "amb.tbl"
    p.write_text("\n".join(lines) + "\n")
    cfg = PipelineConfig(
        model_count=2, top_k=1,
        anneal=AnnealConfig(
            hot_steps=30, cool_cycles=10, cool_steps_per_cycle=2,
            final_steps=40, use_pallas=False, enantiomer=False, init="spiral",
        ),
        length_buckets=(L,),
    )
    out = tmp_path / "out"
    summary = run_restraints_pipeline(str(p), str(out), cfg, L=L)
    report = (out / "amb_violation.txt").read_text()
    rows = [ln for ln in report.splitlines() if not ln.startswith("#")]
    assert len(rows) == L  # 11 simple + 1 group
    assert sum(" or " in ln for ln in rows) == 1
    assert summary["total"] == L


def test_parser_tolerates_malformed_lines(tmp_path):
    """Robustness: junk lines, comments, blank lines, missing tails, and
    unbalanced parens must not crash the parser or corrupt parsed rows."""
    p = tmp_path / "junk.tbl"
    p.write_text(
        "! comment line\n"
        "\n"
        "assign (resid 1 and name ca) (resid 5 and name ca) 7.00 0.00 0.00\n"
        "assign (resid 2 and name ca) (resid 6 and name ca)\n"          # no tail
        "assign (resid 3 and name ca\n"                                  # unbalanced
        "garbage that is not a restraint\n"
        "assign ((resid 4 and name ca) or (resid 7 and name ca)) "
        "(resid 9 and name ca) 6.00 0.00 0.00\n"
    )
    r, og = read_contact_tbl_full(p)
    assert r.count == 1
    assert og is not None and og.count == 1
    assert r.target[0, 4] == pytest.approx(7.0)


def test_parenless_tbl_rows_parse(tmp_path):
    """The paren-less layout (`assign45 resid I and name ca resid J ...`)
    that the old fixed-index parser accepted must still parse (review
    finding: the group scanner swallowed the second selection)."""
    p = tmp_path / "flat.tbl"
    p.write_text(
        "assign45  resid 4 and name ca   resid 12 and name ca  8.00 0.10 0.10\n"
        "assign resid 2 and name ca resid 7 and name ca 5.50 0.00 0.00\n"
    )
    r, og = read_contact_tbl_full(p)
    assert og is None
    assert r.count == 2
    assert r.target[3, 11] == pytest.approx(8.0)
    assert r.negdev[3, 11] == pytest.approx(0.1)
    assert r.target[1, 6] == pytest.approx(5.5)


def test_out_of_range_resid_raises(tmp_path):
    """An explicit L smaller than the tbl's residues errors instead of
    silently clamping on-device gathers to the wrong bead."""
    p = tmp_path / "big.tbl"
    p.write_text(
        "assign ((resid 1 and name ca) or (resid 2 and name ca)) "
        "(resid 50 and name ca) 6.00 0.00 0.00\n"
    )
    with pytest.raises(ValueError, match="resid 50"):
        read_contact_tbl_full(p, L=40)


def test_tbl_report_counts_every_row(tmp_path):
    """Per-TBL-ROW assessment like the reference: duplicate rows and
    reversed (j, i) rows each count individually (count_satisfied_tbl_rows
    iterates the file, ref :447-485)."""
    from chromosome3d.config import PipelineConfig
    from chromosome3d.assess import write_tbl_violation_report

    tbl = tmp_path / "dup.tbl"
    tbl.write_text(
        "assign (resid 1 and name ca) (resid 5 and name ca) 7.00 0.00 0.00\n"
        "assign (resid 1 and name ca) (resid 5 and name ca) 7.00 0.00 0.00\n"
        "assign (resid 5 and name ca) (resid 1 and name ca) 7.00 0.00 0.00\n"
    )
    coords = np.zeros((6, 3), np.float32)
    coords[4, 0] = 7.0  # beads 0 and 4 exactly at target
    sat, total = write_tbl_violation_report(
        tmp_path / "rep.txt", coords, tbl, PipelineConfig()
    )
    assert total == 3 and sat == 3
    rows = [
        ln for ln in (tmp_path / "rep.txt").read_text().splitlines()
        if not ln.startswith("#")
    ]
    assert len(rows) == 3


def test_parenless_truncated_tail_skipped(tmp_path):
    """A paren-less row with a truncated numeric tail is skipped — resid
    numbers must not leak into d/neg/pos (review finding)."""
    from chromosome3d.assess import parse_tbl_rows

    p = tmp_path / "trunc.tbl"
    p.write_text(
        "assign resid 3 and name ca resid 9 and name ca 6.5\n"   # no neg/pos
        "assign resid 3 and name ca resid 9 and name ca 6.5 0.1 0.2\n"
    )
    rows = parse_tbl_rows(p)
    assert len(rows) == 1
    g1, g2, d, nd, pd = rows[0]
    assert (d, nd, pd) == (6.5, 0.1, 0.2)


def test_sharded_ensemble_with_groups_matches_single_chip():
    """Round-4 item: the sharded ensemble accepts or-groups (replicated
    group term, no collectives) and reproduces the single-chip solve."""
    import dataclasses

    from jax.sharding import Mesh

    from chromosome3d.config import fast_anneal
    from chromosome3d.solver.anneal import solve_ensemble_impl
    from chromosome3d.solver.sharded import solve_ensemble_sharded

    n_dev = len(jax.devices())
    L = 16 * n_dev
    t = np.zeros((L, L), np.float32)
    m = np.zeros((L, L), bool)
    for i in range(L - 1):
        t[i, i + 1] = t[i + 1, i] = 3.8
        m[i, i + 1] = m[i + 1, i] = True
    rng = np.random.RandomState(7)
    for _ in range(3 * L):
        i, j = sorted(rng.choice(L, 2, replace=False))
        if j - i >= 3:
            t[i, j] = t[j, i] = rng.uniform(5, 25)
            m[i, j] = m[j, i] = True
    dense = dense_restraints_from_numpy(
        Restraints(t, np.zeros_like(t), np.zeros_like(t), m), "absolute"
    )
    og = OrGroupRestraints(
        idx_i=jnp.asarray([[2, 3], [5, 5]], jnp.int32),
        idx_j=jnp.asarray([[L - 3, L - 3], [L - 8, L - 1]], jnp.int32),
        member=jnp.asarray([[1.0, 1.0], [1.0, 1.0]], jnp.float32),
        lo=jnp.asarray([4.5, 6.0], jnp.float32),
        hi=jnp.asarray([5.5, 6.0], jnp.float32),
        weight=jnp.asarray([5.0, 3.0], jnp.float32),
    )
    cfg = dataclasses.replace(
        fast_anneal(AnnealConfig()), init="landmark", use_pallas=False,
        exact_restraints=True,
    )
    key = jax.random.PRNGKey(21)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    rs = jax.jit(
        lambda d, k, og_: solve_ensemble_sharded(
            mesh, d, cfg, k, 2, or_groups=og_
        )
    )(dense, key, og)
    rd = solve_ensemble_impl(dense, cfg, key, 2, or_groups=og)
    np.testing.assert_allclose(
        np.asarray(rs.coords), np.asarray(rd.coords), rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(rs.energies["noe"]), np.asarray(rd.energies["noe"]),
        rtol=1e-4,
    )


def test_semi_fused_og_matches_unfused_zero_noise(interpret_kernel):
    """The kernel path carries or-groups beside the pair kernel: with zero
    noise it must track the plain-path or-group solve trajectory."""
    import dataclasses

    from chromosome3d.config import fast_anneal
    from chromosome3d.solver.anneal import solve_ensemble_impl

    L = 44
    t = np.zeros((L, L), np.float32)
    m = np.zeros((L, L), bool)
    for i in range(L - 1):
        t[i, i + 1] = t[i + 1, i] = 3.8
        m[i, i + 1] = m[i + 1, i] = True
    rng = np.random.RandomState(8)
    for _ in range(80):
        i, j = sorted(rng.choice(L, 2, replace=False))
        if j - i >= 3:
            t[i, j] = t[j, i] = rng.uniform(5, 20)
            m[i, j] = m[j, i] = True
    dense = dense_restraints_from_numpy(
        Restraints(t, np.zeros_like(t), np.zeros_like(t), m), "absolute"
    )
    og = OrGroupRestraints(
        idx_i=jnp.asarray([[2, 3]], jnp.int32),
        idx_j=jnp.asarray([[30, 30]], jnp.int32),
        member=jnp.asarray([[1.0, 1.0]], jnp.float32),
        lo=jnp.asarray([4.5], jnp.float32),
        hi=jnp.asarray([4.5], jnp.float32),
        weight=jnp.asarray([5.0], jnp.float32),
    )
    base = fast_anneal(AnnealConfig(), 0.1)
    cfg_semi = dataclasses.replace(
        base, use_pallas=True, exact_restraints=True,
        noise_scale=0.0, init="spiral", enantiomer=False,
    )
    cfg_ref = dataclasses.replace(cfg_semi, use_pallas=False)
    key = jax.random.PRNGKey(5)
    res_semi = solve_ensemble_impl(dense, cfg_semi, key, 2, or_groups=og)
    res_ref = solve_ensemble_impl(dense, cfg_ref, key, 2, or_groups=og)
    np.testing.assert_allclose(
        np.asarray(res_semi.coords), np.asarray(res_ref.coords),
        rtol=1e-3, atol=2e-3,
    )
    np.testing.assert_allclose(
        np.asarray(res_semi.energies["overall"]),
        np.asarray(res_ref.energies["overall"]), rtol=1e-4,
    )
