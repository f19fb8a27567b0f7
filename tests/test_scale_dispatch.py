"""At-scale product-surface dispatch: inputs beyond the largest length
bucket must reach the row-sharded solvers straight from run_pipeline /
run_genome (VERDICT round-2 item 1), on the 8-fake-device CPU mesh."""

import os

import numpy as np
import pytest

from chromosome3d.config import (
    AnnealConfig,
    PipelineConfig,
    RestraintConfig,
    fast_anneal,
)


def scale_cfg(**kw):
    # alpha=0.5 matches structured_matrix's IF ~ 1/d^2 (restraint distances
    # then track true geometry), so quality asserts are meaningful even on
    # the 5%-length test schedule
    return PipelineConfig(
        model_count=kw.pop("model_count", 2),
        restraints=RestraintConfig(alpha=0.5),
        anneal=fast_anneal(AnnealConfig(), 0.05),
        length_buckets=kw.pop("length_buckets", (32,)),
        shard_quantum=kw.pop("shard_quantum", 32),
        **kw,
    )


def structured_matrix(L: int, seed: int = 0) -> np.ndarray:
    """IF matrix derived from a real 3D curve (noisy helix), so
    reconstruction quality is measurable (IF ~ 1/d^2)."""
    rng = np.random.RandomState(seed)
    t = np.arange(L) * 0.4
    coords = np.stack(
        [8 * np.cos(t), 8 * np.sin(t), 1.5 * t], axis=-1
    ) + 0.3 * rng.randn(L, 3)
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    np.fill_diagonal(d, 1.0)
    m = 2000.0 / d**2
    np.fill_diagonal(m, 50000.0)
    return m


def test_bucket_pad_dynamic_quantum():
    from chromosome3d.pipeline import _bucket_pad

    cfg = scale_cfg()
    L_pad, bm = _bucket_pad(70, cfg)
    assert L_pad == 96 and bm is not None and bm.sum() == 70
    cfg_off = scale_cfg(shard_large=False)
    L_pad2, bm2 = _bucket_pad(70, cfg_off)
    assert L_pad2 == 70 and bm2 is None


def test_bucket_jobs_quantum_and_raise(tmp_path):
    from chromosome3d.parallel.genome import GenomeJob, bucket_jobs

    p = tmp_path / "chrX_1mb_matrix.txt"
    np.savetxt(p, structured_matrix(70), fmt="%.2f")
    jobs = [GenomeJob(name="chrX_1mb", path=str(p))]
    out = bucket_jobs(jobs, (32,), shard_quantum=32)
    assert list(out) == [96]
    jobs2 = [GenomeJob(name="chrX_1mb", path=str(p))]
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        bucket_jobs(jobs2, (32,))


def test_large_mesh_layout():
    from chromosome3d.parallel.genome import large_mesh_layout

    assert large_mesh_layout(1, 8) == (1, 8)
    assert large_mesh_layout(3, 8) == (2, 4)
    assert large_mesh_layout(8, 8) == (8, 1)
    assert large_mesh_layout(5, 8) == (4, 2)


def test_run_pipeline_dispatches_sharded(tmp_path, monkeypatch):
    """An L=96 input with a 32-bucket config must route through
    _sharded_solve over the 8-device mesh and still produce the full
    artifact set with real reconstruction quality."""
    import chromosome3d.pipeline as pl

    calls = []
    real = pl._sharded_solve

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pl, "_sharded_solve", spy)
    src = tmp_path / "big_matrix.txt"
    np.savetxt(src, structured_matrix(96), fmt="%.3f")
    out = str(tmp_path / "out")
    summary = pl.run_pipeline(str(src), out, scale_cfg())
    assert calls, "sharded path not taken"
    assert summary["L"] == 96 and summary["models"] == 2
    # a structured matrix must reconstruct well even on the tiny schedule
    assert summary["best_spearman_if_inv_d"] > 0.7
    from chromosome3d.io.pdb import read_ca_pdb

    coords = read_ca_pdb(os.path.join(out, "big_matrix_model1.pdb"))
    assert coords.shape == (96, 3)
    assert np.isfinite(coords).all()


def test_run_pipeline_shard_large_off_keeps_plain_path(tmp_path, monkeypatch):
    import chromosome3d.pipeline as pl

    monkeypatch.setattr(
        pl, "_sharded_solve",
        lambda *a, **k: pytest.fail("sharded path taken with shard_large=False"),
    )
    src = tmp_path / "big_matrix.txt"
    np.savetxt(src, structured_matrix(48), fmt="%.3f")
    summary = pl.run_pipeline(
        str(src), str(tmp_path / "out"), scale_cfg(shard_large=False)
    )
    assert summary["L"] == 48


def test_run_genome_mixed_scale(tmp_path, monkeypatch):
    """A genome dir mixing a small (bucketed) and a large (beyond-bucket)
    chromosome must complete in one launch: the small one through
    solve_bucket, the large one through the 2-D chrom x beads sharded
    solver."""
    import chromosome3d.parallel.genome as gn

    small = structured_matrix(24, seed=1)
    large = structured_matrix(96, seed=2)
    indir = tmp_path / "input"
    indir.mkdir()
    np.savetxt(indir / "chr1_1mb_matrix.txt", small, fmt="%.3f")
    np.savetxt(indir / "chr2_1mb_matrix.txt", large, fmt="%.3f")

    sharded_calls, plain_calls = [], []
    # exact matrix buckets take the IF->device route (late round 4); the
    # host-restraint sharded entry remains for non-exact at-scale buckets
    real_sharded, real_plain = gn.solve_bucket_sharded_from_if, gn.solve_bucket
    monkeypatch.setattr(
        gn, "solve_bucket_sharded_from_if",
        lambda *a, **k: (sharded_calls.append(1), real_sharded(*a, **k))[1],
    )
    monkeypatch.setattr(
        gn, "solve_bucket",
        lambda *a, **k: (plain_calls.append(1), real_plain(*a, **k))[1],
    )
    # the at-scale bucket must never host-build restraints (_stack_bucket
    # binds genome.py's module-global name)
    real_build = gn.build_restraints
    build_lengths = []
    monkeypatch.setattr(
        gn, "build_restraints",
        lambda m, rc: (build_lengths.append(m.shape[0]), real_build(m, rc))[1],
    )
    out = str(tmp_path / "out")
    summaries = gn.run_genome(str(indir), out, scale_cfg())
    assert sharded_calls and plain_calls
    assert 24 in build_lengths, "small bucket should use the host route"
    assert 96 not in build_lengths, "at-scale bucket host-built restraints"
    assert summaries["chr1_1mb"]["L"] == 24
    assert summaries["chr2_1mb"]["L"] == 96
    assert summaries["chr2_1mb"]["best_spearman_if_inv_d"] > 0.7
    assert os.path.exists(os.path.join(out, "chr2_1mb", "chr2_1mb_model1.pdb"))


def test_genome_sharded_matches_plain_bucket(tmp_path):
    """The at-scale solver and the plain batched solver are different
    programs over the same protocol: on the same input they must deliver
    comparable quality (not identical trajectories — init and RNG
    assignment differ by design)."""
    from chromosome3d.parallel.genome import (
        solve_bucket,
        solve_bucket_sharded,
    )
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints
    import jax.numpy as jnp

    cfg = scale_cfg()
    m = structured_matrix(96, seed=3)
    r = build_restraints(m, cfg.restraints)
    dense = dense_restraints_from_numpy(
        r, cfg.restraints.weighting, as_numpy=True
    )
    batched = type(dense)(*(jnp.asarray(t)[None] for t in dense))
    masks = jnp.ones((1, 96), jnp.float32)
    res_sharded = solve_bucket_sharded(batched, masks, cfg)
    assert res_sharded.coords.shape == (1, 2, 96, 3)
    assert bool(jnp.isfinite(res_sharded.coords).all())
    from chromosome3d.metrics import spearman_if_inv_d

    scores = [
        spearman_if_inv_d(m, np.asarray(res_sharded.coords[0, i]))
        for i in range(2)
    ]
    assert max(scores) > 0.7


def test_run_genome_resume_with_large_bucket(tmp_path):
    """Checkpoint/resume must cover at-scale (sharded) buckets: a second
    run with resume=True returns every summary without re-solving."""
    import chromosome3d.parallel.genome as gn

    indir = tmp_path / "input"
    indir.mkdir()
    np.savetxt(indir / "chr1_1mb_matrix.txt", structured_matrix(24, seed=4),
               fmt="%.3f")
    np.savetxt(indir / "chr2_1mb_matrix.txt", structured_matrix(96, seed=5),
               fmt="%.3f")
    out = str(tmp_path / "out")
    cfg = scale_cfg()
    first = gn.run_genome(str(indir), out, cfg)
    assert set(first) == {"chr1_1mb", "chr2_1mb"}

    import unittest.mock as mock

    with mock.patch.object(
        gn, "solve_bucket_sharded",
        side_effect=AssertionError("resume must not re-solve"),
    ), mock.patch.object(
        gn, "solve_bucket",
        side_effect=AssertionError("resume must not re-solve"),
    ):
        again = gn.run_genome(str(indir), out, cfg, resume=True)
    assert set(again) == {"chr1_1mb", "chr2_1mb"}
    assert again["chr2_1mb"]["L"] == 96


def test_sharded_solve_program_memoized(tmp_path, monkeypatch):
    """Repeated at-scale solves with the same shape/config reuse one
    compiled program (a long-lived server must not retrace per request)."""
    import jax

    import chromosome3d.pipeline as pl

    builds = []
    import chromosome3d.utils.aot as aot

    real = aot.load_or_compile

    def spy(jitted, args, **kw):
        builds.append(kw.get("tag"))
        return real(jitted, args, **kw)

    monkeypatch.setattr(pl, "load_or_compile", spy, raising=False)
    # pipeline imports load_or_compile inside the function; patch the module
    monkeypatch.setattr(aot, "load_or_compile", spy)
    pl._SHARDED_PROGRAMS.clear()

    cfg = scale_cfg()
    from chromosome3d.restraints import build_restraints

    m = structured_matrix(96, seed=9)
    r = build_restraints(m, cfg.restraints)
    r1, _ = pl._sharded_solve(r, cfg.restraints, cfg, jax.random.PRNGKey(0), 2)
    n_builds = len(builds)
    assert n_builds == 1
    r2, _ = pl._sharded_solve(r, cfg.restraints, cfg, jax.random.PRNGKey(1), 2)
    assert len(builds) == n_builds  # no retrace/rebuild
    assert np.isfinite(np.asarray(r2.coords)).all()
    pl._SHARDED_PROGRAMS.clear()


def test_restraints_pipeline_or_groups_dispatch_sharded(tmp_path, monkeypatch):
    """Round-4 item: an at-scale external tbl WITH or-group rows (and a
    beyond-bucket L) must keep the row-sharded path, not silently fall back
    to the single-program padded solve."""
    import chromosome3d.pipeline as pl

    L = 48
    lines = [
        f"assign (resid {i:3d} and name ca) (resid {i + 1:3d} and name ca)"
        f"  3.80 0.00 0.00"
        for i in range(1, L)
    ]
    lines.append(
        "assign ((resid 2 and name ca) or (resid 3 and name ca)) "
        f"(resid {L - 2} and name ca) 5.00 0.50 0.50"
    )
    tbl = tmp_path / "big_groups.tbl"
    tbl.write_text("\n".join(lines) + "\n")

    calls = []
    real = pl._sharded_solve

    def spy(restraints, rc, cfg, key, n_models, or_groups_np=None, conf=None):
        calls.append({"og": or_groups_np is not None})
        return real(restraints, rc, cfg, key, n_models,
                    or_groups_np=or_groups_np, conf=conf)

    monkeypatch.setattr(pl, "_sharded_solve", spy)
    summary = pl.run_restraints_pipeline(
        str(tbl), str(tmp_path / "out"), scale_cfg()
    )
    assert calls and calls[0]["og"], "or-group tbl did not take the sharded path"
    assert summary["or_groups"] == 1
    assert summary["L_solved"] % len(__import__("jax").devices()) == 0
    assert (tmp_path / "out" / "big_groups_model1.pdb").exists()


def test_restraints_pipeline_never_device_preps(tmp_path, monkeypatch):
    """External restraint files must keep the HOST prep route even at scale:
    device prep recovers the restraint mask as target > 0, and an external
    exact row with target 0 (legal in a CNS tbl) would silently vanish.
    run_restraints_pipeline therefore never passes device_prep=True."""
    import chromosome3d.ops.device_prep as dp
    import chromosome3d.pipeline as pl

    L = 48
    lines = [
        f"assign (resid {i:3d} and name ca) (resid {i + 1:3d} and name ca)"
        f"  3.80 0.00 0.00"
        for i in range(1, L)
    ]
    tbl = tmp_path / "big_plain.tbl"
    tbl.write_text("\n".join(lines) + "\n")

    calls = []
    real = dp.exact_tiles_from_target_device

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(dp, "exact_tiles_from_target_device", spy)
    summary = pl.run_restraints_pipeline(
        str(tbl), str(tmp_path / "out_np"), scale_cfg()
    )
    assert not calls, "external restraint file took the device-prep route"
    assert summary["L_solved"] % len(__import__("jax").devices()) == 0
    assert (tmp_path / "out_np" / "big_plain_model1.pdb").exists()


def test_restraints_pipeline_conf_rr_dispatch_sharded(tmp_path, monkeypatch):
    """An at-scale .rr with non-unit confidences keeps the sharded path;
    conf folds into the stress weights."""
    import chromosome3d.pipeline as pl

    L = 48
    rows = [f"{i} {i + 1} 3.80 3.80 0.9\n" for i in range(1, L)]
    rows.append(f"1 {L} 20.00 20.00 0.5\n")
    rr = tmp_path / "big_conf.rr"
    rr.write_text("".join(rows))

    calls = []
    real = pl._sharded_solve

    def spy(restraints, rc, cfg, key, n_models, or_groups_np=None, conf=None):
        calls.append({"conf": conf is not None})
        return real(restraints, rc, cfg, key, n_models,
                    or_groups_np=or_groups_np, conf=conf)

    monkeypatch.setattr(pl, "_sharded_solve", spy)
    summary = pl.run_restraints_pipeline(
        str(rr), str(tmp_path / "out"), scale_cfg()
    )
    assert calls and calls[0]["conf"], "conf rr did not take the sharded path"
    assert summary["restraints"] == L


def test_at_scale_bucket_tiles_born_distributed(monkeypatch):
    """The at-scale genome bucket's (B, L, L) tensors must reach the 2-D
    mesh program DISTRIBUTED (device_put to per-device (chrom, beads) row
    slices), never materialized whole on one device — the single-device
    HBM ceiling the sharded bucket exists to break (ROADMAP round-4 #3)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import chromosome3d.parallel.genome as gn
    import chromosome3d.utils.aot as aot
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.restraints import build_restraints

    cfg = scale_cfg()
    m = structured_matrix(96, seed=7)
    r = build_restraints(m, cfg.restraints)
    dense = dense_restraints_from_numpy(
        r, cfg.restraints.weighting, as_numpy=True
    )
    # host-numpy batch: what _stack_bucket(as_numpy=True) hands over
    batched = type(dense)(*(np.asarray(t)[None] for t in dense))
    assert isinstance(batched[0], np.ndarray)
    masks = np.ones((1, 96), np.float32)

    captured = {}
    real = aot.load_or_compile

    def spy(fn, args, **kw):
        captured["args"] = args
        return real(fn, args, **kw)

    monkeypatch.setattr(aot, "load_or_compile", spy)
    res = gn.solve_bucket_sharded(batched, masks, cfg)
    assert res.coords.shape == (1, 2, 96, 3)
    assert bool(np.isfinite(np.asarray(res.coords)).all())

    bp, keys, mp = captured["args"]
    n_dev = len(jax.devices())
    nc, nb = gn.large_mesh_layout(1, n_dev)
    for t in bp:
        sh = t.sharding
        assert isinstance(sh, NamedSharding)
        assert sh.spec == P("chrom", "beads", None)
        assert dict(zip(sh.mesh.axis_names, sh.mesh.devices.shape)) == {
            "chrom": nc, "beads": nb,
        }
        B_pad, L_pad = t.shape[0], t.shape[1]
        # every device holds ONLY its row slice of the padded batch
        assert {s.data.shape for s in t.addressable_shards} == {
            (B_pad // nc, L_pad // nb, L_pad)
        }
    assert mp.sharding.spec == P("chrom", None)
    assert keys.sharding.spec == P("chrom", None)


def test_run_pipeline_at_scale_device_route(tmp_path, monkeypatch):
    """Beyond-bucket matrix runs take the device-prep route END TO END
    (late round 4): no host O(L^2) prep pass (if_to_dist /
    dist_to_restraints / build_restraints all forbidden), the O(L^2) text
    artifacts are suppressed, and the assessment views are the downloaded
    device tiles — bit-equal to the host route."""
    import chromosome3d.pipeline as pl
    import chromosome3d.restraints as rst

    m = structured_matrix(96, seed=11)
    cfg = scale_cfg()
    # host-route ground truth BEFORE the host prep is forbidden
    host = rst.dist_to_restraints(rst.if_to_dist(m, cfg.restraints),
                                  cfg.restraints)

    def boom(*a, **k):
        raise AssertionError("at-scale matrix run must not host-prep")

    monkeypatch.setattr(pl, "if_to_dist", boom)
    monkeypatch.setattr(pl, "dist_to_restraints", boom)
    monkeypatch.setattr(rst, "build_restraints", boom)

    src = tmp_path / "big_matrix.txt"
    np.savetxt(src, m, fmt="%.3f")
    out = str(tmp_path / "out")
    summary = pl.run_pipeline(str(src), out, cfg)
    assert summary["L"] == 96
    assert summary["restraints"] == host.count
    assert summary["best_spearman_if_inv_d"] > 0.7
    # O(L^2) text artifacts suppressed beyond the buckets...
    for suffix in (".dist", ".rr"):
        assert not os.path.exists(os.path.join(out, f"big_matrix{suffix}"))
    assert not os.path.exists(os.path.join(out, "contact.tbl"))
    # ...but the model/rank/report artifact set still emits fully
    for name in ("big_matrix_model1.pdb", "big_matrix_rank01_a05.pdb",
                 "contact_violation.txt", "spearman.txt", "summary.json"):
        assert os.path.exists(os.path.join(out, name)), name


def test_run_pipeline_at_scale_device_route_single_device(tmp_path, monkeypatch):
    """Same contract when only one device is available (the plain padded
    solver at the quantum bucket): device prep straight from the IF
    matrix, host views downloaded."""
    import chromosome3d.ops.device_prep as dp
    import chromosome3d.pipeline as pl
    import chromosome3d.restraints as rst

    m = structured_matrix(72, seed=12)
    cfg = scale_cfg()
    host = rst.dist_to_restraints(rst.if_to_dist(m, cfg.restraints),
                                  cfg.restraints)

    def boom(*a, **k):
        raise AssertionError("at-scale matrix run must not host-prep")

    monkeypatch.setattr(pl, "if_to_dist", boom)
    monkeypatch.setattr(pl, "dist_to_restraints", boom)
    monkeypatch.setattr(rst, "build_restraints", boom)
    monkeypatch.setattr(pl, "_use_sharded", lambda L, c: False)
    calls = []
    real = dp.exact_tiles_from_if_device

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(dp, "exact_tiles_from_if_device", spy)

    src = tmp_path / "big_matrix.txt"
    np.savetxt(src, m, fmt="%.3f")
    out = str(tmp_path / "out")
    summary = pl.run_pipeline(str(src), out, cfg)
    assert calls, "device-side IF prep was not used"
    assert summary["L"] == 72
    assert summary["restraints"] == host.count
    assert summary["best_spearman_if_inv_d"] > 0.7


def test_run_pipeline_sharded_bf16_stored(tmp_path, monkeypatch):
    """pair_bf16 at scale: the sharded dispatch builds bf16-STORED tiles
    for the solve (out_dtype reaches device prep) while the assessment
    view stays f32, and the run still reconstructs."""
    import dataclasses

    import jax.numpy as jnp

    import chromosome3d.ops.device_prep as dp
    import chromosome3d.pipeline as pl

    seen = []
    real = dp.exact_tiles_from_if_device

    def spy(*a, **k):
        r = real(*a, **k)
        seen.append((k.get("out_dtype", "float32"), r.target.dtype))
        return r

    monkeypatch.setattr(dp, "exact_tiles_from_if_device", spy)
    src = tmp_path / "big_matrix.txt"
    np.savetxt(src, structured_matrix(96), fmt="%.3f")
    cfg = scale_cfg()
    cfg = dataclasses.replace(
        cfg, anneal=dataclasses.replace(cfg.anneal, pair_bf16=True)
    )
    summary = pl.run_pipeline(str(src), str(tmp_path / "out"), cfg)
    assert summary["best_spearman_if_inv_d"] > 0.7
    assert any(d == "bfloat16" and t == jnp.bfloat16 for d, t in seen), seen
    assert any(t == jnp.float32 for _, t in seen), seen


def test_run_genome_at_scale_bf16_stored(tmp_path, monkeypatch):
    """pair_bf16 on a genome at-scale bucket: the SOLVE tiles are
    bf16-stored (the composed mesh's ceiling extender, like the run/solve/
    serve surfaces), the assessment view is a separate f32 re-prep (bf16
    targets must never reach the violation reports), and the run still
    reconstructs. Closes the surface asymmetry where run_genome silently
    ignored pair_bf16 at scale."""
    import dataclasses

    import jax.numpy as jnp

    import chromosome3d.parallel.genome as gn

    seen = []
    real = gn.bucket_tiles_from_if

    def spy(matrices, L_pad, rc, devices, out_dtype="float32", stack=None):
        r = real(matrices, L_pad, rc, devices, out_dtype, stack=stack)
        seen.append((out_dtype, r[0].target.dtype, stack is not None))
        return r

    monkeypatch.setattr(gn, "bucket_tiles_from_if", spy)
    indir = tmp_path / "input"
    indir.mkdir()
    np.savetxt(indir / "chr9_1mb_matrix.txt", structured_matrix(96, seed=9),
               fmt="%.3f")
    cfg = scale_cfg()
    cfg = dataclasses.replace(
        cfg, anneal=dataclasses.replace(cfg.anneal, pair_bf16=True)
    )
    out = str(tmp_path / "out")
    summaries = gn.run_genome(str(indir), out, cfg)
    assert summaries["chr9_1mb"]["best_spearman_if_inv_d"] > 0.7
    # solve prep bf16-stored, assessment view f32 — in that order
    assert [d for d, _, _ in seen] == ["bfloat16", "float32"], seen
    assert seen[0][1] == jnp.bfloat16 and seen[1][1] == jnp.float32, seen
    # both preps rode ONE prebuilt pad/stack (round-4 review: each call
    # was rebuilding the O(B*L'^2) host copy)
    assert all(s for _, _, s in seen), seen
    # the report targets came from the f32 view: spec distances carry the
    # %.1f quantization grid, which bf16 cannot represent
    report = os.path.join(out, "chr9_1mb", "contact_violation.txt")
    assert os.path.exists(report)


def test_run_genome_at_scale_single_device(tmp_path, monkeypatch):
    """On ONE device an at-scale exact bucket still takes the IF->device
    prep route (never per-chromosome host build_restraints, minutes at L
    in the thousands) through the (1, 1)-mesh degenerate of the composed
    solver, which runs the same per-shard pair code."""
    import jax
    from jax.sharding import Mesh

    import chromosome3d.parallel.genome as gn

    indir = tmp_path / "input"
    indir.mkdir()
    np.savetxt(indir / "chr5_1mb_matrix.txt", structured_matrix(96, seed=5),
               fmt="%.3f")
    build_lengths = []
    real_build = gn.build_restraints
    monkeypatch.setattr(
        gn, "build_restraints",
        lambda m, rc: (build_lengths.append(m.shape[0]), real_build(m, rc))[1],
    )
    mesh1 = Mesh(np.asarray(jax.devices()[:1]), ("chrom",))
    out = str(tmp_path / "out")
    s = gn.run_genome(str(indir), out, scale_cfg(), mesh=mesh1)
    assert 96 not in build_lengths, "single-device at-scale bucket host-built"
    assert s["chr5_1mb"]["L"] == 96
    assert s["chr5_1mb"]["best_spearman_if_inv_d"] > 0.7


def test_run_pipeline_at_scale_streamed_prep(tmp_path, monkeypatch):
    """With the prep HBM budget forced tiny, the at-scale single-device
    matrix run must stream BOTH the solve tiles and the f32 assessment view
    (strip programs, no one-shot (L, L) prep) and still reconstruct — the
    product surface needs no awareness of the one-shot ceiling."""
    import chromosome3d.ops.device_prep as dp
    import chromosome3d.pipeline as pl

    monkeypatch.setenv("CHROM3D_PREP_HBM_BUDGET", "1000")
    monkeypatch.setattr(pl, "_use_sharded", lambda L, c: False)
    tile_calls, view_calls = [], []
    real_t = dp.exact_tiles_from_if_streamed
    real_v = dp.assessment_view_from_if_streamed

    def spy_t(*a, **k):
        tile_calls.append(a)
        return real_t(*a, **k)

    def spy_v(*a, **k):
        view_calls.append(a)
        return real_v(*a, **k)

    monkeypatch.setattr(dp, "exact_tiles_from_if_streamed", spy_t)
    monkeypatch.setattr(dp, "assessment_view_from_if_streamed", spy_v)

    m = structured_matrix(72, seed=31)
    src = tmp_path / "big_matrix.txt"
    np.savetxt(src, m, fmt="%.3f")
    out = str(tmp_path / "out")
    summary = pl.run_pipeline(str(src), out, scale_cfg())
    assert tile_calls, "solve tiles must come from the streamed route"
    assert view_calls, "assessment view must come from the streamed route"
    assert summary["L"] == 72
    assert summary["best_spearman_if_inv_d"] > 0.7


def test_run_genome_at_scale_streamed_single_device(tmp_path, monkeypatch):
    """One huge chromosome, one device, pair_bf16, prep budget forced tiny:
    the genome bucket's solve tiles must come from the streamed route
    (lead_batch, no one-shot (B, L, L) program) and the f32 assessment
    view from the streamed downloads — run_genome end to end."""
    import dataclasses

    import jax

    import chromosome3d.ops.device_prep as dp
    import chromosome3d.parallel.genome as gn

    monkeypatch.setenv("CHROM3D_PREP_HBM_BUDGET", "1000")
    tile_calls, view_calls = [], []
    real_t = dp.exact_tiles_from_if_streamed
    real_v = dp.assessment_view_from_if_streamed

    def spy_t(*a, **k):
        tile_calls.append(k)
        return real_t(*a, **k)

    def spy_v(*a, **k):
        view_calls.append(a)
        return real_v(*a, **k)

    monkeypatch.setattr(dp, "exact_tiles_from_if_streamed", spy_t)
    monkeypatch.setattr(dp, "assessment_view_from_if_streamed", spy_v)

    indir = tmp_path / "input"
    indir.mkdir()
    np.savetxt(indir / "chr9_1mb_matrix.txt", structured_matrix(72, seed=41),
               fmt="%.3f")
    cfg = scale_cfg()
    cfg = dataclasses.replace(
        cfg, anneal=dataclasses.replace(cfg.anneal, pair_bf16=True)
    )
    out = str(tmp_path / "out")
    summaries = gn.run_genome(
        str(indir), out, cfg, mesh=gn.make_mesh(jax.devices()[:1])
    )
    assert tile_calls and tile_calls[0].get("lead_batch") is True
    assert view_calls, "f32 assessment must use the streamed view"
    assert summaries["chr9_1mb"]["L"] == 72
    assert summaries["chr9_1mb"]["best_spearman_if_inv_d"] > 0.7
