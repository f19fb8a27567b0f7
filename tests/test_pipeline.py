"""End-to-end pipeline + genome-runner tests (artifact presence + formats),
run with the reduced schedule on the 8-fake-device CPU mesh."""

import json
import os

import numpy as np
import pytest

from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal

REF_INPUT = "/root/reference/input"


def fast_cfg(**kw):
    return PipelineConfig(
        model_count=kw.pop("model_count", 4),
        restraints=RestraintConfig(alpha=1.1),
        anneal=fast_anneal(AnnealConfig()),
        length_buckets=kw.pop("length_buckets", (64, 128, 256, 512)),
        **kw,
    )


@pytest.fixture(scope="module")
def pipeline_out(tmp_path_factory):
    from chromosome3d.pipeline import run_pipeline

    src = os.path.join(REF_INPUT, "chr22_1mb_matrix.txt")
    if not os.path.exists(src):
        pytest.skip("reference not available")
    out = str(tmp_path_factory.mktemp("chr22_out"))
    summary = run_pipeline(src, out, fast_cfg())
    return out, summary


def test_pipeline_artifacts(pipeline_out):
    out, summary = pipeline_out
    ident = "chr22_1mb_matrix"
    expected = [
        f"{ident}.txt",
        f"{ident}.dist",
        f"{ident}.rr",
        "contact.tbl",
        "contact_violation.txt",
        "model_info.log",
        "spearman.txt",
        "summary.json",
        f"{ident}_model1.pdb",
        f"{ident}_rank01_a11.pdb",
    ]
    for name in expected:
        assert os.path.exists(os.path.join(out, name)), f"missing {name}"
    assert not os.path.exists(os.path.join(out, "iam.running"))
    assert not os.path.exists(os.path.join(out, "iam.failed"))


def test_pipeline_summary_sane(pipeline_out):
    out, summary = pipeline_out
    assert summary["L"] == 35
    assert summary["models"] == 4
    assert summary["restraints"] > 200
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f)["L"] == 35


def test_pipeline_models_readable(pipeline_out):
    from chromosome3d.io.pdb import read_ca_pdb, read_pdb_remarks

    out, _ = pipeline_out
    coords = read_ca_pdb(os.path.join(out, "chr22_1mb_matrix_model1.pdb"))
    assert coords.shape == (35, 3)
    rem = read_pdb_remarks(os.path.join(out, "chr22_1mb_matrix_model1.pdb"))
    assert "noe" in rem and "overall" in rem
    # model1 has the lowest NOE energy of the emitted top-k
    noes = []
    for k in range(1, 5):
        p = os.path.join(out, f"chr22_1mb_matrix_model{k}.pdb")
        if os.path.exists(p):
            noes.append(read_pdb_remarks(p)["noe"])
    assert noes == sorted(noes)


def test_pipeline_spearman_ranking(pipeline_out):
    out, _ = pipeline_out
    with open(os.path.join(out, "spearman.txt")) as f:
        lines = f.read().splitlines()[1:]
    scores = [float(l.split()[0]) for l in lines]
    assert scores == sorted(scores, reverse=True)


def test_violation_report_per_model(pipeline_out):
    """One appended report per model (ref assess_dgsa assesses EVERY pdb,
    chromosome3D.pl:804-810), each in the count_satisfied_tbl_rows format."""
    from chromosome3d.io.pdb import read_pdb_remarks

    out, summary = pipeline_out
    text = open(os.path.join(out, "contact_violation.txt")).read()
    reports = text.split("#NOE violation check")[1:]
    assert len(reports) == summary["models"]
    noes = []
    for rep in reports:
        lines = rep.splitlines()
        pdb_name = lines[0].split(";")[1].split("against")[0].strip()
        noes.append(read_pdb_remarks(os.path.join(out, pdb_name))["noe"])
        assert lines[1].startswith("#violation-flag")
        flags = [int(l.split()[0]) for l in lines[2:] if l.strip()]
        assert len(flags) == summary["restraints"]
        # violated rows sort first
        assert flags == sorted(flags, reverse=True)
    # reports appended in descending NOE-energy order (the reference's loop)
    assert noes == sorted(noes, reverse=True)


def test_bucketed_single_runs_share_one_program(tmp_path):
    """Different-L `run` invocations pad to one bucket and reuse ONE compiled
    solve program (each distinct L otherwise costs a fresh compile)."""
    from chromosome3d.pipeline import run_pipeline
    from chromosome3d.solver.anneal import solve_ensemble

    for name in ("chr22_1mb_matrix.txt", "chr21_1mb_matrix.txt"):
        if not os.path.exists(os.path.join(REF_INPUT, name)):
            pytest.skip("reference not available")
    cfg = fast_cfg(model_count=2, length_buckets=(64,))
    solve_ensemble.clear_cache()
    s22 = run_pipeline(
        os.path.join(REF_INPUT, "chr22_1mb_matrix.txt"), str(tmp_path / "c22"), cfg
    )
    assert solve_ensemble._cache_size() == 1
    s21 = run_pipeline(
        os.path.join(REF_INPUT, "chr21_1mb_matrix.txt"), str(tmp_path / "c21"), cfg
    )  # L=37 != 35, same bucket -> no recompile
    assert solve_ensemble._cache_size() == 1
    assert s22["L"] == 35 and s21["L"] == 37
    # artifacts come out at the TRUE length
    from chromosome3d.io.pdb import read_ca_pdb

    assert read_ca_pdb(tmp_path / "c21" / "chr21_1mb_matrix_model1.pdb").shape == (37, 3)

    # opt-out: exact-L compile per run
    cfg_exact = fast_cfg(model_count=2, bucket_single_runs=False)
    solve_ensemble.clear_cache()
    run_pipeline(
        os.path.join(REF_INPUT, "chr22_1mb_matrix.txt"), str(tmp_path / "e22"),
        cfg_exact,
    )
    run_pipeline(
        os.path.join(REF_INPUT, "chr21_1mb_matrix.txt"), str(tmp_path / "e21"),
        cfg_exact,
    )
    assert solve_ensemble._cache_size() == 2


def test_genome_runner_multi_device(tmp_path):
    """Two chromosomes bucketed + sharded over the 8 fake CPU devices."""
    import jax

    from chromosome3d.parallel.genome import GenomeJob, run_genome

    if not os.path.exists(REF_INPUT):
        pytest.skip("reference not available")
    assert len(jax.devices()) == 8, "conftest should provide 8 fake devices"
    jobs = [
        GenomeJob("chr22_1mb", os.path.join(REF_INPUT, "chr22_1mb_matrix.txt")),
        GenomeJob("chr21_1mb", os.path.join(REF_INPUT, "chr21_1mb_matrix.txt")),
    ]
    out = str(tmp_path / "genome")
    summaries = run_genome(REF_INPUT, out, fast_cfg(), jobs=jobs)
    assert set(summaries) == {"chr22_1mb", "chr21_1mb"}
    for name, s in summaries.items():
        assert s["bucket"] == 64
        assert os.path.exists(os.path.join(out, name, f"{name}_model1.pdb"))
        assert -1.0 <= s["best_spearman_if_inv_d"] <= 1.0
    # round-5: the run writes a top-level summary.json with per-bucket
    # PHASE wall breakdowns (which phase moved between runs)
    with open(os.path.join(out, "summary.json")) as f:
        top = json.load(f)
    assert set(top["chromosomes"]) == {"chr22_1mb", "chr21_1mb"}
    ph = top["phases"]["L64"]
    for key in ("load_s", "solve_and_views_s", "emit_s", "aot"):
        assert key in ph
    assert ph["aot"]["hits"] + ph["aot"]["misses"] + ph["aot"]["uncached"] >= 1
    assert top["wall_seconds"] > 0


def test_bucket_padding_quality_equivalence(tmp_path):
    """A chromosome solved inside a padded bucket must match its unpadded
    solve at quality level (padding is masked out of every term)."""
    import jax
    import numpy as np

    from chromosome3d.io.matrix import load_if_matrix
    from chromosome3d.metrics import spearman_if_inv_d
    from chromosome3d.ops.energy import dense_restraints_from_numpy
    from chromosome3d.parallel.genome import GenomeJob, _stack_bucket, make_mesh, solve_bucket
    from chromosome3d.restraints import build_restraints
    from chromosome3d.solver.anneal import solve_ensemble

    if not os.path.exists(REF_INPUT):
        pytest.skip("reference not available")
    cfg = fast_cfg(model_count=2)
    m = load_if_matrix(os.path.join(REF_INPUT, "chr22_1mb_matrix.txt"))
    jobs = [GenomeJob("chr22_1mb", os.path.join(REF_INPUT, "chr22_1mb_matrix.txt"), 35, 64)]
    batched, masks, _, _ = _stack_bucket(jobs, 64, cfg)
    padded = solve_bucket(batched, masks, cfg, make_mesh(jax.devices()[:1]))
    c_pad = np.asarray(padded.coords)[0, :, :35, :]

    rc = cfg.restraints
    dense = dense_restraints_from_numpy(build_restraints(m, rc), rc.weighting, rc.weight_exponent)
    res = solve_ensemble(dense, cfg.anneal, jax.random.PRNGKey(cfg.seed), 2)
    c_unpad = np.asarray(res.coords)

    s_pad = max(spearman_if_inv_d(m, c) for c in c_pad)
    s_unpad = max(spearman_if_inv_d(m, c) for c in c_unpad)
    assert abs(s_pad - s_unpad) < 0.03


def test_genome_resume_skips_finished(tmp_path):
    """run_genome(resume=True) must not re-solve checkpointed chromosomes."""
    from chromosome3d.parallel.genome import GenomeJob, run_genome

    if not os.path.exists(REF_INPUT):
        pytest.skip("reference not available")
    jobs = lambda: [
        GenomeJob("chr22_1mb", os.path.join(REF_INPUT, "chr22_1mb_matrix.txt")),
        GenomeJob("chr21_1mb", os.path.join(REF_INPUT, "chr21_1mb_matrix.txt")),
    ]
    out = str(tmp_path / "g")
    cfg = fast_cfg(model_count=2)
    first = run_genome(REF_INPUT, out, cfg, jobs=jobs())
    assert len(first) == 2
    # poison one chromosome's matrix path: resume must not read it
    poisoned = [
        GenomeJob("chr22_1mb", "/nonexistent.txt"),
        GenomeJob("chr21_1mb", "/nonexistent.txt"),
    ]
    resumed = run_genome(REF_INPUT, out, cfg, jobs=poisoned, resume=True)
    assert set(resumed) == {"chr22_1mb", "chr21_1mb"}
    for name, s in resumed.items():
        assert s["best_spearman_if_inv_d"] == first[name]["best_spearman_if_inv_d"]

    # PARTIAL resume (ADVICE r1): delete one checkpoint — the returned dict
    # must still cover EVERY job, finished ones from the checkpoint store
    for suffix in (".npz", ".json"):
        os.remove(os.path.join(out, "checkpoint", f"chr21_1mb{suffix}"))
    partial = run_genome(REF_INPUT, out, cfg, jobs=jobs(), resume=True)
    assert set(partial) == {"chr22_1mb", "chr21_1mb"}
    assert (
        partial["chr22_1mb"]["best_spearman_if_inv_d"]
        == first["chr22_1mb"]["best_spearman_if_inv_d"]
    )
    assert -1.0 <= partial["chr21_1mb"]["best_spearman_if_inv_d"] <= 1.0


def test_turbo_preset():
    from chromosome3d.config import AnnealConfig, turbo_anneal

    cfg = turbo_anneal(AnnealConfig())
    assert cfg.total_steps == 30 + 8 * 12 + 150


def test_genome_sharded_matches_single_device(tmp_path):
    """Mesh-sharded solve == single-device solve (same keys, same bucket)."""
    import jax
    import jax.numpy as jnp

    from chromosome3d.io.matrix import load_if_matrix
    from chromosome3d.parallel.genome import GenomeJob, _stack_bucket, make_mesh, solve_bucket

    if not os.path.exists(REF_INPUT):
        pytest.skip("reference not available")
    cfg = fast_cfg(model_count=2)
    jobs = [
        GenomeJob("chr22_1mb", os.path.join(REF_INPUT, "chr22_1mb_matrix.txt"), 35, 64),
        GenomeJob("chr21_1mb", os.path.join(REF_INPUT, "chr21_1mb_matrix.txt"), 37, 64),
    ]
    batched, masks, _, _ = _stack_bucket(jobs, 64, cfg)
    # layout pinned to 1-D so both runs assign identical keys
    multi = solve_bucket(batched, masks, cfg, make_mesh(jax.devices()),
                         model_shards=1)
    single = solve_bucket(batched, masks, cfg, make_mesh(jax.devices()[:1]),
                          model_shards=1)
    # full-path contract is quality-level: the MDS init's 3-D subspace can be
    # near-degenerate (chr22), where mesh-dependent ulps legitimately rotate
    # the embedding; the tight trajectory check (below) pins the anneal
    # sharding itself with a shared x0
    e_m = np.asarray(multi.energies["overall"])
    e_s = np.asarray(single.energies["overall"])
    np.testing.assert_allclose(np.sort(e_m, -1), np.sort(e_s, -1), rtol=0.15)
    from chromosome3d.metrics import spearman_if_inv_d

    m22 = load_if_matrix(os.path.join(REF_INPUT, "chr22_1mb_matrix.txt"))
    s_m = spearman_if_inv_d(m22, np.asarray(multi.coords)[0, 0, :35])
    s_s = spearman_if_inv_d(m22, np.asarray(single.coords)[0, 0, :35])
    assert abs(s_m - s_s) < 0.05


def test_dp_sharded_anneal_trajectory_equal(tmp_path):
    """The tight dp check (r1 review): with a SHARED x0 (no init
    degeneracy in play), the mesh-sharded batched anneal must reproduce the
    single-device trajectories almost bitwise — a real sharding bug (wrong
    lane, wrong mask, wrong key) cannot hide in 1e-4."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from chromosome3d.io.matrix import load_if_matrix
    from chromosome3d.ops.energy import DenseRestraints
    from chromosome3d.parallel.genome import GenomeJob, _stack_bucket, make_mesh
    from chromosome3d.solver.anneal import solve_ensemble_impl
    from chromosome3d.solver.init import spiral_init

    if not os.path.exists(REF_INPUT):
        pytest.skip("reference not available")
    cfg = fast_cfg(model_count=2)
    jobs = [
        GenomeJob("chr22_1mb", os.path.join(REF_INPUT, "chr22_1mb_matrix.txt"), 35, 64),
        GenomeJob("chr21_1mb", os.path.join(REF_INPUT, "chr21_1mb_matrix.txt"), 37, 64),
    ]
    batched, masks, _, _ = _stack_bucket(jobs, 64, cfg)
    x0 = jnp.stack([spiral_init(64), spiral_init(64)]) * masks[:, :, None]
    keys = jax.random.split(jax.random.PRNGKey(3), 2)

    def run(mesh):
        sh = NamedSharding(mesh, P("chrom"))
        f = jax.jit(
            jax.vmap(
                lambda d, k, bead, x: solve_ensemble_impl(
                    d, cfg.anneal, k, cfg.model_count, bead, x
                )
            ),
            in_shardings=(type(batched)(*(sh,) * len(batched)), sh, sh, sh),
            out_shardings=sh,
        )
        return f(batched, keys, masks, x0)

    multi = run(make_mesh(jax.devices()[:2]))
    single = run(make_mesh(jax.devices()[:1]))
    np.testing.assert_allclose(
        np.asarray(multi.history), np.asarray(single.history), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(multi.coords), np.asarray(single.coords), atol=1e-3
    )


def test_pipeline_zero_restraints(tmp_path):
    """A matrix smaller than the separation cutoff yields zero restraints;
    the pipeline must still produce (bond/vdw-shaped) models, not crash."""
    import numpy as np

    m = np.full((4, 4), 10.0)
    np.fill_diagonal(m, 100.0)
    src = tmp_path / "tiny_matrix.txt"
    src.write_text("\n".join(" ".join(f"{v:.1f}" for v in row) for row in m) + "\n")
    from chromosome3d.pipeline import run_pipeline

    summary = run_pipeline(str(src), str(tmp_path / "out"), fast_cfg(model_count=2))
    assert summary["restraints"] == 0
    assert summary["total"] == 0
    assert os.path.exists(tmp_path / "out" / "tiny_matrix_model1.pdb")


def test_pipeline_failure_sentinel(tmp_path):
    """A solve failure must leave iam.failed (the reference's protocol)."""
    src = os.path.join(REF_INPUT, "chr22_1mb_matrix.txt")
    if not os.path.exists(src):
        pytest.skip("reference not available")
    from chromosome3d.pipeline import run_pipeline

    bad = PipelineConfig(
        model_count=2,
        anneal=AnnealConfig(hot_steps=-7),  # breaks schedule construction in-solve
    )
    with pytest.raises(Exception):
        run_pipeline(src, str(tmp_path / "out"), bad)
    assert os.path.exists(tmp_path / "out" / "iam.failed")
    assert not os.path.exists(tmp_path / "out" / "iam.running")


def test_model_axis_shards_layout():
    from chromosome3d.parallel.genome import model_axis_shards

    # chips outnumber chromosomes: split the restart budget
    assert model_axis_shards(2, 8, 20) == 4    # 2*4=8 devices, 5 models each
    assert model_axis_shards(3, 8, 20) == 2    # 3*2=6 <= 8
    assert model_axis_shards(1, 8, 20) == 5    # hmm: largest divisor m<=8
    # chromosomes >= chips: plain 1-D layout
    assert model_axis_shards(8, 8, 20) == 1
    assert model_axis_shards(46, 8, 20) == 1


def test_solve_bucket_2d_model_axis(tmp_path):
    """One chromosome on an 8-device mesh uses the chrom x model layout and
    still returns model_count models."""
    import jax
    import jax.numpy as jnp

    from chromosome3d.ops.energy import DenseRestraints, dense_restraints_from_numpy
    from chromosome3d.parallel.genome import make_mesh, solve_bucket
    from chromosome3d.restraints import build_restraints

    rng = np.random.RandomState(0)
    L = 64
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    d = dense_restraints_from_numpy(
        build_restraints(m, RestraintConfig()), "relative", 2.0
    )
    batched = DenseRestraints(*(t[None] for t in d))
    cfg = fast_cfg(model_count=4)
    res = solve_bucket(batched, jnp.ones((1, L), jnp.float32), cfg, make_mesh())
    assert res.coords.shape == (1, 4, L, 3)
    assert np.isfinite(np.asarray(res.coords)).all()
    assert res.history.shape[:2] == (1, 4)
    # the 4 models are genuinely distinct restarts
    c = np.asarray(res.coords[0])
    assert not np.allclose(c[0], c[1])


def test_assess_failed_sentinel(tmp_path, tiny_matrix, monkeypatch):
    """A restraint-count mismatch must leave an `assess.failed` sentinel for
    monitoring parity with the reference's acceptance check
    (chromosome3D.pl:785-787), in addition to raising."""
    import chromosome3d.pipeline as pl

    src = tmp_path / "tiny_matrix.txt"
    np.savetxt(src, tiny_matrix, fmt="%.3f")
    real = pl.write_contact_tbl
    monkeypatch.setattr(
        pl, "write_contact_tbl", lambda *a, **k: real(*a, **k) + 1
    )
    out = str(tmp_path / "out")
    with pytest.raises(AssertionError, match="restraint-count mismatch"):
        pl.run_pipeline(str(src), out, fast_cfg())
    assert os.path.exists(os.path.join(out, "assess.failed"))


def test_no_violation_reports_knob(tmp_path, tiny_matrix):
    """PipelineConfig.emit_violation_reports=False skips the per-model
    O(L^2) report files (1862 s at L=24576 x 2 models on this host) while
    keeping the stats, rankings, and model artifacts — the at-scale run
    knob (--no-violation-reports)."""
    from chromosome3d.pipeline import run_pipeline

    src = tmp_path / "tiny_matrix.txt"
    np.savetxt(src, tiny_matrix, fmt="%.3f")
    out = tmp_path / "out"
    summary = run_pipeline(
        str(src), str(out), fast_cfg(emit_violation_reports=False)
    )
    assert not os.path.exists(out / "contact_violation.txt")
    assert os.path.exists(out / "tiny_matrix_model1.pdb")
    assert os.path.exists(out / "spearman.txt")
    for key in ("satisfied", "total", "best_spearman_if_inv_d",
                "clashes_under_3A"):
        assert key in summary
    assert summary["total"] > 0
