"""AOT serialized-executable cache (utils/aot.py): compile-once semantics,
cross-instance reload, graceful fallback on corrupt entries. Runs on CPU —
the serialize/deserialize path is backend-generic."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from chromosome3d.utils.aot import cache_key, load_or_compile


def _f():
    return jax.jit(lambda x, y: (x @ y).sum(axis=0) + 2.0 * x.sum())


def test_disabled_without_dir(monkeypatch):
    monkeypatch.delenv("CHROM3D_AOT_CACHE", raising=False)
    f = _f()
    out = load_or_compile(f, (jnp.ones((4, 4)), jnp.ones((4, 4))), tag="t")
    assert out is f  # passthrough: plain jitted callable


def test_save_then_load(tmp_path):
    """A fresh load_or_compile over the same dir resolves through the cached
    blob. (XLA:CPU may reject the blob at dispatch — machine-feature
    strictness — in which case the _GuardedExec fallback recompiles; either
    way the call must succeed with identical results.)"""
    x, y = jnp.ones((8, 8)), jnp.full((8, 8), 2.0)
    c1 = load_or_compile(_f(), (x, y), tag="mm", cache_dir=str(tmp_path))
    files = [p for p in os.listdir(tmp_path) if p.endswith(".aotx")]
    assert len(files) == 1 and files[0].startswith("mm-")
    r1 = np.asarray(c1(x, y))

    c2 = load_or_compile(_f(), (x, y), tag="mm", cache_dir=str(tmp_path))
    r2 = np.asarray(c2(x, y))
    np.testing.assert_allclose(r1, r2)


def test_key_separates_shapes_and_statics(tmp_path):
    x8 = (jnp.ones((8, 8)), jnp.ones((8, 8)))
    x4 = (jnp.ones((4, 4)), jnp.ones((4, 4)))
    k1 = cache_key("t", x8, "cfgA")
    assert cache_key("t", x4, "cfgA") != k1
    assert cache_key("t", x8, "cfgB") != k1
    assert cache_key("u", x8, "cfgA") != k1
    assert cache_key("t", x8, "cfgA") == k1  # deterministic


def test_corrupt_entry_falls_back(tmp_path):
    x, y = jnp.ones((8, 8)), jnp.ones((8, 8))
    load_or_compile(_f(), (x, y), tag="mm", cache_dir=str(tmp_path))
    (entry,) = [p for p in os.listdir(tmp_path) if p.endswith(".aotx")]
    with open(tmp_path / entry, "wb") as f:
        pickle.dump(("garbage",), f)
    c = load_or_compile(_f(), (x, y), tag="mm", cache_dir=str(tmp_path))
    np.testing.assert_allclose(np.asarray(c(x, y)), np.asarray(_f()(x, y)))


def test_genome_bucket_roundtrip(tmp_path, monkeypatch):
    """run_genome with CHROM3D_AOT_CACHE writes a bucket executable and a
    second run loads it — end to end through the production runner."""
    from chromosome3d.config import AnnealConfig, PipelineConfig
    from chromosome3d.parallel.genome import run_genome

    rng = np.random.RandomState(0)
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for name in ("chr1_1mb", "chr2_1mb"):
        L = 24
        base = rng.gamma(2.0, 50.0, size=(L, L))
        m = (base + base.T) / 2
        np.fill_diagonal(m, 5000.0)
        np.savetxt(in_dir / f"{name}_matrix.txt", m, fmt="%.4f")
    cfg = PipelineConfig(
        model_count=2, top_k=1, length_buckets=(32,),
        anneal=AnnealConfig(
            hot_steps=10, cool_cycles=4, cool_steps_per_cycle=2,
            final_steps=10, enantiomer=False, init="spiral",
        ),
    )
    aot_dir = tmp_path / "aot"
    monkeypatch.setenv("CHROM3D_AOT_CACHE", str(aot_dir))
    s1 = run_genome(str(in_dir), str(tmp_path / "out1"), cfg)
    blobs = [p for p in os.listdir(aot_dir) if p.endswith(".aotx")]
    assert len(blobs) == 1 and blobs[0].startswith("genome_bucket-")
    s2 = run_genome(str(in_dir), str(tmp_path / "out2"), cfg)
    for k in s1:
        assert (
            s1[k]["best_spearman_if_inv_d"] == s2[k]["best_spearman_if_inv_d"]
        )


def test_run_pipeline_aot_roundtrip(tmp_path, monkeypatch):
    """run_pipeline with CHROM3D_AOT_CACHE saves the bucket executable and a
    second process-equivalent run loads it with identical results."""
    from chromosome3d.config import AnnealConfig, PipelineConfig
    from chromosome3d.pipeline import run_pipeline

    rng = np.random.RandomState(2)
    L = 20
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    matrix = tmp_path / "chrT_1mb_matrix.txt"
    np.savetxt(matrix, m, fmt="%.4f")
    cfg = PipelineConfig(
        model_count=2, top_k=1, length_buckets=(32,),
        anneal=AnnealConfig(
            hot_steps=10, cool_cycles=4, cool_steps_per_cycle=2,
            final_steps=10, enantiomer=False, init="spiral",
        ),
    )
    monkeypatch.setenv("CHROM3D_AOT_CACHE", str(tmp_path / "aot"))
    s1 = run_pipeline(str(matrix), str(tmp_path / "o1"), cfg)
    blobs = [p for p in os.listdir(tmp_path / "aot") if p.endswith(".aotx")]
    assert len(blobs) == 1 and blobs[0].startswith("pipeline_bucket-")
    s2 = run_pipeline(str(matrix), str(tmp_path / "o2"), cfg)
    assert s1["best_spearman_if_inv_d"] == s2["best_spearman_if_inv_d"]


def test_device_prep_aot_roundtrip(tmp_path, monkeypatch):
    """The at-scale device-prep programs ride the AOT cache too: a fresh
    process re-running a known bucket shape must skip the compile
    for the PREP, not just the solve — otherwise the solve blobs' cold-start
    win is bounded by the prep's compile."""
    from chromosome3d.config import RestraintConfig
    from chromosome3d.ops.device_prep import exact_tiles_from_if_device

    rng = np.random.RandomState(5)
    L = 12
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    rc = RestraintConfig()
    monkeypatch.setenv("CHROM3D_AOT_CACHE", str(tmp_path))
    t1 = exact_tiles_from_if_device(m, 16, rc, rc.weighting, 1.0)
    t1 = (np.asarray(t1.target), np.asarray(t1.w))
    blobs = [p for p in os.listdir(tmp_path) if p.endswith(".aotx")]
    assert len(blobs) == 1 and blobs[0].startswith("prep_if-")
    t2 = exact_tiles_from_if_device(m, 16, rc, rc.weighting, 1.0)
    np.testing.assert_array_equal(t1[0], np.asarray(t2.target))
    np.testing.assert_array_equal(t1[1], np.asarray(t2.w))


def test_device_prep_bucket_aot_roundtrip(tmp_path, monkeypatch):
    """The batched (genome at-scale bucket) prep program rides the cache
    too — it adds vmap + a donated (B, L, L) stack over the single-matrix
    program, so pin its serialize/reload separately."""
    from chromosome3d.config import RestraintConfig
    from chromosome3d.ops.device_prep import (
        exact_tiles_from_if_batched_device,
    )

    rng = np.random.RandomState(7)
    mats = []
    for L in (10, 12):
        base = rng.gamma(2.0, 50.0, size=(L, L))
        m = (base + base.T) / 2
        np.fill_diagonal(m, 5000.0)
        mats.append(m)
    rc = RestraintConfig()
    monkeypatch.setenv("CHROM3D_AOT_CACHE", str(tmp_path))
    t1 = exact_tiles_from_if_batched_device(mats, 16, rc, rc.weighting, [1.0, 1.0])
    t1 = (np.asarray(t1.target), np.asarray(t1.w))
    blobs = [p for p in os.listdir(tmp_path) if p.endswith(".aotx")]
    assert len(blobs) == 1 and blobs[0].startswith("prep_if_bucket-")
    t2 = exact_tiles_from_if_batched_device(mats, 16, rc, rc.weighting, [1.0, 1.0])
    np.testing.assert_array_equal(t1[0], np.asarray(t2.target))
    np.testing.assert_array_equal(t1[1], np.asarray(t2.w))


def test_guarded_retry_recompiles_when_inputs_survive(tmp_path):
    """A cached executable that fails at dispatch WITHOUT consuming its
    inputs is recompiled in place and the poisoned entry evicted."""
    from chromosome3d.utils.aot import _GuardedExec

    poisoned = tmp_path / "t-dead-beef.aotx"
    poisoned.write_bytes(b"x")

    def bad_exec(*args):
        raise ValueError("backend rejected blob")

    f = _f()
    x, y = jnp.ones((4, 4)), jnp.ones((4, 4))
    g = _GuardedExec(
        bad_exec, lambda: f.lower(x, y).compile(), "t", str(poisoned)
    )
    np.testing.assert_allclose(np.asarray(g(x, y)), np.asarray(f(x, y)))
    assert not poisoned.exists()


def test_guarded_retry_donated_inputs_consumed(tmp_path):
    """If the failed dispatch already CONSUMED a donated input (the prep
    programs donate their (L, L) upload), retrying would pass deleted
    buffers to the fresh executable — the guard must evict the entry and
    raise a clear error instead of a confusing low-level one."""
    import pytest

    from chromosome3d.utils.aot import _GuardedExec

    poisoned = tmp_path / "t-dead-beef.aotx"
    poisoned.write_bytes(b"x")

    def consuming_bad_exec(x):
        x.delete()
        raise ValueError("backend rejected blob mid-dispatch")

    x = jnp.ones((4, 4))
    g = _GuardedExec(
        consuming_bad_exec, lambda: None, "t", str(poisoned)
    )
    with pytest.raises(RuntimeError, match="donated input"):
        g(x)
    assert not poisoned.exists()


def test_code_fingerprint_in_key(tmp_path, monkeypatch):
    """The cache key embeds a fingerprint of the package source: editing
    any module must invalidate cached executables (a serialized executable
    embeds the COMPILED code; shapes/config cannot see a bug fix)."""
    import chromosome3d.utils.aot as aot

    args = (jnp.ones((4, 4)), jnp.ones((4, 4)))
    k1 = cache_key("t", args, "s")
    monkeypatch.setattr(aot, "_CODE_FINGERPRINT", "different-code")
    k2 = cache_key("t", args, "s")
    assert k1 != k2


def test_prune_keeps_siblings_drops_stale(tmp_path, monkeypatch):
    """Saving prunes same-tag entries from OLDER source fingerprints but
    keeps current-source siblings (other shapes/buckets)."""
    import chromosome3d.utils.aot as aot

    # two current-source entries with different shapes
    load_or_compile(_f(), (jnp.ones((8, 8)), jnp.ones((8, 8))), tag="t",
                    cache_dir=str(tmp_path))
    load_or_compile(_f(), (jnp.ones((16, 16)), jnp.ones((16, 16))), tag="t",
                    cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("t-*.aotx"))) == 2
    # a stale-fingerprint entry gets pruned by the next save
    stale = tmp_path / "t-deadbeef00000000-ffff.aotx"
    stale.write_bytes(b"old")
    load_or_compile(_f(), (jnp.ones((4, 4)), jnp.ones((4, 4))), tag="t",
                    cache_dir=str(tmp_path))
    names = sorted(p.name for p in tmp_path.glob("t-*.aotx"))
    assert len(names) == 3 and stale.name not in names


def test_event_marks_survive_truncation():
    """Provenance consumers mark positions with the monotonic seq counter;
    list indices would silently shift once the drop-oldest cap truncates
    (round-5 review): a long-lived serve process crossing 256 events must
    not mis-attribute other work's compile time."""
    from chromosome3d.utils import aot

    saved = list(aot.EVENTS)
    try:
        aot.EVENTS.clear()
        for i in range(10):
            aot._record_event({"tag": f"warm{i}", "hit": True, "seconds": 0.1})
        mark = aot.event_mark()
        for i in range(aot._EVENTS_MAX + 5):  # overflow the cap
            aot._record_event({"tag": f"work{i}", "hit": False, "seconds": 1.0})
        evs = aot.events_since(mark)
        # everything after the mark is accounted for: the cap kept the
        # newest 256, and the sentinel flags the 5 lost ones
        assert evs[0]["tag"] == "<truncated>" and evs[0]["lost"] == 5
        assert len(evs) == aot._EVENTS_MAX + 1
        assert all(e["tag"].startswith("work") for e in evs[1:])
        # no truncation across the mark -> exact slice, no sentinel
        mark2 = aot.event_mark()
        aot._record_event({"tag": "tail", "hit": None, "seconds": 0.0})
        evs2 = aot.events_since(mark2)
        assert [e["tag"] for e in evs2] == ["tail"]
    finally:
        aot.EVENTS.clear()
        aot.EVENTS.extend(saved)
