"""ops.device_prep: at-scale restraint prep on the accelerator must match
the reference-semantics host route (restraints.py + ops.energy builders) —
target tiles exactly (up to f32-vs-f64 quantization ties), weights to f32
resolution. Ref semantics: chromosome3D.pl:110-206 (IF2dist_new + dist2rr)."""

import numpy as np
import pytest

from chromosome3d.config import RestraintConfig
from chromosome3d.ops.device_prep import (
    exact_tiles_from_if_device,
    exact_tiles_from_target_device,
    pad_f32,
)
from chromosome3d.ops.energy import (
    auto_weight_exponent,
    exact_restraints_from_numpy,
)
from chromosome3d.restraints import build_restraints


def _matrix(L, seed=3):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    # a few zero cells: IF == 0 must yield no restraint on both routes
    m[3, 40] = m[40, 3] = 0.0
    return m


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_tiles_from_target_match_host(weighting):
    rc = RestraintConfig()
    r = build_restraints(_matrix(96), rc)
    p = auto_weight_exponent(r.length)
    host = exact_restraints_from_numpy(r.padded(128), weighting, p)
    dev = exact_tiles_from_target_device(r.target, 128, weighting, p)
    np.testing.assert_array_equal(np.asarray(dev.target), np.asarray(host.target))
    np.testing.assert_allclose(
        np.asarray(dev.w), np.asarray(host.w), rtol=3e-6, atol=1e-8
    )


def test_tiles_from_if_match_host():
    rc = RestraintConfig()
    m = _matrix(150)
    r = build_restraints(m, rc)
    p = auto_weight_exponent(150)
    host = exact_restraints_from_numpy(r.padded(192), rc.weighting, p)
    dev = exact_tiles_from_if_device(m, 192, rc, rc.weighting, p)
    t_h = np.asarray(host.target)
    t_d = np.asarray(dev.target)
    # the %.1f quantization runs in f32 on device vs f64 on host: cells may
    # differ ONLY where d*10 sits within f32 resolution of a .5 midpoint —
    # bounded by one quantization step, and vanishingly rare
    diff = t_d != t_h
    assert diff.mean() < 1e-3, f"{diff.sum()} quantization mismatches"
    assert np.abs(t_d - t_h).max() <= 0.1 + 1e-5
    # masks must agree wherever targets agree (and everywhere in padding)
    assert not np.logical_xor(t_d > 0, t_h > 0)[~diff].any()
    assert not t_d[150:, :].any() and not t_d[:, 150:].any()
    w_h, w_d = np.asarray(host.w), np.asarray(dev.w)
    same = ~diff
    np.testing.assert_allclose(w_d[same], w_h[same], rtol=1e-4, atol=1e-8)


def test_compensated_decimal_divide_exhaustive():
    """The device quantization's two-term k*hi + k*lo product must equal the
    CORRECTLY-ROUNDED f32 quotient k/10 (XLA strength-reduces a literal /10
    to a reciprocal multiply, one ulp off). Exhaustive over the full target
    range the product can produce (k = round(d*10) <= 2e6)."""
    import jax
    import jax.numpy as jnp

    hi = np.float32(0.1)
    lo = np.float32(0.1 - float(np.float32(0.1)))
    comp = jax.jit(lambda k: k * hi + k * lo)
    k = np.arange(0, 2_000_001, dtype=np.float32)
    want = (k.astype(np.float64) / 10.0).astype(np.float32)
    got = np.asarray(comp(jnp.asarray(k)))
    assert (got == want).all()


def test_pad_f32_passthrough_and_pad():
    import jax.numpy as jnp

    a = np.arange(9, dtype=np.float64).reshape(3, 3)
    out = pad_f32(a, 5)
    assert out.shape == (5, 5) and out.dtype == np.float32
    assert (out[:3, :3] == a).all() and not out[3:, :].any()
    j = jnp.ones((4, 4), jnp.float32)
    assert pad_f32(j, 4) is j  # device arrays pass through, no host trip


def test_padded_dense_device_route_matches_host():
    from chromosome3d.pipeline import _padded_dense

    rc = RestraintConfig()
    r = build_restraints(_matrix(70), rc)
    host, p_h = _padded_dense(r, rc, 128, exact=True, device=False)
    dev, p_d = _padded_dense(r, rc, 128, exact=True, device=True)
    assert p_h == p_d
    np.testing.assert_array_equal(np.asarray(dev.target), np.asarray(host.target))
    np.testing.assert_allclose(
        np.asarray(dev.w), np.asarray(host.w), rtol=3e-6, atol=1e-8
    )


def test_tiles_born_row_sharded():
    """With a row sharding passed, the tiles must (a) equal the host route
    and (b) actually carry the row sharding — at real multi-chip scale the
    (L, L) must never materialize whole on one device (the upload goes
    straight to per-device row slices; GSPMD propagates through the prep
    program; the relative-weight mean is one all-reduce)."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rc = RestraintConfig()
    r = build_restraints(_matrix(96), rc)
    p = auto_weight_exponent(96)
    host = exact_restraints_from_numpy(r.padded(128), rc.weighting, p)
    mesh = Mesh(np.array(jax.devices()), ("beads",))
    row_sh = NamedSharding(mesh, P("beads", None))
    dev = exact_tiles_from_target_device(r.target, 128, rc.weighting, p,
                                         sharding=row_sh)
    np.testing.assert_array_equal(np.asarray(dev.target), np.asarray(host.target))
    np.testing.assert_allclose(
        np.asarray(dev.w), np.asarray(host.w), rtol=3e-6, atol=1e-8
    )
    # every shard holds only its 128/8 = 16 rows
    for arr in (dev.target, dev.w):
        shard_shapes = {s.data.shape for s in arr.addressable_shards}
        assert shard_shapes == {(128 // len(jax.devices()), 128)}, (
            arr.sharding, shard_shapes
        )


def test_device_prep_solve_equivalence():
    """A short anneal from device-prepped tiles must match the host-prepped
    solve to solver-f32 resolution (same program, same seed)."""
    import jax

    from chromosome3d.config import AnnealConfig, fast_anneal
    from chromosome3d.solver.anneal import solve_ensemble

    rc = RestraintConfig()
    m = _matrix(64)
    r = build_restraints(m, rc)
    p = auto_weight_exponent(64)
    cfg = fast_anneal(AnnealConfig(use_pallas=False, exact_restraints=True))
    key = jax.random.PRNGKey(7)
    host = solve_ensemble(
        exact_restraints_from_numpy(r, rc.weighting, p), cfg, key, 2
    )
    dev = solve_ensemble(
        exact_tiles_from_target_device(r.target, 64, rc.weighting, p),
        cfg, key, 2,
    )
    np.testing.assert_allclose(
        np.asarray(dev.coords), np.asarray(host.coords), rtol=2e-4, atol=2e-4
    )


def test_batched_tiles_match_single():
    """The genome-bucket batched prep (one vmapped program) must be
    BIT-equal to per-matrix single prep at the same L_pad, including
    mixed true lengths and per-chromosome weight exponents."""
    from chromosome3d.ops.device_prep import (
        exact_tiles_from_if_batched_device,
    )

    rc = RestraintConfig()
    mats = [_matrix(64, seed=5), _matrix(48, seed=6)]
    ps = [auto_weight_exponent(m.shape[0]) for m in mats]
    L_pad = 72
    batched = exact_tiles_from_if_batched_device(
        mats, L_pad, rc, "relative", ps
    )
    t_all = np.asarray(batched.target)
    w_all = np.asarray(batched.w)
    assert t_all.shape == (2, L_pad, L_pad)
    for b, (m, p) in enumerate(zip(mats, ps)):
        single = exact_tiles_from_if_device(m, L_pad, rc, "relative", p)
        np.testing.assert_array_equal(t_all[b], np.asarray(single.target))
        np.testing.assert_array_equal(w_all[b], np.asarray(single.w))


def test_restraints_from_exact_target_matches_host():
    """The downloaded host view equals the host-built Restraints on the
    same matrix (exact by construction: negdev = posdev = 0)."""
    from chromosome3d.restraints import (
        dist_to_restraints,
        if_to_dist,
        restraints_from_exact_target,
    )

    rc = RestraintConfig()
    m = _matrix(56, seed=7)
    host = dist_to_restraints(if_to_dist(m, rc), rc)
    tiles = exact_tiles_from_if_device(m, 56, rc, "relative",
                                       auto_weight_exponent(56))
    view = restraints_from_exact_target(np.asarray(tiles.target))
    np.testing.assert_array_equal(view.target, host.target)
    np.testing.assert_array_equal(view.mask, host.mask)
    assert view.count == host.count and view.length == host.length
    assert not view.negdev.any() and not view.posdev.any()


def test_tiles_bf16_stored_match_f32_cast():
    """out_dtype="bfloat16" must emit exactly the f32 tiles converted —
    the stored-bf16 form equals the in-jit pair_bf16 cast bit for bit
    (same values, half the argument HBM and per-step stream)."""
    import jax.numpy as jnp

    rc = RestraintConfig()
    m = _matrix(100)
    p = auto_weight_exponent(100)
    f32 = exact_tiles_from_if_device(m, 128, rc, rc.weighting, p)
    b16 = exact_tiles_from_if_device(
        m, 128, rc, rc.weighting, p, out_dtype="bfloat16"
    )
    assert b16.target.dtype == jnp.bfloat16 and b16.w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(b16.target), np.asarray(f32.target.astype(jnp.bfloat16))
    )
    np.testing.assert_array_equal(
        np.asarray(b16.w), np.asarray(f32.w.astype(jnp.bfloat16))
    )
    # mask recovery survives the conversion
    np.testing.assert_array_equal(
        np.asarray(b16.mask) > 0, np.asarray(f32.mask) > 0
    )


def test_solve_with_bf16_stored_tiles():
    """solve_ensemble on bf16-STORED tiles: the init upcasts to f32, the
    hot loop reads the tiles natively, and the result is sane (finite,
    centered, energy comparable to the f32-stored solve)."""
    import dataclasses

    import jax

    from chromosome3d.config import AnnealConfig, fast_anneal
    from chromosome3d.solver.anneal import solve_ensemble

    rc = RestraintConfig()
    m = _matrix(96)
    p = auto_weight_exponent(96)
    f32 = exact_tiles_from_if_device(m, 96, rc, rc.weighting, p)
    b16 = exact_tiles_from_if_device(
        m, 96, rc, rc.weighting, p, out_dtype="bfloat16"
    )
    cfg = fast_anneal(AnnealConfig(exact_restraints=True))
    cfg_b = dataclasses.replace(cfg, pair_bf16=True)
    ref = solve_ensemble(f32, cfg, jax.random.PRNGKey(4), 2)
    got = solve_ensemble(b16, cfg_b, jax.random.PRNGKey(4), 2)
    gc = np.asarray(got.coords)
    assert np.isfinite(gc).all()
    np.testing.assert_allclose(gc.mean(axis=1), 0.0, atol=1e-3)
    e_ref = float(np.asarray(ref.energies["overall"]).min())
    e_got = float(np.asarray(got.energies["overall"]).min())
    assert abs(e_got - e_ref) / max(abs(e_ref), 1.0) < 0.05


def test_target_tiles_bf16_stored_match_f32_cast():
    """exact_tiles_from_target_device out_dtype="bfloat16": same values as
    the f32 program converted (the target-fed twin of the IF-fed test)."""
    import jax.numpy as jnp

    rc = RestraintConfig()
    r = build_restraints(_matrix(96), rc)
    p = auto_weight_exponent(r.length)
    f32 = exact_tiles_from_target_device(r.target, 128, "relative", p)
    b16 = exact_tiles_from_target_device(
        r.target, 128, "relative", p, out_dtype="bfloat16"
    )
    assert b16.target.dtype == jnp.bfloat16 and b16.w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(b16.target), np.asarray(f32.target.astype(jnp.bfloat16))
    )
    np.testing.assert_array_equal(
        np.asarray(b16.w), np.asarray(f32.w.astype(jnp.bfloat16))
    )


def test_tiles_from_if_separation_zero_excludes_diagonal():
    """The host route drops i == j EXPLICITLY (~np.eye in
    dist_to_restraints), not via the separation test — so at separation=0
    the device mask must also exclude the diagonal or the routes diverge by
    L spurious self-restraints (which would also skew the relative-
    weighting mean normalization)."""
    rc = RestraintConfig(separation=0)
    m = _matrix(64)
    r = build_restraints(m, rc)
    p = auto_weight_exponent(64)
    host = exact_restraints_from_numpy(r, rc.weighting, p)
    dev = exact_tiles_from_if_device(m, 64, rc, rc.weighting, p)
    t_d = np.asarray(dev.target)
    assert not np.diagonal(t_d).any()
    t_h = np.asarray(host.target)
    diff = t_d != t_h
    assert diff.mean() < 1e-3
    assert not np.logical_xor(t_d > 0, t_h > 0)[~diff].any()
    np.testing.assert_allclose(
        np.asarray(dev.w)[~diff], np.asarray(host.w)[~diff],
        rtol=1e-4, atol=1e-8,
    )


# ---------------------------------------------------------------------------
# Strip-STREAMED prep (past the one-shot ceiling)
# ---------------------------------------------------------------------------

def _integer_matrix(L, seed=11):
    """Small-integer IF values: with alpha=1.0 every IF^alpha sum is exactly
    f32-representable, so the one-shot and streamed means are BIT-equal and
    the routes can be compared exactly (no quantization-boundary escape
    hatch needed)."""
    rng = np.random.RandomState(seed)
    base = rng.randint(1, 9, size=(L, L)).astype(np.float64)
    m = np.maximum(base, base.T)
    np.fill_diagonal(m, 64.0)
    m[2, 30] = m[30, 2] = 0.0  # IF == 0 -> no restraint, both routes
    return m


def test_pick_strip_rows_divides():
    from chromosome3d.ops.device_prep import _pick_strip_rows

    assert _pick_strip_rows(49152) == 4096
    assert _pick_strip_rows(512) == 512
    assert _pick_strip_rows(96, cap=32) == 32
    assert _pick_strip_rows(100, cap=32) == 25
    for L_pad in (512, 40960, 49152, 100):
        assert L_pad % _pick_strip_rows(L_pad) == 0


def test_should_stream_prep_measured_boundary(monkeypatch):
    """With an explicit 16 GB budget the gate streams exactly where the
    one-shot peak (f32 input + both output planes) exceeds it: L = 40960
    bf16 prep (13.4 GB) runs one-shot, L = 49152 (19.3 GB) streams."""
    from chromosome3d.ops.device_prep import should_stream_prep

    monkeypatch.setenv("CHROM3D_PREP_HBM_BUDGET", "16e9")
    assert not should_stream_prep(40960, "bfloat16")
    assert should_stream_prep(49152, "bfloat16")
    assert should_stream_prep(49152, "float32")
    assert not should_stream_prep(512, "float32")


class _Dev:
    device_kind = "test device"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("case", ["env", "memory_stats", "no_limit"])
def test_prep_budget(case, monkeypatch):
    """The one-shot prep budget: CHROM3D_PREP_HBM_BUDGET when set, else a
    share of the device's bytes_limit; a device reporting no limit is an
    explicit error, never a default size."""
    from chromosome3d.ops.device_prep import (
        _PREP_BUDGET_FRACTION,
        prep_budget_bytes,
    )

    monkeypatch.delenv("CHROM3D_PREP_HBM_BUDGET", raising=False)
    if case == "env":
        monkeypatch.setenv("CHROM3D_PREP_HBM_BUDGET", "2.5e9")
        assert prep_budget_bytes(_Dev(None)) == 2.5e9
    elif case == "memory_stats":
        dev = _Dev({"bytes_limit": 60_000_000_000})
        assert prep_budget_bytes(dev) == _PREP_BUDGET_FRACTION * 60e9
    else:
        with pytest.raises(RuntimeError, match="CHROM3D_PREP_HBM_BUDGET"):
            prep_budget_bytes(_Dev(None))
        with pytest.raises(RuntimeError, match="no memory limit"):
            prep_budget_bytes(_Dev({"bytes_in_use": 0}))


def test_streamed_tiles_bit_equal_absolute():
    """Integer matrix + alpha=1 + absolute weighting: the streamed route is
    BIT-equal to the one-shot device program (shared _strip_target body,
    exactly representable mean, indicator weights — no normalizer pass)."""
    from chromosome3d.ops.device_prep import exact_tiles_from_if_streamed

    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(100)
    p = auto_weight_exponent(100)
    one = exact_tiles_from_if_device(m, 128, rc, "absolute", p)
    st = exact_tiles_from_if_streamed(m, 128, rc, "absolute", p,
                                      strip_rows=32)
    np.testing.assert_array_equal(np.asarray(st.target), np.asarray(one.target))
    np.testing.assert_array_equal(np.asarray(st.w), np.asarray(one.w))
    # padding stays zero even though the strip loop stops at the true L
    assert not np.asarray(st.target)[100:, :].any()
    assert not np.asarray(st.w)[:, 100:].any()


def test_streamed_tiles_match_relative():
    """Relative weighting: targets stay bit-equal (same mean); the weights
    differ only by the normalizer's summation order (strip partials vs one
    whole-array sum) and the scale multiply vs the elementwise divide."""
    from chromosome3d.ops.device_prep import exact_tiles_from_if_streamed

    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(96, seed=13)
    p = auto_weight_exponent(96)
    one = exact_tiles_from_if_device(m, 96, rc, "relative", p)
    st = exact_tiles_from_if_streamed(m, 96, rc, "relative", p,
                                      strip_rows=16)
    np.testing.assert_array_equal(np.asarray(st.target), np.asarray(one.target))
    np.testing.assert_allclose(
        np.asarray(st.w), np.asarray(one.w), rtol=3e-6, atol=1e-8
    )


def test_streamed_tiles_bf16_stored():
    """bf16-STORED streamed tiles: targets bit-equal to the one-shot bf16
    program; weights within the double-rounding bound (bf16(w_unnorm) *
    scale vs bf16(w/denom) — one extra bf16 rounding, <= ~0.8% relative)."""
    import jax.numpy as jnp

    from chromosome3d.ops.device_prep import exact_tiles_from_if_streamed

    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(96, seed=17)
    p = auto_weight_exponent(96)
    one = exact_tiles_from_if_device(m, 96, rc, "relative", p,
                                     out_dtype="bfloat16")
    st = exact_tiles_from_if_streamed(m, 96, rc, "relative", p,
                                      out_dtype="bfloat16", strip_rows=32)
    assert st.target.dtype == jnp.bfloat16 and st.w.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(st.target, np.float32), np.asarray(one.target, np.float32)
    )
    np.testing.assert_allclose(
        np.asarray(st.w, np.float32), np.asarray(one.w, np.float32),
        rtol=1e-2, atol=1e-8,
    )


@pytest.mark.parametrize("weighting", ["relative", "absolute"])
def test_streamed_view_matches_download(weighting):
    """The streamed assessment view (strip downloads, host assembly) must
    match downloading the one-shot f32 tiles: bit-equal targets; weights
    exact for absolute (denom == 1 -> the division is exact), to f32-sum
    resolution for relative."""
    from chromosome3d.ops.device_prep import (
        assessment_view_from_if_streamed,
    )

    rc = RestraintConfig(alpha=1.0)
    L, L_pad = 100, 128
    m = _integer_matrix(L, seed=23)
    p = auto_weight_exponent(L)
    one = exact_tiles_from_if_device(m, L_pad, rc, weighting, p)
    t_one = np.asarray(one.target)[:L, :L]
    w_one = np.asarray(one.w)[:L, :L]
    t_st, w_st = assessment_view_from_if_streamed(
        m, L_pad, rc, weighting, p, strip_rows=32
    )
    assert t_st.shape == (L, L) and w_st.shape == (L, L)
    np.testing.assert_array_equal(t_st, t_one)
    if weighting == "absolute":
        np.testing.assert_array_equal(w_st, w_one)
    else:
        np.testing.assert_allclose(w_st, w_one, rtol=3e-6, atol=1e-8)


def test_stream_gate_routes_transparently(monkeypatch):
    """With the HBM budget forced tiny, exact_tiles_from_if_device must
    dispatch onto the streamed route by itself and produce the same tiles
    (the product surfaces need no code awareness of the ceiling)."""
    import chromosome3d.ops.device_prep as dp

    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(96, seed=29)
    p = auto_weight_exponent(96)
    one = exact_tiles_from_if_device(m, 96, rc, "absolute", p)
    monkeypatch.setenv("CHROM3D_PREP_HBM_BUDGET", "1000")
    calls = []
    real = dp.exact_tiles_from_if_streamed

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(dp, "exact_tiles_from_if_streamed", spy)
    st = dp.exact_tiles_from_if_device(m, 96, rc, "absolute", p)
    assert calls, "tiny budget must route onto the streamed path"
    np.testing.assert_array_equal(np.asarray(st.target), np.asarray(one.target))
    np.testing.assert_array_equal(np.asarray(st.w), np.asarray(one.w))


def test_streamed_strip_rows_must_divide():
    from chromosome3d.ops.device_prep import exact_tiles_from_if_streamed

    rc = RestraintConfig()
    with pytest.raises(ValueError, match="divide"):
        exact_tiles_from_if_streamed(
            _integer_matrix(64), 64, rc, "relative", 1.0, strip_rows=24
        )


def test_streamed_tiles_lead_batch():
    """lead_batch=True emits (1, L_pad, L_pad) tiles — the genome bucket's
    batched layout — identical to the 2-D route with a batch axis on."""
    from chromosome3d.ops.device_prep import exact_tiles_from_if_streamed

    rc = RestraintConfig(alpha=1.0)
    m = _integer_matrix(100, seed=37)
    p = auto_weight_exponent(100)
    st2 = exact_tiles_from_if_streamed(m, 128, rc, "relative", p,
                                       strip_rows=32)
    st3 = exact_tiles_from_if_streamed(m, 128, rc, "relative", p,
                                       strip_rows=32, lead_batch=True)
    assert st3.target.shape == (1, 128, 128) and st3.w.shape == (1, 128, 128)
    np.testing.assert_array_equal(np.asarray(st3.target)[0],
                                  np.asarray(st2.target))
    np.testing.assert_array_equal(np.asarray(st3.w)[0], np.asarray(st2.w))
