"""Warm-model server tests: ping, solve request, warm-bucket reuse, error
handling, shutdown — over a real Unix socket with the server in a thread."""

import json
import os
import threading
import time

import numpy as np
import pytest

from chromosome3d.config import AnnealConfig, PipelineConfig, RestraintConfig, fast_anneal
from chromosome3d.serve import request, serve

REF_INPUT = "/root/reference/input"


@pytest.fixture()
def server(tmp_path):
    sock = str(tmp_path / "c3d.sock")
    cfg = PipelineConfig(
        model_count=2,
        anneal=fast_anneal(AnnealConfig()),
        length_buckets=(64, 128, 256, 512),
    )
    t = threading.Thread(target=serve, args=(sock, cfg), daemon=True)
    t.start()
    for _ in range(100):
        if os.path.exists(sock):
            break
        time.sleep(0.05)
    yield sock
    try:
        request(sock, {"cmd": "shutdown"}, timeout=5)
    except Exception:
        pass


def test_ping(server):
    resp = request(server, {"cmd": "ping"})
    assert resp["ok"] and resp["pong"]
    assert resp["warm_buckets"] == []


def test_solve_request_and_warm_reuse(server, tmp_path):
    src = os.path.join(REF_INPUT, "chr22_1mb_matrix.txt")
    if not os.path.exists(src):
        pytest.skip("reference not available")
    out1 = str(tmp_path / "o1")
    t0 = time.time()
    resp = request(server, {"matrix": src, "out": out1, "models": 2})
    cold = time.time() - t0
    assert resp["ok"], resp
    assert resp["summary"]["L"] == 35
    assert os.path.exists(os.path.join(out1, "chr22_1mb_matrix_model1.pdb"))

    # same bucket, different chromosome: must reuse the compiled program
    src2 = os.path.join(REF_INPUT, "chr21_1mb_matrix.txt")
    out2 = str(tmp_path / "o2")
    t0 = time.time()
    resp2 = request(server, {"matrix": src2, "out": out2, "models": 2})
    warm = time.time() - t0
    assert resp2["ok"] and resp2["summary"]["L"] == 37
    assert warm < cold, f"warm {warm:.2f}s not faster than cold {cold:.2f}s"

    pong = request(server, {"cmd": "ping"})
    assert len(pong["warm_buckets"]) == 1


def test_bad_request_keeps_serving(server):
    resp = request(server, {"matrix": "/nonexistent.txt", "out": "/tmp/x"})
    assert not resp["ok"] and "error" in resp
    assert request(server, {"cmd": "ping"})["ok"]


def test_shutdown(server):
    resp = request(server, {"cmd": "shutdown"})
    assert resp["ok"]


def test_restraints_file_request(server, tmp_path):
    """Serving the general distance-geometry request: solve directly from a
    CNS tbl (incl. an or-group row) through the warm server."""
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
    tbl = tmp_path / "amb.tbl"
    tbl.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out_r"
    resp = request(
        server,
        {"restraints": str(tbl), "out": str(out), "models": 2},
        timeout=600,
    )
    assert resp["ok"] and resp["summary"]["or_groups"] == 1
    assert (out / "amb_model1.pdb").exists()


def test_restraints_rr_request(server, tmp_path):
    """Serving a CONFOLD-style .rr restraint file request."""
    L = 10
    lines = [f"{i} {i + 1} 3.8 3.8 1.0" for i in range(1, L)]
    rr = tmp_path / "chain.rr"
    rr.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out_rr"
    resp = request(
        server,
        {"restraints": str(rr), "out": str(out), "models": 2},
        timeout=600,
    )
    assert resp["ok"] and resp["summary"]["restraints"] == L - 1
    assert (out / "chain_model1.pdb").exists()


def test_ping_during_slow_solve(server, tmp_path):
    """The threaded server must answer control requests while a solve holds
    the device: a ping during a long-running solve returns immediately with
    busy >= 1 (round-3 hardening; the old single-threaded server blocked)."""
    import numpy as np

    import chromosome3d.serve as srv

    # make the solve observably slow without burning CPU
    real = srv.SolverCache.solve

    def slow_solve(self, matrix, cfg):
        time.sleep(2.0)
        return real(self, matrix, cfg)

    srv.SolverCache.solve = slow_solve
    try:
        rng = np.random.RandomState(0)
        m = rng.gamma(2.0, 50.0, size=(16, 16))
        m = (m + m.T) / 2
        np.fill_diagonal(m, 5000.0)
        src = tmp_path / "m_matrix.txt"
        np.savetxt(src, m, fmt="%.3f")

        result = {}

        def bg():
            result["resp"] = request(
                server,
                {"matrix": str(src), "out": str(tmp_path / "slow_out"),
                 "models": 2},
                timeout=600,
            )

        t = threading.Thread(target=bg, daemon=True)
        t.start()
        # poll until the solve is observably in flight (busy counts before
        # the handler's first-request imports, so this converges fast); the
        # solve itself then sleeps 2 s, during which pings must answer
        pong, deadline = None, time.time() + 1.9
        while time.time() < deadline:
            t0 = time.time()
            pong = request(server, {"cmd": "ping"}, timeout=5)
            dt = time.time() - t0
            assert pong["ok"] and pong["pong"]
            assert dt < 1.0, f"ping took {dt:.2f}s during a solve"
            if pong["busy"] >= 1:
                break
            time.sleep(0.05)
        assert pong and pong["busy"] >= 1
        t.join(timeout=600)
        assert result["resp"]["ok"], result["resp"]
    finally:
        srv.SolverCache.solve = real


def test_request_bounds(server, tmp_path):
    """Out-of-bounds / malformed requests are rejected with ok=false and the
    server keeps serving."""
    src = os.path.join(REF_INPUT, "chr22_1mb_matrix.txt")
    if not os.path.exists(src):
        pytest.skip("reference not available")
    cases = [
        ({"matrix": src, "out": str(tmp_path / "x"), "models": 10**6},
         "models"),
        ({"matrix": src, "out": str(tmp_path / "x"), "models": 0}, "models"),
        ({"matrix": src, "out": str(tmp_path / "x"), "alpha": -1.0}, "alpha"),
        ({"matrix": src, "out": str(tmp_path / "x"), "kscaling": 0}, "kscaling"),
        ({"restraints": "/nonexistent.tbl", "out": str(tmp_path / "x")},
         "restraints"),
        ({"matrix": src}, "out"),
        ({"out": str(tmp_path / "x")}, "matrix"),
        ({"cmd": "frobnicate"}, "unknown cmd"),
        ({"matrix": src, "out": str(tmp_path / "x"), "models": "many"},
         "malformed"),
    ]
    for req, frag in cases:
        resp = request(server, req, timeout=30)
        assert not resp["ok"], (req, resp)
        assert frag in resp["error"], (req, resp)
    assert request(server, {"cmd": "ping"})["ok"]


def test_restraint_file_oversized_L_rejected(server, tmp_path):
    """A restraint file naming a residue index beyond MAX_L must be rejected
    with ok=false BEFORE any tensors are allocated or a solve is queued
    (round-3 finding: the validator only saw an explicit "L" field; a file
    whose length is INFERRED from its max resid walked past the cap)."""
    import chromosome3d.serve as srv

    big = srv.MAX_L + 1000
    tbl = tmp_path / "huge.tbl"
    tbl.write_text(
        f"assign45 (resid   1 and name ca) (resid {big} and name ca) "
        "3.80 0.00 0.00\n"
    )
    resp = request(server, {"restraints": str(tbl), "out": str(tmp_path / "o")})
    assert not resp["ok"] and "exceeds the cap" in resp["error"], resp

    rr = tmp_path / "huge.rr"
    rr.write_text(f"1 {big} 3.8 3.8 1.0\n")
    resp = request(server, {"restraints": str(rr), "out": str(tmp_path / "o2")})
    assert not resp["ok"] and "exceeds the cap" in resp["error"], resp
    # server alive and still solving after both rejections
    assert request(server, {"cmd": "ping"})["ok"]
    small = tmp_path / "small.rr"
    small.write_text("\n".join(f"{i} {i + 1} 3.8 3.8 1.0" for i in range(1, 8)) + "\n")
    resp = request(
        server, {"restraints": str(small), "out": str(tmp_path / "o3"),
                 "models": 2}, timeout=600,
    )
    assert resp["ok"], resp


def test_beyond_bucket_single_device_uses_device_prep(tmp_path, monkeypatch):
    """A beyond-bucket matrix request on ONE device must route through the
    device-side exact-tile prep STRAIGHT FROM THE IF MATRIX — the host
    never builds restraints (build_restraints is minutes at scale on a
    single-vCPU box) — and the host assessment views come back as a
    post-solve download (late round 4)."""
    import numpy as np

    import chromosome3d.ops.device_prep as dp
    import chromosome3d.pipeline as pl
    import chromosome3d.restraints as rst
    from chromosome3d.serve import SolverCache

    cfg = PipelineConfig(
        model_count=2,
        anneal=fast_anneal(AnnealConfig(use_pallas=False)),
        length_buckets=(16, 24),
        shard_large=True,
        shard_quantum=16,
    )
    cache = SolverCache(cfg)
    # force the single-device at-scale branch despite the 8 fake devices
    monkeypatch.setattr(pl, "_use_sharded", lambda L, c: False)
    calls = []
    real = dp.exact_tiles_from_if_device

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(dp, "exact_tiles_from_if_device", spy)
    monkeypatch.setattr(
        rst, "build_restraints",
        lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("at-scale matrix route must not host-build")
        ),
    )

    rng = np.random.RandomState(0)
    L = 40  # beyond every bucket -> quantum_bucket(40, 16) = 48
    m = rng.gamma(2.0, 50.0, size=(L, L))
    m = (m + m.T) / 2
    np.fill_diagonal(m, 5000.0)
    coords, energies, r, dense_view = cache.solve(m, cfg)
    # one prep call for the solve + one (memoized program) for the
    # post-solve assessment download
    assert len(calls) == 2, "device-side IF prep was not used"
    assert calls[0][1] == 48  # the quantum bucket, not a length bucket
    assert coords.shape == (2, L, 3) and np.isfinite(coords).all()
    assert cache.warm_snapshot()[0][0] == 48
    # the downloaded host views match the host route bit-for-bit
    host = rst.dist_to_restraints(rst.if_to_dist(m, cfg.restraints),
                                  cfg.restraints)
    assert r.length == L and r.count == host.count
    np.testing.assert_array_equal(r.target, host.target)
    np.testing.assert_array_equal(r.mask, host.mask)
    assert dense_view is not None
    np.testing.assert_array_equal(dense_view.target, host.target)


def test_queue_depth_cap():
    """Requests beyond MAX_QUEUE in-flight solves are rejected immediately
    (no thread needed: preload the busy counter and call the handler)."""
    from chromosome3d.serve import MAX_QUEUE, SolverCache, handle_request

    cache = SolverCache(PipelineConfig(model_count=2))
    cache.busy = MAX_QUEUE
    resp = handle_request(
        {"restraints": "/nonexistent-but-unreached.rr", "out": "/tmp/x"}, cache
    )
    # validation runs before the queue check and rejects the missing file;
    # use a real file so the queue check is what fires
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".rr", mode="w", delete=False) as f:
        f.write("1 2 3.8 3.8 1.0\n")
        path = f.name
    try:
        resp = handle_request({"restraints": path, "out": "/tmp/x"}, cache)
        assert not resp["ok"] and "busy" in resp["error"], resp
        assert cache.busy == MAX_QUEUE  # not leaked by the rejection
    finally:
        os.unlink(path)


def test_matrix_request_keeps_operator_restraint_config(tmp_path, monkeypatch):
    """A matrix request that omits alpha/kscaling must solve with the
    OPERATOR's base restraint config, not hardcoded 0.5/11.0 (round-4
    review: the dataclasses.replace existed to preserve operator fields,
    then overwrote exactly the two it touched)."""
    import dataclasses

    from chromosome3d.serve import SolverCache, handle_request

    base = PipelineConfig(
        model_count=2,
        restraints=RestraintConfig(alpha=1.1, kscaling=7.0),
    )
    cache = SolverCache(base)
    seen = {}

    def fake_solve(self, matrix, cfg):
        seen["rc"] = cfg.restraints
        raise RuntimeError("stop after capture")

    monkeypatch.setattr(SolverCache, "solve", fake_solve)
    src = tmp_path / "m.txt"
    np.savetxt(src, [[9.0, 2.0], [2.0, 9.0]], fmt="%.1f")
    # the capture stub raises (exception-to-response wrapping lives in the
    # socket handler, not handle_request)
    with pytest.raises(RuntimeError, match="stop after capture"):
        handle_request({"matrix": str(src), "out": str(tmp_path / "o")}, cache)
    assert seen["rc"].alpha == 1.1 and seen["rc"].kscaling == 7.0
    # explicit request fields still override the base
    with pytest.raises(RuntimeError, match="stop after capture"):
        handle_request(
            {"matrix": str(src), "out": str(tmp_path / "o"), "alpha": 0.7,
             "kscaling": 12.0}, cache
        )
    assert seen["rc"].alpha == 0.7 and seen["rc"].kscaling == 12.0


def test_restraint_request_marks_warm(server, tmp_path):
    """Restraint-file requests must register their bucket in the warm set
    (round-2 finding: they bypassed bookkeeping)."""
    L = 10
    rr = tmp_path / "chain2.rr"
    rr.write_text("\n".join(f"{i} {i + 1} 3.8 3.8 1.0" for i in range(1, L)) + "\n")
    resp = request(
        server,
        {"restraints": str(rr), "out": str(tmp_path / "o"), "models": 2},
        timeout=600,
    )
    assert resp["ok"]
    pong = request(server, {"cmd": "ping"})
    assert len(pong["warm_buckets"]) == 1
