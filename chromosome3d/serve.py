"""Warm-model serving.

Production deployments solve many matrices over time; XLA compilation
costs more than a solve. This module provides a long-lived server that
keeps compiled solve programs warm across requests, keyed by (padded length
bucket, model count, schedule): the first request for a bucket pays the
compile, every later one runs in milliseconds-to-seconds.

Transport is a Unix domain socket with newline-delimited JSON (zero-egress
friendly; no TCP). The server is THREADED: each connection gets a handler
thread, control requests (ping/shutdown) answer immediately, and device
work is serialized through one lock — a cold-compile request never
blocks a ping, and two solves never interleave on the device. Protocol:

  request:  {"matrix": "/path/to/if_matrix.txt", "out": "/path/out",
             "alpha": 0.5, "kscaling": 11.0, "models": 10,
             "turbo": true}
  response: {"ok": true, "summary": {...}}   |   {"ok": false, "error": "..."}
  control:  {"cmd": "ping"} -> {"ok": true, "pong": true, "warm_buckets": [...],
             "busy": <solves in flight or waiting>}
            {"cmd": "shutdown"} -> server exits after responding

Request bounds (rejected with ok=false, never crashing the server):
models 1..MAX_MODELS, 0 < alpha <= MAX_ALPHA, 0 < kscaling <= MAX_KSCALING,
1 < L <= MAX_L, input paths must exist.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
from typing import Dict, Optional

import numpy as np

from chromosome3d.config import PipelineConfig, RestraintConfig, turbo_anneal
from chromosome3d.utils.logging import get_logger

log = get_logger(__name__)

# request caps: generous for real workloads, small enough that a typo'd or
# hostile request cannot OOM the device or queue hours of work
MAX_MODELS = 256
MAX_L = 65536
MAX_ALPHA = 16.0
MAX_KSCALING = 1e6
# solves in flight or waiting on the device lock before new ones are
# rejected: bounds the queue a runaway client can build up
MAX_QUEUE = 32


class SolverCache:
    """Holds jitted solve programs warm, keyed by (L_pad, models, schedule id).

    jax's jit cache already keys on shapes + static config; this class's job
    is to route every request through the SAME padded shapes so that cache
    actually hits (the same coarse bucketing the genome runner uses).
    device_lock serializes everything that touches the accelerator: handler
    threads answer control requests concurrently, but solves queue.
    """

    def __init__(self, base: Optional[PipelineConfig] = None):
        self.base = base or PipelineConfig()
        self.warm: set = set()
        self.device_lock = threading.Lock()
        self.busy = 0               # solves holding or waiting on the lock
        self._busy_lock = threading.Lock()
        # (L_pad, anneal cfg, n_models) -> compiled/jitted solve; with
        # CHROM3D_AOT_CACHE set these round-trip through the on-disk
        # serialized-executable cache, so even a FRESH server process skips
        # the compile (utils/aot.py)
        self._programs: dict = {}

    def bucket_for(self, L: int) -> int:
        fit = [b for b in self.base.length_buckets if b >= L]
        if fit:
            return min(fit)
        if self.base.shard_large:
            from chromosome3d.pipeline import quantum_bucket

            return quantum_bucket(L, self.base.shard_quantum)
        raise ValueError(
            f"L={L} exceeds the largest bucket {max(self.base.length_buckets)}"
        )

    def mark_warm(self, L: int, cfg: PipelineConfig) -> None:
        self.add_warm(self.bucket_for(L), cfg)

    def add_warm(self, L_pad: int, cfg: PipelineConfig) -> None:
        with self._busy_lock:   # guards warm against ping's iteration
            self.warm.add((L_pad, cfg.model_count, cfg.anneal.total_steps))

    def warm_snapshot(self):
        with self._busy_lock:
            return sorted(self.warm)

    def solve(self, matrix: np.ndarray, cfg: PipelineConfig):
        """Solve one chromosome through the padded path; returns
        (coords (n, L, 3), energies dict, host Restraints view, and an
        assessment-ready dense view or None) with padding stripped. Caller
        must hold device_lock.

        At-scale EXACT matrix requests (L beyond every bucket, quadratic
        well) never touch a host O(L^2) pass: tiles are built on device
        straight from the IF matrix (ops.device_prep) and the host views
        are DOWNLOADED post-solve — build_restraints here measured 313 s
        at L = 8192, the download is one f32 transfer."""
        import jax
        import jax.numpy as jnp

        from chromosome3d.ops.energy import (
            auto_weight_exponent,
            dense_restraints_from_numpy,
        )
        from chromosome3d.restraints import build_restraints

        L = matrix.shape[0]
        rc = cfg.restraints
        from chromosome3d.pipeline import (
            _assessment_view_from_if,
            _exact_provable,
            _sharded_solve,
            _use_sharded,
            auto_exact,
            auto_exact_matrix,
            quantum_bucket,
        )

        device_route = L > max(cfg.length_buckets) and _exact_provable(
            auto_exact_matrix(cfg)
        )
        if device_route:
            cfg = auto_exact_matrix(cfg)
            r = None
        else:
            r = build_restraints(matrix, rc)
            cfg = auto_exact(cfg, r)  # matrix-derived restraints: fast kernel
        key = jax.random.PRNGKey(cfg.seed)
        L_warm = None
        sharded = _use_sharded(L, cfg)
        if_dev = None
        if device_route:
            # pad once, thread the copy through the solve prep and the f32
            # assessment view (each separate pad_f32 is an O(L^2) host
            # copy — run_pipeline's discipline)
            from chromosome3d.ops.device_prep import pad_f32

            if_dev = pad_f32(
                matrix,
                quantum_bucket(L, cfg.shard_quantum,
                               multiple=len(jax.devices()))
                if sharded
                else self.bucket_for(L),
            )
        if sharded:
            # at-scale request: row-sharded over the device mesh, same
            # dispatch as run_pipeline (the program cache is jax's jit
            # cache + the AOT executable cache inside _sharded_solve).
            # Record the ACTUAL padded length the program compiled at
            # (lcm(quantum, devices) — not the plain quantum bucket).
            if device_route:
                result, L_warm = _sharded_solve(
                    None, rc, cfg, key, cfg.model_count, if_matrix=if_dev,
                    L_true=L,
                )
            else:
                result, L_warm = _sharded_solve(r, rc, cfg, key,
                                                cfg.model_count,
                                                device_prep=True)
        else:
            L_pad = self.bucket_for(L)
            p = rc.weight_exponent
            if p is None:
                p = auto_weight_exponent(L)
            if device_route:
                # beyond-bucket single-device request: the whole L3 prep on
                # device from the IF matrix, two-tensor exact form (half the
                # live restraint HBM); no float64 host passes
                from chromosome3d.ops.device_prep import (
                    exact_tiles_from_if_device,
                )

                dense = exact_tiles_from_if_device(
                    if_dev, L_pad, rc, rc.weighting, p, n_true=L,
                    # bf16-STORED tiles when pair_bf16 (the assessment view
                    # below is a separate f32 prep program)
                    out_dtype="bfloat16" if cfg.anneal.pair_bf16
                    else "float32",
                )
            else:
                dense = dense_restraints_from_numpy(
                    r.padded(L_pad), rc.weighting, p
                )
            bead = jnp.asarray(
                np.pad(np.ones(L, np.float32), (0, L_pad - L)), jnp.float32
            )
            prog_key = (L_pad, cfg.anneal, cfg.model_count)
            solve = self._programs.get(prog_key)
            if solve is None:
                from chromosome3d.solver.anneal import solve_ensemble_impl
                from chromosome3d.utils.aot import load_or_compile

                an, n_models = cfg.anneal, cfg.model_count
                solve = load_or_compile(
                    jax.jit(lambda d, k, b: solve_ensemble_impl(d, an, k, n_models, b)),
                    (dense, key, bead),
                    tag="serve_bucket",
                    statics=f"{an!r}|n={n_models}",
                )
                self._programs[prog_key] = solve
            result = solve(dense, key, bead)
            L_warm = L_pad
        self.add_warm(L_warm, cfg)
        coords = np.asarray(result.coords)[:, :L, :]
        energies = {k: np.asarray(v) for k, v in result.energies.items()}
        # the downloads above fenced the solve: free the solve tiles BEFORE
        # the f32 assessment re-prep below allocates its own, so the two
        # tile sets never coexist at the HBM peak (same order as
        # run_pipeline's at-scale branch and run_genome's bf16 route)
        dense = result = None
        dense_view = None
        if device_route:
            # host views for assessment: one f32 download. With pair_bf16
            # OFF the memoized solve-prep program re-invokes for ~free;
            # with it ON the solve compiled the bf16-stored prep, so this
            # f32 view is a DISTINCT program paying its own compile on
            # the first at-scale request per bucket.
            # Layout must match the solve's so the jit cache hits.
            L_assess = (
                quantum_bucket(L, cfg.shard_quantum,
                               multiple=len(jax.devices()))
                if sharded
                else self.bucket_for(L)
            )
            r, dense_view = _assessment_view_from_if(
                if_dev, rc, L_assess, sharded, n_true=L
            )
        return coords, energies, r, dense_view


def _validate(req: Dict, cache: SolverCache) -> Optional[str]:
    """Bounds-check a solve request; returns an error string or None."""
    try:
        models = int(req.get("models", cache.base.model_count))
        if not 1 <= models <= MAX_MODELS:
            return f"models={models} out of bounds [1, {MAX_MODELS}]"
        alpha = float(req.get("alpha", cache.base.restraints.alpha))
        if not 0.0 < alpha <= MAX_ALPHA:
            return f"alpha={alpha} out of bounds (0, {MAX_ALPHA}]"
        k = float(req.get("kscaling", cache.base.restraints.kscaling))
        if not 0.0 < k <= MAX_KSCALING:
            return f"kscaling={k} out of bounds (0, {MAX_KSCALING}]"
        if "L" in req:
            L = int(req["L"])
            if not 1 < L <= MAX_L:
                return f"L={L} out of bounds (1, {MAX_L}]"
        for key in ("matrix", "restraints"):
            if key in req and not os.path.isfile(str(req[key])):
                return f"{key} file {req[key]!r} does not exist"
        if "out" in req and not str(req["out"]).strip():
            return "out must be a non-empty path"
    except (TypeError, ValueError) as e:
        return f"malformed request field: {e}"
    return None


def handle_request(req: Dict, cache: SolverCache) -> Dict:
    if req.get("cmd") == "ping":
        return {
            "ok": True,
            "pong": True,
            "warm_buckets": cache.warm_snapshot(),
            "busy": cache.busy,
        }
    if req.get("cmd"):
        return {"ok": False, "error": f"unknown cmd {req['cmd']!r}"}
    if "restraints" not in req and "matrix" not in req:
        return {"ok": False, "error": "request needs 'matrix' or 'restraints'"}
    if "out" not in req:
        return {"ok": False, "error": "request needs 'out'"}
    err = _validate(req, cache)
    if err:
        return {"ok": False, "error": err}

    # count the request as busy BEFORE the first-request imports below —
    # in a fresh process those take ~0.5 s, during which a concurrent ping
    # must already see busy >= 1. The queue-depth cap rides the same lock
    # acquisition: check-and-increment is atomic.
    with cache._busy_lock:
        if cache.busy >= MAX_QUEUE:
            return {
                "ok": False,
                "error": f"server busy: {cache.busy} solves in flight or "
                         f"queued (max {MAX_QUEUE})",
            }
        cache.busy += 1
    try:
        from chromosome3d.io.matrix import load_if_matrix
        from chromosome3d.ops.energy import dense_restraints_from_numpy
        from chromosome3d.pipeline import emit_artifacts

        if "restraints" in req:
            # solve directly from a .rr / CNS .tbl restraint file (incl.
            # or-groups) — the general distance-geometry request; the
            # bucketed pipeline + the AOT executable cache keep repeated
            # shapes warm
            from chromosome3d.pipeline import run_restraints_pipeline

            anneal_r = cache.base.anneal
            if req.get("turbo"):
                anneal_r = turbo_anneal(anneal_r)
            cfg_r = cache.base.replace(
                model_count=int(req.get("models", cache.base.model_count)),
                anneal=anneal_r,
            )
            try:
                with cache.device_lock:
                    # max_L guards the INFERRED length too: a file naming
                    # resid 200000 with no "L" field must be rejected
                    # before tensors are allocated or a solve is queued
                    summary = run_restraints_pipeline(
                        req["restraints"], req["out"], cfg_r,
                        L=int(req["L"]) if "L" in req else None,
                        max_L=MAX_L,
                    )
            except ValueError as e:
                return {"ok": False, "error": str(e)}
            try:
                # the pipeline reports the padded length its program
                # actually compiled at (L_solved) — record THAT, not the
                # plain quantum bucket (they differ for sharded solves)
                cache.add_warm(int(summary["L_solved"]), cfg_r)
            except (ValueError, KeyError):
                # bookkeeping only (e.g. shard_large=False with L beyond
                # every bucket: the exact-L solve still completed) — never
                # turn a finished solve into an error response
                pass
            # same wire shape as the matrix route (the documented protocol:
            # {"ok": true, "summary": {...}})
            return {"ok": True, "summary": summary}

        matrix_path = req["matrix"]
        out_dir = req["out"]
        anneal = cache.base.anneal
        if req.get("turbo"):
            anneal = turbo_anneal(anneal)
        import dataclasses

        cfg = cache.base.replace(
            model_count=int(req.get("models", cache.base.model_count)),
            # per-request knobs override the server's BASE restraint config;
            # rebuilding RestraintConfig() here would silently reset every
            # other field (separation, weighting, weight_exponent, ...) the
            # operator configured at serve() time
            restraints=dataclasses.replace(
                cache.base.restraints,
                # absent fields keep the OPERATOR's values — a hardcoded
                # 11.0/0.5 here would silently reset exactly the two knobs
                # this replace() exists to preserve
                kscaling=float(
                    req.get("kscaling", cache.base.restraints.kscaling)
                ),
                alpha=float(req.get("alpha", cache.base.restraints.alpha)),
            ),
            anneal=anneal,
        )
        # bound L from the FIRST ROW before materializing the whole matrix:
        # a typo'd/hostile 200k-square file would otherwise make the server
        # load tens of GB of float64 before the post-load check ran
        from chromosome3d.io.matrix import matrix_length

        L_head = matrix_length(matrix_path)
        if L_head > MAX_L:
            return {"ok": False,
                    "error": f"matrix L={L_head} exceeds {MAX_L}"}
        matrix = load_if_matrix(matrix_path)
        if matrix.shape[0] > MAX_L:
            return {"ok": False,
                    "error": f"matrix L={matrix.shape[0]} exceeds {MAX_L}"}
        with cache.device_lock:
            coords, energies, restraints, dense = cache.solve(matrix, cfg)
        os.makedirs(out_dir, exist_ok=True)
        ident = os.path.basename(matrix_path)
        ident = ident[:-4] if ident.endswith(".txt") else ident
        if dense is None:
            # assessment-only tensors: HOST numpy (emit_artifacts is host-
            # side by the documented rule — device arrays here would upload
            # four true-L (L, L) tensors the device never reads, outside
            # device_lock). At-scale device-route solves returned their
            # downloaded exact view instead.
            dense = dense_restraints_from_numpy(
                restraints, cfg.restraints.weighting,
                cfg.restraints.weight_exponent, as_numpy=True,
            )
        summary = emit_artifacts(
            out_dir, ident, coords, energies, matrix, restraints, dense, cfg
        )
        return {"ok": True, "summary": summary}
    finally:
        with cache._busy_lock:
            cache.busy -= 1


def serve(socket_path: str, cfg: Optional[PipelineConfig] = None) -> None:
    """Blocking server loop on a Unix domain socket (threaded: one handler
    thread per connection; device work serialized by cache.device_lock)."""
    cache = SolverCache(cfg)
    if os.path.exists(socket_path):
        os.remove(socket_path)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    self._reply({"ok": False, "error": f"bad json: {e}"})
                    continue
                if not isinstance(req, dict):
                    self._reply({"ok": False, "error": "request must be an object"})
                    continue
                if req.get("cmd") == "shutdown":
                    self._reply({"ok": True, "bye": True})
                    # shutdown() must run off the serve_forever thread and
                    # off this handler (it joins the pollers); a daemon
                    # thread unblocks both
                    threading.Thread(
                        target=self.server.shutdown, daemon=True
                    ).start()
                    return
                try:
                    self._reply(handle_request(req, cache))
                except Exception as e:  # report, keep serving
                    log.info(f"request failed: {e!r}")
                    self._reply({"ok": False, "error": repr(e)})

        def _reply(self, obj):
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()

    class Server(socketserver.ThreadingUnixStreamServer):
        allow_reuse_address = True
        daemon_threads = True

    log.info(f"serving on {socket_path}")
    with Server(socket_path, Handler) as server:
        try:
            server.serve_forever()
        finally:
            if os.path.exists(socket_path):
                os.remove(socket_path)


def request(socket_path: str, req: Dict, timeout: float = 600.0) -> Dict:
    """One-shot client: send a request, return the response dict. Retries
    briefly on ConnectionRefused (the server's bind->listen window) with a
    FRESH socket per attempt — POSIX leaves a socket's state unspecified
    after a failed connect, so reusing one can fail with EINVAL."""
    import time as _time

    s = None
    for attempt in range(20):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        try:
            s.connect(socket_path)
            break
        except (ConnectionRefusedError, FileNotFoundError):
            s.close()
            s = None
            if attempt == 19:
                raise
            _time.sleep(0.05)
        except BaseException:
            # any other connect failure (timeout, EPERM, ...): don't leak
            # the per-attempt socket fd on the propagation path
            s.close()
            raise
    try:
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    finally:
        s.close()
    return json.loads(buf.decode())
