#!/usr/bin/env python3
"""Scaling benchmark: solve synthetic chromosomes at growing L and report
anneal steps/sec, on whatever devices exist.

  python scripts/bench_scaling.py                 # on-chip batched solver
  python scripts/bench_scaling.py --sharded       # row-sharded (beads mesh)
  python scripts/bench_scaling.py --cpu --devices 8

Synthetic inputs are gamma-distributed IF matrices with the reference's
statistics (symmetric, dominant diagonal), so the energy work matches real
data exactly.
"""

import argparse
import functools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def synthetic_matrix(L, seed=0):
    rng = np.random.RandomState(seed)
    base = rng.gamma(2.0, 50.0, size=(L, L))
    m = (base + base.T) / 2
    np.fill_diagonal(m, 5000.0)
    return m


def synthetic_structured_matrix(L, seed=0):
    """An IF matrix with a consistent 3D ground truth: a smooth random-walk
    chain, IF = (c / d_true)^2 (the inverse of the reference's d = K*m/IF^0.5
    conversion). A solve can recover this structure, so its best Spearman is
    a SENSITIVE quality metric at scale — unlike the gamma matrix, whose
    mutually inconsistent restraints rank-correlate weakly with any embedding
    (~0.18 at L=128)."""
    rng = np.random.RandomState(seed)
    steps = rng.randn(L + 32, 3)
    # moving-average smoothing: persistent direction -> polymer-like chain
    k = 16
    kern = np.ones(k) / k
    steps = np.stack([np.convolve(steps[:, a], kern, "valid") for a in range(3)], 1)
    steps = steps[:L]
    steps /= np.linalg.norm(steps, axis=1, keepdims=True) + 1e-9
    coords = np.cumsum(steps * 3.8, axis=0)
    d = np.sqrt(((coords[:, None] - coords[None, :]) ** 2).sum(-1) + 1e-12)
    m = (100.0 / d) ** 2
    np.fill_diagonal(m, 5000.0)
    return m.astype(np.float64)


def synthetic_matrix_device(L, seed=0):
    """Same statistics, generated ON device: at L >= 16384 the host RNG +
    O(L^2) numpy passes cost minutes on a host with little memory
    bandwidth while the device program is milliseconds (see
    ops/device_prep.py).

    Gamma(2, 50) is sampled as -50*(log U1 + log U2) — the Erlang identity —
    instead of jax.random.gamma: the generic gamma rejection sampler's
    threefry-split while loop materializes a u32[L*L, 3] temp (~16 GB HLO
    temp at L=16384)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        k1, k2 = jax.random.split(key)
        tiny = jnp.float32(1e-12)
        u1 = jax.random.uniform(k1, (L, L), jnp.float32, tiny, 1.0)
        u2 = jax.random.uniform(k2, (L, L), jnp.float32, tiny, 1.0)
        base = -50.0 * (jnp.log(u1) + jnp.log(u2))
        m = (base + base.T) / 2
        i = jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
        return jnp.where(i == j, 5000.0, m)

    return gen(jax.random.PRNGKey(seed))


def synthetic_matrix_host_strips(L, strip=4096):
    """Host (L, L) f32 synthetic assembled from DEVICE-generated row strips:
    past ~41k the whole-matrix device generator OOMs on its own
    symmetrization (base + base.T needs two (L, L) planes) and the host
    gamma sampler takes minutes — this keeps the device peak at one strip
    and the host work at transfer speed. Values are symmetric by
    construction (a counter hash of the SORTED pair), gamma(2, 50)-shaped
    via the Erlang identity — distribution fidelity is irrelevant here,
    these sizes are prep/solve THROUGHPUT probes (--quality is impractical
    far below them)."""
    import jax
    import jax.numpy as jnp

    from chromosome3d.ops.device_prep import _pick_strip_rows

    S = _pick_strip_rows(L, cap=strip)

    @functools.partial(jax.jit, static_argnums=(0, 1))
    def gen_strip(Ls, Lcols, r0):
        i = jax.lax.broadcasted_iota(jnp.int32, (Ls, Lcols), 0) + r0
        j = jax.lax.broadcasted_iota(jnp.int32, (Ls, Lcols), 1)
        a = jnp.minimum(i, j).astype(jnp.uint32)
        b = jnp.maximum(i, j).astype(jnp.uint32)
        # two decorrelated 31-bit Knuth/LCG hashes of the unordered pair
        # (uint32 wraparound arithmetic)
        c1, c2 = np.uint32(2654435761), np.uint32(40503)
        h1 = (a * c1 + b * c2 + np.uint32(12345)) & np.uint32(0x7FFFFFFF)
        h2 = (a * c2 + b * c1 + np.uint32(67891)) & np.uint32(0x7FFFFFFF)
        tiny = jnp.float32(1.0 / 2147483648.0)
        u1 = jnp.maximum(h1.astype(jnp.float32) * tiny, tiny)
        u2 = jnp.maximum(h2.astype(jnp.float32) * tiny, tiny)
        base = -50.0 * (jnp.log(u1) + jnp.log(u2))  # Erlang(2, 50)
        return jnp.where(i == j, 5000.0, base)

    out = np.empty((L, L), np.float32)
    for r0 in range(0, L, S):
        out[r0:r0 + S] = np.asarray(gen_strip(S, L, jnp.int32(r0)))
    return out


def synthetic_tiles_device(L, rc, weighting, p, out_dtype="float32"):
    """ExactRestraints synthesized DIRECTLY on device — no (L, L) IF matrix
    is ever resident. This is the SOLVE-feasibility probe past the one-shot
    prep ceiling (the one-shot prep holds the f32 IF upload and the
    output tiles together, ~8*L^2 bytes, twice the bf16 solve's tiles;
    whether the SOLVE fits past it is a separate question this mode
    answers). Targets
    follow the equilibrium-globule scaling d ~ |i-j|^(1/3) with the same
    %.1f quantization and separation mask device prep emits, so the solve
    sees production-shaped tiles; every input is iota-derived, so XLA fuses
    the whole program into the two output loops + one weight-norm reduce
    (peak ~= the output tiles themselves)."""
    import jax
    import jax.numpy as jnp

    from chromosome3d.ops.device_prep import _weights_from_target

    sep = int(rc.separation)

    @functools.partial(jax.jit, static_argnums=(0, 1, 2))
    def gen(Ls, w_mode, dt_name, pe):
        i = jax.lax.broadcasted_iota(jnp.int32, (Ls, Ls), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (Ls, Ls), 1)
        s = jnp.abs(i - j).astype(jnp.float32)
        d = jnp.power(jnp.maximum(s, 1.0), jnp.float32(1.0 / 3.0))
        # the %.1f quantization, compensated /10 (ops/device_prep.py)
        k = jnp.round(d * 10.0)
        q = k * jnp.float32(0.1) + k * jnp.float32(0.1 - float(np.float32(0.1)))
        t = jnp.where((s >= sep) & (i != j), q, 0.0)
        w = _weights_from_target(t, pe, w_mode)
        if dt_name != "float32":
            dt = jnp.dtype(dt_name)
            t, w = t.astype(dt), w.astype(dt)
        from chromosome3d.ops.energy import ExactRestraints

        return ExactRestraints(target=t, w=w)

    return gen(L, weighting, str(out_dtype), jnp.float32(p))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048")
    ap.add_argument("--models", type=int, default=4)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="force host device count (CPU only)")
    ap.add_argument("--turbo", action="store_true", default=True)
    ap.add_argument("--dense-form", action="store_true",
                    help="force the four-tensor DenseRestraints form "
                         "(default: the two-tensor ExactRestraints form, "
                         "which halves live restraint HBM at scale)")
    ap.add_argument("--host-prep", action="store_true",
                    help="build the synthetic matrix and restraint tiles on "
                         "the HOST (the reference-semantics f64 route) "
                         "instead of on device; minutes per case at "
                         "L >= 8192")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 restraint tiles (AnnealConfig.pair_bf16)")
    ap.add_argument("--quality", action="store_true",
                    help="score best Spearman(IF, 1/d) of the ensemble "
                         "against the synthetic matrix (host scipy; "
                         "practical to L ~ 4096)")
    ap.add_argument("--tiles-only", action="store_true",
                    help="synthesize the ExactRestraints tiles directly on "
                         "device (no IF matrix ever resident) — the solve-"
                         "feasibility probe past the one-shot prep ceiling")
    ap.add_argument("--structured", action="store_true",
                    help="use the structured synthetic (consistent 3D "
                         "ground truth) instead of the gamma matrix — the "
                         "quality-sensitive choice for --quality A/Bs")
    args = ap.parse_args()

    if args.devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    from chromosome3d.utils.aot import DEFAULT_CACHE_DIR
    from chromosome3d.utils.cache import configure_compile_cache

    configure_compile_cache()
    os.environ.setdefault("CHROM3D_AOT_CACHE", DEFAULT_CACHE_DIR)

    from chromosome3d.config import AnnealConfig, RestraintConfig, turbo_anneal
    from chromosome3d.ops.energy import (
        dense_restraints_from_numpy,
        exact_restraints_from_numpy,
    )
    from chromosome3d.restraints import build_restraints
    from chromosome3d.solver.anneal import solve_ensemble
    from chromosome3d.solver.sharded import solve_ensemble_sharded

    platform = jax.devices()[0].platform
    # build_restraints always yields exact restraints; the pair route
    # (GPU kernel or plain path) is AnnealConfig's AUTO choice, on the
    # single-device and the sharded solver alike
    cfg = turbo_anneal(AnnealConfig(
        exact_restraints=True,
        pair_bf16=args.bf16,
    ))
    rc = RestraintConfig()

    builder = (
        dense_restraints_from_numpy if args.dense_form
        else exact_restraints_from_numpy
    )
    results = []
    dense = res = coords = None
    for L in [int(s) for s in args.sizes.split(",")]:
        # free the previous case's device tiles BEFORE building the next:
        # a multi-size sweep near the HBM ceiling otherwise holds the old
        # (L, L) tensors alive through the new prep (measured OOM at
        # 36864-after-32768 that the same size solves alone). Measure
        # the last ~10% of the ceiling one size per process (async frees
        # and fragmentation can still bite there)
        dense = res = coords = None
        gen = synthetic_structured_matrix if args.structured else synthetic_matrix
        m_host = (
            gen(L) if (args.quality or args.structured) and not args.tiles_only
            else None
        )
        t_prep = time.time()
        if args.tiles_only:
            from chromosome3d.ops.energy import auto_weight_exponent

            dense = synthetic_tiles_device(
                L, rc, rc.weighting,
                auto_weight_exponent(L)
                if rc.weight_exponent is None
                else rc.weight_exponent,
                out_dtype="bfloat16" if args.bf16 else "float32",
            )
            np.asarray(dense.w[:1, :1])  # fence: include tile synthesis
        elif args.host_prep or args.dense_form:
            dense = builder(build_restraints(
                synthetic_matrix(L) if m_host is None else m_host, rc
            ))
        else:
            from chromosome3d.ops.device_prep import exact_tiles_from_if_device
            from chromosome3d.ops.energy import auto_weight_exponent

            import jax.numpy as jnp

            from chromosome3d.ops.device_prep import should_stream_prep

            dtname = "bfloat16" if args.bf16 else "float32"
            if should_stream_prep(L, dtname) and m_host is None:
                # the streamed route wants the matrix on the HOST (that is
                # the point: IF + tiles cannot coexist on device past the
                # one-shot ceiling; the whole-matrix device generator OOMs
                # there too) — strip-generate it host-side; prep_s then
                # includes the strip sweeps, exactly what a product run
                # from a file pays
                mat_dev = synthetic_matrix_host_strips(L)
            else:
                mat_dev = (
                    synthetic_matrix_device(L) if m_host is None
                    else jnp.asarray(m_host, jnp.float32)
                )
            dense = exact_tiles_from_if_device(
                mat_dev, L, rc, rc.weighting,
                auto_weight_exponent(L)
                if rc.weight_exponent is None
                else rc.weight_exponent,
                out_dtype=dtname,
            )
            np.asarray(dense.w[:1, :1])  # fence: include prep execution
        prep_s = time.time() - t_prep
        t0 = time.time()
        if args.sharded:
            # the full at-scale program: row-sharded landmark init +
            # ensemble + enantiomer, no host-fed x0 (solver.sharded)
            from jax.sharding import Mesh

            mesh = Mesh(np.array(jax.devices()), ("beads",))
            cfg_s = dataclasses.replace(cfg, init="landmark")
            fn = jax.jit(
                lambda d, k: solve_ensemble_sharded(
                    mesh, d, cfg_s, k, args.models
                )
            )
            np.asarray(fn(dense, jax.random.PRNGKey(0)).coords)
            compile_s = time.time() - t0
            t0 = time.time()
            coords = np.asarray(fn(dense, jax.random.PRNGKey(1)).coords)
            n_struct = coords.shape[0]
        else:
            res = solve_ensemble(dense, cfg, jax.random.PRNGKey(0), args.models)
            np.asarray(res.coords)
            compile_s = time.time() - t0
            t0 = time.time()
            res = solve_ensemble(dense, cfg, jax.random.PRNGKey(1), args.models)
            coords = np.asarray(res.coords)
            n_struct = coords.shape[0]
        wall = time.time() - t0
        try:  # HBM evidence for the restraint-form memory claim (VERDICT #2)
            stats = jax.devices()[0].memory_stats() or {}
            peak_gb = round(stats.get("peak_bytes_in_use", 0) / 2**30, 2)
        except Exception:
            peak_gb = None
        best_sp = None
        if m_host is not None:
            from chromosome3d.metrics import spearman_if_inv_d

            best_sp = round(
                max(float(spearman_if_inv_d(m_host, c)) for c in coords), 4
            )
        row = {
            "L": L,
            "structures": n_struct,
            "steps": cfg.total_steps,
            "prep_s": round(prep_s, 3),
            "compile_s": round(compile_s, 1),
            "solve_s": round(wall, 3),
            "steps_per_sec": round(cfg.total_steps / wall, 1),
            "platform": platform,
            "devices": len(jax.devices()),
            "sharded": args.sharded,
            "form": (
                "tiles_only" if args.tiles_only
                else "dense" if args.dense_form else "exact2"
            ),
            "bf16": args.bf16,
            "peak_hbm_gb": peak_gb,
            "best_spearman": best_sp,
        }
        results.append(row)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
