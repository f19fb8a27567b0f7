#!/usr/bin/env python3
"""The GPU pair kernel (ops.pair_kernel) against what XLA makes of the
plain analytic path (ops.pair), on the card.

  python scripts/pair_kernel_ab.py            # pair call + whole solve
  python scripts/pair_kernel_ab.py --quick    # compile, check, pair call

Two shapes, both synthesized by truth.py from a seed:
  * headline: chr1 at 500 kb, L = 456, 10 restarts = 20 structures in the
    hot phase, the full 2,760-step schedule;
  * at scale: chr1 at 25 kb, L = 10,000 padded to 10,240, 4 models = 8
    structures, through the device-prep route.

For each shape: the pair energy+gradient call alone (a 100-step dependent
chain, both routes and several kernel block shapes; the fastest is
reported, the defaults in ops/pair_kernel.py are set from it), then the
whole solve_ensemble scan end to end in the order kernel, plain, plain,
kernel.
Prints one JSON object per measurement and writes them all to --out.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

# (block_m, block_n, num_warps)
VARIANTS = ((16, 64, 4), (16, 128, 4), (32, 32, 4), (32, 64, 4),
            (16, 64, 2), (64, 32, 4))
T0 = time.perf_counter()


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def make_restraints(L, L_pad, seed):
    """Exact restraints of a truth.py structure at (L_pad, L_pad)."""
    import jax.numpy as jnp

    from chromosome3d.config import RestraintConfig
    from chromosome3d.ops.device_prep import exact_tiles_from_if_device
    from chromosome3d.ops.energy import auto_weight_exponent
    from chromosome3d.truth import confined_walk, if_from_structure_strips

    rc = RestraintConfig()
    m = if_from_structure_strips(confined_walk(L, seed=seed), alpha=rc.alpha)
    tiles = exact_tiles_from_if_device(
        m, L_pad, rc, rc.weighting, auto_weight_exponent(L)
    )
    bead = jnp.asarray(np.pad(np.ones(L, np.float32), (0, L_pad - L)))
    return tiles, bead


def chain_time(fn, x, tiles, reps=3, length=100):
    """Median seconds per call of fn(x, tiles) over a dependent chain of
    `length` calls (each step moves x by its gradient), so the device time
    of the call, not its dispatch, is what is timed. The tiles are an
    argument, not a constant folded into the compiled program."""
    import jax

    @jax.jit
    def run(x0, t):
        def body(x, _):
            e, g = fn(x, t)
            return x - 1e-6 * g, e[0]
        return jax.lax.scan(body, x0, None, length=length)

    jax.block_until_ready(run(x, tiles))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(x, tiles))
        ts.append((time.perf_counter() - t0) / length)
    return float(np.median(ts))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "pair_ab.json"))
    ap.add_argument("--shapes", default="456x20,10000x8")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from chromosome3d.utils.cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX found {dev.platform}", file=sys.stderr)
        return 1

    from chromosome3d.config import AnnealConfig
    from chromosome3d.ops.energy import energy, weights_from_config
    from chromosome3d.ops.pair import pair_energy_grad_batched, pair_tiles
    from chromosome3d.ops.pair_kernel import pair_kernel_energy_grad
    from chromosome3d.solver.anneal import solve_ensemble_impl

    records = []

    card_name = card()

    def emit(rec):
        rec.update(card=card_name, device_kind=dev.device_kind,
                   t_s=time.perf_counter() - T0)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    for shape in args.shapes.split(","):
        L, B = (int(v) for v in shape.split("x"))
        L_pad = L if L <= 512 else -(-L // 512) * 512
        n_models = B // 2
        t0 = time.perf_counter()
        restraints, bead = make_restraints(L, L_pad, seed=L)
        jax.block_until_ready(restraints)
        prep_s = time.perf_counter() - t0
        cfg = AnnealConfig(exact_restraints=True)
        w = weights_from_config(cfg)
        tiles = pair_tiles(restraints, True)
        rng = np.random.RandomState(0)
        x = jnp.asarray(rng.randn(B, L_pad, 3) * 3.0 * L ** (1 / 3),
                        jnp.float32) * bead[None, :, None]

        # ---- correctness of the compiled kernel at this width ----
        e_k, g_k = pair_kernel_energy_grad(x, tiles, bead, w)
        e_p, g_p = pair_energy_grad_batched(x, tiles, bead, w)
        w0 = w._replace(bond=jnp.float32(0.0))
        ref = jax.jit(lambda c: jax.value_and_grad(energy)(c, restraints, w0, bead))
        with jax.default_matmul_precision("highest"):
            e_r, g_r = ref(x[0])
        scale = float(jnp.abs(g_r).max())
        emit({
            "what": "check", "L": L, "L_pad": L_pad, "B": B,
            "prep_s": prep_s,
            "kernel_rel_e": float(abs(e_k[0] - e_r) / abs(e_r)),
            "plain_rel_e": float(abs(e_p[0] - e_r) / abs(e_r)),
            "kernel_max_g_err_over_max_g":
                float(jnp.abs(g_k[0] - g_r).max()) / scale,
            "plain_max_g_err_over_max_g":
                float(jnp.abs(g_p[0] - g_r).max()) / scale,
            "kernel_vs_plain_rel_e_all":
                float(jnp.max(jnp.abs(e_k - e_p) / jnp.abs(e_p))),
        })

        # ---- the pair call alone ----
        plain_s = chain_time(
            lambda c, t: pair_energy_grad_batched(c, t, bead, w), x, tiles
        )
        emit({"what": "pair_call", "L": L_pad, "B": B, "route": "plain",
              "us_per_call": plain_s * 1e6})
        best = (None, float("inf"))
        for bm, bn, nw in VARIANTS:
            v = {"block_m": bm, "block_n": bn, "num_warps": nw}
            try:
                s = chain_time(
                    lambda c, t: pair_kernel_energy_grad(c, t, bead, w, **v),
                    x, tiles,
                )
            except Exception as e:  # a variant the compiler refuses
                emit({"what": "pair_call", "L": L_pad, "B": B,
                      "route": "kernel", **v, "error": repr(e)[:300]})
                continue
            emit({"what": "pair_call", "L": L_pad, "B": B, "route": "kernel",
                  **v, "us_per_call": s * 1e6})
            if s < best[1]:
                best = (v, s)
        if args.quick:
            continue

        emit({"what": "fastest_kernel_variant", "L": L_pad, **best[0]})

        # ---- the whole solve, end to end: kernel, plain, plain, kernel ----
        # (the kernel with its default launch parameters)
        progs = {}
        for route in ("kernel", "plain"):
            c = AnnealConfig(exact_restraints=True,
                             use_pallas=(route == "kernel"))
            fn = jax.jit(lambda d, k, c=c: solve_ensemble_impl(
                d, c, k, n_models, bead))
            t0 = time.perf_counter()
            progs[route] = fn.lower(restraints, jax.random.PRNGKey(0)).compile()
            compile_s = time.perf_counter() - t0
            jax.block_until_ready(progs[route](restraints, jax.random.PRNGKey(0)))
            emit({"what": "compile", "L": L_pad, "B": B, "route": route,
                  "compile_s": compile_s})
        walls = {"kernel": [], "plain": []}
        for route in ("kernel", "plain", "plain", "kernel"):
            t0 = time.perf_counter()
            res = progs[route](restraints, jax.random.PRNGKey(82364))
            jax.block_until_ready(res)
            walls[route].append(time.perf_counter() - t0)
            assert np.isfinite(np.asarray(res.coords)).all()
        steps = cfg.total_steps
        for route, ws in walls.items():
            emit({"what": "solve", "L": L_pad, "B": B, "route": route,
                  "steps": steps, "walls_s": ws,
                  "steps_per_s": steps / min(ws)})
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
