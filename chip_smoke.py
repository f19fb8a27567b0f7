#!/usr/bin/env python3
"""Smoke test of chromosome3d on one GPU, through the entry points a user
calls. Inputs are synthesized from a seed by chromosome3d.truth (a known 3D
structure, its IF matrix with 10% multiplicative noise), so every phase can
score what it builds against the true structure.

  python chip_smoke.py              # phases a-f on one GPU
  python chip_smoke.py --four-gpu   # only the multi-device path, on 4 GPUs

Phases (one line of results each):
  a  the device is a GPU (else exit non-zero); the card's name and power
     limit as nvidia-smi reports them
  b  `chromosome3d run -m 10` at L = 456 (chr1 at 500 kb) with the full
     2,760-step schedule: artifact set, truth gates, phase walls
  c  `chromosome3d run -m 4 --turbo` at L = 10,000 (chr1 at 25 kb, .npy
     input, device-prep route, padded to 10,240): finite results, truth gates
  d  `chromosome3d genome` over three chromosomes (hg19 500 kb bead counts
     of chr1/21/22: 499/97/103)
  e  `serve` in a thread of this process answering two `submit` requests
  f  the GPU pair kernel and the plain analytic path against the autodiff
     reference (ops.energy at HIGHEST precision) at L = 456, B = 20 and
     L = 10,240, B = 8

--four-gpu runs the L = 10,000 `run` row-sharded over a 4-card `beads`
mesh and phase d's genome with the chromosomes spread over the cards, and
compares each with the same input and seed solved on one card (a child
process that sees one card runs first, while this one stays off the GPU).

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failed phase exits non-zero before that line is printed.
"""

import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke_work")

# truth gates (tests/test_ground_truth.py): an unrelated compact
# conformation scores rmsd_over_rg ~ 1.4 and spearman_d ~ 0
GATES = {"rmsd_over_rg": 0.15, "spearman_d": 0.98, "drmsd_rel": 0.08}
NOISE = 0.1
GENOME = {"chr1_500kb": 499, "chr21_500kb": 97, "chr22_500kb": 103}
L_HEAD, L_SCALE = 456, 10_000
F_SHAPES = ((456, 456, 20), (10_000, 10_240, 8))   # (L, L_pad, B)

# Pair-kernel and plain-path tolerance against the autodiff reference.
# Energies: float32 sums over ~L^2 terms taken in another order (per-row
# partials over column blocks vs one whole-matrix reduction). Gradients:
# the same reassociation plus rsqrt instead of sqrt-and-divide; relative to
# the largest gradient component, since small components are differences
# of large per-pair forces.
TOL_E = 1e-4
TOL_G = 1e-4


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


_CLI_LOG = []


def quiet_cli(argv):
    """chromosome3d's CLI main, with what it prints (progress log, summary
    JSON) kept in WORK/cli.log; the file stays open because the package
    logger binds to the stream it first sees."""
    from chromosome3d import cli

    if not _CLI_LOG:
        _CLI_LOG.append(open(os.path.join(WORK, "cli.log"), "a"))
    with contextlib.redirect_stdout(_CLI_LOG[0]):
        rc = cli.main(argv)
    check(rc == 0, f"chromosome3d {' '.join(argv)} exited {rc}")


def truth_input(name, L, seed, npy=False):
    """A seeded true structure and its IF matrix file in WORK."""
    from chromosome3d.io.matrix import write_if_matrix
    from chromosome3d.truth import (
        confined_walk,
        if_from_structure,
        if_from_structure_strips,
    )

    import numpy as np

    X = confined_walk(L, seed=seed)
    if npy:
        M = if_from_structure_strips(X, alpha=0.5, noise_sigma=NOISE, seed=seed)
        path = os.path.join(WORK, f"{name}_matrix.npy")
        np.save(path, M)
    else:
        M = if_from_structure(X, alpha=0.5, noise_sigma=NOISE, seed=seed)
        path = os.path.join(WORK, f"{name}_matrix.txt")
        write_if_matrix(path, M)
    return X, path


def truth_metrics(out_dir, X):
    from chromosome3d.io.pdb import read_ca_pdb
    from chromosome3d.truth import reconstruction_metrics

    pdbs = glob.glob(os.path.join(out_dir, "*rank01*.pdb"))
    check(len(pdbs) == 1, f"expected one rank01 PDB in {out_dir}, got {pdbs}")
    return reconstruction_metrics(read_ca_pdb(pdbs[0]), X)


def check_gates(met, where):
    check(met["rmsd_over_rg"] < GATES["rmsd_over_rg"], f"{where}: {met}")
    check(met["spearman_d"] > GATES["spearman_d"], f"{where}: {met}")
    check(met["drmsd_rel"] < GATES["drmsd_rel"], f"{where}: {met}")


def summary_of(out_dir):
    with open(os.path.join(out_dir, "summary.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------- phases

def phase_a():
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"needs a GPU; JAX found {devs[0].platform}")
    return {"card": card_line(), "kind": devs[0].device_kind,
            "count": len(devs), "jax": jax.__version__}


def phase_b():
    ident = "chr1_500kb"
    X, path = truth_input(ident, L_HEAD, seed=1)
    out = os.path.join(WORK, "b_out")
    t0 = time.perf_counter()
    quiet_cli(["run", "-i", path, "-o", out, "-m", "10"])
    wall = time.perf_counter() - t0
    stem = f"{ident}_matrix"
    expected = [f"{stem}.dist", f"{stem}.rr", "contact.tbl", "spearman.txt",
                "contact_violation.txt", "model_info.log", "summary.json"]
    # the top 5 by NOE energy are kept as model files (PipelineConfig.top_k)
    expected += [f"{stem}_model{k}.pdb" for k in range(1, 6)]
    expected += [f"{stem}_rank{k:02d}_a05.pdb" for k in range(1, 11)]
    missing = [f for f in expected if not os.path.exists(os.path.join(out, f))]
    check(not missing, f"missing artifacts: {missing}")
    s = summary_of(out)
    check(s["L"] == L_HEAD, f"summary L {s['L']}")
    met = truth_metrics(out, X)
    check_gates(met, "phase b")
    return {"L": s["L"], "models": 10, "structures_hot": 20,
            "steps": 2760, "cli_wall_s": wall, "phases": s["phases"],
            "truth": met, "best_spearman_if_inv_d": s["best_spearman_if_inv_d"]}


def phase_c():
    import numpy as np

    ident = "chr1_25kb"
    X, path = truth_input(ident, L_SCALE, seed=2, npy=True)
    out = os.path.join(WORK, "c_out")
    t0 = time.perf_counter()
    quiet_cli(["run", "-i", path, "-o", out, "-m", "4", "--turbo",
               "--no-violation-reports"])
    wall = time.perf_counter() - t0
    s = summary_of(out)
    check(s["L"] == L_SCALE, f"summary L {s['L']}")
    check(np.isfinite(s["best_noe_energy"]), f"energy {s['best_noe_energy']}")
    met = truth_metrics(out, X)
    check_gates(met, "phase c")
    return {"L": s["L"], "models": 4, "schedule": "turbo",
            "cli_wall_s": wall, "phases": s["phases"], "truth": met}


def genome_inputs():
    in_dir = os.path.join(WORK, "genome_in")
    os.makedirs(in_dir, exist_ok=True)
    truths = {}
    from chromosome3d.io.matrix import write_if_matrix
    from chromosome3d.truth import confined_walk, if_from_structure

    for k, (name, L) in enumerate(GENOME.items()):
        X = confined_walk(L, seed=10 + k)
        write_if_matrix(
            os.path.join(in_dir, f"{name}_matrix.txt"),
            if_from_structure(X, alpha=0.5, noise_sigma=NOISE, seed=10 + k),
        )
        truths[name] = X
    return in_dir, truths


def run_genome_cli(tag, models="10", extra=()):
    in_dir, truths = genome_inputs()
    out = os.path.join(WORK, f"{tag}_out")
    t0 = time.perf_counter()
    quiet_cli(["genome", "-i", in_dir, "-o", out, "-m", models, *extra])
    wall = time.perf_counter() - t0
    per = {}
    for name, X in truths.items():
        met = truth_metrics(os.path.join(out, name), X)
        per[name] = {"L": len(X), "truth": met}
    return wall, per


def phase_d():
    wall, per = run_genome_cli("d")
    for name, r in per.items():
        check_gates(r["truth"], f"phase d {name}")
    return {"chromosomes": per, "cli_wall_s": wall}


def phase_e():
    from chromosome3d.config import AnnealConfig, PipelineConfig, turbo_anneal
    from chromosome3d.serve import request, serve

    sock = os.path.relpath(os.path.join(WORK, "serve.sock"))
    if os.path.exists(sock):
        os.remove(sock)
    cfg = PipelineConfig(anneal=turbo_anneal(AnnealConfig()))
    th = threading.Thread(target=serve, args=(sock, cfg), daemon=True)
    th.start()
    for _ in range(600):
        if os.path.exists(sock):
            break
        time.sleep(0.1)
    check(request(sock, {"cmd": "ping"}, timeout=60).get("ok"), "ping failed")
    answers = []
    inputs = [os.path.join(WORK, "chr1_500kb_matrix.txt"),
              os.path.join(WORK, "genome_in", "chr21_500kb_matrix.txt")]
    for k, path in enumerate(inputs):
        if not os.path.exists(path):
            genome_inputs()
        t0 = time.perf_counter()
        resp = request(sock, {"matrix": path, "out": os.path.join(WORK, f"e_out{k}"),
                              "models": 4, "turbo": True}, timeout=900)
        check(resp.get("ok"), f"submit {k} failed: {resp.get('error')}")
        answers.append({"L": resp["summary"]["L"],
                        "latency_s": time.perf_counter() - t0,
                        "best_spearman_if_inv_d":
                            resp["summary"]["best_spearman_if_inv_d"]})
    check(request(sock, {"cmd": "shutdown"}, timeout=60).get("ok"), "shutdown")
    th.join(timeout=60)
    check(not th.is_alive(), "server thread did not stop")
    return {"requests": answers}


def _compare(x, tiles, restraints, bead, w, use_kernel):
    """Max relative energy error and max gradient error (relative to the
    largest reference component) of one route against the reference."""
    import jax
    import jax.numpy as jnp

    from chromosome3d.ops.energy import energy
    from chromosome3d.ops.pair import pair_energy_grad_batched

    e, g = pair_energy_grad_batched(x, tiles, bead, w, 0, use_kernel)
    w0 = w._replace(bond=jnp.float32(0.0))
    # the restraints are arguments, not constants folded into the program
    ref = jax.jit(jax.value_and_grad(energy))
    e_err = g_err = 0.0
    with jax.default_matmul_precision("highest"):
        for k in range(x.shape[0]):
            e_r, g_r = ref(x[k], restraints, w0, bead)
            e_err = max(e_err, float(abs(e[k] - e_r) / abs(e_r)))
            g_err = max(g_err, float(jnp.abs(g[k] - g_r).max()
                                     / jnp.abs(g_r).max()))
    return e_err, g_err


def phase_f():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from chromosome3d.config import AnnealConfig, RestraintConfig
    from chromosome3d.ops.device_prep import exact_tiles_from_if_device
    from chromosome3d.ops.energy import auto_weight_exponent, weights_from_config
    from chromosome3d.ops.pair import pair_tiles
    from chromosome3d.truth import confined_walk, if_from_structure_strips

    rc = RestraintConfig()
    w = weights_from_config(AnnealConfig(), vdw_weight=1.0)
    res = {}
    for L, L_pad, B in F_SHAPES:
        X = confined_walk(L, seed=3)
        M = if_from_structure_strips(X, alpha=0.5, noise_sigma=NOISE, seed=3)
        restraints = exact_tiles_from_if_device(
            M, L_pad, rc, rc.weighting, auto_weight_exponent(L))
        bead = jnp.asarray(np.pad(np.ones(L, np.float32), (0, L_pad - L)))
        rng = np.random.RandomState(L)
        # the truth perturbed per structure: realistic distances, with
        # both walls of the well and the vdw overlap active
        x = jnp.asarray(np.pad(X, ((0, L_pad - L), (0, 0)))[None]
                        + rng.randn(B, L_pad, 3) * 2.0, jnp.float32)
        x = x * bead[None, :, None]
        tiles = pair_tiles(restraints, True)
        row = {"B": B}
        for name, use_kernel in (("kernel", True), ("plain", False)):
            e_err, g_err = _compare(x, tiles, restraints, bead, w, use_kernel)
            check(e_err < TOL_E and g_err < TOL_G,
                  f"L={L_pad} {name}: energy err {e_err}, grad err {g_err}")
            row[name] = {"max_rel_energy_err": e_err,
                         "max_grad_err_over_max_grad": g_err}
        res[f"L{L_pad}"] = row
        del restraints, tiles, x
        jax.clear_caches()
    res["tolerance"] = {"energy_rel": TOL_E, "grad_over_max": TOL_G}
    return res


# ---------------------------------------------------------------- four GPUs

def one_card_reference():
    """Child of --four-gpu, sees one card: the L = 10,000 run and the
    genome, results in WORK/one_card.json."""
    import jax

    check(len(jax.devices()) == 1, f"{len(jax.devices())} devices visible")
    out = {"scale": scale_run("one"),
           "genome": run_genome_cli("g1", "8", ["--turbo"])[1]}
    with open(os.path.join(WORK, "one_card.json"), "w") as f:
        json.dump(out, f)


def scale_run(tag):
    X, path = truth_input("chr1_25kb", L_SCALE, seed=2, npy=True)
    out = os.path.join(WORK, f"{tag}_scale_out")
    t0 = time.perf_counter()
    quiet_cli(["run", "-i", path, "-o", out, "-m", "4", "--turbo",
               "--no-violation-reports"])
    wall = time.perf_counter() - t0
    s = summary_of(out)
    return {"cli_wall_s": wall, "phases": s["phases"],
            "best_noe_energy": s["best_noe_energy"],
            "truth": truth_metrics(out, X)}


def four_gpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one-card-reference"], env=env)
    check(child.returncode == 0, f"one-card reference exited {child.returncode}")
    with open(os.path.join(WORK, "one_card.json")) as f:
        one = json.load(f)

    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu" and len(devs) == 4,
          f"needs 4 GPUs; JAX found {len(devs)} {devs[0].platform}")
    print(f"card: {card_line()}", flush=True)
    four = {"scale": scale_run("four"),
            "genome": run_genome_cli("g4", "8", ["--turbo"])[1]}
    check_gates(four["scale"]["truth"], "four-gpu scale run")
    cmp = {"scale": {
        "one_card": one["scale"], "four_cards": four["scale"],
        "noe_energy_rel_diff": abs(four["scale"]["best_noe_energy"]
                                   - one["scale"]["best_noe_energy"])
        / abs(one["scale"]["best_noe_energy"]),
    }}
    check(cmp["scale"]["noe_energy_rel_diff"] < 0.05, f"scale: {cmp['scale']}")
    for name in GENOME:
        a, b = one["genome"][name]["truth"], four["genome"][name]["truth"]
        check_gates(b, f"four-gpu genome {name}")
        cmp[name] = {"one_card": a, "four_cards": b,
                     "spearman_d_diff": abs(a["spearman_d"] - b["spearman_d"])}
        check(cmp[name]["spearman_d_diff"] < 0.01, f"genome {name}: {cmp[name]}")
    print("four_gpu: " + json.dumps(cmp), flush=True)
    return devs


# ---------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpu", action="store_true")
    ap.add_argument("--one-card-reference", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    # the package under test is the one beside this script, never another
    # installation
    if not os.path.isfile(os.path.join(HERE, "chromosome3d", "__init__.py")):
        print("chip_smoke.py must run from a chromosome3d checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    os.makedirs(WORK, exist_ok=True)

    try:
        from chromosome3d.utils.cache import configure_compile_cache

        configure_compile_cache()
        if args.one_card_reference:
            one_card_reference()
            return 0
        if args.four_gpu:
            # the parent opens the cards only after the child is done
            devs = four_gpu()
        else:
            a = phase_a()
            print(f"card: {a['card']}", flush=True)
            print("phase a: " + json.dumps(a), flush=True)
            for name, fn in (("b", phase_b), ("c", phase_c), ("d", phase_d),
                             ("e", phase_e), ("f", phase_f)):
                t0 = time.perf_counter()
                r = fn()
                r["phase_wall_s"] = time.perf_counter() - t0
                print(f"phase {name}: " + json.dumps(r), flush=True)
            import jax

            devs = jax.devices()
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
