"""Command-line interface.

Mirrors the reference CLI (chromosome3D.pl:28-34, usage :2530-2557):

  chromosome3d -i <IF matrix> -o <outdir> [-k K] [-a ALPHA] [-m MODELCOUNT]

plus a `genome` subcommand replacing test.sh's 46 background processes with
one mesh-sharded launch, and a `spearman` subcommand replacing
spearman_IF_pdb.pl.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-k", "--kscaling", type=float, default=11.0,
                   help="distance scaling K (default 11)")
    p.add_argument("-a", "--alpha", type=float, default=0.5,
                   help="IF exponent alpha (default 0.5; published models used 1.1)")
    p.add_argument("-m", "--model-count", type=int, default=20,
                   help="models to build (default 20; top 5 kept by NOE energy)")
    p.add_argument("--fast", action="store_true",
                   help="reduced annealing schedule for smoke runs")
    p.add_argument("--turbo", action="store_true",
                   help="production speed preset: ~10x fewer steps, "
                        "validated quality parity on shipped inputs")
    p.add_argument("--pallas", action="store_true",
                   help="force the fused GPU pair kernel (default: on for "
                        "GPU backends); refused on other backends")
    p.add_argument("--alpha-ensemble", default="",
                   help="comma-separated extra alpha values pooled into the "
                        "Spearman ranking (quality mode), e.g. 0.5,0.7")
    p.add_argument("--no-shard-large", action="store_true",
                   help="disable the at-scale dispatch: inputs beyond the "
                        "largest length bucket then exact-L compile (run) "
                        "or raise (genome) instead of row-sharding over "
                        "the device mesh")
    p.add_argument("--no-violation-reports", action="store_true",
                   help="skip the per-model violation report files (each an "
                        "O(L^2)-distance host pass; stats/rankings still "
                        "computed) — for very large at-scale runs")
    p.add_argument("--shard-quantum", type=int, default=512,
                   help="padding unit for beyond-the-bucket lengths "
                        "(default 512); distinct big inputs rounded to the "
                        "same multiple share one compiled program")


def _make_config(args) -> "PipelineConfig":
    from chromosome3d.config import (
        AnnealConfig,
        PipelineConfig,
        RestraintConfig,
        fast_anneal,
        turbo_anneal,
    )

    # --pallas forces the kernel on; default None = AUTO (on for GPU)
    anneal = AnnealConfig(use_pallas=True if args.pallas else None)
    if getattr(args, "turbo", False):
        anneal = turbo_anneal(anneal)
    if args.fast:
        anneal = fast_anneal(anneal)
    alpha_ensemble = tuple(
        float(a) for a in args.alpha_ensemble.split(",") if a.strip()
    )
    return PipelineConfig(
        model_count=args.model_count,
        restraints=RestraintConfig(kscaling=args.kscaling, alpha=args.alpha),
        anneal=anneal,
        alpha_ensemble=alpha_ensemble,
        shard_large=not getattr(args, "no_shard_large", False),
        shard_quantum=getattr(args, "shard_quantum", 512),
        emit_violation_reports=not getattr(args, "no_violation_reports", False),
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="chromosome3d",
        description="3D chromosome reconstruction from Hi-C IF matrices",
    )
    sub = parser.add_subparsers(dest="command")

    run = sub.add_parser("run", help="reconstruct one chromosome (the reference's main CLI)")
    # "-if" kept as an alias: the reference's test.sh invokes `-if <matrix>`
    # (Getopt::Long prefix-matches it to -i, test.sh:4-11)
    run.add_argument("-i", "-if", "--input", required=True,
                     help="IF matrix: dense text, .cool/.mcool, .hic, or "
                          "HiC-Pro .matrix")
    run.add_argument("-o", "--output", required=True, help="output directory")
    run.add_argument("--profile", default=None, metavar="DIR",
                     help="write a jax.profiler trace of the solve to DIR")
    run.add_argument("--chrom", default=None,
                     help="chromosome name (for .cool/.hic/.matrix inputs)")
    run.add_argument("--resolution", type=int, default=None,
                     help="bin size in bp (for .hic/.mcool inputs)")
    run.add_argument("--bed", default=None,
                     help="HiC-Pro .bed bin table (for .matrix inputs)")
    run.add_argument("--ice", action="store_true",
                     help="ICE-balance raw counts before restraint generation")
    run.add_argument("--norm", default="NONE",
                     help="apply a stored .hic normalization vector "
                          "(KR, VC, VC_SQRT, SCALE, ...; default NONE = raw)")
    _add_common(run)

    gen = sub.add_parser("genome", help="whole-genome single-launch run (replaces test.sh)")
    gen.add_argument("-i", "--input-dir", required=True, help="directory of chr*_matrix.txt")
    gen.add_argument("-o", "--output-dir", required=True)
    gen.add_argument("--filter", default="",
                     help="substring filter on job names, e.g. 500kb")
    gen.add_argument("--resume", action="store_true",
                     help="skip chromosomes already in <output>/checkpoint")
    _add_common(gen)

    sp = sub.add_parser("spearman", help="score models vs an IF matrix (replaces spearman_IF_pdb.pl)")
    sp.add_argument("matrix", help="IF matrix file")
    sp.add_argument("pdb", help="PDB file or directory of PDBs")
    sp.add_argument("range", nargs="?", type=int, default=3,
                    help="|i-j| short-range cutoff (default 3)")

    slv = sub.add_parser(
        "solve",
        help="solve directly from a restraint file (.rr or CNS .tbl), "
             "no IF matrix required",
    )
    slv.add_argument("-r", "--restraints", required=True,
                     help=".rr (i j lo hi conf) or CNS .tbl file")
    slv.add_argument("-o", "--output", required=True)
    slv.add_argument("-L", "--length", type=int, default=None,
                     help="bead count (default: largest residue index)")
    _add_common(slv)

    srv = sub.add_parser(
        "serve",
        help="warm-model server on a Unix socket: keeps compiled solve "
             "programs resident across requests",
    )
    srv.add_argument("--socket", required=True, help="unix socket path")
    srv.add_argument("--turbo", action="store_true")
    srv.add_argument("--pallas", action="store_true")

    cli = sub.add_parser("submit", help="send one solve request to a server")
    cli.add_argument("--socket", required=True)
    cli.add_argument("-i", "--input", help="IF matrix file")
    cli.add_argument("-r", "--restraints",
                     help="solve from a .rr / CNS .tbl restraint file instead")
    cli.add_argument("-o", "--output", help="output directory")
    cli.add_argument("-a", "--alpha", type=float, default=0.5)
    cli.add_argument("-m", "--model-count", type=int, default=10)
    cli.add_argument("--turbo", action="store_true")
    cli.add_argument("--ping", action="store_true")
    cli.add_argument("--shutdown", action="store_true")

    ass = sub.add_parser(
        "assess",
        help="assess model PDB(s) against a CNS NOE tbl "
             "(count_satisfied / sum_dev, incl. or-group restraints)",
    )
    ass.add_argument("pdb", help="PDB file or directory of PDBs")
    ass.add_argument("tbl", help="contact.tbl (CNS NOE restraints)")
    ass.add_argument("--relax", type=float, default=0.5,
                     help="satisfaction window (default 0.5 A)")

    ren = sub.add_parser("render", help="render model PDB(s) to PNG (image.png parity)")
    ren.add_argument("target", help="a PDB file or a run output directory")
    ren.add_argument("-o", "--output", default=None, help="output PNG (file mode)")

    coi = sub.add_parser(
        "coinit",
        help="solve a LOW-resolution matrix co-initialized from a reduced "
             "HIGH-resolution model (cross-resolution consistency workflow)",
    )
    coi.add_argument("-i", "--input", required=True, help="low-res IF matrix")
    coi.add_argument("-p", "--hires-pdb", required=True,
                     help="high-resolution model PDB to seed from")
    coi.add_argument("-o", "--output", required=True)
    coi.add_argument("--factor", type=int, default=2,
                     help="hi-res -> lo-res bead reduction factor (default 2)")
    _add_common(coi)

    sim = sub.add_parser(
        "similarity",
        help="cross-resolution similarity report + reduced models "
             "(the output_models/similarity.txt protocol)",
    )
    sim.add_argument("-o", "--output-dir", required=True,
                     help="a run_genome output tree with chr*_{1mb,500kb} subdirs")
    sim.add_argument("--factor", type=int, default=2)

    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 2

    from chromosome3d.utils.cache import configure_compile_cache

    configure_compile_cache()

    if args.command == "run":
        from chromosome3d.pipeline import run_pipeline

        summary = run_pipeline(
            args.input, args.output, _make_config(args),
            profile_dir=args.profile, chrom=args.chrom,
            resolution=args.resolution, bed_path=args.bed, ice=args.ice,
            norm=args.norm,
        )
        print(json.dumps(summary))
        return 0

    if args.command == "genome":
        from chromosome3d.parallel.genome import discover_jobs, run_genome

        jobs = discover_jobs(args.input_dir)
        if args.filter:
            jobs = [j for j in jobs if args.filter in j.name]
        summaries = run_genome(
            args.input_dir, args.output_dir, _make_config(args),
            jobs=jobs, resume=args.resume,
        )
        print(json.dumps(summaries, indent=1))
        return 0

    if args.command == "spearman":
        import os

        from chromosome3d.io.matrix import load_if_matrix
        from chromosome3d.io.pdb import load_pdb_dir, read_ca_pdb
        from chromosome3d.metrics import spearman_if_model

        matrix = load_if_matrix(args.matrix)
        paths = [args.pdb] if os.path.isfile(args.pdb) else load_pdb_dir(args.pdb)
        scores = {}
        for path in paths:
            coords = read_ca_pdb(path)
            if args.range >= len(coords):
                print("Spearman Correlation coefficient = -")
                return 0
            scores[path] = spearman_if_model(matrix, coords, args.range)
        print("SRCC\tPDB")
        for path in sorted(scores, key=lambda p: -scores[p]):
            print(f"{scores[path]:.3f}\t{path}")
        return 0

    if args.command == "solve":
        from chromosome3d.pipeline import run_restraints_pipeline

        summary = run_restraints_pipeline(
            args.restraints, args.output, _make_config(args), L=args.length
        )
        print(json.dumps(summary))
        return 0

    if args.command == "serve":
        from chromosome3d.config import AnnealConfig, PipelineConfig, turbo_anneal
        from chromosome3d.serve import serve

        # --pallas forces the kernel on; default None = AUTO (on for GPU)
        anneal = AnnealConfig(use_pallas=True if args.pallas else None)
        if args.turbo:
            anneal = turbo_anneal(anneal)
        serve(args.socket, PipelineConfig(anneal=anneal))
        return 0

    if args.command == "submit":
        from chromosome3d.serve import request

        if args.ping:
            print(json.dumps(request(args.socket, {"cmd": "ping"})))
            return 0
        if args.shutdown:
            print(json.dumps(request(args.socket, {"cmd": "shutdown"})))
            return 0
        if args.restraints and args.input:
            print("submit takes -i OR -r, not both", file=sys.stderr)
            return 2
        if args.restraints and args.output:
            resp = request(
                args.socket,
                {
                    "restraints": args.restraints,
                    "out": args.output,
                    "models": args.model_count,
                    "turbo": args.turbo,
                },
            )
            print(json.dumps(resp))
            return 0 if resp.get("ok") else 1
        if not (args.input and args.output):
            print("submit needs -i or -r, and -o (or --ping/--shutdown)",
                  file=sys.stderr)
            return 2
        resp = request(
            args.socket,
            {
                "matrix": args.input,
                "out": args.output,
                "alpha": args.alpha,
                "models": args.model_count,
                "turbo": args.turbo,
            },
        )
        print(json.dumps(resp))
        return 0 if resp.get("ok") else 1

    if args.command == "assess":
        import os

        from chromosome3d.assess import assess_pdb_vs_tbl
        from chromosome3d.config import PipelineConfig
        from chromosome3d.io.pdb import load_pdb_dir, read_ca_pdb

        cfg = PipelineConfig(dist_relax=args.relax)
        paths = [args.pdb] if os.path.isfile(args.pdb) else load_pdb_dir(args.pdb)
        print(f"NOE_SATISFIED(+-{args.relax}A)  SUM_OF_DEVIATIONS>=0.2  PDB")
        for path in paths:
            coords = read_ca_pdb(path)
            sat, total, dev = assess_pdb_vs_tbl(coords, args.tbl, cfg)
            print(f"{sat}/{total}             {dev:.2f}                {path}")
        return 0

    if args.command == "render":
        import os

        from chromosome3d.render import render_model, render_run

        if os.path.isdir(args.target):
            for png in render_run(args.target):
                print(png)
        else:
            from chromosome3d.io.pdb import read_ca_pdb

            out = args.output or args.target.replace(".pdb", ".png")
            print(render_model(read_ca_pdb(args.target), out))
        return 0

    if args.command == "coinit":
        import os

        from chromosome3d.io.matrix import load_if_matrix
        from chromosome3d.io.pdb import read_ca_pdb, write_ca_pdb
        from chromosome3d.metrics import cross_resolution_similarity
        from chromosome3d.similarity import solve_coinit

        cfg = _make_config(args)
        lo_m = load_if_matrix(args.input)
        hi = read_ca_pdb(args.hires_pdb)
        coords, order, scores = solve_coinit(lo_m, hi, cfg, factor=args.factor)
        os.makedirs(args.output, exist_ok=True)
        ident = os.path.basename(args.input)
        ident = ident[:-4] if ident.endswith(".txt") else ident
        atag = f"a{cfg.restraints.alpha}".replace(".", "")
        for rank, idx in enumerate(order, start=1):
            write_ca_pdb(
                os.path.join(args.output, f"{ident}_rank{rank:02d}_{atag}.pdb"),
                coords[idx],
                remarks={"spearman_if_inv_d": float(scores[idx])},
            )
        best = coords[order[0]]
        rho, rmsd = cross_resolution_similarity(hi, best, args.factor)
        print(json.dumps({
            "best_spearman_if_inv_d": float(scores[order[0]]),
            "cross_res_spearman": rho,
            "cross_res_rmsd": rmsd,
            "models": int(len(coords)),
        }))
        return 0

    if args.command == "similarity":
        from chromosome3d.similarity import (
            pair_outputs_by_chromosome,
            similarity_report,
            write_reduced_model,
        )

        pairs = pair_outputs_by_chromosome(args.output_dir)
        if not pairs:
            print("no chromosome pairs with both resolutions found", file=sys.stderr)
            return 1
        for name, (hi, _) in pairs.items():
            write_reduced_model(hi, factor=args.factor)
        out = f"{args.output_dir}/similarity.txt"
        results = similarity_report(pairs, out, args.factor)
        for name, (rho, rmsd) in results.items():
            print(f"{name}: spearman={rho:.4f} rmsd={rmsd:.3f}")
        print(f"wrote {out}")
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
