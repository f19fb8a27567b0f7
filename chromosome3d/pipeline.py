"""End-to-end per-chromosome pipeline (the L4 layer).

Rebuild of chromosome3D.pl's main flow (:28-108):

  workspace setup -> IF2dist -> dist2rr -> carr2tbl        (L3, text artifacts)
  -> solve_ensemble (replaces build_extended + build_models + CNS, L2/L1)
  -> assess + rank + PDB emission                          (L0)

Artifact set matches the reference: `$ID.dist`, `$ID.rr`, `contact.tbl`,
`contact_violation.txt`, `model_info.log`, `${ID}_model1..5.pdb` (NOE-energy
ranked), plus `${ID}_rankNN.pdb` (Spearman-ranked, the published naming) and
a `spearman.txt` table. Failure protocol keeps the reference's sentinel-file
convention: `iam.running` while solving, renamed `iam.failed` on error
(chromosome3D.pl:261-284).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import replace as dataclasses_replace
from typing import Dict, Optional

import jax
import numpy as np

from chromosome3d.assess import (
    append_model_info,
    assess_ensemble,
    coverage_string,
    rank_by_energy,
    rank_by_spearman,
    write_violation_report,
)
from chromosome3d.config import PipelineConfig
from chromosome3d.io.matrix import load_if_matrix, write_dist_matrix
from chromosome3d.io.pdb import write_ca_pdb
from chromosome3d.metrics import clash_count
from chromosome3d.ops.energy import (
    dense_restraints_from_numpy,
    exact_restraints_from_numpy,
)
from chromosome3d.restraints import (
    dist_to_restraints,
    if_to_dist,
    write_contact_tbl,
    write_rr,
)
from chromosome3d.solver.anneal import solve_ensemble
from chromosome3d.utils.logging import banner, get_logger, profile_trace

log = get_logger(__name__)


def _aot_solve(dense, anneal_cfg, key, n_models, bm, or_groups=None):
    """solve_ensemble, routed through the AOT executable cache when
    CHROM3D_AOT_CACHE is set (utils/aot.py): a later process re-running the
    same bucket/config (incl. or-group shapes) skips the compile
    entirely. Without the env var this is exactly solve_ensemble
    (in-process jit cache applies)."""
    from chromosome3d.utils.aot import cache_dir_from_env, load_or_compile

    if cache_dir_from_env() is None:
        return solve_ensemble(dense, anneal_cfg, key, n_models, bm,
                              or_groups=or_groups)
    from chromosome3d.solver.anneal import solve_ensemble_impl

    solve = load_or_compile(
        jax.jit(
            lambda d, k, b, og: solve_ensemble_impl(
                d, anneal_cfg, k, n_models, b, or_groups=og
            )
        ),
        (dense, key, bm, or_groups),
        tag="pipeline_bucket",
        statics=f"{anneal_cfg!r}|n={n_models}",
    )
    return solve(dense, key, bm, or_groups)


def quantum_bucket(L: int, quantum: int, multiple: int = 1) -> int:
    """THE dynamic large-bucket rule, shared by every at-scale call site
    (single runs, genome buckets, serve bookkeeping): round L up to a
    multiple of lcm(quantum, multiple). multiple is the beads-mesh size for
    row-sharded solves (their L must divide the axis) and 1 otherwise."""
    import math

    q = max(quantum, 1)
    unit = q * multiple // math.gcd(q, multiple)
    return -(-L // unit) * unit


def _bucket_pad(L: int, cfg: PipelineConfig):
    """Padded length + (L_pad,) bead mask for a single-chromosome solve.

    L beyond every bucket pads to a dynamic shard_quantum multiple (so big
    runs still share compiled programs); with shard_large off it falls back
    to exact L (one fresh compile per distinct big L), and with bucketing
    off it is always exact L."""
    L_pad = L
    if cfg.bucket_single_runs:
        fit = [b for b in cfg.length_buckets if b >= L]
        if fit:
            L_pad = min(fit)
        elif cfg.shard_large:
            L_pad = quantum_bucket(L, cfg.shard_quantum)
    bead_mask = None
    if L_pad != L:
        bead_mask = np.zeros(L_pad, dtype=np.float32)
        bead_mask[:L] = 1.0
    return L_pad, bead_mask


def _use_sharded(L: int, cfg: PipelineConfig) -> bool:
    """The at-scale dispatch decision: row-shard the solve when L exceeds
    every length bucket and more than one device is available. On a single
    device the plain (unsharded) solver is the better program — it just
    pads to the shard_quantum bucket."""
    return (
        cfg.shard_large
        and L > max(cfg.length_buckets)
        and len(jax.devices()) > 1
    )


_SHARDED_PROGRAMS: dict = {}


def _sharded_solve(restraints, rc, cfg: PipelineConfig, key, n_models: int,
                   or_groups_np=None, conf=None, device_prep: bool = False,
                   if_matrix=None, L_true=None):
    """Sequence-parallel ensemble solve over ALL devices (`beads` mesh axis):
    the product-surface entry to solver.sharded.solve_ensemble_sharded for
    chromosomes beyond the largest bucket. Pads to a multiple of
    lcm(shard_quantum, n_devices) so distinct big inputs share programs;
    routes through the AOT executable cache like every other solve, and
    memoizes the compiled program in-process so repeated at-scale requests
    (a long-lived server, an alpha ensemble) never retrace.

    or_groups_np / conf: ambiguous restraint groups and rr confidence
    weights from external restraint files — both first-class here (round-4:
    an at-scale external tbl/rr no longer falls back to the single-program
    padded path). The group term rides replicated in the shard body; conf
    folds into the stress weights exactly as the plain path does.

    if_matrix: hand the raw IF matrix instead of host-built restraints
    (restraints=None) and the WHOLE L3 prep — IF^alpha, the %.1f
    quantization, separation mask, stress weights — runs on device
    (ops.device_prep.exact_tiles_from_if_device), row-sharded over the
    beads mesh: the host never pays a single O(L^2) pass (build_restraints
    measured 313 s at L = 8192 here). Only valid for matrix-derived
    restraints under the exact gate (they are exact by construction).
    L_true: the matrix's real length when if_matrix arrives PRE-PADDED
    (run_pipeline/serve pad once and thread the copy through the solve,
    alpha-ensemble, and assessment preps)."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from chromosome3d.solver.sharded import solve_ensemble_sharded
    from chromosome3d.utils.aot import load_or_compile

    devices = jax.devices()
    nb = len(devices)
    L = (
        L_true
        if L_true is not None
        else restraints.length if restraints is not None else if_matrix.shape[0]
    )
    L_pad = quantum_bucket(L, cfg.shard_quantum, multiple=nb)
    # device_prep: matrix-derived restraints (quantized targets are >= 0.1
    # wherever a restraint exists) build their exact-form tiles ON device —
    # ops.device_prep, with the upload ROW-SHARDED over the beads mesh so
    # the (L, L) tiles are born distributed (never whole on one device);
    # external restraint files keep the host route (a pathological exact
    # row with target 0 would be dropped by the t > 0 mask recovery)
    exact = _exact_provable(cfg)
    if (device_prep or if_matrix is not None) and exact:
        from chromosome3d.ops.device_prep import (
            exact_tiles_from_if_device,
            exact_tiles_from_target_device,
        )

        p = rc.weight_exponent
        if p is None:
            from chromosome3d.ops.energy import auto_weight_exponent

            p = auto_weight_exponent(L)
        row_sh = _beads_row_sharding()
        # pair_bf16: bf16-STORED tiles for the sharded solve too (the shard
        # body's init upcasts transiently, the strip/row kernels read bf16
        # natively); the f32 assessment view is a separate prep program
        dt = "bfloat16" if cfg.anneal.pair_bf16 else "float32"
        if if_matrix is not None:
            dense = exact_tiles_from_if_device(
                if_matrix, L_pad, rc, rc.weighting, p, sharding=row_sh,
                out_dtype=dt, n_true=L,
            )
        else:
            dense = exact_tiles_from_target_device(
                restraints.target, L_pad, rc.weighting, p, sharding=row_sh,
                out_dtype=dt,
            )
    else:
        if restraints is None:
            from chromosome3d.restraints import build_restraints

            restraints = build_restraints(if_matrix, rc)
        dense, _ = _padded_dense(restraints, rc, L_pad, exact=exact)
    dense = _fold_conf(dense, conf)
    og = None
    og_sig = None
    if or_groups_np is not None:
        from chromosome3d.ops.energy import dense_or_groups_from_numpy

        og = dense_or_groups_from_numpy(or_groups_np)
        og_sig = tuple(np.asarray(og.idx_i).shape)
    bm = jnp.asarray(np.pad(np.ones(L, np.float32), (0, L_pad - L)))
    an, n = cfg.anneal, n_models
    # tile dtype is route-dependent (bf16-stored for device-prep routes,
    # f32 for the external-restraints host route) — it must key the memo
    # or a cached executable would be invoked with mismatched-dtype tiles
    prog_key = (tuple(d.id for d in devices), an, n, L_pad,
                type(dense).__name__, str(dense.lo.dtype),
                conf is not None, og_sig)
    solve = _SHARDED_PROGRAMS.get(prog_key)
    if solve is None:
        mesh = Mesh(np.asarray(devices), ("beads",))
        solve = load_or_compile(
            jax.jit(
                lambda d, k, b, og_: solve_ensemble_sharded(
                    mesh, d, an, k, n, b, or_groups=og_
                )
            ),
            (dense, key, bm, og),
            tag="pipeline_sharded",
            statics=f"{an!r}|n={n}|nb={nb}|devs={[d.id for d in devices]}",
        )
        _SHARDED_PROGRAMS[prog_key] = solve
    return solve(dense, key, bm, og), L_pad


def _fold_conf(dense, conf):
    """Fold per-pair .rr confidence weights into the stress weights.

    Padding rows/cols already carry weight 0 (mask zero), so only the true
    (L, L) block is touched — no (L_pad, L_pad) host allocation or
    unsharded upload, which an at-scale path must never pay (CLAUDE.md:
    a single (L, L) host pass at L = 24576 costs ~50 s on this host, and a
    whole-tensor upload lands 4·L_pad² bytes on one device)."""
    if conf is None:
        return dense
    import jax.numpy as jnp

    from chromosome3d.ops.energy import ExactRestraints

    attr = "w" if isinstance(dense, ExactRestraints) else "weight"
    wt = getattr(dense, attr)
    conf = np.asarray(conf, np.float32)
    if isinstance(wt, np.ndarray):
        wt = wt.copy()
        wt[: conf.shape[0], : conf.shape[1]] *= conf
    else:
        wt = wt.at[: conf.shape[0], : conf.shape[1]].multiply(jnp.asarray(conf))
    return dense._replace(**{attr: wt})


def auto_exact(cfg: PipelineConfig, restraints) -> PipelineConfig:
    """Enable the exact-restraint pair terms when provable from the data:
    every deviation zero (the pipeline's own restraints always are) and the
    pure-quadratic well active. No-op otherwise — the general well stays."""
    an = cfg.anneal
    if (
        not an.exact_restraints
        and an.noe_rswitch >= 1e8
        and not np.asarray(restraints.negdev).any()
        and not np.asarray(restraints.posdev).any()
    ):
        return cfg.replace(anneal=dataclasses_replace(an, exact_restraints=True))
    return cfg


def auto_exact_matrix(cfg: PipelineConfig) -> PipelineConfig:
    """auto_exact for MATRIX-derived restraints, decidable without the
    data: the pipeline's own restraints are exact by construction (dist2rr
    always emits lo == hi, chromosome3D.pl:203-205, and its d <= 0 skip
    excludes the carr2tbl zero-lo case), so only the pure-quadratic-well
    condition needs checking. Lets at-scale matrix paths enable the exact
    kernel BEFORE any restraint tensor exists (the device-prep route never
    builds one on the host)."""
    an = cfg.anneal
    if not an.exact_restraints and an.noe_rswitch >= 1e8:
        return cfg.replace(anneal=dataclasses_replace(an, exact_restraints=True))
    return cfg


def _beads_row_sharding():
    """Row sharding over a 1-D `beads` mesh of every device — the layout
    the at-scale device-prep programs are traced with."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    return NamedSharding(
        Mesh(np.asarray(jax.devices()), ("beads",)), P("beads", None)
    )


def _assessment_view_from_if(if_matrix, rc, L_pad: int, sharded: bool,
                             n_true=None):
    """Post-solve host view for the at-scale device-prep matrix route:
    re-invoke the device prep program at f32 and DOWNLOAD the exact
    tiles — (Restraints view, ExactRestraints numpy view), one f32
    transfer each instead of the float64 host prep passes. Bit-equal to
    the host route (tests/test_device_prep.py pins the quantization).

    sharded MUST match the solve's layout: the prep program's jit cache is
    keyed on input shardings, so a mismatched call would pay a fresh
    compile for assessment-only data. When pair_bf16 is
    ON the solve used the bf16-stored prep program, so this f32 view is a
    distinct compile regardless — one extra prep compile per bucket, the
    price of correct f32 report values (see run_pipeline's at-scale
    branch)."""
    from chromosome3d.ops.device_prep import (
        assessment_view_from_if_streamed,
        exact_tiles_from_if_device,
        should_stream_prep,
    )
    from chromosome3d.ops.energy import ExactRestraints, auto_weight_exponent
    from chromosome3d.restraints import restraints_from_exact_target

    L = if_matrix.shape[0] if n_true is None else n_true
    p = rc.weight_exponent
    if p is None:
        p = auto_weight_exponent(L)
    if not sharded and should_stream_prep(L_pad, "float32"):
        # past the one-shot ceiling the f32 view tiles cannot coexist on
        # one device at all — stream each strip's final values straight to
        # the host (peak = one strip; the solve tiles are already freed)
        target_np, w_np = assessment_view_from_if_streamed(
            if_matrix, L_pad, rc, rc.weighting, p, n_true=L,
        )
    else:
        tiles = exact_tiles_from_if_device(
            if_matrix, L_pad, rc, rc.weighting, p,
            sharding=_beads_row_sharding() if sharded else None,
            n_true=L,
        )
        target_np = np.asarray(tiles.target)[:L, :L]
        w_np = np.asarray(tiles.w)[:L, :L]
    return (
        restraints_from_exact_target(target_np),
        ExactRestraints(target=target_np, w=w_np),
    )


def _exact_provable(cfg: PipelineConfig) -> bool:
    """Whether the solve runs the exact-restraint algebra (the same gate as
    solver.anneal: auto_exact/explicit exact_restraints AND pure-quadratic
    well) — exactly when the TWO-tensor ExactRestraints form is valid."""
    return cfg.anneal.exact_restraints and cfg.anneal.noe_rswitch >= 1e8


def _padded_dense(restraints, rc, L_pad: int, exact: bool = False,
                  device: bool = False):
    """Device tensors padded to L_pad. The weight exponent and the mean-1
    normalization both come from the TRUE length (padding is masked), so the
    padded solve is numerically identical to the exact-L solve.

    exact=True (callers pass _exact_provable(cfg)) builds the two-tensor
    ExactRestraints form: half the upload, half the live restraint HBM —
    the at-scale single-chip memory ceiling is set by live (L, L) tensor
    count, so this is what buys the larger-L headroom.

    device=True (at-scale callers: L_pad beyond every length bucket) moves
    the exact-form padding + weight construction onto the accelerator
    (ops.device_prep): one f32 upload and one jitted program instead of ~10
    float64 host passes — on this single-vCPU host the numpy route costs
    minutes at L >= 8192 while the device program is milliseconds. Weight
    math is f32 there (vs f64 host), ~1e-7 relative — below the solver's
    own f32 resolution; reference-scale bucket solves keep the host route
    so golden-number comparisons stay bit-stable."""
    p = rc.weight_exponent
    if p is None:
        from chromosome3d.ops.energy import auto_weight_exponent

        p = auto_weight_exponent(restraints.length)
    if exact and device:
        from chromosome3d.ops.device_prep import exact_tiles_from_target_device

        return exact_tiles_from_target_device(
            restraints.target, L_pad, rc.weighting, p
        ), p
    builder = exact_restraints_from_numpy if exact else dense_restraints_from_numpy
    return builder(restraints.padded(L_pad), rc.weighting, p), p


_ALT_FORMATS = (".cool", ".mcool", ".hic", ".matrix")


def run_pipeline(
    file_if: str,
    dir_out: str,
    cfg: Optional[PipelineConfig] = None,
    wipe: bool = True,
    profile_dir: Optional[str] = None,
    chrom: Optional[str] = None,
    resolution: Optional[int] = None,
    bed_path: Optional[str] = None,
    ice: bool = False,
    norm: str = "NONE",
) -> Dict:
    """Run one chromosome end to end. Returns a result summary dict.

    Mirrors `chromosome3D.pl -i file_if -o dir_out` semantics, including the
    outdir wipe (:56) and the stdout progress banners (:48-53, 100-107).
    profile_dir: if set, the solve runs under a jax.profiler trace.

    Besides the reference's dense text format, file_if may be a cooler
    .cool/.mcool, a juicer .hic, or a HiC-Pro .matrix (io.hic.load_any);
    chrom/resolution/bed_path select the block for those formats. The loaded
    matrix is materialized as `{ident}.txt` so the artifact tree matches a
    native run.
    """
    cfg = cfg or PipelineConfig()
    t_start = time.time()
    # per-phase wall breakdown (summary["phases"]): says whether
    # load/prep/solve/assessment moved between runs
    phases: Dict = {}
    _t_ph = [t_start]

    def _mark(name: str) -> None:
        now = time.time()
        phases[name] = round(phases.get(name, 0.0) + (now - _t_ph[0]), 2)
        _t_ph[0] = now

    from chromosome3d.utils import aot as _aot_mod

    _aot_mark = _aot_mod.event_mark()
    if not os.path.isfile(file_if):
        raise FileNotFoundError(f"Input IF file {file_if} does not exist!")
    os.makedirs(dir_out, exist_ok=True)
    if wipe:
        for name in os.listdir(dir_out):
            p = os.path.join(dir_out, name)
            if os.path.isfile(p):
                os.remove(p)
    base = os.path.basename(file_if)
    ident, ext = os.path.splitext(base)
    if ext not in (".txt", ".npy") + _ALT_FORMATS:
        ident = base  # unknown extension: keep the full name as the id
    local_if = os.path.join(dir_out, f"{ident}.txt")
    if ext == ".npy":
        # binary at-scale input (io.matrix loads it as a read-only memmap):
        # no text materialization and no copy — a matrix this format exists
        # for is gigabytes, and artifact byte-parity only has a contract at
        # reference scale (PARITY deviation #9 already suppresses the
        # O(L^2) text artifacts beyond every bucket)
        if ice or chrom or resolution or bed_path or norm != "NONE":
            # these selectors belong to the .cool/.hic/.matrix loaders (and
            # ICE is an O(L^2) iterative host balance) — silently ignoring
            # them would hand back results from the RAW matrix
            raise ValueError(
                ".npy input does not support --ice/--chrom/--resolution/"
                "--bed/--norm: pre-process the matrix and save the final "
                "values (np.save) instead"
            )
        local_if = os.fspath(file_if)
    elif ext in _ALT_FORMATS or ice:
        from chromosome3d.io.hic import ice_balance, load_any
        from chromosome3d.io.matrix import write_if_matrix

        loaded = load_any(file_if, chrom=chrom, resolution=resolution,
                          bed_path=bed_path, norm=norm)
        if ice:
            # ICE matrix balancing for raw counts (Imakaev 2012); the
            # materialized {ident}.txt carries the values the run used
            loaded = ice_balance(loaded)
        write_if_matrix(local_if, loaded)
    elif os.path.abspath(file_if) != os.path.abspath(local_if):
        shutil.copy(file_if, local_if)

    rc = cfg.restraints
    banner(log, f"Input      : {file_if}")
    banner(log, f"Output Dir : {dir_out}")
    banner(log, f"Scaling(K) : {rc.kscaling}")
    banner(log, f"Alpha      : {rc.alpha}")
    banner(
        log,
        f"Conversion : D = {rc.kscaling} * mean(IF^{rc.alpha}) / IF^{rc.alpha}",
    )

    # ---- L3: restraint generation + text artifacts ----
    if_matrix = load_if_matrix(local_if)
    _mark("load_s")
    L = if_matrix.shape[0]
    banner(log, f"L          : {L}")
    # Beyond every length bucket there are no published artifacts for the
    # byte-parity contract to honor, and every O(L^2) float64 host pass
    # costs minutes on this host (CLAUDE.md invariant; build_restraints
    # measured 313 s at L = 8192, a .dist file there is gigabytes of text).
    # Matrix-derived EXACT restraints therefore take the device-prep route
    # END TO END at scale: tiles built on the accelerator straight from
    # the IF matrix, the O(L^2) text artifacts suppressed (configure a
    # length bucket >= L to restore the reference-scale host route), and
    # the host assessment view DOWNLOADED post-solve (one f32 transfer).
    device_route = L > max(cfg.length_buckets) and _exact_provable(
        auto_exact_matrix(cfg)
    )
    # $ID.fasta for tooling compatibility (ref :93-98 used a fake protein
    # sequence to drive CNS; beads need no chemistry, so poly-M suffices)
    with open(os.path.join(dir_out, f"{ident}.fasta"), "w") as f:
        f.write(f">{ident}\n{'M' * L}\n")
    restraints = dense = n_tbl = None
    if device_route:
        cfg = auto_exact_matrix(cfg)
        banner(
            log,
            "Artifacts  : beyond-bucket L — restraint prep on device, "
            "O(L^2) text artifacts suppressed",
        )
    else:
        dist = if_to_dist(if_matrix, rc)
        write_dist_matrix(os.path.join(dir_out, f"{ident}.dist"), dist)
        write_rr(os.path.join(dir_out, f"{ident}.rr"), dist, rc)
        n_tbl = write_contact_tbl(
            os.path.join(dir_out, "contact.tbl"),
            os.path.join(dir_out, f"{ident}.rr"),
            rc,
        )
        banner(log, f"Restraints : {n_tbl} lines in tbl file")
        restraints = dist_to_restraints(dist, rc)
        if restraints.count != n_tbl:
            # the reference's restraint-acceptance check leaves an
            # `assess.failed` sentinel before confessing (chromosome3D.pl:
            # 785-787) so a monitoring harness can detect the failure from
            # the tree alone
            msg = (
                f"restraint-count mismatch: tensors {restraints.count} "
                f"vs tbl {n_tbl}"
            )
            with open(os.path.join(dir_out, "assess.failed"), "w") as f:
                f.write(msg + "\n")
            raise AssertionError(msg)
        banner(log, f"Coverage   : {coverage_string(restraints)}")
        cfg = auto_exact(cfg, restraints)
        # assessment-only tensors: HOST numpy (assess_ensemble is host-side
        # by the documented rule — uploading these four true-L tensors would
        # cost four transfers for data the device never reads)
        dense = dense_restraints_from_numpy(
            restraints, rc.weighting, rc.weight_exponent, as_numpy=True
        )
    # solver tensors are padded to the length bucket, so different-L runs
    # share one compiled program (each distinct L otherwise costs a fresh
    # compile — the genome runner's discipline, applied
    # to single runs; see PipelineConfig.bucket_single_runs). L beyond every
    # bucket dispatches to the row-sharded solver over the device mesh
    # (PipelineConfig.shard_large) — the at-scale path, reachable straight
    # from this CLI.
    sharded = _use_sharded(L, cfg)
    L_pad, bead_mask = _bucket_pad(L, cfg)
    bm = None if bead_mask is None else jax.numpy.asarray(bead_mask)
    cfg_solve = cfg
    if_dev = None
    if device_route:
        # pad the IF matrix to the solve layout ONCE and thread the copy:
        # the solve prep, each extra-alpha prep, and the post-solve
        # assessment view all pass this pre-padded f32 array through
        # pad_f32 — each separate pad is an O(L^2) host copy (~25 s at
        # L = 24576 on this ~0.1 GB/s host). Preps-only: scoring and
        # artifact emission keep the original float64 matrix.
        from chromosome3d.ops.device_prep import pad_f32

        if_dev = pad_f32(
            if_matrix,
            quantum_bucket(L, cfg.shard_quantum, multiple=len(jax.devices()))
            if sharded
            else L_pad,
        )
    # host-side restraint prep (text artifacts + tensors on the reference-
    # scale route; the padded f32 matrix copy on the device route)
    _mark("host_prep_s")

    def do_solve(restr_np, rc_x, k):
        if device_route and sharded:
            # matrix straight to row-sharded device tiles; no host prep
            res, _ = _sharded_solve(None, rc_x, cfg_solve, k,
                                    cfg_solve.model_count, if_matrix=if_dev,
                                    L_true=L)
            return res
        if device_route:
            # beyond-bucket single-chip: the whole L3 prep on device from
            # the IF matrix (alpha/K/p are device scalars — the alpha
            # ensemble reuses this compiled prep program)
            from chromosome3d.ops.device_prep import exact_tiles_from_if_device
            from chromosome3d.ops.energy import auto_weight_exponent

            p_x = rc_x.weight_exponent
            if p_x is None:
                p_x = auto_weight_exponent(L)
            tiles = exact_tiles_from_if_device(
                if_dev, L_pad, rc_x, rc_x.weighting, p_x, n_true=L,
                # pair_bf16 at scale: tiles STORED bf16 (half the argument
                # memory and the per-step stream). The assessment view
                # below stays f32 (correct report values), paying one
                # extra prep compile per bucket.
                out_dtype="bfloat16" if cfg_solve.anneal.pair_bf16
                else "float32",
            )
            # phase split: the prep's device work ends before the solve's
            jax.block_until_ready(tiles)
            _mark("device_prep_s")
            return _aot_solve(tiles, cfg_solve.anneal, k, cfg_solve.model_count, bm)
        if sharded:
            res, _ = _sharded_solve(restr_np, rc_x, cfg_solve, k,
                                    cfg_solve.model_count, device_prep=True)
            return res
        dense_x, _ = _padded_dense(
            restr_np, rc_x, L_pad, exact=_exact_provable(cfg_solve),
            # beyond-bucket single-chip solves (shard_quantum padding) build
            # their tiles on device; bucket-size solves keep the f64 host
            # route (golden-number bit stability, and prep there is ~ms)
            device=L_pad > max(cfg_solve.length_buckets),
        )
        return _aot_solve(dense_x, cfg_solve.anneal, k, cfg_solve.model_count, bm)

    # ---- L2/L1: solve (sentinel-file failure protocol, ref :261-284) ----
    running = os.path.join(dir_out, "iam.running")
    with open(running, "w") as f:
        f.write("solving\n")
    try:
        banner(log, f"(B) Build {cfg.model_count} models with the annealer..")
        if sharded:
            banner(
                log,
                f"Scale      : L={L} beyond the largest bucket; row-sharded "
                f"solve over {len(jax.devices())} devices",
            )
        elif L_pad != L:
            banner(log, f"Bucket     : solving padded to L={L_pad}")
        key = jax.random.PRNGKey(cfg.seed)
        with profile_trace(profile_dir):
            result = do_solve(restraints, rc, key)
            coords = np.asarray(result.coords)[:, :L, :]
        energies = {k: np.asarray(v) for k, v in result.energies.items()}
        _mark("solve_s")
        # energy-trajectory observability (the reference discards dgsa.log)
        np.savez_compressed(
            os.path.join(dir_out, "trajectory.npz"),
            energy_history=np.asarray(result.history),
        )
        alphas = [rc.alpha] * cfg.model_count
        # hyperparameter-ensemble: extra alpha variants pool into the
        # Spearman ranking (same shapes -> the compiled program is reused)
        for extra_alpha in cfg.alpha_ensemble:
            if extra_alpha == rc.alpha:
                continue
            rc_x = dataclasses_replace(rc, alpha=extra_alpha)
            key, sub = jax.random.split(key)
            restr_x = (
                None
                if device_route
                else dist_to_restraints(if_to_dist(if_matrix, rc_x), rc_x)
            )
            res_x = do_solve(restr_x, rc_x, sub)
            coords = np.concatenate([coords, np.asarray(res_x.coords)[:, :L, :]])
            # energies under a different restraint set are not comparable;
            # recorded for REMARKs but excluded from the NOE ranking below
            energies = {
                k: np.concatenate([v, np.asarray(res_x.energies[k])])
                for k, v in energies.items()
            }
            alphas += [extra_alpha] * cfg.model_count
    except Exception:
        os.replace(running, os.path.join(dir_out, "iam.failed"))
        raise
    os.remove(running)

    # ---- L0: assess, rank, emit ----
    _mark("alpha_ensemble_s")
    banner(log, "(C) Assess models..")
    if device_route:
        # host assessment view: one f32 download of the device-built tiles
        # (the memoized prep program re-invokes for ~free; sharded must
        # match the solve's layout so the jit cache hits)
        L_pad_assess = (
            quantum_bucket(L, cfg.shard_quantum, multiple=len(jax.devices()))
            if sharded
            else L_pad
        )
        restraints, dense = _assessment_view_from_if(
            if_dev, rc, L_pad_assess, sharded, n_true=L
        )
        n_tbl = restraints.count
        _mark("assess_view_s")
    summary = emit_artifacts(
        dir_out, ident, coords, energies, if_matrix, restraints, dense, cfg,
        alphas=alphas,
    )
    _mark("assess_emit_s")
    evs = _aot_mod.events_since(_aot_mark)
    phases["aot"] = {
        "compile_or_load_s": round(sum(e["seconds"] for e in evs), 2),
        "hits": sum(1 for e in evs if e.get("hit")),
        "misses": sum(1 for e in evs if e.get("hit") is False),
        "uncached": sum(1 for e in evs if e.get("hit") is None),
    }
    summary.update(
        {
            "restraints": int(n_tbl),
            "wall_seconds": time.time() - t_start,
            "phases": phases,
        }
    )
    with open(os.path.join(dir_out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    banner(log, f"Finished in {summary['wall_seconds']:.1f}s "
                f"best Spearman(IF,1/d)={summary['best_spearman_if_inv_d']:.4f}")
    return summary


def run_restraints_pipeline(
    restraints_file: str,
    dir_out: str,
    cfg: Optional[PipelineConfig] = None,
    L: Optional[int] = None,
    max_L: Optional[int] = None,
) -> Dict:
    """Solve directly from a restraint file — a CONFOLD-style `.rr` or a CNS
    `.tbl` — with no IF matrix. This is the general distance-geometry entry
    point (the reference only reaches CNS through its own generated tbl;
    here external restraint sets are first-class). Spearman ranking needs a
    matrix, so models rank by NOE energy only.

    max_L: reject (ValueError) any file whose explicit-or-inferred length
    exceeds it, BEFORE dense tensors are allocated or any solve is queued —
    request-serving callers (serve.MAX_L) pass their cap here, closing the
    hole where a file naming a huge residue index walked past the request
    validator (which only sees an explicit "L" field)."""
    from chromosome3d.restraints import read_contact_tbl_full, read_rr

    cfg = cfg or PipelineConfig()
    t_start = time.time()
    os.makedirs(dir_out, exist_ok=True)
    ident = os.path.basename(restraints_file)
    ident = ident.rsplit(".", 1)[0]
    rc = cfg.restraints

    or_groups_np = None
    tbl_rows = None
    if restraints_file.endswith(".tbl"):
        from chromosome3d.assess import parse_tbl_rows

        tbl_rows = parse_tbl_rows(restraints_file)  # parsed ONCE, shared
        if max_L is not None:
            L_eff = L if L is not None else max(
                (r for g1, g2, *_ in tbl_rows for r, _ in (*g1, *g2)),
                default=0,
            )
            if L_eff > max_L:
                raise ValueError(
                    f"{restraints_file}: L={L_eff} exceeds the cap {max_L}"
                )
        restraints, or_groups_np = read_contact_tbl_full(
            restraints_file, L, rows=tbl_rows
        )
        conf = None
    else:
        restraints, conf = read_rr(restraints_file, L, rc, max_L=max_L)
    n_groups = 0 if or_groups_np is None else or_groups_np.count
    banner(
        log,
        f"Restraints : {restraints.count} from {restraints_file} "
        f"(L={restraints.length}"
        + (f", +{n_groups} or-groups)" if n_groups else ")"),
    )
    cfg = auto_exact(cfg, restraints)
    if not cfg.anneal.embed_two_sided and (
        np.asarray(restraints.negdev).any() or np.asarray(restraints.posdev).any()
    ):
        # external restraints with real deviation windows: the embed must
        # respect BOTH bounds (mmdg's bounds-matrix smoothing semantics,
        # chromosome3D.pl:1471-1489) — midpoint completion alone can push a
        # restrained pair below its lower bound through an intermediate path
        cfg = cfg.replace(
            anneal=dataclasses_replace(cfg.anneal, embed_two_sided=True)
        )
    Lr = restraints.length
    # at-scale dispatch: like run_pipeline, L beyond every bucket row-shards
    # over the mesh — or-group rows and rr confidences included (round 4:
    # the group term rides replicated in the shard body, conf folds into
    # the stress weights, so external restraint files keep the sharded path)
    sharded = _use_sharded(Lr, cfg)
    key = jax.random.PRNGKey(cfg.seed)
    L_solved = Lr
    if sharded:
        banner(
            log,
            f"Scale      : L={Lr} beyond the largest bucket; row-sharded "
            f"solve over {len(jax.devices())} devices",
        )
        result, L_solved = _sharded_solve(
            restraints, rc, cfg, key, cfg.model_count,
            or_groups_np=or_groups_np, conf=conf,
        )
    else:
        L_pad, bead_mask = _bucket_pad(Lr, cfg)
        L_solved = L_pad
        dense, _ = _padded_dense(
            restraints, rc, L_pad, exact=_exact_provable(cfg)
        )
        dense = _fold_conf(dense, conf)
        bm = None if bead_mask is None else jax.numpy.asarray(bead_mask)
        or_groups = None
        if or_groups_np is not None:
            from chromosome3d.ops.energy import dense_or_groups_from_numpy

            or_groups = dense_or_groups_from_numpy(or_groups_np)
        result = _aot_solve(
            dense, cfg.anneal, key, cfg.model_count, bm, or_groups=or_groups
        )
    coords = np.asarray(result.coords)[:, :Lr, :]
    energies = {k: np.asarray(v) for k, v in result.energies.items()}

    e_order = rank_by_energy(energies["noe"], cfg.top_k)
    info_log = os.path.join(dir_out, "model_info.log")
    for rank, idx in enumerate(e_order, start=1):
        path = os.path.join(dir_out, f"{ident}_model{rank}.pdb")
        remarks = {k: float(energies[k][idx]) for k in ("overall", "vdw", "bon", "noe")}
        write_ca_pdb(path, coords[idx], remarks=remarks)
        append_model_info(info_log, path, remarks)
    best = int(e_order[0])
    if tbl_rows is not None:
        # external tbl: assess per TBL ROW like the reference (duplicates,
        # reversed rows, and or-groups each count; :447-485, :487-554)
        from chromosome3d.assess import write_tbl_violation_report

        satisfied, total = write_tbl_violation_report(
            os.path.join(dir_out, f"{ident}_violation.txt"),
            coords[best], restraints_file, cfg,
            pdb_name=f"{ident}_model1.pdb", rows=tbl_rows,
        )
    else:
        satisfied, total = write_violation_report(
            os.path.join(dir_out, f"{ident}_violation.txt"),
            coords[best], restraints, cfg, pdb_name=f"{ident}_model1.pdb",
            tbl_name=os.path.basename(restraints_file),
        )
    summary = {
        "id": ident,
        "L": int(restraints.length),
        # the padded length the compiled program actually used (bucket or
        # lcm(quantum, devices) for sharded solves) — warm-cache bookkeeping
        "L_solved": int(L_solved),
        "restraints": int(restraints.count),
        "or_groups": int(n_groups),
        "models": int(cfg.model_count),
        "best_noe_energy": float(energies["noe"][best]),
        "satisfied": int(satisfied),
        "total": int(total),
        "wall_seconds": time.time() - t_start,
    }
    with open(os.path.join(dir_out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def emit_artifacts(
    dir_out: str,
    ident: str,
    coords: np.ndarray,
    energies: Dict[str, np.ndarray],
    if_matrix: np.ndarray,
    restraints,
    dense,
    cfg: PipelineConfig,
    alphas=None,
) -> Dict:
    """The L0 assessment + artifact emission shared by the per-chromosome
    pipeline and the genome runner: satisfaction stats, NOE-energy top-k
    model PDBs (ref :822-828), Spearman-ranked rankNN PDBs (the published
    naming), spearman.txt, model_info.log, and the best model's violation
    report. Returns the summary dict."""
    rc = cfg.restraints
    L = if_matrix.shape[0]
    n_base = min(cfg.model_count, len(coords))
    if alphas is None:
        alphas = [rc.alpha] * len(coords)

    stats = assess_ensemble(coords, dense, cfg)
    sp_order, sp_scores = rank_by_spearman(if_matrix, coords, cfg.spearman_range)
    # NOE-energy ranking only within the base-alpha models (energies under
    # different restraint sets are not comparable)
    e_order = rank_by_energy(energies["noe"][:n_base], cfg.top_k)

    info_log = os.path.join(dir_out, "model_info.log")
    banner(log, f"NOE_SATISFIED(+-{cfg.dist_relax}A)  SUM_OF_DEVIATIONS>=0.2  MODEL")
    for i in range(len(coords)):
        banner(
            log,
            f"{stats['satisfied'][i]}/{stats['total'][i]}"
            f"              {stats['sum_dev'][i]:.2f}"
            f"              model{i} (noe={energies['noe'][i]:.2f},"
            f" spearman={sp_scores[i]:.4f})",
        )

    # NOE-energy top-k -> ${ID}_model1..5.pdb (ref :822-828)
    for rank, idx in enumerate(e_order, start=1):
        path = os.path.join(dir_out, f"{ident}_model{rank}.pdb")
        remarks = {k: float(energies[k][idx]) for k in ("overall", "vdw", "bon", "noe")}
        write_ca_pdb(path, coords[idx], remarks=remarks)
        append_model_info(info_log, path, remarks)

    # Spearman-ranked full set -> ${ID}_rankNN.pdb (the published naming,
    # e.g. output_models/chr21_1mb_rank07_a11.pdb)
    atag = f"a{rc.alpha}".replace(".", "")
    for rank, idx in enumerate(sp_order, start=1):
        path = os.path.join(dir_out, f"{ident}_rank{rank:02d}_{atag}.pdb")
        remarks = {k: float(energies[k][idx]) for k in ("overall", "vdw", "bon", "noe")}
        remarks["spearman_if_inv_d"] = float(sp_scores[idx])
        remarks["alpha"] = float(alphas[idx])
        write_ca_pdb(path, coords[idx], remarks=remarks)

    with open(os.path.join(dir_out, "spearman.txt"), "w") as f:
        f.write("SRCC\tPDB\n")
        for rank, idx in enumerate(sp_order, start=1):
            f.write(f"{sp_scores[idx]:.3f}\t{ident}_rank{rank:02d}_{atag}.pdb\n")

    # violation reports for EVERY model, appended into one file in
    # descending-NOE-energy order — exactly the reference's assessment loop
    # (assess_dgsa iterates `sort {$energyNoe{$b} <=> $energyNoe{$a}}` and
    # count_satisfied_tbl_rows print2file-APPENDS each report,
    # chromosome3D.pl:804-810, 478-484)
    viol_path = os.path.join(dir_out, "contact_violation.txt")
    idx_to_rank = {int(idx): rank for rank, idx in enumerate(sp_order, start=1)}
    best = int(e_order[0])
    satisfied = total = 0
    if not cfg.emit_violation_reports:
        # stats above still cover satisfaction; the per-model report FILES
        # are each an O(L^2) host pass (PipelineConfig.emit_violation_reports)
        return {
            "id": ident,
            "L": int(L),
            "models": int(len(coords)),
            "best_noe_energy": float(energies["noe"][best]),
            "best_spearman_if_inv_d": float(sp_scores[sp_order[0]]),
            "satisfied": int(stats["satisfied"][best]),
            "total": int(stats["total"][best]),
            "clashes_under_3A": clash_count(coords[best], 3.0),
        }
    # the spec column is model-independent: format it once per chromosome —
    # but ONLY at reference scale. Beyond FULL_REPORT_MAX the writer keeps
    # violated rows only and formats specs for just those; precomputing all
    # of them here (one Python f-string per restraint, ~L^2/2 at scale)
    # would be hours of host time at L = 16384 on this single-vCPU box.
    from chromosome3d.assess import FULL_REPORT_MAX, restraint_spec_strings

    specs = (
        restraint_spec_strings(restraints)
        if restraints.count <= FULL_REPORT_MAX
        else None
    )
    for n, idx in enumerate(np.argsort(-energies["noe"], kind="stable")):
        idx = int(idx)
        s, t = write_violation_report(
            viol_path,
            coords[idx],
            restraints,
            cfg,
            pdb_name=f"{ident}_rank{idx_to_rank[idx]:02d}_{atag}.pdb",
            append=n > 0,
            specs=specs,
        )
        if idx == best:
            satisfied, total = s, t

    return {
        "id": ident,
        "L": int(L),
        "models": int(len(coords)),
        "best_noe_energy": float(energies["noe"][best]),
        "best_spearman_if_inv_d": float(sp_scores[sp_order[0]]),
        "satisfied": int(satisfied),
        "total": int(total),
        "clashes_under_3A": clash_count(coords[best], 3.0),
    }
