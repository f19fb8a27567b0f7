"""Whole-genome runs: chromosomes sharded over the device mesh.

Replacement for test.sh's 46 backgrounded Unix processes
(test.sh:4-11, the reference's entire "distributed" story). Here the genome
is a handful of *single compiled launches*:

  1. chromosomes are bucketed by padded bead count (length_buckets in
     PipelineConfig) — padding beads are masked out of every energy term;
  2. each bucket is a (B, L, L) batch of dense restraint tensors, solved by
     vmap(solve_ensemble_impl) — restarts vmap *inside* each chromosome;
  3. the batch axis is laid out over a 1-D `chrom` device mesh with
     jax.sharding.NamedSharding, so XLA splits the work across devices
     with zero collectives in the hot loop (the problem is embarrassingly
     parallel; only the result gather crosses devices).

Length buckets keep ragged L (35..455 shipped, SURVEY.md 2.3) from forcing
one compile per chromosome: one program per bucket covers the genome.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from chromosome3d.config import PipelineConfig
from chromosome3d.io.matrix import load_if_matrix
from chromosome3d.ops.energy import DenseRestraints, dense_restraints_from_numpy
from chromosome3d.restraints import build_restraints
from chromosome3d.solver.anneal import AnnealResult, solve_ensemble_impl
from chromosome3d.utils.logging import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class GenomeJob:
    """One chromosome x resolution work item."""

    name: str              # e.g. "chr21_500kb"
    path: str              # IF matrix file
    length: int = 0        # true bead count (filled by bucket_jobs)
    bucket: int = 0        # padded length


def discover_jobs(input_dir: str, pattern: str = r"chr(\w+)_(\w+)_matrix\.txt$") -> List[GenomeJob]:
    """Find chr*_{res}_matrix.txt inputs (the test.sh file layout)."""
    jobs = []
    rx = re.compile(pattern)
    for name in sorted(os.listdir(input_dir)):
        m = rx.search(name)
        if m:
            jobs.append(
                GenomeJob(
                    name=name.replace("_matrix.txt", ""),
                    path=os.path.join(input_dir, name),
                )
            )
    return jobs


def bucket_jobs(
    jobs: Sequence[GenomeJob],
    buckets: Sequence[int],
    shard_quantum: Optional[int] = None,
) -> Dict[int, List[GenomeJob]]:
    """Assign each job the smallest bucket >= its bead count.

    Jobs beyond the largest bucket get a DYNAMIC bucket rounded up to
    shard_quantum (the at-scale group run_genome hands to the 2-D
    chrom x beads sharded solver); with shard_quantum=None they raise
    (PipelineConfig.shard_large=False restores that contract)."""
    out: Dict[int, List[GenomeJob]] = {}
    for job in jobs:
        if not job.length:
            from chromosome3d.io.matrix import matrix_length

            job.length = matrix_length(job.path)
        fit = [b for b in buckets if b >= job.length]
        if fit:
            job.bucket = min(fit)
        elif shard_quantum:
            from chromosome3d.pipeline import quantum_bucket

            job.bucket = quantum_bucket(job.length, shard_quantum)
        else:
            raise ValueError(
                f"{job.name}: L={job.length} exceeds the largest bucket {max(buckets)}"
            )
        out.setdefault(job.bucket, []).append(job)
    return out


def _stack_bucket(
    jobs: Sequence[GenomeJob], L_pad: int, cfg: PipelineConfig,
    as_numpy: bool = False,
) -> tuple[DenseRestraints, jnp.ndarray, List[np.ndarray], List]:
    """Load + pad one bucket: (B, L, L) dense tensors, (B, L) bead masks,
    the raw IF matrices, and the unpadded Restraints (for assessment).

    NOTE: the per-chromosome weight normalization (mean-1 over the real
    restraints) happens BEFORE padding, so the padded batch is numerically
    identical to solving each chromosome alone.

    as_numpy=True keeps the stacked tensors HOST-side (numpy): at-scale
    buckets hand them to solve_bucket_sharded, which device_puts each
    tensor straight to its per-device (chrom x beads) slices — the batch
    is born distributed instead of materializing whole on one device (the
    single-device HBM ceiling the 2-D mesh exists to break)."""
    rc = cfg.restraints
    masks, matrices, raw = [], [], []
    for job in jobs:
        m = load_if_matrix(job.path)
        matrices.append(m)
        raw.append(build_restraints(m, rc))
        bead = np.zeros(L_pad, dtype=np.float32)
        bead[: m.shape[0]] = 1.0
        masks.append(bead)
    # pipeline-generated restraints are exact (zero deviations) whenever the
    # pure-quadratic well is active — then the TWO-tensor form ships half
    # the bucket's restraint bytes (mirrors pipeline.auto_exact's proof)
    exact = cfg.anneal.noe_rswitch >= 1e8 and all(
        not r.negdev.any() and not r.posdev.any() for r in raw
    )
    from chromosome3d.ops.energy import exact_restraints_from_numpy

    builder = exact_restraints_from_numpy if exact else dense_restraints_from_numpy
    denses = []
    for r in raw:
        # length-adaptive exponent from the TRUE length, not the padded one
        p = rc.weight_exponent
        if p is None:
            from chromosome3d.ops.energy import auto_weight_exponent

            p = auto_weight_exponent(r.length)
        denses.append(builder(r.padded(L_pad), rc.weighting, p, as_numpy=True))
    # stack on the HOST, upload once per tensor: 2 (exact) or 4 device
    # transfers for the whole bucket instead of one set per chromosome
    wrap = (lambda a: a) if as_numpy else jnp.asarray
    batched = type(denses[0])(
        *(wrap(np.stack(ts)) for ts in zip(*denses))
    )
    return batched, wrap(np.stack(masks)), matrices, raw


def make_mesh(devices: Optional[Sequence] = None, axis: str = "chrom") -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis,))


def model_axis_shards(B: int, n_dev: int, model_count: int) -> int:
    """The 2-D `chrom x model` layout decision: when chips outnumber the
    bucket's chromosomes, split each chromosome's restart budget over m
    replicas (virtual batch entries with independent PRNG keys) so every
    chip works. Returns the largest divisor m of model_count with
    B * m <= n_dev (1 = plain 1-D chrom layout)."""
    best = 1
    for m in range(2, model_count + 1):
        if model_count % m == 0 and B * m <= n_dev:
            best = m
    return best


def solve_bucket(
    batched: DenseRestraints,
    bead_masks: jnp.ndarray,
    cfg: PipelineConfig,
    mesh: Optional[Mesh] = None,
    base_seed: Optional[int] = None,
    model_shards: Optional[int] = None,
) -> AnnealResult:
    """Solve a (B, L, L) bucket, batch axis sharded over the mesh.

    Layout is picked from (B, n_devices): when devices outnumber
    chromosomes, each chromosome is expanded into model_axis_shards(...)
    replicas that each solve model_count/m restarts under independent keys
    (a 2-D chrom x model decomposition flattened onto the 1-D mesh axis —
    the enantiomer pairing stays inside each replica, so semantics per
    model are unchanged; only the key assignment differs). The batch is
    then padded up to a multiple of the mesh size with copies of entry 0
    (discarded after).
    """
    B = batched.lo.shape[0]
    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    m_shards = (
        model_axis_shards(B, n_dev, cfg.model_count)
        if model_shards is None
        else model_shards
    )
    if cfg.model_count % m_shards:
        raise ValueError(
            f"model_shards={m_shards} must divide model_count={cfg.model_count}"
        )
    models_per = cfg.model_count // m_shards
    if m_shards > 1:
        log.info(
            f"2-D layout: {B} chromosomes x {m_shards} model shards "
            f"({models_per} models each) over {n_dev} devices"
        )

    def expand(a):
        return jnp.repeat(a, m_shards, axis=0) if m_shards > 1 else a

    batched = type(batched)(*(expand(t) for t in batched))
    bead_masks = expand(bead_masks)
    B_eff = B * m_shards
    B_pad = -(-B_eff // n_dev) * n_dev

    def pad(a):
        return jnp.concatenate([a, jnp.repeat(a[:1], B_pad - B_eff, axis=0)], axis=0) \
            if B_pad > B_eff else a

    batched = type(batched)(*(pad(t) for t in batched))
    bead_masks = pad(bead_masks)
    keys = jax.random.split(
        jax.random.PRNGKey(cfg.seed if base_seed is None else base_seed), B_pad
    )

    batch_sharding = NamedSharding(mesh, P("chrom"))

    solve = jax.vmap(
        lambda dense, key, bead: solve_ensemble_impl(
            dense, cfg.anneal, key, models_per, bead
        )
    )
    solve = jax.jit(
        solve,
        in_shardings=(
            type(batched)(*(batch_sharding,) * len(batched)),
            batch_sharding,
            batch_sharding,
        ),
        out_shardings=batch_sharding,
    )
    # with CHROM3D_AOT_CACHE set, the bucket program round-trips through the
    # serialized-executable cache: later PROCESSES skip the compile
    # entirely (utils/aot.py)
    from chromosome3d.utils.aot import load_or_compile

    solve = load_or_compile(
        solve,
        (batched, keys, bead_masks),
        tag="genome_bucket",
        statics=(
            f"{cfg!r}|models_per={models_per}"
            f"|mesh={dict(zip(mesh.axis_names, mesh.devices.shape))}"
            f"|devs={[d.id for d in mesh.devices.flat]}"
        ),
    )
    result = solve(batched, keys, bead_masks)

    # drop batch padding, then fold the model shards back into the model axis
    def fold(a):
        a = a[:B_eff]
        if m_shards > 1:
            a = a.reshape((B, m_shards * models_per) + a.shape[2:])
        return a

    return AnnealResult(
        coords=fold(result.coords),
        energies={k: fold(v) for k, v in result.energies.items()},
        history=fold(result.history),
    )


def large_mesh_layout(B: int, n_dev: int) -> tuple[int, int]:
    """Factor the device count into (chrom, beads) axes for an at-scale
    bucket: the chrom axis takes the largest divisor of n_dev that the B
    chromosomes can fill; every remaining device shards bead rows (the
    memory axis — each device then holds B/nc x L/nb x L restraint rows)."""
    nc = max(d for d in range(1, n_dev + 1) if n_dev % d == 0 and d <= B)
    return nc, n_dev // nc


def solve_bucket_sharded(
    batched: DenseRestraints,
    bead_masks: jnp.ndarray,
    cfg: PipelineConfig,
    devices: Optional[Sequence] = None,
    base_seed: Optional[int] = None,
) -> AnnealResult:
    """Solve an at-scale bucket (L beyond every length bucket) with the 2-D
    chrom x beads sharded genome solver (solver.sharded.solve_genome_sharded):
    chromosomes split over the chrom axis, each chromosome's O(L^2) restraint
    rows over the beads axis, one compiled program for the bucket. The
    product-surface wiring of the library-level at-scale solver.

    Pads the batch up to a chrom-axis multiple with copies of entry 0 and L
    up to a beads-axis multiple (masked); both are stripped before return.

    Host-numpy batched tensors (run_genome's at-scale buckets pass
    _stack_bucket(as_numpy=True)) are padded on the host and device_put
    STRAIGHT to their (chrom, beads) per-device row slices — each (B, L, L)
    tensor is born distributed, never whole on one device. Device-array
    inputs take the same device_put (an on-device reshard)."""
    devices = list(devices if devices is not None else jax.devices())
    B, L = batched.lo.shape[0], batched.lo.shape[1]
    n_dev = len(devices)
    nc, nb = large_mesh_layout(B, n_dev)
    B_pad = -(-B // nc) * nc
    L_pad = -(-L // nb) * nb
    padr = L_pad - L
    host = isinstance(batched[0], np.ndarray)
    xp = np if host else jnp

    def pad_mat(a):
        a = xp.pad(a, ((0, 0), (0, padr), (0, padr)))
        if B_pad > B:
            a = xp.concatenate([a, xp.repeat(a[:1], B_pad - B, axis=0)])
        return a

    mesh2 = Mesh(np.asarray(devices).reshape(nc, nb), ("chrom", "beads"))
    sh_mat = NamedSharding(mesh2, P("chrom", "beads", None))
    sh_row = NamedSharding(mesh2, P("chrom", None))
    batched_p = type(batched)(
        *(jax.device_put(pad_mat(t), sh_mat) for t in batched)
    )
    masks_p = xp.pad(bead_masks, ((0, 0), (0, padr)))
    if B_pad > B:
        masks_p = xp.concatenate(
            [masks_p, xp.repeat(masks_p[:1], B_pad - B, axis=0)]
        )
    masks_p = jax.device_put(masks_p, sh_row)
    keys = jax.device_put(
        jax.random.split(
            jax.random.PRNGKey(cfg.seed if base_seed is None else base_seed),
            B_pad,
        ),
        sh_row,
    )
    return _launch_bucket_sharded(batched_p, masks_p, keys, cfg, mesh2, B, devices)


def _launch_bucket_sharded(batched_p, masks_p, keys, cfg, mesh2, B, devices):
    """Compile (or AOT-load) + run the 2-D genome bucket program on already
    padded, (chrom, beads)-sharded inputs; strips the batch padding."""
    nc, nb = mesh2.shape["chrom"], mesh2.shape["beads"]
    log.info(
        f"at-scale bucket: {B} chromosomes (L_pad={batched_p.lo.shape[1]}) "
        f"on a {nc} chrom x {nb} beads mesh"
    )
    from chromosome3d.solver.sharded import solve_genome_sharded
    from chromosome3d.utils.aot import load_or_compile

    an, n_models = cfg.anneal, cfg.model_count
    solve = load_or_compile(
        jax.jit(
            lambda b, k, m: solve_genome_sharded(mesh2, b, an, k, n_models, m)
        ),
        (batched_p, keys, masks_p),
        tag="genome_sharded",
        statics=(
            f"{an!r}|n={n_models}|mesh={nc}x{nb}"
            f"|devs={[d.id for d in devices]}"
        ),
    )
    result = solve(batched_p, keys, masks_p)
    return AnnealResult(
        coords=result.coords[:B],
        energies={k: v[:B] for k, v in result.energies.items()},
        history=result.history[:B],
    )


def solve_bucket_sharded_from_if(
    matrices: Sequence[np.ndarray],
    L_pad: int,
    cfg: PipelineConfig,
    devices: Optional[Sequence] = None,
    base_seed: Optional[int] = None,
    stack: Optional[np.ndarray] = None,
):
    """The at-scale genome bucket's IF→device route (late round 4): build
    the whole bucket's exact tiles ON the accelerator straight from the IF
    matrices (ops.device_prep.exact_tiles_from_if_batched_device), born
    distributed over the (chrom, beads) mesh, and solve. The host never
    runs a float64 O(L^2) prep pass (build_restraints measured 313 s at
    L = 8192 per chromosome here); its only O(B·L^2) work is the f32
    pad/stack copy any text input pays.

    Returns (AnnealResult, tiles, true_L_pad): tiles is the live
    (B_pad, L', L') ExactRestraints — callers download per-chromosome
    slices for host assessment (pipeline.restraints_from_exact_target)
    instead of rebuilding them. Under cfg.anneal.pair_bf16 the tiles are
    bf16-STORED (half the per-device tile HBM and per-step stream — the
    composed mesh's ceiling extender, same as the single-chip surfaces);
    assessment callers must then free them and rebuild an f32 view via
    bucket_tiles_from_if (run_genome does). Only valid under the exact
    gate (pipeline.auto_exact_matrix: matrix restraints are exact by
    construction)."""
    devices = list(devices if devices is not None else jax.devices())
    solve_dtype = "bfloat16" if cfg.anneal.pair_bf16 else "float32"
    tiles, mesh2, sh_row, B_pad, L_pad = bucket_tiles_from_if(
        matrices, L_pad, cfg.restraints, devices, solve_dtype, stack=stack
    )
    mats_n = [m.shape[0] for m in matrices]
    mats_n += [mats_n[0]] * (B_pad - len(matrices))
    masks = np.zeros((B_pad, L_pad), np.float32)
    for b, n in enumerate(mats_n):
        masks[b, :n] = 1.0
    masks_p = jax.device_put(masks, sh_row)
    keys = jax.device_put(
        jax.random.split(
            jax.random.PRNGKey(cfg.seed if base_seed is None else base_seed),
            B_pad,
        ),
        sh_row,
    )
    result = _launch_bucket_sharded(
        tiles, masks_p, keys, cfg, mesh2, len(matrices), devices
    )
    return result, tiles, L_pad


def bucket_stack(
    matrices: Sequence[np.ndarray], L_pad: int, devices: Sequence
) -> np.ndarray:
    """The (B_pad, L', L') f32 pad/stack bucket_tiles_from_if would build,
    computed ONCE by callers that prep the same bucket repeatedly (the
    bf16 two-program split, alpha ensembles) — each rebuild is an
    O(B*L'^2) host copy on a ~0.1 GB/s host. Uses the same mesh-layout
    rounding as bucket_tiles_from_if, so the shapes always agree."""
    B = len(matrices)
    nc, nb = large_mesh_layout(B, len(devices))
    B_pad = -(-B // nc) * nc
    L_pad = -(-L_pad // nb) * nb
    mats = list(matrices) + [matrices[0]] * (B_pad - B)
    stack = np.zeros((B_pad, L_pad, L_pad), np.float32)
    for b, m in enumerate(mats):
        Lb = m.shape[0]
        stack[b, :Lb, :Lb] = np.asarray(m, np.float32)
    return stack


def bucket_tiles_from_if(
    matrices: Sequence[np.ndarray],
    L_pad: int,
    rc,
    devices: Sequence,
    out_dtype: str = "float32",
    stack: Optional[np.ndarray] = None,
):
    """Build an at-scale genome bucket's exact tiles on device, born
    distributed over the bucket's (chrom, beads) mesh. Returns
    (tiles, mesh2, row_sharding, B_pad, true_L_pad). Shared by the solve
    (solve dtype — bf16-stored under pair_bf16) and by run_genome's f32
    assessment view (the bf16 route frees the solve tiles first, then
    re-invokes this at f32: one extra prep program + stack upload per
    bucket, the price of f32 report values — the same split as
    pipeline._assessment_view_from_if)."""
    from chromosome3d.ops.device_prep import (
        exact_tiles_from_if_batched_device,
    )
    from chromosome3d.ops.energy import auto_weight_exponent

    devices = list(devices)
    B = len(matrices)
    nc, nb = large_mesh_layout(B, len(devices))
    B_pad = -(-B // nc) * nc
    L_pad = -(-L_pad // nb) * nb
    mesh2 = Mesh(np.asarray(devices).reshape(nc, nb), ("chrom", "beads"))
    sh_mat = NamedSharding(mesh2, P("chrom", "beads", None))
    sh_row = NamedSharding(mesh2, P("chrom", None))
    mats = list(matrices) + [matrices[0]] * (B_pad - B)
    p = rc.weight_exponent
    ps = [auto_weight_exponent(m.shape[0]) if p is None else p for m in mats]
    if B_pad == 1 and len(devices) == 1:
        from chromosome3d.ops.device_prep import (
            exact_tiles_from_if_streamed,
            should_stream_prep,
        )

        if should_stream_prep(L_pad, out_dtype):
            # one huge chromosome on one device: past the one-shot prep
            # ceiling the batched program would OOM exactly like the single
            # one (pipeline's gate) — stream it, tiles born WITH the batch
            # axis (lead_batch) so no (L, L) -> (1, L, L) reshape is ever
            # scheduled at the HBM ceiling
            tiles = exact_tiles_from_if_streamed(
                mats[0], L_pad, rc, rc.weighting, ps[0],
                out_dtype=out_dtype, n_true=mats[0].shape[0],
                lead_batch=True,
            )
            return tiles, mesh2, sh_row, B_pad, L_pad
    tiles = exact_tiles_from_if_batched_device(
        mats, L_pad, rc, rc.weighting, ps, sharding=sh_mat,
        out_dtype=out_dtype, stack=stack,
    )
    return tiles, mesh2, sh_row, B_pad, L_pad


def run_genome(
    input_dir: str,
    output_dir: str,
    cfg: Optional[PipelineConfig] = None,
    jobs: Optional[List[GenomeJob]] = None,
    mesh: Optional[Mesh] = None,
    resume: bool = False,
) -> Dict[str, Dict]:
    """The single-launch test.sh equivalent: every chr*_matrix.txt in
    input_dir is solved (bucketed + mesh-sharded) and assessed; per-
    chromosome artifacts land in output_dir/<name>/.

    resume=True skips chromosomes already present in <output_dir>/checkpoint
    (the checkpoint/resume capability the reference lacks, SURVEY.md 5).

    Writes <output_dir>/summary.json: per-chromosome summaries plus a
    per-bucket PHASE wall breakdown (load / solve+transfer / aot
    compile-or-load / assessment prep / extra alphas / emit), so a
    change in end-to-end genome wall can be attributed to its phase."""
    import json as _json
    import time as _time

    from chromosome3d.pipeline import emit_artifacts
    from chromosome3d.utils import aot as _aot
    from chromosome3d.utils.checkpoint import GenomeCheckpoint

    cfg = cfg or PipelineConfig()
    t_genome0 = _time.time()
    jobs = jobs if jobs is not None else discover_jobs(input_dir)
    if not jobs:
        raise FileNotFoundError(f"no chr*_matrix.txt inputs under {input_dir}")
    ckpt = GenomeCheckpoint(output_dir)
    summaries: Dict[str, Dict] = {}
    phases: Dict[str, Dict] = {}

    def _write_summary():
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "summary.json"), "w") as f:
            _json.dump(
                {
                    "chromosomes": summaries,
                    "phases": phases,
                    "wall_seconds": round(_time.time() - t_genome0, 2),
                },
                f, indent=1,
            )

    if resume:
        done = [j for j in jobs if ckpt.has(j.name)]
        if done:
            log.info(f"resume: skipping {len(done)} finished chromosomes")
        jobs = [j for j in jobs if not ckpt.has(j.name)]
        # the returned dict always covers EVERY job: finished chromosomes
        # contribute their checkpointed summaries even on a partial resume
        summaries.update({d.name: ckpt.load(d.name)[2] for d in done})
        if not jobs:
            _write_summary()
            return summaries
    buckets = bucket_jobs(
        jobs, cfg.length_buckets, cfg.shard_quantum if cfg.shard_large else None
    )
    mesh = mesh or make_mesh()
    max_bucket = max(cfg.length_buckets)
    for L_pad, bucket in sorted(buckets.items()):
        ph = phases[f"L{L_pad}"] = {"chromosomes": [j.name for j in bucket]}
        t_ph = _time.time()
        aot_mark = _aot.event_mark()

        def _phase(name):
            # close the running phase segment and start the next
            nonlocal t_ph
            now = _time.time()
            ph[name] = round(ph.get(name, 0.0) + (now - t_ph), 2)
            t_ph = now

        # at-scale buckets (beyond every length bucket) go to the 2-D
        # chrom x beads sharded solver when devices allow; on one device the
        # plain chrom-batched program covers them (dynamic quantum bucket)
        large = L_pad > max_bucket and mesh.devices.size > 1

        def bucket_solve(bt, mk, cfg_x, seed=None):
            if large:
                return solve_bucket_sharded(
                    bt, mk, cfg_x, devices=list(mesh.devices.flat),
                    base_seed=seed,
                )
            return solve_bucket(bt, mk, cfg_x, mesh, base_seed=seed)

        log.info(
            f"bucket L={L_pad}: {len(bucket)} chromosomes "
            f"({', '.join(j.name for j in bucket)}) on {mesh.devices.size} devices"
            + (" [at-scale: row-sharded]" if large else "")
        )
        # pipeline-generated restraints are always exact; use the fast kernel
        from chromosome3d.pipeline import (
            _exact_provable,
            auto_exact,
            auto_exact_matrix,
        )

        # at-scale EXACT buckets skip the host prep entirely (late round 4):
        # IF matrices go straight to device tiles (exact by construction —
        # auto_exact_matrix), and the host assessment views are downloaded
        # from the live tiles afterwards. The host route below pays
        # build_restraints per chromosome (minutes at L in the thousands) —
        # which is why this route does NOT require multiple devices: on one
        # device the (1, 1)-mesh degenerate of the composed solver runs the
        # same per-shard pair code and the prep stays off the host either
        # way.
        large_device = L_pad > max_bucket and _exact_provable(
            auto_exact_matrix(cfg)
        )
        dense_views = None
        if large_device:
            matrices = [load_if_matrix(job.path) for job in bucket]
            cfg_b = auto_exact_matrix(cfg)
            devs = list(mesh.devices.flat)
            # pad/stack the bucket ONCE when a later prep reuses it (the
            # bf16 f32-assessment re-prep, alpha-ensemble solves) — each
            # rebuild is an O(B*L'^2) host copy (~25 s per L=24576 pad on
            # this ~0.1 GB/s host); 125 GB host RAM holds it comfortably
            stack = (
                bucket_stack(matrices, L_pad, devs)
                if (cfg_b.anneal.pair_bf16 or cfg.alpha_ensemble)
                else None
            )
            _phase("load_s")
            result, tiles, _ = solve_bucket_sharded_from_if(
                matrices, L_pad, cfg_b, devices=devs, stack=stack
            )
            from chromosome3d.ops.energy import ExactRestraints
            from chromosome3d.restraints import restraints_from_exact_target

            if cfg_b.anneal.pair_bf16:
                # the solve ran on bf16-STORED tiles (the at-scale ceiling
                # extender); assessment must read f32 targets. Download the
                # results assessment needs anyway, free the bf16 tiles,
                # then re-prep the bucket at f32 — so the two tile sets
                # never coexist at the memory peak.
                result = AnnealResult(
                    coords=np.asarray(result.coords),
                    energies={
                        k: np.asarray(v) for k, v in result.energies.items()
                    },
                    history=result.history,
                )
                del tiles
                from chromosome3d.ops.device_prep import should_stream_prep

                if (
                    len(devs) == 1
                    and len(bucket) == 1
                    and should_stream_prep(L_pad, "float32")
                ):
                    # past the one-shot ceiling the f32 view tiles cannot
                    # exist on one device at all (8*L'^2 bytes) — stream
                    # each strip's final values straight to the host, the
                    # same route as pipeline._assessment_view_from_if
                    from chromosome3d.ops.device_prep import (
                        assessment_view_from_if_streamed,
                    )
                    from chromosome3d.ops.energy import (
                        auto_weight_exponent,
                    )

                    rc_b = cfg_b.restraints
                    n1 = bucket[0].length
                    p1 = rc_b.weight_exponent
                    if p1 is None:
                        p1 = auto_weight_exponent(n1)
                    t_np, w_np = assessment_view_from_if_streamed(
                        matrices[0], L_pad, rc_b, rc_b.weighting, p1,
                        n_true=n1,
                    )
                    raw = [restraints_from_exact_target(t_np)]
                    dense_views = [ExactRestraints(target=t_np, w=w_np)]
                    tiles = None
                else:
                    tiles = bucket_tiles_from_if(
                        matrices, L_pad, cfg_b.restraints, devs, "float32",
                        stack=stack,
                    )[0]
            if dense_views is None:
                # truncate ON DEVICE before downloading when the padding is
                # material: the live tiles are (B_pad, L', L') with batch-
                # padding chromosomes and padded rows the assessment never
                # reads — at L'=16384 that is gigabytes of extra transfer.
                # One static-shape slice program
                # covers both tensors. On a SINGLE device (B_pad == B,
                # L' = the quantum bucket) the waste is a few %, not worth
                # a fresh compiled program — download the tiles as-is there.
                L_max = max(j.length for j in bucket)
                B_real = len(bucket)
                t_dev, w_dev = tiles.target, tiles.w
                # batch-padding chromosomes (B_pad > B_real on multi-device
                # meshes) are WHOLE duplicated (L', L') tensors the
                # assessment never reads — always slice them off before the
                # download; row padding is only worth a fresh compiled slice
                # program when it is material
                waste = t_dev.shape[1] ** 2 / L_max**2
                if t_dev.shape[0] > B_real or waste > 1.15:
                    t_dev = t_dev[:B_real, :L_max, :L_max]
                    w_dev = w_dev[:B_real, :L_max, :L_max]
                t_all = np.asarray(t_dev)
                w_all = np.asarray(w_dev)
                del t_dev, w_dev
                raw = [
                    restraints_from_exact_target(
                        t_all[b, : j.length, : j.length]
                    )
                    for b, j in enumerate(bucket)
                ]
                dense_views = [
                    ExactRestraints(
                        target=t_all[b, : j.length, : j.length],
                        w=w_all[b, : j.length, : j.length],
                    )
                    for b, j in enumerate(bucket)
                ]
                del tiles, t_all, w_all
        else:
            batched, bead_masks, matrices, raw = _stack_bucket(
                bucket, L_pad, cfg, as_numpy=large
            )
            cfg_b = cfg
            if all(not r.negdev.any() and not r.posdev.any() for r in raw):
                cfg_b = auto_exact(cfg, raw[0])
            _phase("load_s")
            result = bucket_solve(batched, bead_masks, cfg_b)
        coords = np.asarray(result.coords)
        energies_all = {k: np.asarray(v) for k, v in result.energies.items()}
        # solve wall includes the on-device prep, execution, the host
        # transfer fence above and (at-scale f32/bf16 routes) the
        # assessment-view downloads — the aot record below splits out the
        # compile-or-cache-load share
        _phase("solve_and_views_s")
        alphas = [cfg.restraints.alpha] * coords.shape[1]
        # hyperparameter-ensemble quality mode, same as run_pipeline: extra
        # alpha variants pool into the Spearman ranking (bucket shapes are
        # identical, so each extra alpha reuses the compiled program)
        for extra_alpha in cfg.alpha_ensemble:
            if extra_alpha == cfg.restraints.alpha:
                continue
            rc_x = dataclasses.replace(cfg.restraints, alpha=extra_alpha)
            cfg_x = cfg.replace(restraints=rc_x)
            if large_device:
                res_x, tiles_x, _ = solve_bucket_sharded_from_if(
                    matrices, L_pad, auto_exact_matrix(cfg_x),
                    devices=list(mesh.devices.flat),
                    base_seed=cfg.seed + hash(extra_alpha) % 10000,
                    # alpha/K/p are device scalars: the prep PROGRAM is
                    # reused, and the threaded stack skips the host
                    # pad/stack rebuild too
                    stack=stack,
                )
                # the extra alpha's tiles are solve-only (assessment uses
                # the primary alpha's views): drop them now so the device
                # frees the (B_pad, L', L') pair before the next alpha's
                # prep allocates its own
                del tiles_x
            else:
                batched_x, masks_x, _, raw_x = _stack_bucket(
                    bucket, L_pad, cfg_x, as_numpy=large
                )
                cfg_bx = cfg_x
                if all(not r.negdev.any() and not r.posdev.any() for r in raw_x):
                    cfg_bx = auto_exact(cfg_x, raw_x[0])
                res_x = bucket_solve(
                    batched_x, masks_x, cfg_bx,
                    seed=cfg.seed + hash(extra_alpha) % 10000,
                )
            coords = np.concatenate([coords, np.asarray(res_x.coords)], axis=1)
            energies_all = {
                k: np.concatenate([v, np.asarray(res_x.energies[k])], axis=1)
                for k, v in energies_all.items()
            }
            alphas += [extra_alpha] * res_x.coords.shape[1]
        _phase("alpha_s")
        if large_device:
            stack = None  # last prep done: release the (B_pad, L', L') pad

        def emit_one(b, job):
            """Assessment + artifact emission for one chromosome — pure
            HOST work (numpy/scipy/file IO; dense tensors stay numpy), so
            chromosomes emit concurrently on host threads while nothing
            touches the device."""
            L = job.length
            out = os.path.join(output_dir, job.name)
            os.makedirs(out, exist_ok=True)
            c = coords[b, :, :L, :]
            energies = {k: v[b] for k, v in energies_all.items()}
            dense_b = (
                dense_views[b]
                if dense_views is not None
                else dense_restraints_from_numpy(
                    raw[b], cfg.restraints.weighting,
                    cfg.restraints.weight_exponent, as_numpy=True,
                )
            )
            summary = emit_artifacts(
                out, job.name, c, energies, matrices[b], raw[b], dense_b, cfg,
                alphas=alphas,
            )
            summary["bucket"] = L_pad
            ckpt.save(job.name, c, energies, summary)
            log.info(
                f"  {job.name}: best Spearman(IF,1/d) = "
                f"{summary['best_spearman_if_inv_d']:.4f}"
            )
            return job.name, summary

        from concurrent.futures import ThreadPoolExecutor

        workers = min(8, os.cpu_count() or 1, len(bucket))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                for name, summary in pool.map(
                    emit_one, range(len(bucket)), bucket
                ):
                    summaries[name] = summary
        else:
            for b, job in enumerate(bucket):
                name, summary = emit_one(b, job)
                summaries[name] = summary
        _phase("emit_s")
        # compile-vs-cache-load attribution for this bucket's programs
        evs = _aot.events_since(aot_mark)
        ph["aot"] = {
            "compile_or_load_s": round(sum(e["seconds"] for e in evs), 2),
            "hits": sum(1 for e in evs if e.get("hit")),
            "misses": sum(1 for e in evs if e.get("hit") is False),
            "uncached": sum(1 for e in evs if e.get("hit") is None),
        }
    _write_summary()
    return summaries
