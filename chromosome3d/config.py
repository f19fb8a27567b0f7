"""Typed configuration for the whole pipeline.

The reference scatters its knobs across Getopt flags (chromosome3D.pl:28-34),
hard-coded Perl globals (chromosome3D.pl:64-74), and ~150 `{===>}` constants baked
into the generated CNS scripts (chromosome3D.pl:882-2528). Here every knob lives
in one of three frozen dataclasses so a run is fully described by
(RestraintConfig, AnnealConfig, PipelineConfig).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RestraintConfig:
    """IF-matrix -> distance-restraint conversion knobs.

    Mirrors the reference semantics exactly:
      d_ij = K * mean(IF^alpha) / IF_ij^alpha   (chromosome3D.pl:110-162)
    restraint kept iff j > i, |i-j| >= separation, IF_ij > 0
    (chromosome3D.pl:181-206).
    """

    kscaling: float = 11.0        # -k flag; chromosome3D.pl:18
    alpha: float = 0.5            # -a flag; chromosome3D.pl:19 (published models use 1.1)
    separation: int = 5           # $SEPARATION / $min_sep; chromosome3D.pl:20,65
    # carr2tbl zero-lower-bound special case (chromosome3D.pl:355-359):
    zero_lo_distance: float = 3.6
    zero_lo_negdev: float = 0.1
    # solver-side per-restraint weighting (see ops.energy.dense_restraints_from_numpy);
    # weight_exponent None = length-adaptive p*(L) (ops.energy.auto_weight_exponent)
    weighting: str = "relative"
    weight_exponent: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    """The full solver protocol, lifted from the CNS dgsa.inp template
    (chromosome3D.pl:882-1846) and re-expressed for a gradient-based
    Langevin annealer. Defaults keep the *shape* of the CNS schedule
    (hot randomization -> 80-cycle cool with vdw/radius/temperature ramps ->
    long final minimization); step counts are retuned for a first-order
    optimizer instead of CNS's Cartesian MD + LBFGS.
    """

    # ---- energy model (ref: CNS N5, chromosome3D.pl:1092-1135) ----
    noe_weight: float = 10.0       # $con_wt; chromosome3D.pl:66
    noe_rswitch: float = 1e9       # soft-square switch (CNS NOE asymptote):
    #                                violations beyond this grow linearly.
    #                                Default effectively disables the tail:
    #                                with stress (1/t^p) weighting the
    #                                quadratic well measurably beats the
    #                                soft tail (chr21_1mb 0.965 vs 0.804);
    #                                the tail remains available for
    #                                weighting="absolute" runs, where it is
    #                                what keeps huge low-IF targets bounded.
    bond_weight: float = 10.0      # chain-bond term replacing protein topology (N1)
    bond_length: float = 3.8       # CA-CA virtual bond of the fake protein chain
    # optional chain-stiffness (angle) term: E = w * sum(1 - cos phi_i) over
    # consecutive bond-vector pairs (worm-like-chain bending; 0 = straight).
    # CNS runs its annealing with `angl` active on the fake protein's
    # internal angles (chromosome3D.pl:1640-1642, 1866-1886); a bead chain
    # has only the bond directions, so this is the faithful reduced
    # analogue. OFF by default: A/B on the shipped inputs measured it
    # quality-neutral-to-negative (see PARITY.md deviations). When nonzero
    # the angle term rides the jnp bonded path beside the pair terms.
    angle_weight: float = 0.0
    vdw_radius: float = 3.6        # soft-sphere bead diameter (matches the 3.6 A
    #                                lower-bound the reference assigns to zero-lo
    #                                restraints, chromosome3D.pl:356)
    vdw_weight_final: float = 4.0  # cool-phase endpoint (ref :1740-1782 ramp to 4.0)
    vdw_weight_start: float = 0.003  # cool-phase start (ref vdw scale 0.003)
    repel_start: float = 1.0       # repel-radius scale ramp (ref $rep1 :69)
    repel_end: float = 0.85        # ref $rep2 :67

    # ---- initialization (replaces CNS mmdg embedding, ref :1471-1525) ----
    # "auto": classical MDS below L=2048, landmark MDS at/above (the O(L^3
    # log L) bounds smoothing dominates the whole solve past that; landmark
    # is quality-equal on real data, see DESIGN.md). "mds" | "landmark" |
    # "random" | "spiral" force a specific init.
    init: str = "auto"
    # bounds completion for unrestrained pairs before the MDS embed:
    #   "shortest_path" — min-plus all-pairs shortest paths (mmdg's `auto`
    #       bound smoothing, chromosome3D.pl:1480); O(L^2 log L) per squaring.
    #   "max_target"    — fill with the largest restraint target; O(L^2), the
    #       cheap choice for very large L where the min-plus dominates.
    mds_unknown_fill: str = "shortest_path"
    # two-sided bounds geometry in the embed: smooth a bounds MATRIX
    # (distinct lo/hi with inverse-triangle lower-bound propagation,
    # mmdg's semantics for real deviation windows, chromosome3D.pl:
    # 1471-1489) instead of completing the single midpoint-target matrix.
    # Auto-enabled by run_restraints_pipeline when an external .rr/.tbl
    # carries nonzero windows; meaningless (and off) for the pipeline's
    # exact restraints. Applies to init="mds" AND init="landmark" (incl.
    # the row-sharded solver): the landmark relaxation raises its rows'
    # lower bounds by the inverse-triangle sweep and clips restrained
    # targets into the smoothed window (solver.init.landmark_targets).
    embed_two_sided: bool = False
    init_noise: float = 2.0        # per-restart jitter added to the shared embed (A)
    # init="landmark" (and the row-sharded solver, which always uses it):
    # landmark-MDS with this many evenly spaced landmarks and Bellman-Ford
    # relaxation sweeps — O(k L^2) compute / O(k L) memory vs classical MDS's
    # O(L^3 log L) smoothing, the init that scales past one device.
    landmark_count: int = 64
    landmark_iters: int = 4

    # ---- hot phase (ref :1644-1709: T=2000, 1000 MD steps, dt=.003) ----
    hot_steps: int = 300
    hot_temperature: float = 2000.0
    hot_lr: float = 0.05

    # ---- slow-cool phase (ref :1728-1782: 80 cycles x 12 steps, dt=.005) ----
    cool_cycles: int = 80
    cool_steps_per_cycle: int = 12
    cool_temperature_step: float = 25.0   # bath -25 K per cycle (ref :1779)
    cool_lr: float = 0.02

    # ---- final minimization (ref :1800-1803: 10 x 15000 LBFGS steps) ----
    final_steps: int = 1500
    final_lr: float = 0.5          # Adam lr (A); decays by cosine to ~0

    # ---- Langevin noise scaling ----
    # sigma = noise_scale * sqrt(T / hot_temperature); noise is isotropic per bead.
    noise_scale: float = 0.6

    # ---- protocol toggles ----
    enantiomer: bool = True        # run mirror-image pair per restart, keep lower
    #                                energy (ref enantiomer trial :1605-1727)
    # per-bead gradient-norm clip, applied to the raw gradient before Adam:
    # each bead's 3-vector is scaled down to at most this norm. None = off
    # (the validated default; the quadratic well + Adam are already stable).
    # Set it when feeding adversarial restraint sets (huge absolute-weighted
    # targets) where early gradients can overflow float32.
    gradient_clip: Optional[float] = None
    # fused GPU pair kernel (ops.pair_kernel): None = AUTO (on for GPU
    # backends, the plain analytic path elsewhere); True forces it and
    # raises where it cannot compile; False forces the plain path.
    use_pallas: Optional[bool] = None
    # exact-restraint specialization: when every restraint has negdev ==
    # posdev == 0 (always true for pipeline-generated restraints, carr2tbl
    # emits `d 0.00 0.00`) AND the well is pure quadratic (noe_rswitch
    # disabled), the pair terms read one target tensor instead of the lo/hi
    # pair and drop the wall-selection logic. The pipeline auto-enables
    # this when provable; only set it manually if you know the restraints
    # are exact.
    exact_restraints: bool = False
    # store the exact-path restraint tiles (target + folded weight) in
    # bfloat16: halves the (L, L) stream read every step and the live
    # restraint memory; the pair math still runs f32 (tiles convert on
    # read). Costs ~0.4% relative error on the restraint targets.
    pair_bf16: bool = False
    # lax.scan unroll factor for the annealing loop: >1 amortizes the
    # per-iteration loop overhead at the cost of a proportionally larger
    # program.
    scan_unroll: int = 2

    @property
    def cool_steps(self) -> int:
        return self.cool_cycles * self.cool_steps_per_cycle

    @property
    def total_steps(self) -> int:
        return self.hot_steps + self.cool_steps + self.final_steps


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Per-job orchestration knobs (ref: CLI flags + assessment constants)."""

    model_count: int = 20          # -m flag, models built; chromosome3D.pl:21
    top_k: int = 5                 # models kept after NOE-energy ranking (:822-828)
    dist_relax: float = 0.5        # $DISTRELAX satisfaction window (:74)
    sum_dev_margin: float = 0.2    # sum_noe_dev threshold (:592-597)
    spearman_range: int = 3        # |i-j| cutoff of spearman_IF_pdb.pl (:22)
    seed: int = 82364              # CNS's fixed RNG seed (chromosome3D.pl:980)
    # hyperparameter-ensemble quality mode: extra alpha values solved in
    # addition to restraints.alpha; all models pool into the Spearman
    # ranking (NOE-energy ranking stays within the base alpha, since NOE
    # energies are only comparable under one restraint set). Alpha grids
    # cost one extra batched solve each and close the last quality gaps:
    # large L favors alpha ~0.5, small L ~0.7 (see PARITY.md).
    alpha_ensemble: tuple = ()
    restraints: RestraintConfig = dataclasses.field(default_factory=RestraintConfig)
    anneal: AnnealConfig = dataclasses.field(default_factory=AnnealConfig)
    # genome runs: pad each chromosome to the smallest bucket >= L.
    # Coarse buckets on purpose: every shipped chromosome fits 512, so the
    # whole genome is ONE compiled program. Padded-out compute is masked,
    # while each extra bucket costs a separate XLA compilation.
    length_buckets: tuple = (512, 768)
    # single-chromosome runs (`run`/`solve` CLI) also pad to the bucket, so
    # 45 sequential runs share ~1 compiled program instead of paying one
    # compile per distinct L. False = exact-L compile.
    bucket_single_runs: bool = True
    # at-scale dispatch: inputs whose L exceeds the largest length bucket
    # route to the row-sharded (sequence-parallel) solvers over the
    # available device mesh — solver.sharded.solve_ensemble_sharded for a
    # single run, solve_genome_sharded (2-D chrom x beads) for genome
    # buckets — instead of raising (the reference dies at 663 beads,
    # chromosome3D.pl:93-94). On a single device the plain solver runs,
    # padded to a dynamic shard_quantum bucket. False restores the
    # pre-round-3 behavior (genome raises; single runs exact-L compile).
    shard_large: bool = True
    # padding unit for beyond-the-buckets lengths: large runs pad up to a
    # multiple of lcm(shard_quantum, mesh beads-axis size), so distinct big
    # inputs still share compiled programs (same discipline as
    # length_buckets, at the large end).
    shard_quantum: int = 512
    # per-model violation REPORTS (contact_violation.txt, ref :447-485):
    # each is an O(L^2)-distance host pass per model, which dominates the
    # wall at tens of thousands of beads. False skips the report files only; the assessment STATS
    # (satisfied/total/sum_dev, NOE + Spearman rankings, spearman.txt)
    # are always computed. Reference-scale runs keep the default True —
    # the reports are part of the artifact parity set.
    emit_violation_reports: bool = True

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def fast_anneal(cfg: Optional[AnnealConfig] = None, scale: float = 0.25) -> AnnealConfig:
    """A reduced-budget schedule for tests / smoke runs."""
    base = cfg or AnnealConfig()
    return dataclasses.replace(
        base,
        hot_steps=max(8, int(base.hot_steps * scale)),
        cool_cycles=max(8, int(base.cool_cycles * scale)),
        cool_steps_per_cycle=max(2, int(base.cool_steps_per_cycle * scale)),
        final_steps=max(16, int(base.final_steps * scale)),
    )


def turbo_anneal(cfg: Optional[AnnealConfig] = None) -> AnnealConfig:
    """Production speed preset: ~10x fewer steps than the CNS-shaped default
    with no measured quality loss on the shipped inputs (the classical-MDS
    init + stress weighting do the heavy lifting; validated on
    chr1/13/17/22 at both resolutions: Spearman within +-0.002 of the full
    2760-step protocol at 276 steps)."""
    base = cfg or AnnealConfig()
    return dataclasses.replace(
        base, hot_steps=30, cool_cycles=8, cool_steps_per_cycle=12,
        final_steps=150,
    )
