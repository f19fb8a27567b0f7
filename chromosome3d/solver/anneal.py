"""The annealing solver: jit lax.scan over the full DGSA-shaped schedule.

Replacement for the CNS dgsa.inp protocol (SURVEY.md section 3.2;
chromosome3D.pl:882-1846). CNS runs, per model: mmdg embed -> enantiomer
trial -> hot Cartesian MD (T=2000, weight ramps) -> 80-cycle slow cool
(vdw x1.094/cycle 0.003 -> 4.0, repel radius 1.0 -> 0.85, bath -25 K/cycle)
-> 10 x 15000-step LBFGS minimization.

Here the whole protocol is ONE compiled lax.scan of noisy-Adam (Langevin)
steps driven by a precomputed per-step schedule table: temperature becomes
coordinate-noise sigma, the MD integrator becomes Adam (whose per-coordinate
step magnitude is bounded by lr, playing the role of dt), and the final
minimization is the same scan with zero noise and cosine-decayed lr. The
multi-model loop (20 models, chromosome3D.pl:1492,1574) becomes vmap over
PRNG keys; the enantiomer trial mirrors the shared embedding for half the
restarts and keeps the lower-energy member of each pair.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from chromosome3d.config import AnnealConfig
from chromosome3d.ops.energy import (
    DenseRestraints,
    EnergyWeights,
    OrGroupRestraints,
    energy_terms,
    energy_terms_chunked,
    or_group_energy,
)
from chromosome3d.ops.pair import (
    bonded_energy,
    energy_and_grad_batched,
    pair_energy,
    pair_tiles,
)
from chromosome3d.solver.init import (
    landmark_init,
    mds_init,
    random_init,
    spiral_init,
)

# beyond this (padded) L the final canonical-terms pass runs row-chunked;
# below it the dense reference evaluation keeps its exact float-summation
# order (reference-scale buckets top out at Lp = 768)
_CHUNKED_TERMS_MIN_L = 8192


class Schedule(NamedTuple):
    """Per-step hyperparameters, stacked as (T,) arrays and scanned over."""

    lr: jnp.ndarray
    sigma: jnp.ndarray        # Langevin noise stddev (A)
    vdw_weight: jnp.ndarray
    repel_scale: jnp.ndarray


class AnnealResult(NamedTuple):
    coords: jnp.ndarray                 # (n, L, 3)
    energies: Dict[str, jnp.ndarray]    # each (n,), final canonical weights
    history: jnp.ndarray                # (n, T) total energy per step


def build_schedule(cfg: AnnealConfig) -> Schedule:
    """Materialize the hot -> cool -> final-min schedule as static arrays.

    Shapes mirror the CNS protocol:
      hot   (ref :1644-1709): T = hot_temperature, vdw tiny, repel 1.0
      cool  (ref :1740-1782): geometric vdw ramp vdw_start -> vdw_final
            (the x1.094/cycle of CNS), linear repel 1.0 -> 0.85, bath
            -temperature_step per cycle
      final (ref :1800-1803): zero temperature, full vdw, cosine-decayed lr
    """
    hot_T = np.full(cfg.hot_steps, cfg.hot_temperature)
    hot_lr = np.full(cfg.hot_steps, cfg.hot_lr)
    hot_vdw = np.full(cfg.hot_steps, cfg.vdw_weight_start)
    hot_rep = np.full(cfg.hot_steps, cfg.repel_start)

    cycles = np.arange(cfg.cool_cycles)
    frac = cycles / max(cfg.cool_cycles - 1, 1)
    cyc_T = np.maximum(
        cfg.hot_temperature - (cycles + 1) * cfg.cool_temperature_step, 0.0
    )
    cyc_vdw = cfg.vdw_weight_start * (
        (cfg.vdw_weight_final / cfg.vdw_weight_start) ** frac
    )
    cyc_rep = cfg.repel_start + (cfg.repel_end - cfg.repel_start) * frac
    reps = cfg.cool_steps_per_cycle
    cool_T = np.repeat(cyc_T, reps)
    cool_vdw = np.repeat(cyc_vdw, reps)
    cool_rep = np.repeat(cyc_rep, reps)
    cool_lr = np.full(cfg.cool_steps, cfg.cool_lr)

    fsteps = np.arange(cfg.final_steps)
    final_lr = cfg.final_lr * 0.5 * (
        1.0 + np.cos(np.pi * fsteps / max(cfg.final_steps - 1, 1))
    )
    final_T = np.zeros(cfg.final_steps)
    final_vdw = np.full(cfg.final_steps, cfg.vdw_weight_final)
    final_rep = np.full(cfg.final_steps, cfg.repel_end)

    temp = np.concatenate([hot_T, cool_T, final_T])
    sigma = cfg.noise_scale * np.sqrt(temp / cfg.hot_temperature)
    return Schedule(
        lr=jnp.asarray(np.concatenate([hot_lr, cool_lr, final_lr]), jnp.float32),
        sigma=jnp.asarray(sigma, jnp.float32),
        vdw_weight=jnp.asarray(np.concatenate([hot_vdw, cool_vdw, final_vdw]), jnp.float32),
        repel_scale=jnp.asarray(np.concatenate([hot_rep, cool_rep, final_rep]), jnp.float32),
    )


def _final_weights(cfg: AnnealConfig) -> EnergyWeights:
    """Canonical end-of-protocol weights used for ranking energies, matching
    what CNS reports in the REMARK block after final minimization."""
    return EnergyWeights(
        noe=jnp.float32(cfg.noe_weight),
        bond=jnp.float32(cfg.bond_weight),
        bond_length=jnp.float32(cfg.bond_length),
        vdw=jnp.float32(cfg.vdw_weight_final),
        vdw_radius=jnp.float32(cfg.repel_end * cfg.vdw_radius),
        noe_rswitch=jnp.float32(cfg.noe_rswitch),
        angle=jnp.float32(cfg.angle_weight),
    )


def _schedule_weights(cfg: AnnealConfig, base: EnergyWeights, vdw_w, repel):
    """The weights of one schedule step: the canonical ones with the step's
    vdw weight and repel radius."""
    return base._replace(vdw=vdw_w, vdw_radius=repel * cfg.vdw_radius)


def _clip_per_bead(g: jnp.ndarray, clip: Optional[float]) -> jnp.ndarray:
    """Scale each bead's gradient 3-vector down to at most `clip` norm
    (AnnealConfig.gradient_clip); identity when clip is None. Works on any
    (..., L, 3) batch."""
    if clip is None:
        return g
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True) + 1e-12)
    return g * jnp.minimum(1.0, clip / norm)


def resolve_use_pallas(cfg: AnnealConfig) -> bool:
    """Whether the fused pair kernel (ops.pair_kernel) runs the hot loop.

    AnnealConfig.use_pallas=None means AUTO: the kernel on GPU backends,
    the plain analytic path (ops.pair) elsewhere. True forces the kernel
    and raises on a backend it cannot compile for. Resolved at trace time."""
    backend = jax.default_backend()
    if cfg.use_pallas is None:
        return backend == "gpu"
    if cfg.use_pallas and backend != "gpu":
        raise ValueError(
            f"use_pallas=True needs a GPU backend; this one is {backend!r}"
        )
    return cfg.use_pallas


def _exact(cfg: AnnealConfig) -> bool:
    """Exact restraints with a pure quadratic well (pipeline.auto_exact)."""
    return cfg.exact_restraints and cfg.noe_rswitch >= 1e8


def _solver_tiles(restraints, cfg: AnnealConfig):
    """The pair tiles the hot loop reads, built once outside the scan;
    bf16 under AnnealConfig.pair_bf16 (exact restraints only)."""
    exact = _exact(cfg)
    tiles = pair_tiles(restraints, exact)
    if exact and cfg.pair_bf16:
        tiles = tuple(t.astype(jnp.bfloat16) for t in tiles)
    return tiles


def solve_single(
    restraints: DenseRestraints,
    cfg: AnnealConfig,
    key: jax.Array,
    x0: jnp.ndarray,
    bead_mask: Optional[jnp.ndarray] = None,
    schedule: Optional[Schedule] = None,
    or_groups: Optional[OrGroupRestraints] = None,
):
    """Anneal one structure from x0 (+ per-restart jitter). Returns
    (final coords (L, 3), per-step total-energy history (T,)).

    schedule overrides the cfg-built table — it is a runtime input, so
    hyperparameter sweeps with equal step counts share one compilation."""
    L = x0.shape[0]
    if bead_mask is None:
        bead_mask = jnp.ones((L,), dtype=jnp.float32)
    sched = build_schedule(cfg) if schedule is None else schedule
    use_kernel = resolve_use_pallas(cfg)
    tiles = _solver_tiles(restraints, cfg)

    def efn(x, weights):
        e = pair_energy(x, tiles, bead_mask, weights, use_kernel)
        e = e + bonded_energy(x, bead_mask, weights)
        if or_groups is not None:
            e = e + or_group_energy(x, or_groups, weights, bead_mask)
        return e

    grad_fn = jax.value_and_grad(efn)

    key, jkey = jax.random.split(key)
    x = x0 + cfg.init_noise * jax.random.normal(jkey, x0.shape) * bead_mask[:, None]

    opt = optax.scale_by_adam()
    opt_state = opt.init(x)

    base = _final_weights(cfg)

    def step(carry, srow):
        x, opt_state, key = carry
        lr, sigma, vdw_w, repel = srow
        e, g = grad_fn(x, _schedule_weights(cfg, base, vdw_w, repel))
        g = _clip_per_bead(g, cfg.gradient_clip)
        updates, opt_state = opt.update(g, opt_state)
        key, nkey = jax.random.split(key)
        noise = sigma * jax.random.normal(nkey, x.shape)
        x = x + (-lr * updates + noise) * bead_mask[:, None]
        return (x, opt_state, key), e

    srows = jnp.stack([sched.lr, sched.sigma, sched.vdw_weight, sched.repel_scale], axis=-1)
    (x, _, _), history = jax.lax.scan(step, (x, opt_state, key), srows)
    return x, history


def solve_ensemble_impl(
    restraints: DenseRestraints,
    cfg: AnnealConfig,
    key: jax.Array,
    n_models: int,
    bead_mask: Optional[jnp.ndarray] = None,
    x0: Optional[jnp.ndarray] = None,
    schedule: Optional[Schedule] = None,
    or_groups: Optional[OrGroupRestraints] = None,
) -> AnnealResult:
    """Build n_models structures: one batched scan over all restarts
    (+ enantiomer pairs) at once.

    or_groups: optional ambiguous (`or`-group) restraints; their group-min
    well joins the energy (ops.energy.or_group_energy) beside the pair
    terms (the group term is O(R*G), tiny next to the O(L^2) pair work).

    Replaces the reference's `loop dgsa` over 20 models
    (chromosome3D.pl:1574-1829) with one compiled program. The batch shares
    one restraint set; the GPU pair kernel orders its grid so the
    structures of one row block read the same restraint tiles back to back.

    Enantiomer semantics match CNS exactly: both mirror images run through
    the HOT phase only, the lower-energy image is picked, and only the
    winner pays for slow-cool + final minimization (chromosome3D.pl:
    1605-1727 picks handedness between the hot and cool stages) — roughly
    halving the dominant cool+final compute vs annealing both mirrors
    end-to-end.
    """
    L = restraints.lo.shape[0]
    if bead_mask is None:
        bead_mask = jnp.ones((L,), dtype=jnp.float32)

    if x0 is None:
        init = cfg.init
        if init == "auto":
            # classical MDS's O(L^3 log L) bounds smoothing dominates the
            # whole solve past ~2048 beads; landmark MDS is O(k L^2) and
            # quality-equal on real data (DESIGN.md)
            init = "mds" if L < 2048 else "landmark"
        if init == "mds":
            # bf16-STORED tiles (device_prep out_dtype="bfloat16"): the mds
            # embed math must run f32 — one transient upcast (mds is the
            # small-L route, so the f32 twin is cheap there). The landmark
            # path below takes the RAW tiles: it converts per <= 4096-row
            # strip itself (landmark_targets), and a whole-tile upcast here
            # would be hoisted out of its relaxation scan by XLA — exactly
            # the persistent f32 (L, L) the blocked init exists to avoid.
            init_restraints = restraints
            if restraints.lo.dtype == jnp.bfloat16:
                init_restraints = jax.tree.map(
                    lambda a: a.astype(jnp.float32), restraints
                )
            x0 = mds_init(
                init_restraints,
                bond_length=cfg.bond_length,
                unknown_fill=cfg.mds_unknown_fill,
                bead_mask=bead_mask,
                two_sided=cfg.embed_two_sided,
            )
        elif init == "landmark":
            x0 = landmark_init(
                restraints,
                bond_length=cfg.bond_length,
                k=cfg.landmark_count,
                n_iters=cfg.landmark_iters,
                bead_mask=bead_mask,
                two_sided=cfg.embed_two_sided,
            )
        elif init == "spiral":
            x0 = spiral_init(L, bond_length=cfg.bond_length)
        else:
            key, ikey = jax.random.split(key)
            x0 = random_init(ikey, L)
    x0 = x0 * bead_mask[:, None]

    n_eff = n_models * 2 if cfg.enantiomer else n_models
    if cfg.enantiomer:
        # pairs (direct, mirrored): flip the x axis of the shared embedding
        signs = jnp.tile(jnp.asarray([1.0, -1.0], dtype=jnp.float32), n_models)
    else:
        signs = jnp.ones((n_eff,), dtype=jnp.float32)

    key, jkey = jax.random.split(key)
    xs = x0[None, :, :] * jnp.stack(
        [signs, jnp.ones_like(signs), jnp.ones_like(signs)], axis=-1
    )[:, None, :]
    xs = xs + cfg.init_noise * jax.random.normal(jkey, xs.shape) * bead_mask[None, :, None]

    sched = build_schedule(cfg) if schedule is None else schedule
    base = _final_weights(cfg)

    use_kernel = resolve_use_pallas(cfg)
    tiles = _solver_tiles(restraints, cfg)
    if or_groups is not None:
        # the O(R*G) group-min well rides beside the pair terms as an
        # additive jnp value-and-grad
        _og_vg = jax.value_and_grad(or_group_energy)

    def vag(x, weights):
        e, g = energy_and_grad_batched(x, tiles, bead_mask, weights, use_kernel)
        if or_groups is not None:
            e_og, g_og = jax.vmap(
                lambda c: _og_vg(c, or_groups, weights, bead_mask)
            )(x)
            e, g = e + e_og, g + g_og
        return e, g

    # the update glue (clip, Adam, threefry noise) stays plain jnp: XLA
    # fuses it around the pair call
    opt = optax.scale_by_adam()
    carry0 = (xs, opt.init(xs), key)

    def step(carry, srow):
        x, opt_state, k = carry
        lr, sigma, vdw_w, repel = srow[0], srow[1], srow[2], srow[3]
        e, g = vag(x, _schedule_weights(cfg, base, vdw_w, repel))
        g = _clip_per_bead(g, cfg.gradient_clip)
        updates, opt_state = opt.update(g, opt_state)
        k, nkey = jax.random.split(k)
        noise = sigma * jax.random.normal(nkey, x.shape)
        x = x + (-lr * updates + noise) * bead_mask[None, :, None]
        return (x, opt_state, k), e

    def select(carry, sel):
        x, opt_state, k = carry
        opt_state = jax.tree.map(
            lambda a: a[sel]
            if (hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == n_eff)
            else a,
            opt_state,
        )
        return (x[sel], opt_state, k)

    srows = jnp.stack(
        [sched.lr, sched.sigma, sched.vdw_weight, sched.repel_scale], axis=-1
    )
    unroll = max(1, cfg.scan_unroll)
    if cfg.enantiomer:
        # hot phase on all 2n mirror-pair members
        hot = cfg.hot_steps
        carry, hist_hot = jax.lax.scan(step, carry0, srows[:hot],
                                       unroll=unroll)
        # pick handedness per pair by energy under the end-of-hot weights
        # (ref :1710-1727: CNS evaluates with the flags active at that point)
        w_hot = _schedule_weights(
            cfg, base, sched.vdw_weight[hot - 1], sched.repel_scale[hot - 1]
        )
        e_hot, _ = vag(carry[0], w_hot)                         # (2n,)
        pick = jnp.argmin(e_hot.reshape(n_models, 2), axis=1)   # (n,)
        sel = jnp.arange(n_models) * 2 + pick
        carry = select(carry, sel)
        hist_hot = hist_hot[:, sel]                             # (hot, n)
        # only the winners pay for slow-cool + final minimization
        carry, hist_rest = jax.lax.scan(step, carry, srows[hot:],
                                        unroll=unroll)
        history = jnp.concatenate([hist_hot, hist_rest], axis=0).T  # (n, T)
    else:
        carry, history = jax.lax.scan(step, carry0, srows, unroll=unroll)
        history = history.T                        # (n_eff, T)
    coords = carry[0]

    # Final canonical terms: beyond reference scale the dense evaluation's
    # (n, L, L) well temp — not the hot loop — would set the single-device
    # memory ceiling (several GB at L=24576). The row-chunked evaluation
    # computes the same terms
    # in O(row_chunk * L); reference-scale buckets keep the dense path so
    # their NOE-ranking float-summation order (and the byte artifacts it
    # feeds) stays frozen.
    if L >= _CHUNKED_TERMS_MIN_L:
        term_fn = energy_terms_chunked
    else:
        term_fn = energy_terms
    terms = jax.vmap(
        lambda c: term_fn(c, restraints, base, bead_mask, or_groups)
    )(coords)

    # centroid to origin (ref :1805-1816), padding excluded
    nvalid = bead_mask.sum()
    centroid = (coords * bead_mask[None, :, None]).sum(axis=1, keepdims=True) / nvalid
    coords = (coords - centroid) * bead_mask[None, :, None]

    return AnnealResult(coords=coords, energies=terms, history=history)


solve_ensemble = jax.jit(solve_ensemble_impl, static_argnames=("cfg", "n_models"))

