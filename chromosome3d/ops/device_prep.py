"""At-scale restraint prep ON the accelerator.

Why this exists: restraint prep is O(L^2) *elementwise* work (IF^alpha, the
%.1f quantization, separation/validity masks, stress weights) — exactly the
kind of elementwise math the solve already does, and a rounding error
next to one anneal step. But the reference-semantics host path
(restraints.if_to_dist -> dist_to_restraints -> ops.energy builders) makes
dozens of float64 passes over (L, L) numpy arrays, which on a host with
little memory bandwidth takes minutes at L in the tens of thousands —
longer than the solve it feeds. The fix is the same design rule
the solver follows (DESIGN.md "what stays off the accelerator", inverted):
per-element work at a BUCKETED shape belongs on the device, because the
compile is paid once per bucket while the host pays per element per run.

So the at-scale paths build their tiles here: ONE padded (L_pad, L_pad)
f32 host->device transfer, then a single jitted program produces the
two-tensor ExactRestraints form (ops/energy.py:51). Scalar knobs (alpha,
K, the stress exponent p) ride as device scalars so hyperparameter sweeps
share the compiled program; only (L_pad, weighting, separation) are static.
Programs are keyed by the PADDED shape only — the same compile-count
discipline as PipelineConfig.length_buckets (CLAUDE.md: one bucket = one
program).

The reference-scale paths (L <= the length buckets) keep the float64 host
route: its %.1f text-file round-trip is byte-parity-tested against the
reference's own Perl (chromosome3D.pl:110-206), and at those sizes host
prep costs milliseconds. This module is gated to beyond-bucket L, where no
text artifacts exist to be parity-locked (f32-vs-f64 quantization can
differ only for distances within ~1e-6 of a .05 decimal midpoint).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from chromosome3d.ops.energy import ExactRestraints


def pad_f32(a, L_pad: int):
    """Zero-pad to (L_pad, L_pad) f32 in ONE host pass (the only O(L^2) host
    work the device-prep path pays). An already-padded f32 jax array passes
    straight through — callers that generate input ON device (the scaling
    bench) never round-trip it to the host."""
    if (
        isinstance(a, jnp.ndarray)
        and a.shape == (L_pad, L_pad)
        and a.dtype == jnp.float32
    ):
        return a
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        # a (L_pad, L)-shaped array would otherwise slip through the
        # passthrough above and trace the prep program at a wrong shape
        raise ValueError(f"pad_f32 needs a square matrix, got {a.shape}")
    L = a.shape[0]
    if L == L_pad and a.dtype == np.float32:
        return np.ascontiguousarray(a)
    out = np.zeros((L_pad, L_pad), np.float32)
    out[:L, :L] = a
    return out


def _run_prog(prog, args: tuple, tag: str, statics: str):
    """Dispatch a prep program through the AOT executable cache when
    CHROM3D_AOT_CACHE is set (utils/aot.py), so a fresh process re-running
    a known bucket shape skips the compile for the PREP too, not just the
    solve — otherwise the cold-start win the solve blobs buy is bounded by
    the prep's compile. Disabled (no
    env var): the plain jitted callable, jax's in-process cache applies."""
    from chromosome3d.utils.aot import load_or_compile

    return load_or_compile(prog, args, tag, statics=statics)(*args)


def _unnorm_weights(t, p, weighting: str):
    """(unnormalized weights, restraint-mask) — the per-element half of the
    weight math, shared by the one-shot and the strip-streamed programs (the
    streamed route applies the global normalization as a separate pass once
    every strip's partial sums are in)."""
    m = (t > 0.0).astype(jnp.float32)
    if weighting == "relative":
        return m * jnp.power(jnp.maximum(t, 1.0), -p), m
    if weighting == "absolute":
        return m, m
    raise ValueError(f"unknown weighting {weighting!r}")


def _weights_from_target(t, p, weighting: str):
    """Device mirror of ops.energy._restraint_weights for exact restraints:
    mask is recoverable as t > 0 (quantized targets are >= 0.1 wherever a
    restraint exists; padding and masked-out cells are exactly 0)."""
    w, m = _unnorm_weights(t, p, weighting)
    if weighting == "relative":
        denom = jnp.sum(w, dtype=jnp.float32) / jnp.maximum(
            jnp.sum(m, dtype=jnp.float32), 1.0
        )
        return w / jnp.maximum(denom, 1e-30)
    return w


@functools.lru_cache(maxsize=16)
def _tiles_from_target_prog(weighting: str, out_dtype: str = "float32"):
    # donate t: the output target IS the input (zero-copy aliasing) — at the
    # ceiling sizes every live (L, L) buffer counts (callers never reuse the
    # uploaded array). With out_dtype="bfloat16" the alias is lost (dtype
    # differs) but the donated buffer is still reusable scratch.
    @functools.partial(jax.jit, donate_argnums=0)
    def prog(t, p):
        w = _weights_from_target(t, p, weighting)
        if out_dtype != "float32":
            dt = jnp.dtype(out_dtype)
            t, w = t.astype(dt), w.astype(dt)
        return ExactRestraints(target=t, w=w)

    return prog


def exact_tiles_from_target_device(
    target: np.ndarray,
    L_pad: int,
    weighting: str,
    weight_exponent: float,
    sharding=None,
    out_dtype: str = "float32",
) -> ExactRestraints:
    """(L, L) masked target (zero where no restraint) -> the two-tensor
    ExactRestraints form at (L_pad, L_pad), weights computed on device.

    Drop-in for `exact_restraints_from_numpy(r.padded(L_pad), ...)` when the
    caller has proven exactness: same weighting semantics, one upload and
    ~L_pad^2 * 4 host bytes touched instead of ~10 float64 host passes.
    (f32 weight math; the f64 host path differs by ~1e-7 relative — below
    the solver's own f32 resolution. tests/test_device_prep.py pins it.)

    sharding: optional jax.sharding.NamedSharding (row spec, e.g.
    P("beads", None)) — the padded upload goes straight to its per-device
    row slices and the tiles are BORN distributed (GSPMD propagates the row
    sharding through the program; the relative-weighting mean is one
    all-reduce). Without this, a multi-chip caller would materialize the
    whole (L, L) on one device before shard_map redistributes — the exact
    failure mode the sharded solver exists to avoid.

    out_dtype: "bfloat16" emits bf16-STORED tiles (see _tiles_from_if_body)."""
    t = pad_f32(target, L_pad)
    t = jnp.asarray(t) if sharding is None else jax.device_put(t, sharding)
    return _run_prog(
        _tiles_from_target_prog(weighting, str(out_dtype)),
        (t, jnp.float32(weight_exponent)),
        "prep_target",
        f"w={weighting};dt={out_dtype}",
    )


def _strip_target(strip, r0, n_true, alpha, kscaling, mean, separation: int):
    """The per-element half of the L3 prep for a ROW STRIP [r0, r0+S) of
    the padded matrix: quantized exact targets, zero where masked. The
    one-shot body calls this with the whole matrix and r0 = 0, the streamed
    route per strip — identical math by construction.

    d = K * mean / IF^a (IF2dist_new, chromosome3D.pl:110-162), then the
    %.1f .dist-file quantization (restraints.quantize_dist): round-half-even
    like np.round, in f32. The final /10 must be the CORRECTLY-ROUNDED f32
    quotient to match the host's f32(round(d*10)/10 in f64) bit-for-bit,
    but XLA strength-reduces x/10 to x*(1/10) (one ulp off for e.g.
    149/10). A compensated two-term product k*hi + k*lo with hi = f32(0.1),
    lo = f32(0.1 - f64(f32(0.1))) recovers the correctly-rounded quotient —
    verified exhaustively for k in [0, 2e6] (tests/test_device_prep.py)."""
    S, L_pad = strip.shape
    x = jnp.power(strip, alpha)
    d = jnp.where(x > 0.0, kscaling * mean / jnp.maximum(x, 1e-30), 0.0)
    k = jnp.round(d * 10.0)
    q = k * jnp.float32(0.1) + k * jnp.float32(0.1 - float(np.float32(0.1)))
    i = jax.lax.broadcasted_iota(jnp.int32, (S, L_pad), 0) + r0
    j = jax.lax.broadcasted_iota(jnp.int32, (S, L_pad), 1)
    n = n_true.astype(jnp.int32)
    mask = (
        (jnp.abs(i - j) >= separation)
        & (i != j)     # host route excludes the diagonal EXPLICITLY
        #                (dist_to_restraints), not via separation >= 1 —
        #                at separation = 0 the routes must still agree
        & (q > 0.0)
        & (i < n)
        & (j < n)
    )
    return jnp.where(mask, q, 0.0)


def _tiles_from_if_body(if_padded, n_true, alpha, kscaling, p,
                        separation: int, weighting: str,
                        out_dtype: str = "float32") -> ExactRestraints:
    """One chromosome's L3 prep as a traceable body (shared by the single
    and the vmapped-batch programs)."""
    # The mean of IF^a is over ALL n_true^2 cells of the true matrix;
    # padding cells are 0 and 0^a == 0, so the padded sum equals the
    # true sum.
    mean = jnp.sum(
        jnp.power(if_padded, alpha), dtype=jnp.float32
    ) / (n_true * n_true)
    t = _strip_target(
        if_padded, jnp.int32(0), n_true, alpha, kscaling, mean, separation
    )
    w = _weights_from_target(t, p, weighting)
    if out_dtype != "float32":
        # bf16-STORED tiles (AnnealConfig.pair_bf16 at scale): all prep math
        # and the %.1f quantization stay f32; only the emitted tensors
        # convert (XLA fuses the converts into the producers, so no f32
        # copy outlives the program). Halves the solve's argument HBM AND
        # the per-step tile stream — unlike the in-jit cast, which keeps
        # the f32 originals alive. Mask recovery (t > 0) survives the
        # conversion (quantized targets are >= 0.1; zeros stay zero).
        dt = jnp.dtype(out_dtype)
        t, w = t.astype(dt), w.astype(dt)
    return ExactRestraints(target=t, w=w)


@functools.lru_cache(maxsize=16)
def _tiles_from_if_prog(separation: int, weighting: str,
                        out_dtype: str = "float32"):
    # donate the IF matrix: XLA reuses its buffer for an output tile, so the
    # prep peak is ~3 live (L, L) tensors instead of 4 — this is what decides
    # the single-chip ceiling L (callers never reuse the uploaded matrix)
    @functools.partial(jax.jit, donate_argnums=0)
    def prog(if_padded, n_true, alpha, kscaling, p):
        return _tiles_from_if_body(
            if_padded, n_true, alpha, kscaling, p, separation, weighting,
            out_dtype,
        )

    return prog


@functools.lru_cache(maxsize=16)
def _tiles_from_if_batched_prog(separation: int, weighting: str,
                                out_dtype: str = "float32"):
    # the genome at-scale bucket's prep: one program for the whole
    # (B, L_pad, L_pad) bucket, per-chromosome n_true/p as device vectors
    @functools.partial(jax.jit, donate_argnums=0)
    def prog(if_padded, n_true, alpha, kscaling, p):
        return jax.vmap(
            lambda m, n, pe: _tiles_from_if_body(
                m, n, alpha, kscaling, pe, separation, weighting, out_dtype
            )
        )(if_padded, n_true, p)

    return prog


def exact_tiles_from_if_batched_device(
    matrices,
    L_pad: int,
    rc,
    weighting: str,
    weight_exponents,
    sharding=None,
    out_dtype: str = "float32",
    stack: "np.ndarray | None" = None,
) -> ExactRestraints:
    """Batched exact_tiles_from_if_device for a genome bucket: a list of
    (L_b, L_b) IF matrices -> (B, L_pad, L_pad) ExactRestraints, built by
    ONE device program. The single O(B*L_pad^2) host pass is the f32
    pad/stack copy (the minimum any text-matrix input pays); all float64
    prep passes run on the accelerator. weight_exponents: per-chromosome p
    (auto_weight_exponent of each TRUE length). sharding: a (chrom, beads)
    NamedSharding — the stacked upload goes straight to per-device slices
    and the bucket's tiles are born distributed.

    out_dtype: "bfloat16" emits bf16-STORED tiles for the solve (see
    _tiles_from_if_body). Host assessment must NOT read those — bf16-
    rounded targets would reach the violation reports — so bf16 callers
    (run_genome with pair_bf16) free the solve tiles and re-invoke this at
    f32 for the assessment view, the same two-program split as the
    run/solve/serve surfaces (pipeline._assessment_view_from_if).

    stack: optional prebuilt (B, L_pad, L_pad) f32 pad/stack — callers
    that prep the same bucket more than once (the bf16 two-program split,
    alpha ensembles) pass it so the O(B*L_pad^2) host copy runs ONCE, the
    same pad-once-and-thread discipline as pipeline's if_dev. The device
    upload donates only the device buffer; the host array stays valid
    across calls."""
    B = len(matrices)
    if stack is None:
        stack = np.zeros((B, L_pad, L_pad), np.float32)
        for b, m in enumerate(matrices):
            Lb = m.shape[0]
            stack[b, :Lb, :Lb] = np.asarray(m, np.float32)
    elif stack.shape != (B, L_pad, L_pad) or stack.dtype != np.float32:
        raise ValueError(
            f"prebuilt stack {stack.shape}/{stack.dtype} does not match "
            f"({B}, {L_pad}, {L_pad}) float32"
        )
    x = jnp.asarray(stack) if sharding is None else jax.device_put(stack, sharding)
    prog = _tiles_from_if_batched_prog(
        int(rc.separation), weighting, str(out_dtype)
    )
    return _run_prog(
        prog,
        (
            x,
            jnp.asarray([m.shape[0] for m in matrices], jnp.float32),
            jnp.float32(rc.alpha),
            jnp.float32(rc.kscaling),
            jnp.asarray(np.asarray(weight_exponents, np.float32)),
        ),
        "prep_if_bucket",
        f"sep={int(rc.separation)};w={weighting};dt={out_dtype}",
    )


def exact_tiles_from_if_device(
    if_matrix: np.ndarray,
    L_pad: int,
    rc,
    weighting: str,
    weight_exponent: float,
    sharding=None,
    out_dtype: str = "float32",
    n_true: int | None = None,
) -> ExactRestraints:
    """Full L3 restraint generation on device: (L, L) IF matrix ->
    ExactRestraints at (L_pad, L_pad). Mirrors if_to_dist + quantize_dist +
    dist_to_restraints for the pipeline's own (always-exact) restraints;
    alpha/K/p are device scalars, so alpha-ensemble sweeps reuse the
    compiled program. Static keys: (L_pad, separation, weighting) only.

    sharding: like exact_tiles_from_target_device — the padded IF upload
    goes straight to per-device row slices and the tiles are born
    distributed (the global mean is one all-reduce under GSPMD).
    out_dtype: "bfloat16" emits bf16-STORED tiles (see _tiles_from_if_body)
    — a distinct compiled program from the f32 one.
    n_true: the matrix's TRUE length when if_matrix arrives PRE-PADDED to
    (L_pad, L_pad) f32 (pad_f32 passes such arrays through) — callers that
    invoke this several times on one matrix (solve prep + alpha ensemble +
    the f32 assessment view) pad once and thread the copy; each pad is an
    O(L^2) host pass."""
    if sharding is None and should_stream_prep(L_pad, out_dtype):
        # past the one-shot prep ceiling (the f32 IF upload and the output
        # tiles cannot coexist in HBM) the strip-STREAMED route takes over
        # transparently: same semantics, peak = the tiles + one strip
        return exact_tiles_from_if_streamed(
            if_matrix, L_pad, rc, weighting, weight_exponent,
            out_dtype=out_dtype, n_true=n_true,
        )
    prog = _tiles_from_if_prog(int(rc.separation), weighting, str(out_dtype))
    m = pad_f32(if_matrix, L_pad)
    return _run_prog(
        prog,
        (
            jnp.asarray(m) if sharding is None else jax.device_put(m, sharding),
            jnp.float32(if_matrix.shape[0] if n_true is None else n_true),
            jnp.float32(rc.alpha),
            jnp.float32(rc.kscaling),
            jnp.float32(weight_exponent),
        ),
        "prep_if",
        f"sep={int(rc.separation)};w={weighting};dt={out_dtype}",
    )


# ---------------------------------------------------------------------------
# Strip-STREAMED prep: past the one-shot ceiling
# ---------------------------------------------------------------------------
# The one-shot prep program's HBM peak is the f32 IF upload PLUS the output
# tiles (~8*L^2 bytes either out_dtype: with bf16 outputs the donated f32
# buffer cannot alias them; with f32 outputs the target aliases the donated
# input but the weight plane is extra), while the SOLVE on bf16 tiles needs
# only the 4*L^2 tiles plus a working set. The streamed route closes that
# gap: the host IF crosses in
# row strips, each strip's targets/weights are written into pre-allocated
# accumulator tiles with dynamic_update_slice (donated, so XLA updates in
# place), and the two global reductions the prep needs — the IF^alpha mean
# (chromosome3D.pl:110-162 is a GLOBAL mean) and the relative-weighting
# normalizer — accumulate as per-strip scalar partials on the host. Peak
# device memory = the output tiles + ONE (S, L_pad) strip.
#
# Numerics vs the one-shot route: the target quantization math is shared
# code (_strip_target) — bit-equal given the same mean; the mean itself and
# the weight normalizer sum per strip then across strips (vs one whole-array
# f32 sum), an order-of-summation difference of ~1e-7 relative. With
# weighting="absolute" the weights are exact indicators and the routes are
# bit-equal end to end (tests/test_device_prep.py pins both statements).

_PREP_BUDGET_ENV = "CHROM3D_PREP_HBM_BUDGET"
# share of the device allocator's limit the one-shot prep may plan for; the
# rest is headroom for XLA temporaries and arrays already resident
_PREP_BUDGET_FRACTION = 0.85


def prep_budget_bytes(device=None) -> float:
    """Device-memory budget of the one-shot prep: CHROM3D_PREP_HBM_BUDGET
    when set, else a share of the device's `memory_stats()["bytes_limit"]`.
    A device that reports no limit is an error, not a guess."""
    import os

    env = os.environ.get(_PREP_BUDGET_ENV, "").strip()
    if env:
        return float(env)
    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats() if hasattr(dev, "memory_stats") else None
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {getattr(dev, 'device_kind', dev)!r} reports no memory "
            f"limit (memory_stats); set {_PREP_BUDGET_ENV}=<bytes> to size "
            "the one-shot restraint prep"
        )
    return _PREP_BUDGET_FRACTION * float(stats["bytes_limit"])


def prep_peak_bytes(L_pad: int, out_dtype: str = "float32") -> int:
    """Estimated HBM peak of the ONE-SHOT prep program: the f32 input plane
    plus both output planes, minus the donated-buffer alias XLA gets when
    the target dtype matches the input (f32 out only)."""
    out_b = np.dtype(out_dtype).itemsize
    alias = 4 if out_b == 4 else 0
    return L_pad * L_pad * (4 + 2 * out_b - alias)


def should_stream_prep(L_pad: int, out_dtype: str = "float32") -> bool:
    """Whether the one-shot prep at this padded size would exceed the
    device-memory budget (prep_budget_bytes) — the gate
    exact_tiles_from_if_device and the assessment view use to dispatch
    onto the streamed route."""
    return prep_peak_bytes(L_pad, out_dtype) > prep_budget_bytes()


def _pick_strip_rows(L_pad: int, cap: int = 4096) -> int:
    """Largest divisor of L_pad <= cap: uniform strips mean ONE compiled
    program per sweep (compile-count discipline), and ~4096 rows keeps the
    strip under a GB while amortizing per-call dispatch."""
    for s in range(min(cap, L_pad), 0, -1):
        if L_pad % s == 0:
            return s
    return L_pad


@functools.lru_cache(maxsize=4)
def _strip_sum_prog():
    # sweep 1: the IF^alpha partial sum of one strip (padding rows/cols are
    # zero and 0^a == 0, so plain sums equal true-cell sums). The strip is
    # NOT donated: a scalar output gives XLA nothing to alias it with (the
    # buffer frees by refcount right after the call anyway)
    @functools.partial(jax.jit)
    def prog(strip, alpha):
        return jnp.sum(jnp.power(strip, alpha), dtype=jnp.float32)

    return prog


@functools.lru_cache(maxsize=16)
def _strip_tiles_prog(separation: int, weighting: str, out_dtype: str,
                      lead_batch: bool = False):
    # sweep 2: one strip's targets + UNNORMALIZED weights written into the
    # donated accumulator tiles (in-place dynamic_update_slice), plus the
    # [sum(w_unnorm), sum(mask)] partials the normalizer needs.
    # lead_batch: accumulators carry a leading length-1 batch axis — the
    # genome bucket's (B, L, L) layout, built without any (L, L) -> (1, L, L)
    # whole-tile reshape at the HBM ceiling.
    # t_acc/w_acc donate (same-shape outputs alias -> true in-place update);
    # the strip cannot alias anything here and frees by refcount
    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def prog(t_acc, w_acc, strip, r0, n_true, alpha, kscaling, mean, p):
        t = _strip_target(strip, r0, n_true, alpha, kscaling, mean,
                          separation)
        w, m = _unnorm_weights(t, p, weighting)
        part = jnp.stack([
            jnp.sum(w, dtype=jnp.float32), jnp.sum(m, dtype=jnp.float32)
        ])
        dt = t_acc.dtype
        t_s, w_s = t.astype(dt), w.astype(dt)
        at = (0, r0, 0) if lead_batch else (r0, 0)
        if lead_batch:
            t_s, w_s = t_s[None], w_s[None]
        t_acc = jax.lax.dynamic_update_slice(t_acc, t_s, at)
        w_acc = jax.lax.dynamic_update_slice(w_acc, w_s, at)
        return t_acc, w_acc, part

    return prog


@functools.lru_cache(maxsize=4)
def _scale_prog():
    # sweep 3 (relative weighting only): fold the global normalizer into the
    # accumulated weights in place (donated; f32 math, emitted dtype kept)
    @functools.partial(jax.jit, donate_argnums=0)
    def prog(w_acc, scale):
        return (w_acc.astype(jnp.float32) * scale).astype(w_acc.dtype)

    return prog


@functools.lru_cache(maxsize=16)
def _strip_scalars_prog(separation: int, weighting: str):
    # assessment view sweep 2: the normalizer partials alone (the strip's
    # target is recomputed and discarded — elementwise work is free next
    # to the transfer; holding full f32 tiles on device is what is NOT free).
    # Scalar outputs: nothing to alias the strip with, so no donation
    @functools.partial(jax.jit)
    def prog(strip, r0, n_true, alpha, kscaling, mean, p):
        t = _strip_target(strip, r0, n_true, alpha, kscaling, mean,
                          separation)
        w, m = _unnorm_weights(t, p, weighting)
        return jnp.stack([
            jnp.sum(w, dtype=jnp.float32), jnp.sum(m, dtype=jnp.float32)
        ])

    return prog


@functools.lru_cache(maxsize=16)
def _strip_view_prog(separation: int, weighting: str):
    # assessment view sweep 3: one strip's FINAL f32 targets + weights, for
    # immediate download (the same final division as the one-shot program).
    # The donated f32 strip aliases one of the equal-shaped f32 outputs
    @functools.partial(jax.jit, donate_argnums=0)
    def prog(strip, r0, n_true, alpha, kscaling, mean, p, denom):
        t = _strip_target(strip, r0, n_true, alpha, kscaling, mean,
                          separation)
        w, _ = _unnorm_weights(t, p, weighting)
        return t, w / jnp.maximum(denom, 1e-30)

    return prog


def _host_padded(if_matrix, L_pad: int) -> np.ndarray:
    """The streamed route's input must live on the HOST (strips cross one at
    a time — that is the point); a device-resident input is downloaded once
    and freed."""
    m = pad_f32(if_matrix, L_pad)
    if isinstance(m, jnp.ndarray):
        m = np.asarray(m)
    return m


def _streamed_mean(m: np.ndarray, n: int, S: int, alpha, aot) -> jnp.ndarray:
    """Sweep 1: the global mean of IF^alpha from per-strip partials (f64
    host accumulation; strips at/below the true length only — rows beyond n
    are zero padding and contribute 0)."""
    sum_prog = None
    total = 0.0
    for r0 in range(0, n, S):
        strip = jnp.asarray(m[r0:r0 + S])
        if sum_prog is None:
            sum_prog = aot(_strip_sum_prog(), (strip, alpha),
                           "prep_strip_sum", f"S={S}")
        total += float(sum_prog(strip, alpha))
    # mirror the one-shot program's f32 arithmetic (f32 sum / f32(n*n)):
    # one host f32 division (IEEE correctly rounded, like XLA:CPU's) of the
    # f32-rounded total — routes agree bit-for-bit whenever the sum is
    # exactly representable, and to ~1e-7 relative otherwise
    return jnp.float32(
        np.float32(np.float64(total)) / (np.float32(n) * np.float32(n))
    )


def exact_tiles_from_if_streamed(
    if_matrix,
    L_pad: int,
    rc,
    weighting: str,
    weight_exponent: float,
    out_dtype: str = "float32",
    n_true: int | None = None,
    strip_rows: int | None = None,
    lead_batch: bool = False,
) -> ExactRestraints:
    """exact_tiles_from_if_device semantics with the IF matrix STREAMED in
    row strips: device peak = the output tiles + one (S, L_pad) strip, so
    the prep reaches every L the solve itself can hold (the one-shot route
    needs ~8*L^2 bytes at its peak, twice the bf16 solve's tiles).
    Single-device only
    (the sharded path splits rows across devices and keeps the one-shot
    program per shard).

    lead_batch: emit (1, L_pad, L_pad) tiles — the genome bucket's batched
    layout for its B_pad == 1 single-device at-scale case, born with the
    batch axis so no whole-tile reshape is ever scheduled at the ceiling."""
    from chromosome3d.utils.aot import load_or_compile as aot

    m = _host_padded(if_matrix, L_pad)
    n = int(if_matrix.shape[0] if n_true is None else n_true)
    S = int(strip_rows or _pick_strip_rows(L_pad))
    if L_pad % S:
        raise ValueError(f"strip_rows {S} must divide L_pad {L_pad}")
    sep = int(rc.separation)
    alpha = jnp.float32(rc.alpha)
    K = jnp.float32(rc.kscaling)
    p = jnp.float32(weight_exponent)
    nt = jnp.float32(n)
    mean = _streamed_mean(m, n, S, alpha, aot)

    dt = jnp.dtype(out_dtype)
    acc_shape = (1, L_pad, L_pad) if lead_batch else (L_pad, L_pad)
    t_acc = jnp.zeros(acc_shape, dt)
    w_acc = jnp.zeros(acc_shape, dt)
    tiles_prog = None
    sums = np.zeros(2, np.float64)
    statics = f"sep={sep};w={weighting};dt={out_dtype};S={S};lb={lead_batch}"
    for r0 in range(0, n, S):
        args = (t_acc, w_acc, jnp.asarray(m[r0:r0 + S]), jnp.int32(r0),
                nt, alpha, K, mean, p)
        if tiles_prog is None:
            tiles_prog = aot(_strip_tiles_prog(sep, weighting, str(out_dtype),
                                               lead_batch),
                             args, "prep_strip_tiles", statics)
        t_acc, w_acc, part = tiles_prog(*args)
        sums += np.asarray(part, np.float64)
    if weighting == "relative":
        denom = sums[0] / max(sums[1], 1.0)
        scale = jnp.float32(np.float32(1.0) / np.float32(max(denom, 1e-30)))
        w_acc = aot(_scale_prog(), (w_acc, scale), "prep_strip_scale",
                    f"dt={out_dtype}")(w_acc, scale)
    return ExactRestraints(target=t_acc, w=w_acc)


def assessment_view_from_if_streamed(
    if_matrix,
    L_pad: int,
    rc,
    weighting: str,
    weight_exponent: float,
    n_true: int | None = None,
    strip_rows: int | None = None,
):
    """The HOST f32 assessment view (target, weights) at TRUE length (L, L),
    streamed: past the one-shot ceiling the f32 view tiles cannot even
    exist on device (t + w = 8*L^2 bytes), so each strip's final values are
    computed and DOWNLOADED immediately. Three sweeps: IF^alpha mean,
    normalizer partials, final strips (the extra scalar sweep keeps the
    weight division on device, identical to the one-shot program's final
    op, instead of a multi-minute in-place host pass over w)."""
    from chromosome3d.utils.aot import load_or_compile as aot

    m = _host_padded(if_matrix, L_pad)
    n = int(if_matrix.shape[0] if n_true is None else n_true)
    S = int(strip_rows or _pick_strip_rows(L_pad))
    if L_pad % S:
        raise ValueError(f"strip_rows {S} must divide L_pad {L_pad}")
    sep = int(rc.separation)
    alpha = jnp.float32(rc.alpha)
    K = jnp.float32(rc.kscaling)
    p = jnp.float32(weight_exponent)
    nt = jnp.float32(n)
    mean = _streamed_mean(m, n, S, alpha, aot)

    statics = f"sep={sep};w={weighting};S={S}"
    if weighting == "relative":
        scal_prog = None
        sums = np.zeros(2, np.float64)
        for r0 in range(0, n, S):
            args = (jnp.asarray(m[r0:r0 + S]), jnp.int32(r0), nt, alpha, K,
                    mean, p)
            if scal_prog is None:
                scal_prog = aot(_strip_scalars_prog(sep, weighting), args,
                                "prep_strip_scalars", statics)
            sums += np.asarray(scal_prog(*args), np.float64)
        denom = jnp.float32(max(sums[0] / max(sums[1], 1.0), 0.0))
    else:
        denom = jnp.float32(1.0)  # x / max(1, eps) == x exactly

    t_np = np.empty((n, n), np.float32)
    w_np = np.empty((n, n), np.float32)
    view_prog = None
    for r0 in range(0, n, S):
        args = (jnp.asarray(m[r0:r0 + S]), jnp.int32(r0), nt, alpha, K,
                mean, p, denom)
        if view_prog is None:
            view_prog = aot(_strip_view_prog(sep, weighting), args,
                            "prep_strip_view", statics)
        t_s, w_s = view_prog(*args)
        rows = min(S, n - r0)
        t_np[r0:r0 + rows] = np.asarray(t_s)[:rows, :n]
        w_np[r0:r0 + rows] = np.asarray(w_s)[:rows, :n]
    return t_np, w_np
