"""Ground-truth synthetic benchmark: known 3D structures -> IF matrices.

The reference's de-facto regression standard is real data with golden
outputs (readme.txt:57-60, output_models/similarity.txt) — but that only
exists at reference scale (L <= 455 shipped). Beyond it, scoring
Spearman(IF, 1/d) against the SAME matrix the restraints were built from
verifies plumbing, not reconstruction: a solver bug that systematically
distorted large-L geometry while preserving rank order would pass. This
module closes that gap (round-4 VERDICT missing #1): synthesize a known 3D
polymer conformation, derive an IF matrix from it exactly the way the
pipeline's conversion assumes IF relates to distance
(d = K * mean(IF^alpha) / IF^alpha, chromosome3D.pl:110-162, inverted:
IF = (1/d)^(1/alpha)), optionally corrupt it with multiplicative noise,
reconstruct through the REAL product path, and score the result against
the TRUE coordinates — superposition RMSD (Kabsch, mirror + scale
resolved), distance Spearman vs truth, and relative dRMSD.

Structures are CONFINED PERSISTENT RANDOM WALKS: fixed bond length,
direction persistence (chromatin fibers are locally stiff), confined to a
sphere whose radius scales as L^(1/3) (constant bead density — the
chromosome-territory geometry that makes long-range contacts informative).
Everything is seed-deterministic.

Scoring is host-side numpy (the assess.py rule); pair statistics sample
beyond SPEARMAN_MAX_PAIRS-scale counts like metrics.spearman_if_model.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from chromosome3d.metrics import kabsch_rmsd


def confined_walk(
    L: int,
    seed: int = 0,
    bond: float = 3.8,
    radius_factor: float = 0.75,
    persistence: float = 0.7,
) -> np.ndarray:
    """A confined persistent random walk: (L, 3) float64 coordinates.

    bond: step length (the solver's default bond_length, so reconstructions
    are commensurate without rescaling).
    radius_factor: confinement sphere radius = radius_factor * bond *
    L**(1/3) — constant bead density across L.
    persistence: direction memory in [0, 1); 0 = pure random walk.

    Vectorization note: the walk is inherently sequential, but the O(L)
    python loop only does 3-vector work — ~1 s at L = 49152.
    """
    rs = np.random.RandomState(seed)
    R = radius_factor * bond * L ** (1.0 / 3.0)
    x = np.zeros((L, 3))
    d = _unit(rs.randn(3))
    for i in range(1, L):
        d = _unit(persistence * d + (1.0 - persistence) * _unit(rs.randn(3)))
        nxt = x[i - 1] + bond * d
        r = np.linalg.norm(nxt)
        if r > R:
            # reflect the direction off the (spherical) wall and retake
            # the step; the rare double-violation clamps to the boundary
            n = nxt / r
            d = _unit(d - 2.0 * float(d @ n) * n)
            nxt = x[i - 1] + bond * d
            r = np.linalg.norm(nxt)
            if r > R:
                nxt *= R / r
        x[i] = nxt
    return x - x.mean(axis=0)


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else np.array([1.0, 0.0, 0.0])


def radius_of_gyration(coords: np.ndarray) -> float:
    c = np.asarray(coords, dtype=np.float64)
    c = c - c.mean(axis=0)
    return float(np.sqrt((c * c).sum(axis=1).mean()))


def if_from_structure(
    coords: np.ndarray,
    alpha: float = 0.5,
    noise_sigma: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Host reference: (L, L) float64 IF matrix from true coordinates.

    IF_ij = (1/d_ij)^(1/alpha) * exp(noise_sigma * g_ij) with g symmetric
    standard normal — under the pipeline's conversion d_hat = K *
    mean(IF^alpha) / IF^alpha this recovers d_hat proportional to
    d_true * exp(-alpha * noise_sigma * g) (multiplicative noise, zero
    dropout). The diagonal uses d = bond-scale floor (huge IF, like real
    matrices); reconstruction is scale-free so the proportionality constant
    is irrelevant.

    O(L^2) float64 host passes: reference-scale only — use
    if_from_structure_strips for large L (same math on the accelerator).
    """
    c = np.asarray(coords, dtype=np.float64)
    L = c.shape[0]
    d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
    floor = 0.5 * 3.8
    np.fill_diagonal(d, floor)
    d = np.maximum(d, floor)
    m = (1.0 / d) ** (1.0 / alpha)
    if noise_sigma > 0.0:
        rs = np.random.RandomState(seed + 1)
        g = rs.standard_normal((L, L))
        g = np.triu(g, 1)
        g = g + g.T                      # symmetric, zero diagonal
        m = m * np.exp(noise_sigma * g)
    return m


def if_from_structure_strips(
    coords: np.ndarray,
    alpha: float = 0.5,
    noise_sigma: float = 0.0,
    seed: int = 0,
    strip: int = 2048,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Device-strip twin of if_from_structure for at-scale L: uploads the
    (L, 3) truth once and computes/downloads (strip, L) f32 rows — the host
    never runs an O(L^2) pass (this single-vCPU box takes ~50 s per (L, L)
    float64 pass at L = 24576), and the device never holds more than one
    strip. One compiled program serves every strip (row offset is a device
    scalar). out: optional preallocated/memmapped (L, L) f32 target.

    Noise is a symmetric counter-hash normal (xorshift mix of
    (min(i,j), max(i,j), seed) + Box-Muller) — not jax.random, so the
    value at (i, j) is position-determined and strips stay independent;
    statistical quality is ample for benchmark noise.
    """
    import jax
    import jax.numpy as jnp

    c = np.asarray(coords, dtype=np.float32)
    L = c.shape[0]
    S = min(strip, L)
    floor = np.float32(0.5 * 3.8)

    @jax.jit
    def gen_strip(cdev, r0):
        rows = cdev[r0 + jnp.arange(S)]                       # (S, 3)
        d2 = (
            (rows[:, None, :] - cdev[None, :, :]) ** 2
        ).sum(-1)                                             # (S, L)
        d = jnp.maximum(jnp.sqrt(d2), floor)
        m = (1.0 / d) ** jnp.float32(1.0 / alpha)
        if noise_sigma > 0.0:
            i = (r0 + jnp.arange(S))[:, None]
            j = jnp.arange(L)[None, :]
            lo = jnp.minimum(i, j).astype(jnp.uint32)
            hi = jnp.maximum(i, j).astype(jnp.uint32)
            g = _hash_normal(lo, hi, np.uint32(seed + 1))
            g = jnp.where(i == j, 0.0, g)
            m = m * jnp.exp(jnp.float32(noise_sigma) * g)
        return m

    cdev = jax.device_put(c)
    if out is None:
        out = np.empty((L, L), dtype=np.float32)
    for r0 in range(0, L, S):
        n = min(S, L - r0)
        out[r0:r0 + n] = np.asarray(
            gen_strip(cdev, jnp.int32(r0))
        )[:n]
    return out


def _hash_normal(lo, hi, seed):
    """Symmetric deterministic standard normal from integer coordinates:
    two xorshift-mixed uint32 streams -> Box-Muller. jnp, elementwise."""
    import jax.numpy as jnp

    def mix(x):
        x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
        x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
        return x ^ (x >> 16)

    base = (
        lo * jnp.uint32(2654435761)
        + hi * jnp.uint32(40503)
        + jnp.uint32(seed) * jnp.uint32(2246822519)
    )
    u1 = mix(base)
    u2 = mix(base ^ jnp.uint32(0x9E3779B9))
    # uniforms in (0, 1]; 2^-32 offset keeps log() finite
    f1 = (u1.astype(jnp.float32) + 1.0) * jnp.float32(2.0 ** -32)
    f2 = u2.astype(jnp.float32) * jnp.float32(2.0 ** -32)
    return jnp.sqrt(-2.0 * jnp.log(f1)) * jnp.cos(
        jnp.float32(2.0 * np.pi) * f2
    )


def reconstruction_metrics(
    rec: np.ndarray,
    true: np.ndarray,
    n_pairs: int = 2_000_000,
    seed: int = 0,
) -> Dict[str, float]:
    """Score a reconstruction against the TRUE structure. Returns:

      rmsd_over_rg : Kabsch superposition RMSD (mirror resolved — the
                     distance-only energy cannot see chirality,
                     chromosome3D.pl:1605-1727's enantiomer trial exists
                     for the same reason — and scale-optimal, since the
                     IF->distance map fixes scale only up to K*mean),
                     divided by the truth's radius of gyration. 0 = exact;
                     ~sqrt(2) ~ an unrelated compact conformation.
      spearman_d   : Spearman between reconstructed and true pair
                     distances (subsampled beyond n_pairs unordered pairs,
                     fixed seed). 1 = perfect rank recovery.
      drmsd_rel    : scale-optimal dRMSD over the same pairs, divided by
                     the mean true distance.
    """
    from scipy import stats as sps

    a = np.asarray(rec, dtype=np.float64)
    b = np.asarray(true, dtype=np.float64)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]

    rmsd = kabsch_rmsd(a, b, allow_mirror=True, allow_scale=True)
    rg = radius_of_gyration(b)

    total = n * (n - 1) // 2
    if total > n_pairs:
        rs = np.random.RandomState(seed + 20260820)
        i = rs.randint(0, n, size=int(2.2 * n_pairs))
        j = rs.randint(0, n, size=int(2.2 * n_pairs))
        keep = i < j
        i, j = i[keep][:n_pairs], j[keep][:n_pairs]
    else:
        i, j = np.triu_indices(n, k=1)
    da = np.sqrt(((a[i] - a[j]) ** 2).sum(-1))
    db = np.sqrt(((b[i] - b[j]) ** 2).sum(-1))
    rho = float(sps.spearmanr(da, db).statistic)
    s = float((da * db).sum() / max((da * da).sum(), 1e-30))
    drmsd_rel = float(np.sqrt(((s * da - db) ** 2).mean()) / db.mean())
    return {
        "rmsd_over_rg": float(rmsd / rg),
        "spearman_d": rho,
        "drmsd_rel": drmsd_rel,
        "n_pairs": int(len(i)),
    }
