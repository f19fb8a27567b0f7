"""chromosome3d — a JAX framework for 3D chromosome reconstruction.

Rebuilds, from scratch, the full capability of multicom-toolbox/Chromosome3D
(the reference: chromosome3D.pl + the external CNS solve 1.3 suite):
Hi-C interaction-frequency (IF) matrices are converted to pairwise distance
restraints, and bead coordinates are solved by a jit-compiled distance-geometry
simulated annealer whose hot loop (the N x N pairwise-distance /
restraint-violation energy + gradient) runs as XLA-fused jnp or as one fused
GPU kernel.

Layer map (redesign of SURVEY.md section 1):

  L5  parallel.genome    whole-genome single-launch runs, chromosomes sharded
                         over a jax.sharding.Mesh       (ref: test.sh)
  L4  pipeline / cli     end-to-end per-chromosome job  (ref: chromosome3D.pl main)
  L3  restraints         IF -> distance restraints      (ref: IF2dist_new/dist2rr/carr2tbl)
  L2  solver.anneal      jit lax.scan annealing protocol (ref: dgsa.inp template)
  L1  ops.energy/pair    energy reference, analytic pair energy + grad, and the
                         GPU pair kernel          (ref: CNS Fortran engine)
  L0  assess / metrics   violation reports, NOE-energy ranking, Spearman scoring
                         (ref: assess_dgsa, spearman_IF_pdb.pl)
"""

from chromosome3d.config import (
    RestraintConfig,
    AnnealConfig,
    PipelineConfig,
    fast_anneal,
    turbo_anneal,
)

__version__ = "0.3.0"


def __getattr__(name):
    """Lazy top-level API (keeps `import chromosome3d` light)."""
    lazy = {
        "run_pipeline": ("chromosome3d.pipeline", "run_pipeline"),
        "run_restraints_pipeline": ("chromosome3d.pipeline", "run_restraints_pipeline"),
        "run_genome": ("chromosome3d.parallel.genome", "run_genome"),
        "solve_ensemble": ("chromosome3d.solver.anneal", "solve_ensemble"),
        "build_restraints": ("chromosome3d.restraints", "build_restraints"),
        "spearman_if_inv_d": ("chromosome3d.metrics", "spearman_if_inv_d"),
        "solve_ensemble_sharded": ("chromosome3d.solver.sharded", "solve_ensemble_sharded"),
        "solve_genome_sharded": ("chromosome3d.solver.sharded", "solve_genome_sharded"),
        "solve_coinit": ("chromosome3d.similarity", "solve_coinit"),
        "load_any": ("chromosome3d.io.hic", "load_any"),
        "load_cooler": ("chromosome3d.io.hic", "load_cooler"),
        "load_hic": ("chromosome3d.io.hic", "load_hic"),
        "ice_balance": ("chromosome3d.io.hic", "ice_balance"),
        "read_contact_tbl_full": ("chromosome3d.restraints", "read_contact_tbl_full"),
        "or_group_energy": ("chromosome3d.ops.energy", "or_group_energy"),
        "solve_bucket_sharded": ("chromosome3d.parallel.genome", "solve_bucket_sharded"),
        "quantum_bucket": ("chromosome3d.pipeline", "quantum_bucket"),
        # NOTE: the serve() FUNCTION is deliberately not lazy-exported: the
        # name collides with the chromosome3d.serve SUBMODULE (the
        # import system binds the module onto the package after any
        # import, shadowing __getattr__) — use
        # `from chromosome3d.serve import serve`.
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "RestraintConfig",
    "AnnealConfig",
    "PipelineConfig",
    "fast_anneal",
    "turbo_anneal",
    "run_pipeline",
    "run_restraints_pipeline",
    "run_genome",
    "solve_ensemble",
    "solve_ensemble_sharded",
    "solve_coinit",
    "build_restraints",
    "spearman_if_inv_d",
    "load_any",
    "load_cooler",
    "load_hic",
    "ice_balance",
    "solve_bucket_sharded",
    "__version__",
]
