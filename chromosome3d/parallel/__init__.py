from chromosome3d.parallel.genome import (
    GenomeJob,
    bucket_jobs,
    run_genome,
    solve_bucket,
)

__all__ = ["GenomeJob", "bucket_jobs", "run_genome", "solve_bucket"]
