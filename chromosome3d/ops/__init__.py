from chromosome3d.ops.energy import (
    DenseRestraints,
    EnergyWeights,
    ExactRestraints,
    OrGroupRestraints,
    energy,
    energy_terms,
    energy_terms_chunked,
    or_group_energy,
    dense_restraints_from_numpy,
    dense_or_groups_from_numpy,
    exact_restraints_from_numpy,
)

__all__ = [
    "DenseRestraints",
    "EnergyWeights",
    "ExactRestraints",
    "OrGroupRestraints",
    "energy",
    "energy_terms",
    "energy_terms_chunked",
    "or_group_energy",
    "dense_restraints_from_numpy",
    "dense_or_groups_from_numpy",
    "exact_restraints_from_numpy",
]
