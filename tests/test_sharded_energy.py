"""Sequence-parallel (row-sharded) energy vs the dense reference, on the
8-fake-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from chromosome3d.config import AnnealConfig
from chromosome3d.ops.energy import energy, weights_from_config
from chromosome3d.parallel.sharded_energy import make_sharded_energy_grad
from tests.test_pallas_energy import make_case


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()), ("beads",))


def test_sharded_energy_matches_dense(mesh):
    L = 16 * 8
    x, dense, w, bead = make_case(L)
    w0 = w._replace(bond=jnp.float32(0.0))
    fn = jax.jit(make_sharded_energy_grad(mesh, w0))
    e_sharded, g_sharded = fn(x, dense, bead)
    e_ref = float(energy(x, dense, w0, bead))
    assert float(e_sharded) == pytest.approx(e_ref, rel=1e-5)
    g_ref = jax.grad(energy)(x, dense, w0, bead)
    np.testing.assert_allclose(
        np.asarray(g_sharded), np.asarray(g_ref), rtol=1e-4, atol=1e-4
    )


def test_sharded_energy_with_padding(mesh):
    L = 16 * 8
    x, dense, w, _ = make_case(L)
    w0 = w._replace(bond=jnp.float32(0.0))
    bead = jnp.asarray([1.0] * 100 + [0.0] * (L - 100), jnp.float32)
    fn = jax.jit(make_sharded_energy_grad(mesh, w0))
    e_sharded, _ = fn(x, dense, bead)
    e_ref = float(energy(x, dense, w0, bead))
    assert float(e_sharded) == pytest.approx(e_ref, rel=1e-5)


def test_sharded_energy_rejects_bad_length(mesh):
    x, dense, w, bead = make_case(50)
    fn = make_sharded_energy_grad(mesh, w)
    with pytest.raises(ValueError):
        fn(x, dense, bead)
