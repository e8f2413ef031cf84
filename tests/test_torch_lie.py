"""The Sim3 half of ``ops/lie.py``, the ``SE3`` / ``Sim3`` wrappers and
``cat``: the port against the JAX functions on the same numpy inputs, on
the cases of tests/test_lie.py.

Tolerance: atol 1e-5 (float32, a few products and one 3x3 solve).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildgs_slam_tpu.ops import lie as jlie
from wildgs_slam_tpu_torch.ops import lie as tlie

torch.set_num_threads(1)
ATOL = 1e-5


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol)


def sim3_twists(n=64, seed=20):
    """Random twists, and rows in each of sim3_exp's four regimes (theta
    and sigma small or not) and on their thresholds' sides."""
    xi = 0.4 * np.random.RandomState(seed).normal(size=(n, 7))
    k = n // 8
    xi[:2 * k, 3:6] *= 1e-5          # theta small
    xi[k:3 * k, 6] = 3e-5            # sigma small
    xi[n - 1, 6] = 0.0
    xi[n - 2, 3:6] = 0.0
    return xi.astype(np.float32)


def both(fn, *args):
    """fn of the port and of the JAX package on the same arrays."""
    t = getattr(tlie, fn)(*[torch.tensor(a) for a in args])
    j = getattr(jlie, fn)(*[jnp.asarray(a) for a in args])
    return t.numpy(), np.asarray(j)


def test_sim3_functions_follow_jax():
    xi = sim3_twists()
    G, Gj = both("sim3_exp", xi)
    close(G, Gj)
    close(*both("sim3_log", Gj))
    close(tlie.sim3_log(torch.tensor(G)), xi, 5e-5)
    H = np.asarray(jlie.sim3_exp(jnp.asarray(np.roll(xi, 1, 0))))
    for fn, args in (("sim3_inv", (Gj,)), ("sim3_mul", (Gj, H)),
                     ("sim3_matrix", (Gj,))):
        close(*both(fn, *args))
    p = np.random.RandomState(2).normal(size=(64, 3)).astype(np.float32)
    p4 = np.concatenate([p, np.full((64, 1), 0.5, np.float32)], -1)
    close(*both("sim3_act", Gj, p))
    close(*both("sim3_act4", Gj, p4))
    se3 = Gj[:, :7]
    close(*both("sim3_from_se3", se3))
    close(*both("sim3_from_se3", se3, Gj[:, 7:]))
    close(tlie.sim3_identity((2, 3), device="cpu"), jlie.sim3_identity((2, 3)),
          0)


def test_sim3_roundtrip_and_action():
    g = np.asarray(jlie.se3_exp(0.3 * jax.random.normal(
        jax.random.PRNGKey(18), (6,))))
    G = torch.from_numpy(np.append(g, 1.7).astype(np.float32))
    close(tlie.sim3_mul(G, tlie.sim3_inv(G)), tlie.sim3_identity(device="cpu"))
    p = torch.tensor([0.2, -0.4, 1.3])
    close(tlie.sim3_act(G, p), (tlie.sim3_matrix(G) @ torch.cat(
        [p, torch.ones(1)]))[:3])
    # sigma = 0 is SE3; a pure scale multiplies
    xi0 = torch.from_numpy(sim3_twists())
    xi0[:, 6] = 0.0
    close(tlie.sim3_exp(xi0)[:, :7], tlie.se3_exp(xi0[:, :6]), 1e-6)
    s = tlie.sim3_exp(torch.tensor([0., 0, 0, 0, 0, 0, float(np.log(2.0))]))
    close(tlie.sim3_act(s, torch.tensor([1.0, 2.0, 3.0])), [2.0, 4.0, 6.0])


@pytest.mark.parametrize("kind", ["SE3", "Sim3"])
def test_wrappers_and_cat_follow_jax(kind):
    xi = sim3_twists(8, seed=4)
    if kind == "SE3":
        data = np.asarray(jlie.se3_exp(jnp.asarray(xi[:, :6])))
    else:
        data = np.asarray(jlie.sim3_exp(jnp.asarray(xi)))
    J, T = getattr(jlie, kind)(jnp.asarray(data)), getattr(tlie, kind)(
        torch.tensor(data))
    assert T.shape == J.shape == (8,)
    assert (T.manifold_dim, T.embedded_dim) == (J.manifold_dim,
                                                J.embedded_dim)
    close(T.inv().data, J.inv().data)
    close((T * T.inv()).data, (J * J.inv()).data)
    close(T.matrix(), J.matrix())
    p = np.random.RandomState(5).normal(size=(8, 3)).astype(np.float32)
    p4 = np.concatenate([p, np.ones((8, 1), np.float32)], -1)
    close(T * torch.from_numpy(p), J * jnp.asarray(p))
    close(T * torch.from_numpy(p4), J * jnp.asarray(p4))
    ident = getattr(tlie, kind).Identity(3, device="cpu")
    close(ident.data, getattr(jlie, kind).Identity(3).data, 0)
    cat_t = tlie.cat([T, ident], dim=0)
    cat_j = jlie.cat([J, getattr(jlie, kind).Identity(3)], axis=0)
    assert type(cat_t) is getattr(tlie, kind) and cat_t.shape == (11,)
    close(cat_t.data, cat_j.data)
    if kind == "SE3":
        tw = 0.01 * xi[:, :6]
        close(T.retr(torch.from_numpy(tw)).data, J.retr(jnp.asarray(tw)).data)
        close(T.log(), J.log())
        close(T[2:4].data, J[2:4].data)
        a = torch.from_numpy(xi[:, :6])
        close(T.adj(a), J.adj(jnp.asarray(xi[:, :6])))
        close(T.adjT(a), J.adjT(jnp.asarray(xi[:, :6])))
        close(T.normalize().data, J.normalize().data)
        close(tlie.SE3.exp(a).data, jlie.SE3.exp(jnp.asarray(xi[:, :6])).data)
        close(T.translation(), J.translation(), 0)
        close(T.quaternion(), J.quaternion(), 0)
        g = tlie.SE3.Identity(4, device="cpu").retr(torch.from_numpy(tw[:4]))
        close(g.log(), tw[:4])
