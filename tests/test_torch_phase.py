"""The port's phase utilities (``ops/phase.py``) against the JAX package's on
the same seeded numpy inputs.

Tolerances: the operations are elementwise or cumulative sums in float32;
both packages add in the same order along the frame axis, so differences are
a few ulp of the running sum (1e-5 relative covers sums of up to ~100 terms
of size pi).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acids_transforms_tpu.ops import phase as jp
from acids_transforms_tpu_torch.ops import phase as pp
from test_torch_common import rel, t2n


def phases(seed, shape=(2, 13, 9), spread=3.0):
    """Random walks of phase along frames: jumps of either sign, some past pi."""
    rng = np.random.default_rng(seed)
    steps = rng.uniform(-spread, spread, shape).astype(np.float32)
    return np.cumsum(steps, axis=-2).astype(np.float32)


def wrapped(p):
    return np.angle(np.exp(1j * p)).astype(np.float32)


def test_expi_is_cos_sin():
    p = phases(0)
    z = pp.expi(torch.as_tensor(p))
    assert z.dtype == torch.complex64
    assert rel(t2n(z), np.asarray(jp.expi(jnp.asarray(p)))) <= 1e-6
    assert pp.expi(torch.as_tensor(p, dtype=torch.float16)).dtype == torch.complex64


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_unwrap_matches_jax_and_undoes_wrapping(seed):
    p = phases(seed)
    w = wrapped(p)
    jo = np.asarray(jp.unwrap(jnp.asarray(w)))
    po = t2n(pp.unwrap(torch.as_tensor(w)))
    assert np.abs(po - jo).max() <= 1e-5 * max(1.0, np.abs(jo).max())
    # steps of at most 3 rad < pi: unwrapping restores the walk up to 2 pi k
    k = np.round((p[..., :1, :] - w[..., :1, :]) / (2 * np.pi))
    assert np.abs(po + 2 * np.pi * k - p).max() <= 1e-4


@pytest.mark.parametrize("name", ["fdiff_forward", "fdiff_backward", "fdiff_central"])
def test_fdiff_matches_jax(name):
    x = phases(4)
    jo = np.asarray(getattr(jp, name)(jnp.asarray(x)))
    po = t2n(getattr(pp, name)(torch.as_tensor(x)))
    assert po.shape == jo.shape and rel(po, jo) <= 1e-6


@pytest.mark.parametrize("kind", ["forward", "backward"])
def test_fint_inverts_fdiff_exactly(kind):
    x = phases(5)
    d = getattr(pp, "fdiff_" + kind)(torch.as_tensor(x))
    y = getattr(pp, "fint_" + kind)(d)
    jy = np.asarray(getattr(jp, "fint_" + kind)(jnp.asarray(t2n(d))))
    assert rel(t2n(y), x) <= 1e-5
    assert rel(t2n(y), jy) <= 1e-6


@pytest.mark.parametrize("T", [1, 2, 3, 8, 11, 12])
def test_fint_central_matches_jax_odd_and_even(T):
    x = phases(6, shape=(2, T, 7), spread=1.0)
    d = pp.fdiff_central(torch.as_tensor(x))
    y = t2n(pp.fint_central(d))
    jy = np.asarray(jp.fint_central(jnp.asarray(t2n(d))))
    assert y.shape == jy.shape
    assert rel(y, jy) <= 1e-5
    if T % 2 == 0 or T <= 2:
        assert rel(y, x) <= 1e-5          # even count: exact


def test_fint_central_odd_count_sets_the_free_offset_by_least_squares():
    """Odd T: the odd chain's offset is the mean midpoint residual, so a
    linear phase (zero curvature) still comes back exactly."""
    t = np.arange(9, dtype=np.float32)[None, :, None]
    x = (0.7 * t + 0.1).astype(np.float32) * np.ones((1, 1, 3), np.float32)
    y = t2n(pp.fint_central(pp.fdiff_central(torch.as_tensor(x))))
    assert rel(y, x) <= 1e-6


@pytest.mark.parametrize("L", [8, 9, 16])
def test_get_fft_idx_matches_jax(L):
    assert np.array_equal(t2n(pp.get_fft_idx(L).float()), np.asarray(jp.get_fft_idx(L), np.float32))


@pytest.mark.parametrize("order", [2, 4, float("inf")])
def test_deriv_matches_jax(order):
    rng = np.random.default_rng(7)
    m = rng.standard_normal((16, 5)).astype(np.float32)
    jo = np.asarray(jp.deriv(jnp.asarray(m), order))
    po = t2n(pp.deriv(torch.as_tensor(m), order))
    assert rel(po, jo) <= 1e-5
    with pytest.raises(ValueError):
        pp.deriv(torch.as_tensor(m), 3)
