"""`ops/lsq.py`'s Gauss-Newton and Levenberg-Marquardt and the pose-only
reference backend (`models/ref_backend.py`) of the port against the JAX
package, on the cases of `tests/test_lsq.py` and
`tests/test_ref_backend.py`.

Tolerances: lsq's x within 1e-5 relative (of max(|x|, 1)) and its costs
within 1e-5 absolute. ref_backend's costs within 1e-4 relative and its
recomposed end pose within 1e-4; its twists within 1e-3. The segment's
z-translation prior weighs 5e-4 against an endpoint weight of 1000, so
the normal equations reach a condition number near 1e7, and float32
twists are good to some 1e-4 along that weak axis on either side: the
test holds both packages' float32 twists within 1e-3 of the port's
float64 solve of the same segment as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.models import ref_backend as jrb
from slam1_tpu.ops import lsq as jlsq
from slam1_tpu_torch.models import ref_backend as trb
from slam1_tpu_torch.ops import lsq as tlsq
from torch_threads import one_torch_thread  # noqa: F401

T_CURVE = np.linspace(0, 1, 30).astype(np.float32)
Y_CURVE = (2.5 * np.exp(-1.3 * T_CURVE)
           + 0.01 * np.sin(20 * T_CURVE).astype(np.float32))


def _residuals(xp, name):
    """The residual functions of tests/test_lsq.py for either package
    (`xp` = jnp or torch)."""
    def asarr(a):
        return jnp.asarray(a) if xp is jnp else torch.as_tensor(a)

    if name == "linear":
        target = asarr(np.array([1.0, -2.0, 3.0], np.float32))
        return lambda x: (x - target, xp.ones_like(x))
    if name == "rosenbrock":
        def fn(x):
            r = xp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])
            return r, xp.ones_like(r)
        return fn
    if name == "masked":
        def fn(x):
            r = xp.concatenate([x - 2.0, x + 100.0]) if xp is jnp else \
                torch.cat([x - 2.0, x + 100.0])
            w = (xp.concatenate([xp.ones_like(x), xp.zeros_like(x)])
                 if xp is jnp else torch.cat([torch.ones_like(x),
                                              torch.zeros_like(x)]))
            return r, w
        return fn
    if name == "curve":
        t, y = asarr(T_CURVE), asarr(Y_CURVE)

        def fn(p):
            r = p[0] * xp.exp(p[1] * t) - y
            return r, xp.ones_like(r)
        return fn
    if name == "sine":
        def fn(x):
            r = xp.stack([xp.sin(x[0]) * 5 + x[0] * 0.1 - 1.0])
            return r, xp.ones_like(r)
        return fn
    raise KeyError(name)


# (solver, residual, x0, keyword arguments), as tests/test_lsq.py runs them
LSQ_CASES = [
    ("gauss_newton", "linear", [0.0, 0.0, 0.0], dict(iters=3)),
    ("gauss_newton", "rosenbrock", [-1.2, 1.0], dict(iters=30,
                                                     damping=1e-8)),
    ("gauss_newton", "masked", [0.0, 0.0], dict(iters=5)),
    ("levenberg_marquardt", "curve", [1.0, 0.0], dict(iters=30)),
    ("levenberg_marquardt", "sine", [2.0], dict(iters=20)),
]


@pytest.mark.parametrize("solver,name,x0,kw", LSQ_CASES,
                         ids=[c[1] for c in LSQ_CASES])
def test_lsq_solvers_match_jax(solver, name, x0, kw):
    x0 = np.array(x0, np.float32)
    xj, cj = getattr(jlsq, solver)(_residuals(jnp, name), jnp.asarray(x0),
                                   **kw)
    xt, ct = getattr(tlsq, solver)(_residuals(torch, name),
                                   torch.as_tensor(x0), **kw)
    xj = np.asarray(xj)
    assert xt.dtype == torch.float32
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(xj).max()))
    assert abs(float(ct) - float(cj)) <= 1e-5


def test_weighted_normal_eqs_match_jax():
    rng = np.random.default_rng(0)
    J = rng.normal(size=(12, 4)).astype(np.float32)
    r = rng.normal(size=12).astype(np.float32)
    w = (rng.random(12) > 0.3).astype(np.float32)
    Hj, gj = jlsq.weighted_normal_eqs(jnp.asarray(J), jnp.asarray(r),
                                      jnp.asarray(w))
    Ht, gt = tlsq.weighted_normal_eqs(torch.as_tensor(J), torch.as_tensor(r),
                                      torch.as_tensor(w))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)


def _segment(name):
    """(twists, valid, Z_loop, iters, with_loop) of test_ref_backend.py's
    three cases."""
    if name == "closes_gap":
        s = 16
        xi_true = np.tile(np.array([0, 0, 1.0, 0, 0.05, 0], np.float32),
                          (s, 1))
        valid = np.ones(s, bool)
        T_end = np.array(jrb.recompose(jnp.eye(4), jnp.asarray(xi_true),
                                         jnp.asarray(valid))[-1])
        xi = xi_true.copy()
        xi[:, 2] += 0.05
        xi[:, 4] += 0.002
        return xi, valid, T_end, 25, True
    if name == "without_loop":
        s = 8
        xi = np.tile(np.array([0, 0, 1.0, 0, 0.01, 0], np.float32), (s, 1))
        return xi, np.ones(s, bool), np.eye(4, dtype=np.float32), 10, False
    if name == "padding":
        s = 8
        xi = np.tile(np.array([0, 0, 1.0, 0, 0, 0], np.float32), (s, 1))
        valid = np.array([True] * 5 + [False] * 3)
        T_end = np.array(jrb.recompose(jnp.eye(4), jnp.asarray(xi),
                                       jnp.asarray(valid))[-1])
        T_end[2, 3] += 1.0
        return xi, valid, T_end, 15, True
    raise KeyError(name)


@pytest.mark.parametrize("name", ["closes_gap", "without_loop", "padding"])
def test_optimize_segment_matches_jax(name):
    xi, valid, Z, iters, with_loop = _segment(name)
    xj, cj = jrb.optimize_segment(jnp.asarray(xi), jnp.asarray(valid),
                                  jnp.asarray(Z), iters=iters,
                                  with_loop=with_loop)
    xt, ct = trb.optimize_segment(torch.as_tensor(xi), torch.as_tensor(valid),
                                  torch.as_tensor(Z), iters=iters,
                                  with_loop=with_loop)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-3)
    x64, _ = trb.optimize_segment(torch.as_tensor(xi).double(),
                                  torch.as_tensor(valid),
                                  torch.as_tensor(Z).double(), iters=iters,
                                  with_loop=with_loop)
    for x32 in (xt.numpy(), xj):
        np.testing.assert_allclose(x32, x64.numpy(), rtol=0, atol=1e-3)
    # Padding rows stay where they were, on both sides.
    np.testing.assert_array_equal(xt.numpy()[~valid], xi[~valid])
    assert abs(float(ct) - float(cj)) <= 1e-4 * max(float(cj), 1e-6)
    ej = np.asarray(jrb.recompose(jnp.eye(4), jnp.asarray(xj),
                                  jnp.asarray(valid))[-1])
    et = trb.recompose(torch.eye(4), xt, torch.as_tensor(valid))[-1]
    np.testing.assert_allclose(et.numpy(), ej, rtol=0, atol=1e-4)


def test_recompose_matches_jax():
    rng = np.random.default_rng(1)
    xi = (rng.normal(size=(10, 6)) * [0.2, 0.1, 1.0, 0.02, 0.05, 0.02]
          ).astype(np.float32)
    valid = rng.random(10) > 0.3
    T0 = np.asarray(jrb.recompose(jnp.eye(4), jnp.asarray(xi[:3]),
                                  jnp.ones(3, bool))[-1])
    j = np.asarray(jrb.recompose(jnp.asarray(T0), jnp.asarray(xi),
                                 jnp.asarray(valid)))
    t = trb.recompose(torch.as_tensor(T0), torch.as_tensor(xi),
                      torch.as_tensor(valid))
    assert t.shape == (11, 4, 4)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)
