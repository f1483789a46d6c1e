"""PyTorch port, slice 6: the ODE/SDE sampler set of flow/samplers.py and
the transport's drift, score and prior, against the JAX package.

Analytic drifts only (no network): the fixed-step integrators on the same
float32 grid; dopri5 and every ``ADAPTIVE_TABLEAUS`` method with the time
of each drift call recorded on both sides (JAX's with
``jax.debug.callback`` inside its ``while_loop``), from which each
attempt's start time and so its accept or reject follow: the attempts and
the decisions must be the same; the SDE loops and the likelihood with
JAX's Wiener increments and Rademacher probes rebuilt from its keys and
passed in. The convergence-order checks of tests/test_transport.py are
repeated on the port.

The adaptive cases are stiff relaxations whose error estimates stay far
above float32 rounding. Where a step's estimate is rounding noise (a
smooth field at dt = span / 100, an 8th-order method) or the controller
chatters at err ~ 1 on a stability limit, the decision rests on the last
bits of a float32 sum that XLA and torch round differently, and the two
step sequences part (ROADMAP.md §3).

Tolerances: fixed-step and SDE loop results 1e-6 of the largest magnitude
(the same float32 operations, in a few places summed in another order);
adaptive results rtol / 10 (the solver's own error is ~rtol) and attempt
start times 1e-2 (the error norm's last bits still move dt a little:
4.8e-3 at most); ``sample_ode``'s adaptive methods 1e-4; the
likelihood 1e-5 relative (JAX's jvp against the port's vector-Jacobian
product: the same products summed in another order); ``sample_sde`` with
Heun 1e-3 (at SBDM's t0 = 1e-3 the diffusion is ~1000 and the corrector
cancels terms of that size: JAX's own float32 result is 1.4e-4 off a
float64 run of the port, the port's 3.7e-5), with Euler 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fitv2_tpu.flow import samplers as js
from fitv2_tpu.flow import transport as jtr

from fitv2_tpu_torch.flow import samplers as ts
from fitv2_tpu_torch.flow import transport as ttr


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(ours, ref, tol):
    ours = np.asarray(ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


# (JAX drift, port drift): nonlinear in x, and one depending on t
DRIFTS = {
    'square': (lambda x, t: x * x, lambda x, t: x * x),
    'sin_t': (lambda x, t: jnp.sin(3.0 * x) + t[:, None],
              lambda x, t: torch.sin(3.0 * x) + t[:, None]),
}
X0 = np.array([[0.5, 0.1, -0.3], [0.2, 0.4, 0.0]], np.float32)


@pytest.mark.parametrize('drift', list(DRIFTS))
@pytest.mark.parametrize('method', ['euler', 'heun', 'midpoint', 'rk4'])
def test_fixed_step_integrators_match_jax(method, drift):
    jd, td = DRIFTS[drift]
    grid = np.linspace(0.0, 1.0, 9).astype(np.float32)
    want = getattr(js, f'ode_{method}')(jd, jnp.asarray(X0),
                                        jnp.asarray(grid))
    got = getattr(ts, f'ode_{method}')(td, _t(X0), grid)
    _close(got, want, 1e-6)


def _jax_call_times(fn):
    """Run ``fn(recording_drift)`` and the times of its drift calls, in
    order: a JAX drift that reports its t through jax.debug.callback."""
    times = []

    def wrap(drift):
        def rec(x, t):
            jax.debug.callback(lambda v: times.append(float(v[0])), t,
                               ordered=True)
            return drift(x, t)
        return rec
    out = fn(wrap)
    jax.block_until_ready(out)
    jax.effects_barrier()
    return np.asarray(out), times


def _port_call_times(fn):
    times = []

    def wrap(drift):
        def rec(x, t):
            times.append(float(t[0]))
            return drift(x, t)
        return rec
    return fn(wrap), times


def _decisions(times, method):
    """Each attempt's start time and whether it was accepted (the next
    attempt starts later; the last one ends the loop, so it was) from the
    times of the drift calls. dopri5 reuses the last stage (FSAL): after
    the initial call, an attempt calls stages 2-7 at t + dt/5, ..., t +
    dt, so t = (5 s2 - s7) / 4."""
    if method == 'dopri5':
        calls = np.asarray(times[1:], np.float64).reshape(-1, 6)
        starts = (5 * calls[:, 0] - calls[:, 5]) / 4
    else:
        n = len(ts.ADAPTIVE_TABLEAUS[method].c)
        starts = np.asarray(times, np.float64).reshape(-1, n)[:, 0]
    accept = np.append(np.diff(starts) > 1e-7, True)
    return starts, accept


def _adaptive_pair(method, jd, td, t1=1.0, **kw):
    if method == 'dopri5':
        want, jt = _jax_call_times(lambda w: js.ode_dopri5(
            w(jd), jnp.asarray(X0), 0.0, t1, **kw))
        (got, steps), pt = _port_call_times(lambda w: ts.ode_dopri5(
            w(td), _t(X0), 0.0, t1, return_steps=True, **kw))
    else:
        want, jt = _jax_call_times(lambda w: js.ode_adaptive(
            w(jd), jnp.asarray(X0), 0.0, t1, method=method, **kw))
        (got, steps), pt = _port_call_times(lambda w: ts.ode_adaptive(
            w(td), _t(X0), 0.0, t1, method=method, return_steps=True, **kw))
    assert len(pt) == len(jt), (len(pt), len(jt))
    (j_starts, j_accept), (p_starts, p_accept) = (
        _decisions(jt, method), _decisions(pt, method))
    np.testing.assert_array_equal(p_accept, j_accept)
    assert (len(p_accept), int(p_accept.sum())) == steps
    np.testing.assert_allclose(p_starts, j_starts, rtol=0, atol=1e-2)
    return got, want, steps


def _relax(lam, w):
    """dx/dt = -lam (x - sin(w t)): stiff enough that every step's error
    estimate is far above float32 rounding and the controller rejects the
    first dt = span / 100 when lam is large."""
    return (lambda x, t: -lam * (x - jnp.sin(w * t)[:, None]),
            lambda x, t: -lam * (x - torch.sin(w * t)[:, None]))


# (lam, w, t1, rtol): the controller settles where its decisions are not
# at the mercy of the error estimate's last bits
ADAPTIVE_CASES = {'lam200': (200.0, 10.0, 0.5, 3e-4),
                  'lam50': (50.0, 10.0, 1.0, 1e-3)}


@pytest.mark.parametrize('case', list(ADAPTIVE_CASES))
@pytest.mark.parametrize('method', ['dopri5', 'dopri8', 'bosh3',
                                    'adaptive_heun'])
def test_adaptive_solvers_take_jax_steps(method, case):
    lam, w, t1, rtol = ADAPTIVE_CASES[case]
    jd, td = _relax(lam, w)
    got, want, (steps, accepted) = _adaptive_pair(method, jd, td, t1=t1,
                                                  rtol=rtol, atol=1e-6)
    assert 0 < accepted < steps  # some attempts were rejected
    _close(got, want, rtol / 10)


def test_tableaus_equal_jax_and_are_consistent():
    assert set(ts.ADAPTIVE_TABLEAUS) == set(js.ADAPTIVE_TABLEAUS)
    for name, tab in ts.ADAPTIVE_TABLEAUS.items():
        ts.check_tableau(tab)
        assert tuple(tab) == tuple(js.ADAPTIVE_TABLEAUS[name]), name
    ts.check_tableau(ts.DOPRI5)
    np.testing.assert_array_equal(ts.DOPRI5.c, js._DP_C)
    np.testing.assert_array_equal(ts.DOPRI5.b_hi, js._DP_B5)
    np.testing.assert_array_equal(ts.DOPRI5.b_lo, js._DP_B4)
    assert [list(r) for r in ts.DOPRI5.a] == js._DP_A
    bad = ts.BOSH3._replace(b_hi=(2 / 9, 1 / 3, 4 / 9, 0.01))
    with pytest.raises(ValueError):
        ts.check_tableau(bad)


# -- the convergence-order checks of tests/test_transport.py, on the port ------

def test_heun_integrates_a_linear_field_exactly():
    out = ts.ode_heun(lambda x, t: t[:, None].expand_as(x),
                      torch.zeros(3, 5), np.linspace(0., 1., 21))
    np.testing.assert_allclose(out.numpy(), 0.5, rtol=1e-5)


def test_dopri5_exponential():
    out = ts.ode_dopri5(lambda x, t: x, torch.ones(2, 3), 0.0, 1.0,
                        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out.numpy(), np.e, rtol=1e-4)


@pytest.mark.parametrize('method', ['dopri8', 'bosh3', 'adaptive_heun'])
def test_adaptive_nonlinear_endpoint(method):
    out = ts.ode_adaptive(lambda x, t: x * x, torch.full((2, 3), 0.5), 0.0,
                          1.0, method=method, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=5e-4)


def test_adaptive_tolerance_scaling():
    def model(x, t):
        return torch.sin(3.0 * x) + 1.0
    x0 = torch.full((1, 4), 0.1)
    ref = ts.ode_adaptive(model, x0, 0.0, 1.0, method='dopri8', rtol=1e-9,
                          atol=1e-12)
    errs = [float((ts.ode_adaptive(model, x0, 0.0, 1.0, method='bosh3',
                                   rtol=r, atol=r * 1e-3) - ref).abs().max())
            for r in (1e-2, 1e-4, 1e-6)]
    assert errs[1] < errs[0] and errs[2] < errs[1], errs
    assert errs[2] < 1e-5, errs


@pytest.mark.parametrize('method,order', [('midpoint', 2), ('rk4', 4)])
def test_fixed_step_convergence_order(method, order):
    fn = {'midpoint': ts.ode_midpoint, 'rk4': ts.ode_rk4}[method]
    errs = []
    for n in ((8, 16, 32) if method == 'midpoint' else (2, 4, 8)):
        out = fn(lambda x, t: x * x, torch.full((1, 1), 0.5),
                 np.linspace(0.0, 1.0, n + 1))
        errs.append(abs(float(out[0, 0]) - 1.0))
    measured = np.log2(errs[0] / errs[2]) / 2.0
    assert abs(measured - order) < 0.4, (measured, errs)


# -- the Sampler facade and the transport's wrappers --------------------------------

@pytest.mark.parametrize('method', ['dopri5', 'dopri8', 'bosh3',
                                    'adaptive_heun', 'euler', 'heun',
                                    'midpoint', 'rk4'])
def test_sample_ode_matches_jax(method):
    """Every method of sample_ode on a velocity field that depends on x and
    t (the reference's torchdiffeq method list)."""
    jf = js.Sampler(jtr.create_transport()).sample_ode(
        sampling_method=method, num_steps=9)
    tf = ts.Sampler(ttr.create_transport()).sample_ode(
        sampling_method=method, num_steps=9)
    want = jf(jnp.asarray(X0), DRIFTS['sin_t'][0])
    got = tf(_t(X0), DRIFTS['sin_t'][1])
    adaptive = method == 'dopri5' or method in ts.ADAPTIVE_TABLEAUS
    _close(got, want, 1e-4 if adaptive else 1e-5)
    with pytest.raises(NotImplementedError):
        ts.Sampler(ttr.create_transport()).sample_ode(sampling_method='rk45')


PLANS = [('Linear', 'velocity'), ('Linear', 'noise'), ('GVP', 'score'),
         ('VP', 'velocity'), ('GVP', 'noise')]


@pytest.mark.parametrize('path,prediction', PLANS)
def test_drift_score_and_prior_match_jax(path, prediction):
    jt = jtr.create_transport(path, prediction)
    tt = ttr.create_transport(path, prediction)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    t = np.array([0.2, 0.5, 0.9], np.float32)

    def jm(x, t):
        return jnp.tanh(x) * (1 + t[:, None, None])

    def tm(x, t):
        return torch.tanh(x) * (1 + t[:, None, None])
    for jf, tf in ((jt.get_drift(), tt.get_drift()),
                   (jt.get_score(), tt.get_score())):
        _close(tf(_t(x), _t(t), tm), jf(jnp.asarray(x), jnp.asarray(t), jm),
               1e-6)
    _close(tt.prior_logp(_t(x)), jt.prior_logp(jnp.asarray(x)), 1e-6)


def _wiener(key, n_steps, shape):
    """JAX sde_sample's increments: normal(split(key, n)[i], shape)."""
    keys = jax.random.split(key, n_steps)
    return np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, shape, jnp.float32))(keys))


@pytest.mark.parametrize('method', ['Euler', 'Heun'])
def test_sde_sample_matches_jax(method):
    jd, td = DRIFTS['sin_t']
    grid = np.linspace(0.0, 0.9, 11).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def jdiff(x, t):
        return 0.1 * (1.0 + t[:, None]) * jnp.ones_like(x)

    def tdiff(x, t):
        return 0.1 * (1.0 + t[:, None]) * torch.ones_like(x)
    want = js.sde_sample(jd, jdiff, key, jnp.asarray(X0), jnp.asarray(grid),
                         method=method)
    noise = _wiener(key, len(grid) - 1, X0.shape)
    got = ts.sde_sample(td, tdiff, _t(X0), grid, method=method,
                        noise=_t(noise))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    again = ts.sde_sample(td, tdiff, _t(X0), grid, method=method,
                          generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(again[0]).all()


@pytest.mark.parametrize('method', ['Euler', 'Heun'])
@pytest.mark.parametrize('last_step', ['Mean', 'Euler', 'Tweedie', None])
def test_sample_sde_matches_jax(last_step, method):
    """Sampler.sample_sde with each last step, SBDM diffusion (the
    reference's constraint: sample_eps > 0 for a velocity model)."""
    jt = jtr.create_transport('Linear', 'velocity', sample_eps=1e-3)
    tt = ttr.create_transport('Linear', 'velocity', sample_eps=1e-3)
    kw = dict(sampling_method=method, num_steps=8, last_step=last_step,
              last_step_size=0.04)
    key = jax.random.PRNGKey(1)
    want = js.Sampler(jt).sample_sde(**kw)(key, jnp.asarray(X0),
                                           DRIFTS['sin_t'][0])
    noise = _wiener(key, 7, X0.shape)
    got = ts.Sampler(tt).sample_sde(**kw)(_t(X0), DRIFTS['sin_t'][1],
                                          noise=_t(noise))
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want, 1e-3 if method == 'Heun' else 1e-5)


def test_sample_ode_likelihood_matches_jax():
    """A nonlinear field, so the Hutchinson divergence is not 0: logp and z
    with JAX's Rademacher probe passed in; the zero field's logp is the
    prior's."""
    key = jax.random.PRNGKey(3)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 6)))
    jf = js.Sampler(jtr.create_transport()).sample_ode_likelihood(
        num_steps=8)
    tf = ts.Sampler(ttr.create_transport()).sample_ode_likelihood(
        num_steps=8)

    def jm(x, t):
        return jnp.tanh(1.5 * x) * t[:, None] + 0.3 * x

    def tm(x, t):
        return torch.tanh(1.5 * x) * t[:, None] + 0.3 * x
    jlogp, jz = jf(key, jnp.asarray(x), jm)
    eps = np.asarray(jax.random.randint(key, x.shape, 0, 2).astype(
        jnp.float32) * 2 - 1)
    logp, z = tf(_t(x), tm, eps=_t(eps))
    _close(z, jz, 1e-5)
    _close(logp, jlogp, 1e-5)
    prior = ttr.create_transport().prior_logp(_t(x))
    assert (logp - prior).abs().max() > 0.1  # the divergence term counts
    logp0, z0 = tf(_t(x), lambda x, t: torch.zeros_like(x),
                   generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(z0, _t(x))
    torch.testing.assert_close(logp0, prior)
