"""Flow samplers over ``model_fn(x, t) -> drift-like`` closures.

Counterpart of fitv2_tpu/flow/samplers.py:
  - the FiTv2 Euler family: plain Euler over a time ladder, the
    training-free velocity-extrapolation sampler (the model runs on every
    ``eval_every``-th step only) and the CFG wrapper that builds the
    doubled batch;
  - fixed-step ODE integrators (Euler, Heun, midpoint, RK4), adaptive
    Dormand-Prince 5(4) (``ode_dopri5``, with FSAL) and the tableau-driven
    adaptive solver (``ode_adaptive``: dopri8, bosh3, adaptive_heun);
  - the Euler-Maruyama and Heun SDE loop (``sde_sample``);
  - the ``Sampler`` facade over a ``Transport``: ``sample_ode``,
    ``sample_sde`` with its last steps, ``sample_ode_likelihood``.

JAX runs these as ``lax.scan`` and ``lax.while_loop``; here they are
Python loops. Time is float32 host arithmetic (numpy float32 scalars), as
JAX's is float32 device arithmetic, so the adaptive step control computes
the same dt, t and decisions; its error norm is a float32 device value
read back each step (a sync on the card). The SDE's Wiener increments come
from a CPU ``torch.Generator`` or are passed in as a tensor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fitv2_tpu_torch.flow.transport import Transport

Tensor = torch.Tensor
ModelFn = Callable[[Tensor, Tensor], Tensor]
f32 = np.float32


def euler_ladder(steps: int) -> np.ndarray:
    """The (steps + 1,) float32 time ladder from 0 to 1 of the samplers.

    It equals ``jnp.linspace(0.0, 1.0, steps + 1)``, the ladder of JAX's
    sampler (fitv2_tpu/sample/pipeline.py:193), bit for bit:
    ``i * f32(1 / steps)`` in float32 with the last entry exactly 1
    (``torch.linspace`` rounds differently, 1-2 ulps off at most step
    counts)."""
    ladder = np.arange(steps + 1, dtype=np.float32) * (
        np.float32(1) / np.float32(steps))
    ladder[-1] = 1.0
    return ladder


def _full(x: Tensor, t) -> Tensor:
    """(B,) time vector in x's dtype, as JAX's ``jnp.full(..., z.dtype)``."""
    return torch.full((x.shape[0],), float(t), dtype=x.dtype,
                      device=x.device)


def euler_sample(model_fn: ModelFn, x: Tensor, sigmas,
                 return_trajectory: bool = False):
    """x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v(x_i, sigma_i); sigmas is
    the (steps + 1,) ladder, typically ``euler_ladder(steps)``. With
    ``return_trajectory``, returns (x, traj): traj (steps, *x.shape) holds
    each step's x_{i+1}, so traj[-1] is x."""
    sig = np.asarray(sigmas, np.float32)
    traj = []
    for t_cur, t_next in zip(sig[:-1], sig[1:]):
        x = x + float(t_next - t_cur) * model_fn(x, _full(x, t_cur))
        if return_trajectory:
            traj.append(x)
    return (x, torch.stack(traj)) if return_trajectory else x


def _safe_inv(dt: np.float32) -> np.float32:
    """Sign-preserving 1 / dt with |dt| clamped to 1e-8 (a descending ladder
    has dt < 0; clamping the signed value would flip the slope)."""
    return np.sign(dt) / np.maximum(np.abs(dt), np.float32(1e-8))


def euler_sample_extrapolated(model_fn: ModelFn, x: Tensor, sigmas,
                              eval_every: int = 2, order: int = 1) -> Tensor:
    """Euler over the whole ladder with the model run only on the first
    step of each block of ``eval_every`` steps; the other steps extrapolate
    the velocity in t from the last evaluations.

    order 1: v = v_e + (v_e - v_p) / (t_e - t_p) * (t - t_e) (linear through
    the last two evaluations); order 2 adds Newton's quadratic term through
    the last three. The first evaluations, with too few predecessors, use
    the lower order (v_e alone at first). A ladder that ``eval_every`` does
    not divide ends in a shorter block, one more model call."""
    if order not in (1, 2):
        raise ValueError(f'velocity extrapolation order must be 1 or 2, got '
                         f'{order}')
    if eval_every < 1:
        raise ValueError(f'eval_every must be >= 1, got {eval_every}')
    sig = np.asarray(sigmas, np.float32)
    pairs = np.stack([sig[:-1], sig[1:]], axis=-1)
    v_p = v_pp = None
    t_p = t_pp = np.float32(0.0)
    for start in range(0, len(pairs), eval_every):
        block = pairs[start:start + eval_every]
        t_e = block[0, 0]
        v_e = model_fn(x, _full(x, t_e))
        f1 = f2 = None
        if v_p is not None:
            f1 = (v_e - v_p) * float(_safe_inv(t_e - t_p))
            if order == 2 and v_pp is not None:
                f01 = (v_p - v_pp) * float(_safe_inv(t_p - t_pp))
                f2 = (f1 - f01) * float(_safe_inv(t_e - t_pp))
        for t_cur, t_next in block:
            v = v_e
            if f1 is not None:
                v = v_e + f1 * float(t_cur - t_e)
            if f2 is not None:
                v = v + f2 * float(t_cur - t_e) * float(t_cur - t_p)
            x = x + float(t_next - t_cur) * v
        v_pp, t_pp, v_p, t_p = v_p, t_p, v_e, t_e
    return x


def cfg_model_fn(model_fn_doubled: ModelFn, cfg_scale: float,
                 num_channels: Optional[int] = None) -> ModelFn:
    """Single-batch CFG drift from a model over the doubled (2B) batch whose
    second half carries the null class: ``uncond + s * (cond - uncond)`` on
    the first ``num_channels`` channels (all by default); the others keep
    the conditional output."""
    def fn(x: Tensor, t: Tensor) -> Tensor:
        out = model_fn_doubled(torch.cat([x, x], dim=0),
                               torch.cat([t, t], dim=0))
        cond, uncond = out.chunk(2, dim=0)
        if num_channels is None:
            return uncond + cfg_scale * (cond - uncond)
        mixed = uncond[..., :num_channels] + cfg_scale * (
            cond[..., :num_channels] - uncond[..., :num_channels])
        return torch.cat([mixed, cond[..., num_channels:]], dim=-1)
    return fn


# -- fixed-step ODE integrators ------------------------------------------------

def linspace_f32(t0: float, t1: float, num: int) -> np.ndarray:
    """The float32 time grid of ``num`` points from t0 to t1: numpy's
    float64 linspace rounded once (JAX's float32 ``jnp.linspace`` is
    within an ulp of it)."""
    return np.linspace(t0, t1, num).astype(f32)


def _pairs(t_grid):
    g = np.asarray(t_grid, f32)
    return zip(g[:-1], g[1:])


def ode_euler(drift: ModelFn, x: Tensor, t_grid) -> Tensor:
    for t0, t1 in _pairs(t_grid):
        x = x + float(t1 - t0) * drift(x, _full(x, t0))
    return x


def ode_heun(drift: ModelFn, x: Tensor, t_grid) -> Tensor:
    for t0, t1 in _pairs(t_grid):
        dt = t1 - t0
        k1 = drift(x, _full(x, t0))
        k2 = drift(x + float(dt) * k1, _full(x, t1))
        x = x + float(dt * f32(0.5)) * (k1 + k2)
    return x


def ode_midpoint(drift: ModelFn, x: Tensor, t_grid) -> Tensor:
    """Explicit midpoint (RK2), torchdiffeq's ``method='midpoint'``."""
    for t0, t1 in _pairs(t_grid):
        dt = t1 - t0
        k1 = drift(x, _full(x, t0))
        x = x + float(dt) * drift(x + float(f32(0.5) * dt) * k1,
                                  _full(x, t0 + f32(0.5) * dt))
    return x


def ode_rk4(drift: ModelFn, x: Tensor, t_grid) -> Tensor:
    """Classic fixed-step RK4, torchdiffeq's ``method='rk4'``."""
    for t0, t1 in _pairs(t_grid):
        dt = t1 - t0
        half = float(f32(0.5) * dt)
        tm = _full(x, t0 + f32(0.5) * dt)
        k1 = drift(x, _full(x, t0))
        k2 = drift(x + half * k1, tm)
        k3 = drift(x + half * k2, tm)
        k4 = drift(x + float(dt) * k3, _full(x, t1))
        x = x + float(dt / f32(6.0)) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


# -- adaptive embedded Runge-Kutta --------------------------------------------

class RKTableau(NamedTuple):
    c: tuple       # (s,) stage times
    a: tuple       # per-stage coefficient rows (row i has i entries)
    b_hi: tuple    # (s,) high-order solution weights
    b_lo: tuple    # (s,) embedded lower-order weights (error estimate)
    order: int     # order of the propagated (high) solution


# Dormand-Prince 5(4), FSAL: its last stage is the next step's first
DOPRI5 = RKTableau(
    c=(0., 1/5, 3/10, 4/5, 8/9, 1., 1.),
    a=((), (1/5,), (3/40, 9/40), (44/45, -56/15, 32/9),
       (19372/6561, -25360/2187, 64448/6561, -212/729),
       (9017/3168, -355/33, 46732/5247, 49/176, -5103/18656),
       (35/384, 0., 500/1113, 125/192, -2187/6784, 11/84)),
    b_hi=(35/384, 0., 500/1113, 125/192, -2187/6784, 11/84, 0.),
    b_lo=(5179/57600, 0., 7571/16695, 393/640, -92097/339200, 187/2100,
          1/40),
    order=5)

# Bogacki-Shampine 3(2) (torchdiffeq 'bosh3')
BOSH3 = RKTableau(
    c=(0., 1/2, 3/4, 1.),
    a=((), (1/2,), (0., 3/4), (2/9, 1/3, 4/9)),
    b_hi=(2/9, 1/3, 4/9, 0.),
    b_lo=(7/24, 1/4, 1/3, 1/8),
    order=3)

# Heun-Euler 2(1) (torchdiffeq 'adaptive_heun')
ADAPTIVE_HEUN = RKTableau(
    c=(0., 1.),
    a=((), (1.,)),
    b_hi=(1/2, 1/2),
    b_lo=(1., 0.),
    order=2)

# Prince-Dormand RK8(7)13M (torchdiffeq 'dopri8')
DOPRI8 = RKTableau(
    c=(0., 1/18, 1/12, 1/8, 5/16, 3/8, 59/400, 93/200,
       5490023248/9719169821, 13/20, 1201146811/1299019798, 1., 1.),
    a=(
        (),
        (1/18,),
        (1/48, 1/16),
        (1/32, 0., 3/32),
        (5/16, 0., -75/64, 75/64),
        (3/80, 0., 0., 3/16, 3/20),
        (29443841/614563906, 0., 0., 77736538/692538347,
         -28693883/1125000000, 23124283/1800000000),
        (16016141/946692911, 0., 0., 61564180/158732637,
         22789713/633445777, 545815736/2771057229, -180193667/1043307555),
        (39632708/573591083, 0., 0., -433636366/683701615,
         -421739975/2616292301, 100302831/723423059, 790204164/839813087,
         800635310/3783071287),
        (246121993/1340847787, 0., 0., -37695042795/15268766246,
         -309121744/1061227803, -12992083/490766935, 6005943493/2108947869,
         393006217/1396673457, 123872331/1001029789),
        (-1028468189/846180014, 0., 0., 8478235783/508512852,
         1311729495/1432422823, -10304129995/1701304382,
         -48777925059/3047939560, 15336726248/1032824649,
         -45442868181/3398467696, 3065993473/597172653),
        (185892177/718116043, 0., 0., -3185094517/667107341,
         -477755414/1098053517, -703635378/230739211, 5731566787/1027545527,
         5232866602/850066563, -4093664535/808688257, 3962137247/1805957418,
         65686358/487910083),
        (403863854/491063109, 0., 0., -5068492393/434740067,
         -411421997/543043805, 652783627/914296604, 11173962825/925320556,
         -13158990841/6184727034, 3936647629/1978049680,
         -160528059/685178525, 248638103/1413531060, 0.),
    ),
    b_hi=(14005451/335480064, 0., 0., 0., 0., -59238493/1068277825,
          181606767/758867731, 561292985/797845732, -1041891430/1371343529,
          760417239/1151165299, 118820643/751138087, -528747749/2220607170,
          1/4),
    b_lo=(13451932/455176623, 0., 0., 0., 0., -808719846/976000145,
          1757004468/5645159321, 656045339/265891186,
          -3867574721/1518517206, 465885868/322736535, 53011238/667516719,
          2/45, 0.),
    order=8)

ADAPTIVE_TABLEAUS = {'dopri8': DOPRI8, 'bosh3': BOSH3,
                     'adaptive_heun': ADAPTIVE_HEUN}


def check_tableau(tab: RKTableau, atol: float = 1e-12) -> None:
    """Guards against coefficient typos: each row of A sums to its c, and
    both weight rows satisfy sum(b) = 1, sum(b c) = 1/2 and sum(b c^2) =
    1/3 up to their orders (the 2(1) pair's low row is order 1 only)."""
    for i, row in enumerate(tab.a):
        if abs(sum(row) - tab.c[i]) >= atol:
            raise ValueError(f'row {i}: sum {sum(row)} != c {tab.c[i]}')
    for b, min_order in ((tab.b_hi, min(tab.order, 3)), (tab.b_lo, 1)):
        conditions = [(sum(b), 1.0, atol)]
        if min_order >= 2:
            conditions.append((sum(bi * ci for bi, ci in zip(b, tab.c)),
                               0.5, 1e-9))
        if min_order >= 3:
            conditions.append((sum(bi * ci * ci for bi, ci in zip(b, tab.c)),
                               1 / 3, 1e-9))
        for got, want, tol in conditions:
            if abs(got - want) >= tol:
                raise ValueError(f'order condition: {got} != {want}')


def _err_norm(e: Tensor, z_old: Tensor, z_new: Tensor, rtol: float,
              atol: float) -> float:
    """RMS of err / (atol + rtol * max(|x_old|, |x_new|)), float32, read
    back to the host."""
    tol = atol + rtol * torch.maximum(z_old.abs(), z_new.abs())
    return f32(torch.sqrt(torch.mean((e / tol).float() ** 2)).item())


def _adaptive(x: Tensor, t0: float, t1: float, rk_step, order: int,
              max_steps: int, rtol: float, atol: float,
              fsal: Optional[Tensor] = None):
    """The step-control loop shared by dopri5 and the tableau solver, with
    JAX's float32 arithmetic: dt clipped to land on t1, accept when the
    error norm is <= 1, dt scaled by clip(0.9 err^(-1/order), 0.2, 10)
    after every attempt. ``rk_step(t, x, dt, k1)`` returns (x_new, err,
    the FSAL stage or None). Returns (x, steps attempted, accepted)."""
    span = t1 - t0  # float64, as JAX's Python-float span
    abs_span, sign = f32(abs(span)), f32(np.sign(span))
    t0, t1 = f32(t0), f32(t1)
    t, dt = t0, f32(span / 100.0)
    steps = accepted = 0
    while steps < max_steps and (t - t1) * sign < 0:
        if abs(t + dt - t0) > abs_span:
            dt = f32(t1 - t)
        x_new, err, k_new = rk_step(t, x, dt, fsal)
        en = _err_norm(err, x, x_new, rtol, atol)
        factor = f32(np.clip(
            f32(0.9) * np.maximum(en, f32(1e-10)) ** f32(-1.0 / order),
            f32(0.2), f32(10.0)))
        if en <= 1.0:
            t, x, fsal = f32(t + dt), x_new, k_new
            accepted += 1
        dt = f32(dt * factor)
        steps += 1
    return x, steps, accepted


def _dr(drift: ModelFn, z: Tensor, ts) -> Tensor:
    return drift(z, _full(z, ts)).float()


def ode_dopri5(drift: ModelFn, x: Tensor, t0: float, t1: float,
               rtol: float = 1e-3, atol: float = 1e-6,
               max_steps: int = 4096, return_steps: bool = False):
    """Adaptive Dormand-Prince 5(4) from t0 to t1 in float32, reusing the
    last stage of an accepted step as the next step's first (FSAL). Error
    control as torchdiffeq's defaults (see ``_adaptive``).
    ``return_steps`` also returns (steps attempted, accepted)."""
    tab = DOPRI5
    x = x.float()

    def rk_step(t, z, dt, k1):
        ks = [k1]
        for i in range(1, 7):
            zi = z
            for j, aij in enumerate(tab.a[i]):
                zi = zi + float(dt * f32(aij)) * ks[j]
            ks.append(_dr(drift, zi, t + f32(tab.c[i]) * dt))
        k = torch.stack(ks)
        shape = (7,) + (1,) * z.dim()
        b5 = torch.tensor(tab.b_hi, dtype=torch.float32,
                          device=z.device).reshape(shape)
        b4 = torch.tensor(tab.b_lo, dtype=torch.float32,
                          device=z.device).reshape(shape)
        z5 = z + float(dt) * torch.sum(b5 * k, dim=0)
        z4 = z + float(dt) * torch.sum(b4 * k, dim=0)
        return z5, z5 - z4, ks[-1]

    out, steps, accepted = _adaptive(x, t0, t1, rk_step, tab.order,
                                     max_steps, rtol, atol,
                                     fsal=_dr(drift, x, f32(t0)))
    return (out, (steps, accepted)) if return_steps else out


def ode_adaptive(drift: ModelFn, x: Tensor, t0: float, t1: float,
                 method: str = 'dopri8', rtol: float = 1e-3,
                 atol: float = 1e-6, max_steps: int = 4096,
                 return_steps: bool = False):
    """Adaptive embedded RK of ``ADAPTIVE_TABLEAUS[method]`` from t0 to t1
    in float32 (no FSAL: each step computes its first stage), with
    ode_dopri5's step control and exponent -1/order."""
    tab = ADAPTIVE_TABLEAUS[method]
    x = x.float()

    def rk_step(t, z, dt, _):
        ks = []
        for i in range(len(tab.c)):
            zi = z
            for j, aij in enumerate(tab.a[i]):
                if aij != 0.0:
                    zi = zi + float(dt * f32(aij)) * ks[j]
            ks.append(_dr(drift, zi, t + f32(tab.c[i]) * dt))
        z_hi = z
        err = torch.zeros_like(z)
        for bh, bl, k in zip(tab.b_hi, tab.b_lo, ks):
            if bh != 0.0:
                z_hi = z_hi + float(dt * f32(bh)) * k
            if bh != bl:
                err = err + float(dt * f32(bh - bl)) * k
        return z_hi, err, None

    out, steps, accepted = _adaptive(x, t0, t1, rk_step, tab.order,
                                     max_steps, rtol, atol)
    return (out, (steps, accepted)) if return_steps else out


# -- SDE integrators ------------------------------------------------------------

def sde_sample(drift: ModelFn, diffusion: ModelFn, x: Tensor, t_grid,
               method: str = 'Euler', noise: Optional[Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Tensor, Tensor]:
    """Euler-Maruyama or Heun over t_grid[:-1] with the constant step
    t_grid[1] - t_grid[0]; returns (x, mean_x) there (the caller applies
    the last step). The standard-normal increments are ``noise`` (steps,
    *x.shape), else one draw of that shape from ``generator`` on the
    CPU."""
    if method not in ('Euler', 'Heun'):
        raise NotImplementedError(f'SDE method {method!r}')
    grid = np.asarray(t_grid, f32)
    dt = f32(grid[1] - grid[0])
    n_steps = len(grid) - 1
    if noise is None:
        noise = torch.randn((n_steps,) + tuple(x.shape), generator=generator)
    noise = noise.to(device=x.device, dtype=x.dtype)
    sqrt_dt = float(np.sqrt(dt))
    mean_x = x
    for i, t_cur in enumerate(grid[:-1]):
        tv = _full(x, t_cur)
        dw = noise[i] * sqrt_dt
        if method == 'Euler':
            d = drift(x, tv)
            g = diffusion(x, tv)
            mean_x = x + d * float(dt)
            x = mean_x + torch.sqrt(2 * g) * dw
        else:
            g = diffusion(x, tv)
            xhat = x + torch.sqrt(2 * g) * dw
            k1 = drift(xhat, tv)
            k2 = drift(xhat + float(dt) * k1, tv + float(dt))
            x, mean_x = xhat + float(f32(0.5) * dt) * (k1 + k2), xhat
    return x, mean_x


# -- the Sampler facade ---------------------------------------------------------

class Sampler:
    """Sampling-function factory over a ``Transport``."""

    def __init__(self, transport: Transport):
        self.transport = transport
        self.drift = transport.get_drift()
        self.score = transport.get_score()

    def _sde_drift_diffusion(self, diffusion_form: str, diffusion_norm: float):
        plan = self.transport.path_sampler

        def diffusion_fn(x, t):
            return plan.compute_diffusion(x, t, form=diffusion_form,
                                          norm=diffusion_norm)

        def sde_drift(x, t, model_fn):
            return (self.drift(x, t, model_fn)
                    + diffusion_fn(x, t) * self.score(x, t, model_fn))
        return sde_drift, diffusion_fn

    def sample_ode(self, *, sampling_method: str = 'dopri5',
                   num_steps: int = 50, atol: float = 1e-6,
                   rtol: float = 1e-3, reverse: bool = False):
        """Returns ``sample_fn(x, model_fn) -> x(t1)``: an adaptive method
        (dopri5, dopri8, bosh3, adaptive_heun) or a fixed-step one (euler,
        heun, midpoint, rk4) over ``num_steps`` grid points."""
        if reverse:
            base = self.drift

            def drift_raw(x, t, m):
                return base(x, torch.ones_like(t) * (1 - t), m)
        else:
            drift_raw = self.drift
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            sde=False, eval=True, reverse=reverse, last_step_size=0.0)
        fixed = {'euler': ode_euler, 'Euler': ode_euler, 'heun': ode_heun,
                 'Heun': ode_heun, 'heun2': ode_heun,
                 'midpoint': ode_midpoint, 'rk4': ode_rk4}
        if (sampling_method not in fixed and sampling_method != 'dopri5'
                and sampling_method not in ADAPTIVE_TABLEAUS):
            raise NotImplementedError(sampling_method)

        def sample_fn(x: Tensor, model_fn: ModelFn) -> Tensor:
            def drift(z, t):
                return drift_raw(z, t, model_fn)
            if sampling_method == 'dopri5':
                return ode_dopri5(drift, x, t0, t1, rtol=rtol, atol=atol)
            if sampling_method in ADAPTIVE_TABLEAUS:
                return ode_adaptive(drift, x, t0, t1, method=sampling_method,
                                    rtol=rtol, atol=atol)
            return fixed[sampling_method](drift, x,
                                          linspace_f32(t0, t1, num_steps))
        return sample_fn

    def sample_sde(self, *, sampling_method: str = 'Euler',
                   diffusion_form: str = 'SBDM', diffusion_norm: float = 1.0,
                   last_step: Optional[str] = 'Mean',
                   last_step_size: float = 0.04, num_steps: int = 250):
        """Returns ``sample_fn(x, model_fn, generator=None, noise=None)``:
        the SDE loop (increments as ``sde_sample`` takes them), then the
        last step ('Mean', 'Euler', 'Tweedie' or None) to t1."""
        if last_step not in (None, 'Mean', 'Euler', 'Tweedie'):
            raise NotImplementedError(last_step)
        if last_step is None:
            last_step_size = 0.0
        sde_drift, sde_diffusion = self._sde_drift_diffusion(
            diffusion_form, diffusion_norm)
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            diffusion_form=diffusion_form, sde=True, eval=True,
            reverse=False, last_step_size=last_step_size)

        def last_step_fn(x, t, model_fn):
            if last_step is None:
                return x
            if last_step == 'Mean':
                return x + sde_drift(x, t, model_fn) * last_step_size
            if last_step == 'Euler':
                return x + self.drift(x, t, model_fn) * last_step_size
            plan = self.transport.path_sampler  # Tweedie
            alpha = plan.compute_alpha_t(t)[0][0]
            sigma = plan.compute_sigma_t(t)[0][0]
            return x / alpha + (sigma ** 2) / alpha * self.score(
                x, t, model_fn)

        def sample_fn(x: Tensor, model_fn: ModelFn,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Tensor] = None) -> Tensor:
            def drift(z, t):
                return sde_drift(z, t, model_fn)
            xs, _ = sde_sample(drift, sde_diffusion, x,
                               linspace_f32(t0, t1, num_steps),
                               method=sampling_method, noise=noise,
                               generator=generator)
            return last_step_fn(xs, _full(x, f32(t1)), model_fn)
        return sample_fn

    def sample_ode_likelihood(self, *, sampling_method: str = 'dopri5',
                              num_steps: int = 50, atol: float = 1e-6,
                              rtol: float = 1e-3):
        """Returns ``fn(x, model_fn, generator=None, eps=None) -> (logp,
        z)``: the probability-flow ODE from data to noise with fixed-step
        Heun over ``num_steps`` grid points, the divergence by Hutchinson's
        estimator with Rademacher ``eps`` (drawn from ``generator`` unless
        given). JAX forms eps . (J eps) with ``jax.jvp``; here it is
        (eps J) . eps from one vector-Jacobian product (the same number,
        summed in another order), which the kernels' autograd Functions
        support on the card."""
        t0, t1 = self.transport.check_interval(
            self.transport.train_eps, self.transport.sample_eps,
            sde=False, eval=True, reverse=False, last_step_size=0.0)

        def sample_fn(x: Tensor, model_fn: ModelFn,
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[Tensor] = None):
            if eps is None:
                eps = torch.randint(0, 2, tuple(x.shape), generator=generator
                                    ).to(x.dtype) * 2 - 1
            eps = eps.to(device=x.device, dtype=x.dtype)

            def aug_drift(z, t):
                tr = torch.ones_like(t) * (1 - t)
                with torch.enable_grad():
                    zz = z.detach().requires_grad_(True)
                    drift_val = self.drift(zz, tr, model_fn)
                    vjp = (torch.autograd.grad((drift_val * eps).sum(), zz)[0]
                           if drift_val.requires_grad
                           else torch.zeros_like(z))  # a field constant in z
                logp_grad = (vjp * eps).reshape(z.shape[0], -1).sum(-1)
                return -drift_val.detach(), logp_grad

            z, logp = x, torch.zeros((x.shape[0],), dtype=x.dtype,
                                     device=x.device)
            for tt0, tt1 in _pairs(linspace_f32(t0, t1, num_steps)):
                dt = float(tt1 - tt0)
                k1z, k1l = aug_drift(z, _full(x, tt0))
                k2z, k2l = aug_drift(z + dt * k1z, _full(x, tt1))
                half = float(f32(tt1 - tt0) * f32(0.5))
                z, logp = z + half * (k1z + k2z), logp + half * (k1l + k2l)
            return self.transport.prior_logp(z) - logp, z
        return sample_fn
