"""Bayesian hyperparameter search and HyperBand early termination (the
port of octseg/tune/search.py).

``SearchSpace`` (one-hot encoding of configs/tune.yaml's categorical
space), ``BayesianSearch`` (random exploration for the first ``n_random``
trials, then expected improvement under a Gaussian process) and
``HyperBand`` (rung-based early termination shared by a sweep) decide as
octseg's do.

octseg fits its GP with sklearn's ``GaussianProcessRegressor(kernel=
Matern(nu=2.5), alpha=1e-4, normalize_y=True)`` and, where sklearn is
missing, falls back to random search without a word. The port imports
neither sklearn nor scipy and has no fallback: ``GaussianProcess`` below is
that regressor in numpy. A Matern 5/2 kernel with one length scale and unit
amplitude on Cholesky factors; the log marginal likelihood maximised over
the log length scale within [log 1e-5, log 1e5] from log 1.0 by the
iteration of L-BFGS-B, which sklearn runs through scipy, in one dimension
(``_lbfgsb_1d``): the likelihood has several local maxima on some
observation sets, and which one the fit reaches depends on the optimizer's
steps, so the port takes the same steps; predictive mean and std; expected
improvement with the normal cdf and pdf from ``math.erfc`` and
``math.exp``.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np


class SearchSpace:
    """Categorical/discrete space with one-hot encoding for the surrogate."""

    def __init__(self, params: Dict[str, Sequence]):
        self.params = {k: list(v) for k, v in params.items()}
        self.names = list(self.params.keys())
        self._dims = [len(self.params[n]) for n in self.names]

    @classmethod
    def from_config(cls, cfg) -> 'SearchSpace':
        input_sizes = list(range(cfg.input_size_min, cfg.input_size_max + 1,
                                 cfg.input_size_step))
        return cls({'architecture': list(cfg.architecture), 'encoder': list(cfg.encoder),
                    'optimizer': list(cfg.optimizer), 'lr': list(cfg.learning_rate),
                    'input_size': input_sizes})

    @property
    def size(self) -> int:
        return int(np.prod(self._dims))

    def sample(self, rng: np.random.Generator) -> Dict:
        return {n: self.params[n][rng.integers(len(self.params[n]))] for n in self.names}

    def encode(self, point: Dict) -> np.ndarray:
        parts = []
        for n in self.names:
            onehot = np.zeros(len(self.params[n]))
            onehot[self.params[n].index(point[n])] = 1.0
            parts.append(onehot)
        return np.concatenate(parts)


def _matern52(x: np.ndarray, y: np.ndarray, length_scale: float) -> np.ndarray:
    d = np.sqrt(((x[:, None, :] / length_scale - y[None, :, :] / length_scale) ** 2).sum(-1))
    k = d * math.sqrt(5.0)
    return (1.0 + k + k ** 2 / 3.0) * np.exp(-k)


def _cho_solve(lower: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.solve(lower.T, np.linalg.solve(lower, b))


# ------------------------------------------------------------------------
# L-BFGS-B in one dimension: what scipy.optimize.minimize(method='L-BFGS-B',
# jac=True, bounds=...) does with its defaults (m = 10, ftol = 2.22e-9,
# gtol = 1e-5, maxls = 20) for one bounded variable, after lbfgsb 3.0
# (Zhu, Byrd, Lu and Nocedal; Morales and Nocedal) and MINPACK-2's dcsrch
# line search (More and Thuente). In one dimension the limited-memory
# matrix is the secant y/s of the last accepted pair, so the generalized
# Cauchy point is the secant step clipped to the box, and the subspace
# minimisation leaves it where it is.

_LS_FTOL, _LS_GTOL, _LS_XTOL = 1e-3, 0.9, 0.1   # lbfgsb's line search
# scipy's defaults: projected-gradient and relative-reduction stops, line
# search evaluations, iterations
_PGTOL, _FTOL, _MAXLS, _MAXITER = 1e-5, 2.220446049250313e-09, 20, 15000


def _dcstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax):
    """MINPACK-2's dcstep: a safeguarded cubic or quadratic step, and the
    update of the interval (stx, sty) that brackets a minimiser."""
    sgnd = math.copysign(1.0, dp) * math.copysign(1.0, dx) if dp and dx else 0.0
    if fp > fx:
        theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp
        s = max(abs(theta), abs(dx), abs(dp))
        gamma = s * math.sqrt((theta / s) ** 2 - (dx / s) * (dp / s))
        if stp < stx:
            gamma = -gamma
        p = (gamma - dx) + theta
        q = ((gamma - dx) + gamma) + dp
        stpc = stx + p / q * (stp - stx)
        stpq = stx + ((dx / ((fx - fp) / (stp - stx) + dx)) / 2.0) * (stp - stx)
        stpf = stpc if abs(stpc - stx) <= abs(stpq - stx) else stpc + (stpq - stpc) / 2.0
        brackt = True
    elif sgnd < 0.0:
        theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp
        s = max(abs(theta), abs(dx), abs(dp))
        gamma = s * math.sqrt((theta / s) ** 2 - (dx / s) * (dp / s))
        if stp > stx:
            gamma = -gamma
        p = (gamma - dp) + theta
        q = ((gamma - dp) + gamma) + dx
        stpc = stp + p / q * (stx - stp)
        stpq = stp + (dp / (dp - dx)) * (stx - stp)
        stpf = stpc if abs(stpc - stp) > abs(stpq - stp) else stpq
        brackt = True
    elif abs(dp) < abs(dx):
        theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp
        s = max(abs(theta), abs(dx), abs(dp))
        gamma = s * math.sqrt(max(0.0, (theta / s) ** 2 - (dx / s) * (dp / s)))
        if stp > stx:
            gamma = -gamma
        p = (gamma - dp) + theta
        q = (gamma + (dx - dp)) + gamma
        r = p / q
        if r < 0 and gamma != 0:
            stpc = stp + r * (stx - stp)
        elif stp > stx:
            stpc = stpmax
        else:
            stpc = stpmin
        stpq = stp + (dp / (dp - dx)) * (stx - stp)
        if brackt:
            stpf = stpc if abs(stpc - stp) < abs(stpq - stp) else stpq
            if stp > stx:
                stpf = min(stp + 0.66 * (sty - stp), stpf)
            else:
                stpf = max(stp + 0.66 * (sty - stp), stpf)
        else:
            stpf = stpc if abs(stpc - stp) > abs(stpq - stp) else stpq
            stpf = min(max(stpf, stpmin), stpmax)
    elif brackt:
        theta = 3.0 * (fp - fy) / (sty - stp) + dy + dp
        s = max(abs(theta), abs(dy), abs(dp))
        gamma = s * math.sqrt((theta / s) ** 2 - (dy / s) * (dp / s))
        if stp > sty:
            gamma = -gamma
        p = (gamma - dp) + theta
        q = ((gamma - dp) + gamma) + dy
        stpf = stp + p / q * (sty - stp)
    else:
        stpf = stpmax if stp > stx else stpmin
    if fp > fx:
        sty, fy, dy = stp, fp, dp
    else:
        if sgnd < 0.0:
            sty, fy, dy = stx, fx, dx
        stx, fx, dx = stp, fp, dp
    return stx, fx, dx, sty, fy, dy, stpf, brackt


class _LineSearch:
    """MINPACK-2's dcsrch as a generator: it yields each trial step and
    receives (f, g) there; it returns on convergence or a warning, with the
    last trial step the accepted one."""

    def __init__(self, f0: float, g0: float, stp: float, stpmax: float):
        self.stp, self.stpmin, self.stpmax = stp, 0.0, stpmax
        self.brackt, self.stage = False, 1
        self.finit, self.ginit = f0, g0
        self.gtest = _LS_FTOL * g0
        self.width = stpmax
        self.width1 = self.width / 0.5
        self.stx, self.fx, self.gx = 0.0, f0, g0
        self.sty, self.fy, self.gy = 0.0, f0, g0
        self.stmin, self.stmax = 0.0, stp + 4.0 * stp

    def done(self, f: float, g: float) -> bool:
        """Take (f, g) at ``self.stp``; True when the search stops there,
        else ``self.stp`` is the next trial step."""
        stp = self.stp
        ftest = self.finit + stp * self.gtest
        if self.stage == 1 and f <= ftest and g >= 0:
            self.stage = 2
        stop = ((self.brackt and (stp <= self.stmin or stp >= self.stmax))
                or (self.brackt and self.stmax - self.stmin <= _LS_XTOL * self.stmax)
                or (stp == self.stpmax and f <= ftest and g <= self.gtest)
                or (stp == self.stpmin and (f > ftest or g >= self.gtest))
                or (f <= ftest and abs(g) <= _LS_GTOL * -self.ginit))
        if stop:
            return True
        if self.stage == 1 and f <= self.fx and f > ftest:
            gt = self.gtest
            (self.stx, fxm, gxm, self.sty, fym, gym, stp, self.brackt) = _dcstep(
                self.stx, self.fx - self.stx * gt, self.gx - gt, self.sty,
                self.fy - self.sty * gt, self.gy - gt, stp, f - stp * gt, g - gt,
                self.brackt, self.stmin, self.stmax)
            self.fx, self.fy = fxm + self.stx * gt, fym + self.sty * gt
            self.gx, self.gy = gxm + gt, gym + gt
        else:
            (self.stx, self.fx, self.gx, self.sty, self.fy, self.gy, stp,
             self.brackt) = _dcstep(self.stx, self.fx, self.gx, self.sty, self.fy, self.gy,
                                    stp, f, g, self.brackt, self.stmin, self.stmax)
        if self.brackt:
            if abs(self.sty - self.stx) >= 0.66 * self.width1:
                stp = self.stx + 0.5 * (self.sty - self.stx)
            self.width1 = self.width
            self.width = abs(self.sty - self.stx)
            self.stmin, self.stmax = min(self.stx, self.sty), max(self.stx, self.sty)
        else:
            self.stmin = stp + 1.1 * (stp - self.stx)
            self.stmax = stp + 4.0 * (stp - self.stx)
        stp = min(max(stp, self.stpmin), self.stpmax)
        if self.brackt and (stp <= self.stmin or stp >= self.stmax
                            or self.stmax - self.stmin <= _LS_XTOL * self.stmax):
            stp = self.stx
        self.stp = stp
        return False


def _lbfgsb_1d(fg, x0: float, lo: float, hi: float) -> float:
    """Minimise ``fg(x) -> (f, f')`` over [lo, hi] from ``x0`` as scipy's
    L-BFGS-B does; returns its final x."""
    eps = np.finfo(float).eps

    def projected(x, g):
        return abs(max(x - hi, g) if g < 0 else min(x - lo, g))

    x = min(max(x0, lo), hi)
    f, g = fg(x)
    if projected(x, g) <= _PGTOL:
        return x
    theta, have_pair, it = 1.0, False, 0
    while it < _MAXITER:
        # generalized Cauchy point of the model with curvature theta
        bound = hi if g < 0 else lo
        z = x - g / theta
        if (z - bound) * (bound - x) >= 0:   # the step reaches the bound
            z = bound
        d = z - x
        if it == 0:
            stpmax = 1.0
        else:
            stpmax = 1e10
            if d < 0:
                a2 = lo - x
                stpmax = 0.0 if a2 >= 0 else (a2 / d if d * stpmax < a2 else stpmax)
            elif d > 0:
                a2 = hi - x
                stpmax = 0.0 if a2 <= 0 else (a2 / d if d * stpmax > a2 else stpmax)
        x_old, f_old, g_old = x, f, g
        gd_old = g * d
        failed = gd_old >= 0
        if not failed:
            search = _LineSearch(f, gd_old, 1.0, stpmax)
            n_eval = 0
            while True:
                if n_eval >= _MAXLS:   # iback = evaluations - 1 reaches maxls
                    failed = True
                    break
                stp = search.stp
                x = z if stp == 1.0 else stp * d + x_old
                f, g = fg(x)
                n_eval += 1
                if search.done(f, g * d):
                    break
        if failed:
            x, f, g = x_old, f_old, g_old
            if not have_pair:
                return x      # abnormal termination in the line search
            theta, have_pair = 1.0, False   # restart from steepest descent
            continue
        it += 1
        if projected(x, g) <= _PGTOL:
            return x
        if f_old - f <= _FTOL * max(abs(f_old), abs(f), 1.0):
            return x
        y = g - g_old
        gd = g * d
        if stp == 1.0:
            dr, ddum = gd - gd_old, -gd_old
        else:
            dr, ddum = (gd - gd_old) * stp, -gd_old * stp
        if dr > eps * ddum:
            theta, have_pair = y * y / dr, True
    return x


class GaussianProcess:
    """sklearn's ``GaussianProcessRegressor(kernel=Matern(nu=2.5),
    alpha=1e-4, normalize_y=True)`` with its default L-BFGS-B fit and no
    restarts, in numpy (see the module docstring)."""

    ALPHA = 1e-4
    BOUNDS = (math.log(1e-5), math.log(1e5))

    def log_marginal_likelihood(self, theta: float) -> Tuple[float, float]:
        """(log marginal likelihood, its derivative in ``theta`` = log
        length scale) of the normalised targets; (-inf, 0) where K is not
        positive definite, as sklearn returns."""
        x, y = self.x, self.y
        n = len(x)
        scale = math.exp(theta)
        xs = x / scale
        sq = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
        k = np.sqrt(sq) * math.sqrt(5.0)
        kern = (1.0 + k + k ** 2 / 3.0) * np.exp(-k)
        np.fill_diagonal(kern, 1.0)
        # d kern / d log(length scale), sklearn's Matern gradient for nu 2.5
        tmp = np.sqrt(5.0 * sq)
        kern_grad = 5.0 / 3.0 * sq * (tmp + 1.0) * np.exp(-tmp)
        kern[np.diag_indices(n)] += self.ALPHA
        try:
            lower = np.linalg.cholesky(kern)
        except np.linalg.LinAlgError:
            return -math.inf, 0.0
        alpha = _cho_solve(lower, y)
        lml = (-0.5 * float(y @ alpha) - float(np.log(np.diag(lower)).sum())
               - n / 2 * math.log(2 * math.pi))
        inner = np.outer(alpha, alpha) - _cho_solve(lower, np.eye(n))
        return lml, 0.5 * float(np.einsum('ij,ji->', inner, kern_grad))

    def fit(self, x: np.ndarray, y: np.ndarray) -> 'GaussianProcess':
        y = np.asarray(y, np.float64)
        self.y_mean = float(np.mean(y))
        std = float(np.std(y))
        self.y_std = 1.0 if std == 0.0 else std
        self.x = np.asarray(x, np.float64)
        self.y = (y - self.y_mean) / self.y_std
        self.theta = _lbfgsb_1d(lambda t: tuple(-v for v in self.log_marginal_likelihood(t)),
                                0.0, *self.BOUNDS)
        self.length_scale = math.exp(self.theta)
        kern = _matern52(self.x, self.x, self.length_scale)
        np.fill_diagonal(kern, 1.0)
        kern[np.diag_indices(len(x))] += self.ALPHA
        self.lower = np.linalg.cholesky(kern)
        self.alpha = _cho_solve(self.lower, self.y)
        return self

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Predictive mean and standard deviation at ``x``, in the units of
        the targets."""
        k_trans = _matern52(np.asarray(x, np.float64), self.x, self.length_scale)
        mean = self.y_std * (k_trans @ self.alpha) + self.y_mean
        v = np.linalg.solve(self.lower, k_trans.T)
        var = np.maximum(1.0 - np.einsum('ij,ji->i', v.T, v), 0.0)
        return mean, np.sqrt(var * self.y_std ** 2)


def expected_improvement(mu: np.ndarray, sigma: np.ndarray, best: float) -> np.ndarray:
    """EI of a maximisation at ``best``, sigma floored at 1e-9 as octseg
    floors it."""
    sigma = np.maximum(sigma, 1e-9)
    z = (mu - best) / sigma
    cdf = np.array([0.5 * math.erfc(-v / math.sqrt(2.0)) for v in z])
    pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2.0 * math.pi)
    return (mu - best) * cdf + sigma * pdf


class BayesianSearch:
    """GP-EI over the encoded space; random exploration for the first
    ``n_random`` trials. Draws from ``np.random.default_rng(seed)`` in
    octseg's order, so both packages suggest the same points."""

    def __init__(self, space: SearchSpace, seed: int = 11, n_random: int = 10,
                 n_candidates: int = 256):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_random = n_random
        self.n_candidates = n_candidates
        self.observed_x: List[np.ndarray] = []
        self.observed_y: List[float] = []
        self._seen = set()

    def suggest(self) -> Dict:
        if len(self.observed_y) < self.n_random:
            point = self._sample_unseen()
        else:
            point = self._suggest_gp()
        self._seen.add(tuple(sorted(point.items())))
        return point

    def _sample_unseen(self) -> Dict:
        for _ in range(100):
            p = self.space.sample(self.rng)
            if tuple(sorted(p.items())) not in self._seen:
                return p
        return self.space.sample(self.rng)

    def _suggest_gp(self) -> Dict:
        # octseg draws sklearn's random_state here; the draw keeps the
        # stream, and so every later suggestion, in step with it
        self.rng.integers(2 ** 31)
        y = np.asarray(self.observed_y)
        gp = GaussianProcess().fit(np.stack(self.observed_x), y)
        candidates = [self._sample_unseen() for _ in range(self.n_candidates)]
        mu, sigma = gp.predict(np.stack([self.space.encode(c) for c in candidates]))
        return candidates[int(np.argmax(expected_improvement(mu, sigma, y.max())))]

    def observe(self, point: Dict, value: float) -> None:
        self.observed_x.append(self.space.encode(point))
        self.observed_y.append(float(value))
        # points fed from a resumed or warm-started sweep were never
        # suggested here: mark them seen, or the sweep reruns them
        self._seen.add(tuple(sorted(point.items())))


class HyperBand:
    """Rung-based early termination (W&B hyperband: eta 2, rungs at
    min_iter * eta^k below max_iter; a run stops at a rung when its metric
    is below the 1 - 1/eta quantile of the values recorded there, its own
    included, once the rung holds eta of them). One instance serves a
    sweep, so the rungs fill across trials; ``should_stop`` is thread-safe
    for concurrent trials."""

    def __init__(self, min_iter: int = 25, eta: int = 2, max_iter: int = 50, s: int = 2):
        self.eta = eta
        self.rungs = []
        r = min_iter
        for _ in range(s + 1):
            if r >= max_iter:
                break
            self.rungs.append(r)
            r *= eta
        self.history: Dict[int, List[float]] = {r: [] for r in self.rungs}
        self._lock = threading.Lock()

    def seed(self, epochs_done: int, metric: float) -> None:
        """Refill the rungs from a completed trial of a resumed sweep: it
        reached every rung up to ``epochs_done``, and its final metric
        stands in for the rung-time one (tuning_results.csv keeps only the
        final value)."""
        with self._lock:
            for r in self.rungs:
                if r <= epochs_done:
                    self.history[r].append(float(metric))

    def should_stop(self, epoch: int, metric: float) -> bool:
        if epoch not in self.history:
            return False
        with self._lock:
            rung = self.history[epoch]
            rung.append(metric)
            if len(rung) < self.eta:
                return False
            threshold = np.quantile(rung, 1.0 - 1.0 / self.eta)
        return bool(metric < threshold)
