"""Bayesian hierarchical qualifying model — pure JAX, no PyMC.

The reference's design doc sketches this model as "Approach B: Bayesian
Hierarchical (PyMC/Stan)" (/root/reference/plan.md:1111-1175) but never ships
it (the shipped predictor uses the Elo + feature-boost quali path,
/root/reference/src/predictor.py:466-520). This module implements the exact
generative model from that sketch — same priors, same non-centering targets,
same `gap_to_fastest` percentage response — as a JAX-native sampler:

  * the posterior is explored by Hamiltonian Monte Carlo with a non-centered
    parameterization (hierarchical scale funnels are the classic HMC failure
    mode; non-centering removes them), dual-averaging step-size adaptation
    and diagonal mass-matrix estimation during warmup;
  * chains are `vmap`-ed — 4 chains run as one batched program —
    and every phase (two warmup stages + sampling) is a single `lax.scan`
    under one `jit`, so the whole fit is one compiled program;
  * everything is float32 and threefry-keyed: same seed → bitwise-identical
    posterior on any backend, matching the framework's reproducibility
    contract.

Model (plan.md:1159-1172), for lap i with team t(i), driver d(i), circuit c(i):

    team_mu        ~ Normal(0, 1)
    team_sigma     ~ HalfNormal(0.5)
    team_effect_t  ~ Normal(team_mu, team_sigma)
    driver_sigma   ~ HalfNormal(0.3)
    driver_effect_d~ Normal(0, driver_sigma)
    circuit_sigma  ~ HalfNormal(0.2)
    circuit_eff_c  ~ Normal(0, circuit_sigma)
    sigma          ~ HalfNormal(0.1)
    y_i            ~ Normal(team_effect_{t(i)} + driver_effect_{d(i)}
                            + circuit_eff_{c(i)}, sigma)

where y is the percentage gap to the fastest lap of the same circuit
(plan.md:1139-1140). Unconstrained parameterization: scales are sampled as
logs (with the log-|Jacobian| correction) and effects as standard-normal
"raw" vectors scaled inside the likelihood.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from monte_carlo_gp.models.quali_common import (
    rank_draws_to_probs,
    valid_q_rows,
)
from monte_carlo_gp.utils.logging import log_event


def _host_cpu():
    """Pin context for the fit: HMC over a ~50-dim posterior is sequential
    tiny-step compute — latency-bound, no matrix work — so an accelerator
    adds only compile + launch cost per step. Same policy and fallback as
    the Elo flush (models/elo.py `flush`): prefer the host CPU backend,
    tolerate a process limited to the GPU (JAX_PLATFORMS=cuda), which has
    no 'cpu' backend. The Monte Carlo engine (throughput-bound) stays on
    the default device."""
    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return contextlib.nullcontext()
    return jax.default_device(cpu)

# Prior scales from the reference sketch (plan.md:1160-1168).
TEAM_SIGMA_SCALE = 0.5
DRIVER_SIGMA_SCALE = 0.3
CIRCUIT_SIGMA_SCALE = 0.2
OBS_SIGMA_SCALE = 0.1

# Dual-averaging constants (Hoffman & Gelman 2014, table 1 defaults).
_DA_GAMMA = 0.05
_DA_T0 = 10.0
_DA_KAPPA = 0.75
_TARGET_ACCEPT = 0.8


# ---------------------------------------------------------------------------
# Design matrix (host side, pandas → dense numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QualiDesign:
    """Indexed training rows for the hierarchical model.

    Vocabularies are in first-appearance order of the source frame (stable:
    the archive frame is built in sorted event order — never from a Python
    set, whose iteration order is hash-randomized per process)."""

    y: np.ndarray  # (N,) float32 gap-to-fastest percent
    team_idx: np.ndarray  # (N,) int32
    driver_idx: np.ndarray  # (N,) int32
    circuit_idx: np.ndarray  # (N,) int32
    teams: tuple[str, ...]
    drivers: tuple[str, ...]
    circuits: tuple[str, ...]

    @property
    def n_rows(self) -> int:
        return int(self.y.shape[0])


def build_quali_design(
    laps: pd.DataFrame, session_type: str | None = "Q"
) -> QualiDesign:
    """Build the (gap%, team, driver, circuit) design from an archive frame.

    Mirrors the reference sketch's data prep (plan.md:1118-1158): drop rows
    with missing lap times, compute each lap's percentage gap to the fastest
    lap of the same circuit, and integer-index the team/driver/circuit
    vocabularies. Our archive already stores LapTime as float seconds
    (data/loader.py normalized schema), so the sketch's Timedelta branch
    (plan.md:1131-1138) is moot.

    `session_type` filters the archive (default "Q": it is a qualifying
    model; the sketch trains on whatever frame it is handed). Pass None to
    train on all laps. Raises ValueError when no usable rows remain — or
    when the archive HAS a session_type column but zero matching rows
    (a qualifying model must not silently fit race laps; the predictor's
    wrapper degrades the raise to the Elo path). Filter semantics shared
    with the GBM model via quali_common.valid_q_rows
    (plan.md:1121-1122, 1153-1154).
    """
    rows = valid_q_rows(laps, session_type)

    lap_s = rows["LapTime"].to_numpy(np.float64)
    # Gap to the fastest lap of the same circuit, in percent
    # (plan.md:1139-1140).
    fastest = rows.groupby("circuit")["LapTime"].transform("min").to_numpy(np.float64)
    gap = (lap_s - fastest) / fastest * 100.0

    teams = tuple(pd.unique(rows["Team"]))
    drivers = tuple(pd.unique(rows["Driver"]))
    circuits = tuple(pd.unique(rows["circuit"]))
    team_map = {t: i for i, t in enumerate(teams)}
    driver_map = {d: i for i, d in enumerate(drivers)}
    circuit_map = {c: i for i, c in enumerate(circuits)}

    return QualiDesign(
        y=gap.astype(np.float32),
        team_idx=rows["Team"].map(team_map).to_numpy(np.int32),
        driver_idx=rows["Driver"].map(driver_map).to_numpy(np.int32),
        circuit_idx=rows["circuit"].map(circuit_map).to_numpy(np.int32),
        teams=teams,
        drivers=drivers,
        circuits=circuits,
    )


# ---------------------------------------------------------------------------
# Log posterior (unconstrained, non-centered)
# ---------------------------------------------------------------------------

# Flat parameter vector layout: [team_mu, log team_sigma, log driver_sigma,
# log circuit_sigma, log obs_sigma, team_raw (T), driver_raw (D),
# circuit_raw (C)].
_N_SCALAR = 5


def _param_dim(design: QualiDesign) -> int:
    return _N_SCALAR + len(design.teams) + len(design.drivers) + len(design.circuits)


def _unpack(theta: jax.Array, sizes: tuple[int, int, int]):
    t, d, c = sizes
    team_mu = theta[0]
    log_sigmas = theta[1:_N_SCALAR]
    team_raw = theta[_N_SCALAR : _N_SCALAR + t]
    driver_raw = theta[_N_SCALAR + t : _N_SCALAR + t + d]
    circuit_raw = theta[_N_SCALAR + t + d : _N_SCALAR + t + d + c]
    return team_mu, log_sigmas, team_raw, driver_raw, circuit_raw


def constrain(theta: jax.Array, sizes: tuple[int, int, int]) -> dict:
    """Unconstrained vector → named constrained parameters (the quantities
    the reference sketch's PyMC trace would contain)."""
    team_mu, log_sigmas, team_raw, driver_raw, circuit_raw = _unpack(theta, sizes)
    sig = jnp.exp(log_sigmas)
    return {
        "team_mu": team_mu,
        "team_sigma": sig[0],
        "driver_sigma": sig[1],
        "circuit_sigma": sig[2],
        "sigma": sig[3],
        "team_effect": team_mu + sig[0] * team_raw,
        "driver_effect": sig[1] * driver_raw,
        "circuit_effect": sig[2] * circuit_raw,
    }


def make_log_posterior(design: QualiDesign):
    """Returns logp(theta) for the unconstrained flat vector.

    HalfNormal(s; scale) with s = exp(u) contributes -s²/(2·scale²) + u
    (log-density up to constants, plus the log-Jacobian of exp). Raw effect
    vectors are standard normal; the likelihood applies the scales
    (non-centered — plan.md:1159-1168 writes the centered form, which is
    distribution-identical but geometrically hostile to HMC)."""
    sizes = (len(design.teams), len(design.drivers), len(design.circuits))
    y = jnp.asarray(design.y)
    team_idx = jnp.asarray(design.team_idx)
    driver_idx = jnp.asarray(design.driver_idx)
    circuit_idx = jnp.asarray(design.circuit_idx)
    prior_scales = jnp.asarray(
        [TEAM_SIGMA_SCALE, DRIVER_SIGMA_SCALE, CIRCUIT_SIGMA_SCALE, OBS_SIGMA_SCALE],
        dtype=jnp.float32,
    )

    def logp(theta: jax.Array) -> jax.Array:
        team_mu, log_sigmas, team_raw, driver_raw, circuit_raw = _unpack(
            theta, sizes
        )
        sig = jnp.exp(log_sigmas)
        lp = -0.5 * team_mu**2
        lp += jnp.sum(-0.5 * (sig / prior_scales) ** 2 + log_sigmas)
        lp += -0.5 * (
            jnp.sum(team_raw**2) + jnp.sum(driver_raw**2) + jnp.sum(circuit_raw**2)
        )
        team_effect = team_mu + sig[0] * team_raw
        driver_effect = sig[1] * driver_raw
        circuit_effect = sig[2] * circuit_raw
        mu = (
            team_effect[team_idx]
            + driver_effect[driver_idx]
            + circuit_effect[circuit_idx]
        )
        resid = (y - mu) / sig[3]
        lp += jnp.sum(-0.5 * resid**2) - y.shape[0] * log_sigmas[3]
        return lp

    return logp, sizes


# ---------------------------------------------------------------------------
# HMC with warmup adaptation
# ---------------------------------------------------------------------------


def _leapfrog(theta, p, eps, inv_mass, grad_fn, n_steps: int):
    p = p + 0.5 * eps * grad_fn(theta)

    def body(_, carry):
        th, pp = carry
        th = th + eps * inv_mass * pp
        pp = pp + eps * grad_fn(th)
        return th, pp

    theta, p = jax.lax.fori_loop(0, n_steps - 1, body, (theta, p))
    theta = theta + eps * inv_mass * p
    p = p + 0.5 * eps * grad_fn(theta)
    return theta, p


def _hmc_transition(key, theta, lp, eps, inv_mass, logp_fn, grad_fn, n_leapfrog):
    """One Metropolis-corrected HMC proposal. Returns (theta', lp', alpha)
    where alpha is the acceptance probability used for dual averaging."""
    k_mom, k_acc, k_jit = jax.random.split(key, 3)
    z = jax.random.normal(k_mom, theta.shape, theta.dtype)
    p = z / jnp.sqrt(inv_mass)  # p ~ N(0, M), M = 1/inv_mass (diagonal)
    # Multiplicative step jitter breaks leapfrog periodicity (a fixed
    # (eps, L) can resonate with a posterior mode's curvature and trap a
    # chain at low acceptance); the dual-averaging statistic still sees the
    # realized alpha, so adaptation is unaffected.
    eps = eps * jax.random.uniform(k_jit, (), theta.dtype, 0.8, 1.2)
    theta_new, p_new = _leapfrog(theta, p, eps, inv_mass, grad_fn, n_leapfrog)
    lp_new = logp_fn(theta_new)
    ke = 0.5 * jnp.sum(p * inv_mass * p)
    ke_new = 0.5 * jnp.sum(p_new * inv_mass * p_new)
    log_alpha = (lp_new - ke_new) - (lp - ke)
    alpha = jnp.where(
        jnp.isfinite(log_alpha), jnp.minimum(1.0, jnp.exp(log_alpha)), 0.0
    )
    accept = jax.random.uniform(k_acc) < alpha
    theta = jnp.where(accept, theta_new, theta)
    lp = jnp.where(accept, lp_new, lp)
    return theta, lp, alpha


def _warmup_scan(
    key, theta0, logp_fn, grad_fn, n_iters: int, n_leapfrog: int, inv_mass, eps0
):
    """One warmup stage: dual-averaged step size at fixed `inv_mass`, with a
    Welford variance estimate accumulated over the second half (the next
    stage's / sampler's diagonal mass)."""
    dim = theta0.shape[0]
    mu = jnp.log(10.0) + jnp.log(eps0)
    half = n_iters // 2

    def step(carry, it):
        theta, lp, k, h_bar, log_eps, log_eps_bar, w_n, w_mean, w_m2 = carry
        k, k_step = jax.random.split(k)
        theta, lp, alpha = _hmc_transition(
            k_step, theta, lp, jnp.exp(log_eps), inv_mass, logp_fn, grad_fn, n_leapfrog
        )
        m = it + 1.0
        h_bar = (1.0 - 1.0 / (m + _DA_T0)) * h_bar + (_TARGET_ACCEPT - alpha) / (
            m + _DA_T0
        )
        log_eps = mu - jnp.sqrt(m) / _DA_GAMMA * h_bar
        w = m ** (-_DA_KAPPA)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        # Welford over the stage's second half.
        in_window = it >= half
        n1 = w_n + jnp.where(in_window, 1.0, 0.0)
        delta = theta - w_mean
        w_mean = jnp.where(in_window, w_mean + delta / jnp.maximum(n1, 1.0), w_mean)
        w_m2 = jnp.where(in_window, w_m2 + delta * (theta - w_mean), w_m2)
        return (theta, lp, k, h_bar, log_eps, log_eps_bar, n1, w_mean, w_m2), alpha

    init = (
        theta0,
        logp_fn(theta0),
        key,
        jnp.float32(0.0),
        jnp.log(eps0),
        jnp.log(eps0),
        jnp.float32(0.0),
        jnp.zeros(dim, jnp.float32),
        jnp.zeros(dim, jnp.float32),
    )
    carry, alphas = jax.lax.scan(step, init, jnp.arange(n_iters, dtype=jnp.float32))
    theta, lp, k, _, _, log_eps_bar, w_n, _, w_m2 = carry
    var = jnp.where(w_n > 1.0, w_m2 / jnp.maximum(w_n - 1.0, 1.0), 1.0)
    var = jnp.clip(var, 1e-4, 1e4)
    return theta, lp, k, jnp.exp(log_eps_bar), var, jnp.mean(alphas)


def _sample_chain(key, theta0, logp_fn, grad_fn, n_warmup, n_samples, n_leapfrog):
    """Full single-chain schedule: two warmup stages (identity mass → Welford
    mass), then fixed-kernel sampling. Returns (samples, accept_rate)."""
    w1 = max(n_warmup // 2, 1)
    w2 = max(n_warmup - w1, 1)
    dim = theta0.shape[0]
    theta, lp, key, eps, var, _ = _warmup_scan(
        key, theta0, logp_fn, grad_fn, w1, n_leapfrog,
        jnp.ones(dim, jnp.float32), jnp.float32(0.1),
    )
    inv_mass = var  # optimal diagonal M⁻¹ ≈ posterior variance
    theta, lp, key, eps, var2, _ = _warmup_scan(
        key, theta, logp_fn, grad_fn, w2, n_leapfrog, inv_mass, eps
    )

    def step(carry, _):
        th, l, k = carry
        k, k_step = jax.random.split(k)
        th, l, alpha = _hmc_transition(
            k_step, th, l, eps, inv_mass, logp_fn, grad_fn, n_leapfrog
        )
        return (th, l, k), (th, alpha)

    (_, _, _), (samples, alphas) = jax.lax.scan(
        step, (theta, lp, key), None, length=n_samples
    )
    return samples, jnp.mean(alphas)


def _run_chains(key, theta0s, logp_fn, grad_fn, n_warmup, n_samples, n_leapfrog):
    # NOT a module-level jit: logp_fn/grad_fn are fresh closures per fit, so
    # a global static-arg cache can never hit across fits — it would only
    # accumulate one compiled executable (plus its captured design arrays)
    # per walk-forward refit for the life of the process. sample_posterior
    # jits this per fit instead; the executable is released with the wrapper.
    return jax.vmap(
        lambda k, t0: _sample_chain(
            k, t0, logp_fn, grad_fn, n_warmup, n_samples, n_leapfrog
        )
    )(key, theta0s)


@dataclasses.dataclass(frozen=True)
class QualiPosterior:
    """Posterior draws (chains flattened) in constrained space, plus
    per-chain diagnostics. `raw` keeps (chains, samples, dim) for R-hat."""

    design: QualiDesign
    team_effect: np.ndarray  # (S, T)
    driver_effect: np.ndarray  # (S, D)
    circuit_effect: np.ndarray  # (S, C)
    team_mu: np.ndarray  # (S,)
    driver_sigma: np.ndarray  # (S,)
    sigma: np.ndarray  # (S,)
    accept_rate: np.ndarray  # (chains,)
    raw: np.ndarray  # (chains, samples, dim)

    @property
    def n_draws(self) -> int:
        return int(self.sigma.shape[0])


def sample_posterior(
    design: QualiDesign,
    num_chains: int = 4,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_leapfrog: int = 48,
    seed: int = 42,
) -> QualiPosterior:
    """Fit the hierarchical model; the counts mirror the sketch's
    `pm.sample(2000, tune=1000, cores=4, random_seed=42)` defaults scaled to
    this sampler (plan.md:1171-1173). One jitted program: chains vmapped,
    iterations scanned."""
    logp_fn, sizes = make_log_posterior(design)
    grad_fn = jax.grad(logp_fn)
    dim = _param_dim(design)
    # Jittered inits: raws near 0, log-scales near log(prior scale / 2).
    offsets = np.zeros(dim, np.float32)
    offsets[1:_N_SCALAR] = np.log(
        [TEAM_SIGMA_SCALE / 2, DRIVER_SIGMA_SCALE / 2, CIRCUIT_SIGMA_SCALE / 2,
         OBS_SIGMA_SCALE / 2]
    )
    with _host_cpu():
        key = jax.random.PRNGKey(seed)
        k_init, k_run = jax.random.split(key)
        theta0s = (
            jnp.asarray(offsets)
            + 0.1 * jax.random.normal(k_init, (num_chains, dim), jnp.float32)
        )
        run = jax.jit(
            lambda ks, t0s: _run_chains(
                ks, t0s, logp_fn, grad_fn,
                int(num_warmup), int(num_samples), int(num_leapfrog),
            )
        )
        samples, accept = run(jax.random.split(k_run, num_chains), theta0s)
        raw = np.asarray(samples)  # (chains, samples, dim)
        flat = jnp.asarray(raw.reshape(num_chains * num_samples, dim))
        con = jax.vmap(lambda t: constrain(t, sizes))(flat)
    return QualiPosterior(
        design=design,
        team_effect=np.asarray(con["team_effect"]),
        driver_effect=np.asarray(con["driver_effect"]),
        circuit_effect=np.asarray(con["circuit_effect"]),
        team_mu=np.asarray(con["team_mu"]),
        driver_sigma=np.asarray(con["driver_sigma"]),
        sigma=np.asarray(con["sigma"]),
        accept_rate=np.asarray(accept),
        raw=raw,
    )


def split_rhat(chains_samples: np.ndarray) -> np.ndarray:
    """Split-R̂ (Gelman et al.) per parameter from (chains, samples, dim)
    draws — the convergence diagnostic PyMC's InferenceData would report."""
    c, s, d = chains_samples.shape
    half = s // 2
    halves = np.concatenate(
        [chains_samples[:, :half], chains_samples[:, half : 2 * half]], axis=0
    )  # (2c, half, d)
    m, n = halves.shape[0], halves.shape[1]
    chain_means = halves.mean(axis=1)  # (2c, d)
    chain_vars = halves.var(axis=1, ddof=1)  # (2c, d)
    w = chain_vars.mean(axis=0)
    b = n * chain_means.var(axis=0, ddof=1)
    var_hat = (n - 1) / n * w + b / n
    return np.sqrt(var_hat / np.maximum(w, 1e-12))


# ---------------------------------------------------------------------------
# Posterior → qualifying grid probabilities
# ---------------------------------------------------------------------------


def quali_position_probs(
    posterior: QualiPosterior,
    drivers: list[str],
    driver_teams: dict[str, str | None],
    circuit: str,
    seed: int = 0,
) -> dict[str, list[float]]:
    """Posterior-predictive grid-position distributions for a weekend field.

    For every posterior draw: each driver's predicted gap is
    team_effect + driver_effect + circuit_effect plus Normal(0, sigma)
    session noise; ranking the draws yields one simulated grid, and averaging
    the one-hot grids over draws gives each driver's position distribution —
    the same dict[str, list[float]] shape as the Elo quali path
    (predictor._predict_quali), so the two models are drop-in swappable.

    Entities absent from the training archive draw their effect from the
    fitted hierarchical prior per posterior draw (a rookie driver gets
    Normal(0, driver_sigma[s]); an unseen team Normal(team_mu[s],
    team_sigma[s]) via the same mechanism on the team level is approximated
    by team_mu[s]; an unseen circuit contributes 0) — uncertainty about the
    unknown propagates into wider position distributions instead of a
    point guess.
    """
    n = len(drivers)
    if n == 0:
        return {}
    design = posterior.design
    team_of = {t: i for i, t in enumerate(design.teams)}
    driver_of = {d: i for i, d in enumerate(design.drivers)}
    circuit_i = {c: i for i, c in enumerate(design.circuits)}.get(circuit, -1)

    s_draws = posterior.n_draws
    mu = np.zeros((s_draws, n), np.float32)
    with _host_cpu():  # tiny eager draws — keep them on the host
        key = jax.random.PRNGKey(seed)
        k_rookie, k_noise = jax.random.split(key)
        rookie_z = np.asarray(
            jax.random.normal(k_rookie, (s_draws, n), jnp.float32)
        )
        noise = np.asarray(jax.random.normal(k_noise, (s_draws, n), jnp.float32))
    for j, d in enumerate(drivers):
        di = driver_of.get(d, -1)
        if di >= 0:
            mu[:, j] += posterior.driver_effect[:, di]
        else:
            mu[:, j] += posterior.driver_sigma * rookie_z[:, j]
        ti = team_of.get(driver_teams.get(d) or "", -1)
        mu[:, j] += (
            posterior.team_effect[:, ti] if ti >= 0 else posterior.team_mu
        )
        if circuit_i >= 0:
            mu[:, j] += posterior.circuit_effect[:, circuit_i]

    gaps = mu + posterior.sigma[:, None] * noise
    return rank_draws_to_probs(gaps, drivers)


# ---------------------------------------------------------------------------
# Predictor-facing wrapper with archive-token fit caching
# ---------------------------------------------------------------------------


class BayesianQualiModel:
    """Owns one fitted posterior per feature-archive build.

    The fit is cached against the archive frame's unforgeable loader token
    (features.py `_mcgp_loader_token`): walk-forward backtests rebuild the
    archive per race (new token → refit, so race k's model sees only races
    < k — the leakage contract), while repeated predictions within one
    weekend reuse the fit."""

    def __init__(
        self,
        num_chains: int = 4,
        num_warmup: int = 1000,
        num_samples: int = 1000,
        seed: int = 42,
    ):
        self.num_chains = num_chains
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.seed = seed
        self._token: object | None = None
        self._posterior: QualiPosterior | None = None

    def fit(self, laps: pd.DataFrame) -> QualiPosterior:
        design = build_quali_design(laps)
        posterior = sample_posterior(
            design,
            num_chains=self.num_chains,
            num_warmup=self.num_warmup,
            num_samples=self.num_samples,
            seed=self.seed,
        )
        self._posterior = posterior
        self._token = laps.attrs.get("_mcgp_loader_token")
        log_event(
            "bayes_quali_fit",
            rows=design.n_rows,
            teams=len(design.teams),
            drivers=len(design.drivers),
            circuits=len(design.circuits),
            accept=float(np.mean(posterior.accept_rate)),
        )
        return posterior

    def posterior_for(self, laps: pd.DataFrame) -> QualiPosterior:
        from monte_carlo_gp.models.quali_common import needs_refit

        token = laps.attrs.get("_mcgp_loader_token")
        if needs_refit(self._posterior, token, self._token):
            return self.fit(laps)
        return self._posterior

    def predict(
        self,
        laps: pd.DataFrame,
        drivers: list[str],
        driver_teams: dict[str, str | None],
        circuit: str,
        seed: int = 0,
    ) -> dict[str, list[float]]:
        posterior = self.posterior_for(laps)
        return quali_position_probs(posterior, drivers, driver_teams, circuit, seed)
