"""Monte Carlo variance / standard error estimators.

Reference: src/stats/variance/mcvar.jl:5-218 — four estimators with
`:imse` as the default (mcvar.jl:194-200):

  * ``iid``  — var(v)/n assuming independence (line 5);
  * ``bm``   — Flegal-Jones batch means (lines 35-41, batchlen=100);
  * ``imse`` — Geyer initial monotone sequence (lines 75-105);
  * ``ipse`` — Geyer initial positive sequence (lines 137-158).

Design: autocovariances come from one batched real FFT
(O(n log n), runs on-device), and Geyer's data-dependent cutoffs become
mask arithmetic (leading-positive count via cumprod, monotonicity via
cummin) instead of early-exiting loops — fully vectorised over
(chains × coordinates) with no host round-trips.

All functions reduce along axis 0 (draws) and broadcast over any
remaining axes, so they apply directly to ``(n_post, n_chains, dim)``
trace buffers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def autocov(x, maxlag=None):
    """Empirical autocovariances [γ₀..γ_maxlag] along axis 0, denominator n
    (StatsBase.autocov convention used by the reference)."""
    x = jnp.asarray(x)
    n = x.shape[0]
    if maxlag is None:
        maxlag = n - 1
    xc = x - jnp.mean(x, axis=0, keepdims=True)
    nfft = 1
    while nfft < 2 * n:
        nfft *= 2
    f = jnp.fft.rfft(xc, n=nfft, axis=0)
    acf = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=0)[: maxlag + 1]
    return jnp.real(acf) / n


def mcvar_iid(x):
    """var(v)/n with Bessel correction (reference mcvar.jl:5)."""
    x = jnp.asarray(x)
    n = x.shape[0]
    return jnp.var(x, axis=0, ddof=1) / n


def mcvar_bm(x, batchlen: int = 100):
    """Batch-means estimator (reference mcvar.jl:35-41)."""
    x = jnp.asarray(x)
    n = x.shape[0]
    nbatches = n // batchlen
    if nbatches <= 1:
        raise ValueError("batchlen leaves fewer than 2 batches")
    nbsamples = nbatches * batchlen
    bm = jnp.mean(
        x[:nbsamples].reshape((nbatches, batchlen) + x.shape[1:]), axis=1
    )
    return batchlen * jnp.var(bm, axis=0, ddof=1) / nbsamples


def _initial_sequence(x, monotone: bool):
    x = jnp.asarray(x)
    n = x.shape[0]
    maxlag = n - 1
    k = (maxlag - 1) // 2
    acv = autocov(x, maxlag)
    # Γ̂_j = γ_{2j} + γ_{2j+1}, j = 0..k (Geyer pp. 477)
    g = acv[0 : 2 * k + 1 : 2] + acv[1 : 2 * k + 2 : 2]
    pos = (g > 0).astype(x.dtype)
    lead = jnp.cumprod(pos, axis=0)          # 1 while all previous Γ̂ positive
    if monotone:
        g = jax.lax.cummin(g, axis=0)        # enforce decreasing sequence
    total = jnp.sum(g * lead, axis=0)
    return (-acv[0] + 2.0 * total) / n


def mcvar_imse(x):
    """Geyer initial monotone sequence estimator (reference mcvar.jl:75-105)."""
    return _initial_sequence(x, monotone=True)


def mcvar_ipse(x):
    """Geyer initial positive sequence estimator (reference mcvar.jl:137-158)."""
    return _initial_sequence(x, monotone=False)


_ESTIMATORS = {
    "iid": mcvar_iid,
    "bm": mcvar_bm,
    "imse": mcvar_imse,
    "ipse": mcvar_ipse,
}


def _extract(chain_or_array, field):
    # promotes bf16 trace storage to f32 before any reduction
    from klara_tpu.stats._common import extract_f32

    return extract_f32(chain_or_array, field)


def mcvar(chain_or_array, estimator: str = "imse", field: str = "value", **kwargs):
    """MC variance of the chain mean, along the draws axis (default
    estimator :imse, reference mcvar.jl:194-200)."""
    fn = _ESTIMATORS[estimator]
    return fn(_extract(chain_or_array, field), **kwargs)


def mcse(chain_or_array, estimator: str = "imse", field: str = "value", **kwargs):
    """MC standard error = sqrt(mcvar) (reference mcvar.jl mcse family)."""
    return jnp.sqrt(mcvar(chain_or_array, estimator, field, **kwargs))


def ess(chain_or_array, estimator: str = "imse", field: str = "value", combine_chains: bool = True, **kwargs):
    """Effective sample size  n·var_iid/var_mc
    (reference src/stats/convergence/ess.jl:3-24).

    For multi-chain traces the per-chain ESS is computed independently;
    with ``combine_chains`` the chain axis (axis 1) is summed — effective
    samples add across independent chains.
    """
    x = _extract(chain_or_array, field)
    n = x.shape[0]
    e = n * mcvar_iid(x) / _ESTIMATORS[estimator](x, **kwargs)
    if combine_chains and x.ndim >= 2:
        e = jnp.sum(e, axis=0)
    return e


def iact(chain_or_array, estimator: str = "imse", field: str = "value", **kwargs):
    """Integrated autocorrelation time  var_mc/var_iid
    (reference src/stats/convergence/iact.jl:3-24)."""
    x = _extract(chain_or_array, field)
    return _ESTIMATORS[estimator](x, **kwargs) / mcvar_iid(x)
