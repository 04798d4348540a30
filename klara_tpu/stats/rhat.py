"""Split-R̂ potential scale reduction (Gelman-Rubin / Vehtari et al. 2021).

NOT in the reference (it runs one chain at a time); added here because the
chains axis is first-class here — this is the natural cross-chain
convergence diagnostic, computed on-device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from klara_tpu.stats._common import extract_f32


def rhat(chain_or_array, field: str = "value"):
    """Split-R̂ along (draws, chains); broadcasts over trailing axes.

    Input (n, m, ...) -> output (...)."""
    x = extract_f32(chain_or_array, field)
    n = x.shape[0] // 2 * 2
    # split each chain in half -> 2m chains of length n/2
    half = n // 2
    x = jnp.concatenate([x[:half], x[half:n]], axis=1)

    chain_means = jnp.mean(x, axis=0)
    chain_vars = jnp.var(x, axis=0, ddof=1)
    w = jnp.mean(chain_vars, axis=0)
    b = half * jnp.var(chain_means, axis=0, ddof=1)
    var_plus = (half - 1) / half * w + b / half
    return jnp.sqrt(var_plus / w)


def _rank_normalize(x):
    """Joint rank-normalisation over (draws, chains): AVERAGE ranks ->
    Blom fractional offsets -> standard-normal quantiles (Vehtari et al.
    2021 eq. 14).  Average ranks (not ordinal) so ties — e.g. the binary
    indicator chains of tail-ESS — don't acquire spurious time order."""
    shape = x.shape
    flat = x.reshape((shape[0] * shape[1], -1))

    def avg_ranks(col):
        s = jnp.sort(col)
        lo = jnp.searchsorted(s, col, side="left")
        hi = jnp.searchsorted(s, col, side="right")
        return (lo + hi + 1).astype(jnp.float32) / 2.0

    ranks = jax.vmap(avg_ranks, in_axes=1, out_axes=1)(flat)
    u = (ranks - 0.375) / (flat.shape[0] + 0.25)
    z = jax.scipy.special.ndtri(u)
    return z.reshape(shape)


def rhat_rank(chain_or_array, field: str = "value"):
    """Rank-normalised split-R̂ (Vehtari, Gelman, Simpson, Carpenter &
    Bürkner 2021): max of bulk (rank-normalised) and tail (folded
    rank-normalised) split-R̂ — robust to heavy tails and nonstationary
    variance, the modern convergence gate (threshold 1.01).

    Input (n, m, ...) -> output (...)."""
    x = extract_f32(chain_or_array, field)
    bulk = rhat(_rank_normalize(x))
    folded = jnp.abs(x - jnp.median(x.reshape((-1,) + x.shape[2:]), axis=0))
    tail = rhat(_rank_normalize(folded))
    return jnp.maximum(bulk, tail)


def ess_bulk(chain_or_array, field: str = "value", **kwargs):
    """Bulk-ESS: ESS of the rank-normalised draws (Vehtari et al. 2021) —
    a center-of-distribution effective sample size robust to heavy tails."""
    from klara_tpu.stats.mcvar import ess

    x = extract_f32(chain_or_array, field)
    return ess(_rank_normalize(x), **kwargs)


def ess_tail(chain_or_array, field: str = "value", quantiles=(0.05, 0.95), **kwargs):
    """Tail-ESS: minimum ESS of the rank-normalised indicator chains for
    the given tail quantiles (Vehtari et al. 2021) — measures how well the
    tails are resolved."""
    from klara_tpu.stats.mcvar import ess

    x = extract_f32(chain_or_array, field)
    out = None
    for q in quantiles:
        qv = jnp.quantile(x.reshape((-1,) + x.shape[2:]), q, axis=0)
        ind = (x <= qv).astype(jnp.float32)
        e = ess(_rank_normalize(ind), **kwargs)
        out = e if out is None else jnp.minimum(out, e)
    return out
