"""Hamiltonian-dynamics utilities: leapfrog, Hamiltonian, step-size search.

Reference: src/samplers/samplers.jl:101-202 —
  * ``hamiltonian(logtarget, momentum) = logtarget − ½‖p‖²`` (line 101-103);
  * ``leapfrog!`` (105-134);
  * ``initialize_step!`` doubling/halving heuristic stepsize search
    (136-202; Hoffman-Gelman Algorithm 4).

Design: the leapfrog trajectory runs as `lax.fori_loop` with a traced
trip count (needed because the dual-averaging HMC recomputes
nleaps = round(λ/ε) per iteration, src/samplers/iterate/HMC.jl:142-144),
and the step-size search as `lax.while_loop`.  Everything vmaps over
chains; under vmap the loops run to the per-batch maximum, so every chain
pays for the longest trajectory in the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from klara_tpu.core.target import Target


def hamiltonian(logtarget, momentum, inv_mass=None):
    """H(x, p) stored in log-target convention (higher is better).

    With a diagonal mass matrix M (a many-chain extension — the reference
    always uses identity mass, samplers.jl:101-103), the kinetic term is
    ½ pᵀM⁻¹p."""
    if inv_mass is None:
        return logtarget - 0.5 * jnp.sum(jnp.square(momentum))
    return logtarget - 0.5 * jnp.sum(inv_mass * jnp.square(momentum))


def sample_momentum(key, position, inv_mass=None):
    """p ~ N(0, M): z / sqrt(M⁻¹) for diagonal M."""
    z = jax.random.normal(key, position.shape, position.dtype)
    if inv_mass is None:
        return z
    return z * jax.lax.rsqrt(inv_mass)


class PhasePoint(NamedTuple):
    position: jax.Array
    momentum: jax.Array
    logtarget: jax.Array
    gradlogtarget: jax.Array


def leapfrog_step(target: Target, pp: PhasePoint, eps, inv_mass=None) -> PhasePoint:
    """One leapfrog step (reference samplers.jl:105-134); with diagonal
    mass, the position update uses the velocity M⁻¹p."""
    p_half = pp.momentum + 0.5 * eps * pp.gradlogtarget
    vel = p_half if inv_mass is None else inv_mass * p_half
    x = pp.position + eps * vel
    lt, grad = target.logdensity_and_grad(x)
    p = p_half + 0.5 * eps * grad
    return PhasePoint(x, p, lt, grad)


def leapfrog(
    target: Target, pp: PhasePoint, eps, n_steps, inv_mass=None, unroll: int = 1
) -> PhasePoint:
    """n_steps leapfrog steps; n_steps may be a traced integer.

    unroll=1 by default: unrolling multiplies the straight-line code XLA
    compiles (compile time grows superlinearly with it), while the loop
    overhead is small next to a fused logreg value+grad; the trade-off is
    not measured on the H100.  Raise it only for targets whose grad eval
    is genuinely tiny."""

    def body(_, carry):
        return leapfrog_step(target, carry, eps, inv_mass)

    if isinstance(n_steps, int) and unroll > 1:
        return jax.lax.fori_loop(
            0, n_steps, body, pp, unroll=min(unroll, n_steps)
        )
    return jax.lax.fori_loop(0, n_steps, body, pp)


def find_reasonable_step_size(key, target: Target, position, max_iter=100):
    """Heuristic ε init by doubling/halving until the one-step acceptance
    probability crosses 0.5 (reference samplers.jl:136-202, HG Alg 4)."""
    position = jnp.asarray(position)
    lt, grad = target.logdensity_and_grad(position)
    p0 = jax.random.normal(key, position.shape, position.dtype)
    h0 = hamiltonian(lt, p0)
    eps0 = jnp.asarray(1.0, position.dtype)

    def ratio_for(eps):
        pp = leapfrog_step(target, PhasePoint(position, p0, lt, grad), eps)
        r = hamiltonian(pp.logtarget, pp.momentum) - h0
        return jnp.where(jnp.isnan(r), -jnp.inf, r)

    r0 = ratio_for(eps0)
    # a = +1 if the step is too small (accept prob > 0.5), else -1
    a = jnp.where(r0 > jnp.log(0.5), 1.0, -1.0)

    def cond(carry):
        eps, it = carry
        return (a * ratio_for(eps) > -a * jnp.log(2.0)) & (it < max_iter)

    def body(carry):
        eps, it = carry
        return eps * (2.0 ** a).astype(eps.dtype), it + 1

    eps, _ = jax.lax.while_loop(cond, body, (eps0, jnp.int32(0)))
    return eps
