"""Slice sampler (univariate + coordinate-wise multivariate, Neal 2003).

Reference: src/samplers/SliceSampler.jl:22-36 (widths, stepout=true) and
kernel src/samplers/iterate/SliceSampler.jl:60-119:

  for each coordinate i:
    log u' = log(rand()) + logπ(x)
    r ~ U(0,1);  L = x_i − r·w_i;  R = x_i + (1−r)·w_i
    step-out:  while logπ(x|L) > log u': L -= w_i   (and same for R)
    shrink:    repeat x_i' ~ U(L, R); accept if logπ > log u',
               else shrink the violated side to x_i'

Formulation: the unbounded reference loops become `lax.while_loop`s
with iteration caps (``max_stepouts``, ``max_shrinks``) — the standard
bounded-iteration slice formulation.  If the shrink loop exhausts its cap
the coordinate stays put (guaranteed-correct fallback: the current point
is always in the slice).  The coordinate sweep is a `lax.fori_loop`;
everything vmaps over chains.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from klara_tpu.core.target import Target
from klara_tpu.samplers.base import Info, Sampler
from klara_tpu.tuners.tuners import TuneState


class SliceState(NamedTuple):
    position: jax.Array
    logtarget: jax.Array
    tune: TuneState


@dataclasses.dataclass(frozen=True)
class SliceSampler(Sampler):
    widths: object = 1.0        # scalar or per-coordinate vector
    stepout: bool = True
    max_stepouts: int = 100
    max_shrinks: int = 100

    def init(self, key, target: Target, position, step_size=None, tuner=None):
        position = jnp.asarray(position)
        lt = target.logdensity(position)
        tuner = tuner or self.default_tuner()
        tune = tuner.init(jnp.asarray(1.0, position.dtype))
        return SliceState(position, lt, tune)

    def step(self, key, state: SliceState, target: Target):
        x0, lt0 = state.position, state.logtarget
        f = x0.dtype
        d = x0.shape[-1]
        widths = jnp.broadcast_to(jnp.asarray(self.widths, f), x0.shape)

        def coord_body(i, carry):
            x, lt, key = carry
            key, k_u, k_r, k_shrink = jax.random.split(key, 4)
            w = widths[i]
            xi = x[i]
            logu = jnp.log(jax.random.uniform(k_u, dtype=f)) + lt

            r = jax.random.uniform(k_r, dtype=f)
            left = xi - r * w
            right = xi + (1.0 - r) * w

            def lt_at(v):
                return target.logdensity(x.at[i].set(v))

            if self.stepout:
                def so_cond(c):
                    v, it = c
                    return (lt_at(v) > logu) & (it < self.max_stepouts)

                left, _ = jax.lax.while_loop(
                    so_cond, lambda c: (c[0] - w, c[1] + 1), (left, jnp.int32(0))
                )
                right, _ = jax.lax.while_loop(
                    so_cond, lambda c: (c[0] + w, c[1] + 1), (right, jnp.int32(0))
                )

            # shrinkage loop
            def sh_cond(c):
                _, _, _, accepted, it, _ = c
                return (~accepted) & (it < self.max_shrinks)

            def sh_body(c):
                l, rr, prop, _, it, k = c
                k, k_draw = jax.random.split(k)
                prop = l + jax.random.uniform(k_draw, dtype=f) * (rr - l)
                ok = lt_at(prop) > logu
                l = jnp.where(~ok & (prop < xi), prop, l)
                rr = jnp.where(~ok & (prop > xi), prop, rr)
                return (l, rr, prop, ok, it + 1, k)

            _, _, prop, accepted, _, _ = jax.lax.while_loop(
                sh_cond, sh_body, (left, right, xi, jnp.asarray(False), jnp.int32(0), k_shrink)
            )
            xi_new = jnp.where(accepted, prop, xi)
            x = x.at[i].set(xi_new)
            lt = jnp.where(accepted, lt_at(xi_new), lt)
            return (x, lt, key)

        x, lt, _ = jax.lax.fori_loop(0, d, coord_body, (x0, lt0, key))
        new_state = SliceState(x, lt, state.tune)
        moved = jnp.any(x != x0)
        info = Info(
            accept=moved, accept_stat=moved.astype(f), logtarget=lt
        )
        return new_state, info
