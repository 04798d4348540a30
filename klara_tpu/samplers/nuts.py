"""No-U-Turn Sampler (NUTS), iterative jit-compatible formulation.

Reference: src/samplers/NUTS.jl (struct: leapstep=0.1, maxδ=1000,
maxndoublings=5; `uturn` at :392-396; recursive `build_tree!` at
:398-949) and kernels src/samplers/iterate/NUTS.jl:230-457.  Klara
implements the original Hoffman-Gelman (2014) slice-variable algorithm:

  * log-slice variable u = log(rand()) + H₀  (iterate/NUTS.jl:261);
  * doubling loop `while s && j < maxndoublings`: pick direction v = ±1,
    build a depth-j subtree from the corresponding tree end; if the
    subtree is valid, replace the proposal with prob n'/n; accumulate
    n += n'; stop on divergence (u ≥ maxδ + H') or u-turn;
  * leaf counts n' = 𝕀(u ≤ H'), validity s' = u < maxδ + H'
    (NUTS.jl:420-421);
  * dual-averaging variant accumulates (a, na) = (Σ min(1, e^{H'−H₀}), #leaves)
    through the tree and adapts ε with a/na (iterate/NUTS.jl:433-437);
  * diagnostics: accept (proposal replaced), ndoublings, a, na
    (iterate/NUTS.jl:392-409).

The recursion cannot run under `jit`/`vmap`, so the tree is built
**iteratively**: the doubling loop is a `lax.while_loop`, and each
depth-j subtree is itself a `lax.while_loop` over its 2^j leapfrog
leaves with

  * *progressive sampling*: at leaf ℓ the running subtree candidate is
    replaced with prob n_ℓ / (n_acc + n_ℓ) — distributionally identical
    to Klara's pairwise binary merges (both draw a leaf with probability
    proportional to its count);
  * *checkpoint-stack u-turn detection*: even-indexed leaves are stored
    in a popcount-indexed stack of ≤ max_doublings+1 slots; after each
    odd leaf k, the u-turn criterion is evaluated against the stored
    left ends of every completed power-of-two subtree ending at k
    (sizes 2^m for each m with 2^m | (k+1)).  This reproduces exactly
    the set of (left, right) u-turn checks performed by the reference's
    recursive merges.

Per-chain trajectory lengths diverge; under `vmap` each while_loop runs
to the batch maximum (all chains retire when the slowest chain's tree
terminates).

Two tree implementations, selected by ``tree_impl``:

  * ``'static'`` (default for max_doublings <= 6): the doubling loop and
    every subtree are **unrolled in Python** into one straight-line
    program of 2^max_doublings - 1 leapfrogs.  An ``alive`` mask threads
    through the leaves in visit order, exactly reproducing the looped
    semantics (leaves after a divergence/u-turn stop contributing);
    u-turn checks happen at the recursion's merge nodes as plain (D,)
    dot products on the subtree boundary states.  It drops the looped
    form's per-leaf (S, D) checkpoint-stack arithmetic, and at large
    batch the while_loops run to the lockstep maximum anyway, so
    unrolling loses nothing.  The static/looped ratio on the H100 is
    not measured yet (ROADMAP A1).
  * ``'looped'``: the while_loop + checkpoint-stack form described
    above — compact compile for deep trees (max_doublings > 6) and true
    early exit when ALL chains' trees terminate (relevant at small
    chain counts).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from klara_tpu.core.target import Target
from klara_tpu.samplers.base import Info, Sampler
from klara_tpu.samplers.hamiltonian import (
    PhasePoint,
    find_reasonable_step_size,
    hamiltonian,
    leapfrog_step,
    sample_momentum,
)
from klara_tpu.tuners.tuners import DualAveragingTuner, TuneState


class NUTSState(NamedTuple):
    position: jax.Array
    logtarget: jax.Array
    gradlogtarget: jax.Array
    inv_mass: jax.Array     # diagonal inverse mass (1 = identity, reference)
    tune: TuneState


class _Candidate(NamedTuple):
    position: jax.Array
    logtarget: jax.Array
    gradlogtarget: jax.Array


def _popcount(k, nbits):
    c = jnp.zeros_like(k)
    for i in range(nbits):
        c = c + ((k >> i) & 1)
    return c


def _trailing_zeros(k, nbits):
    """Number of trailing zero bits of k (k >= 1)."""
    tz = jnp.zeros_like(k)
    done = jnp.zeros_like(k, dtype=bool)
    for i in range(nbits):
        bit = (k >> i) & 1
        done = done | (bit == 1)
        tz = tz + jnp.where(done, 0, 1)
    return tz


def _turn(pos_hi, mom_hi, pos_lo, mom_lo, v, inv_mass):
    """U-turn criterion between trajectory-ordered ends (reference
    NUTS.jl:392-396).  `hi` is the later point along build direction v;
    d = (θ₊ − θ₋) with chronological orientation restored via v.  With a
    diagonal mass matrix the criterion uses velocities M⁻¹p."""
    d = v * (pos_hi - pos_lo)
    # sum-contraction (not jnp.dot) so rank>=2 positions work unflattened
    return (jnp.sum(d * (inv_mass * mom_hi)) < 0.0) | (
        jnp.sum(d * (inv_mass * mom_lo)) < 0.0
    )


@dataclasses.dataclass(frozen=True)
class NUTS(Sampler):
    leapstep: float = 0.1
    maxdelta: float = 1000.0
    max_doublings: int = 5
    # dtype for the u-turn checkpoint stack carried through the leaf loop
    # ((S, D) positions+momenta per chain — the dominant while_loop carry
    # traffic at large chain counts).  'bfloat16' halves that memory traffic;
    # the u-turn dot products still reduce in f32.  Stopping decisions may
    # differ from f32 only when a checkpoint inner product sits within
    # bf16 rounding of zero.  Caveat: rounding only the STORED endpoint
    # (the current point stays f32) makes the stopping rule slightly
    # direction-asymmetric, which weakens the usual reversibility
    # argument for slice NUTS near-zero inner products — opt-in,
    # non-default, practically negligible, but not exactly the textbook
    # kernel.  Only used by tree_impl='looped'.
    ckpt_dtype: str = "float32"
    # 'static' | 'looped' | 'auto' (see module docstring).  'auto' picks
    # the static tree from max_doublings alone; note the static form
    # always executes all 2^d - 1 leapfrogs with no early exit, so at
    # SMALL chain counts (e.g. the reference's single-chain regime, or
    # anything where the chip is not saturated) the looped form's
    # per-chain early termination can win — pass tree_impl='looped'
    # explicitly when batch size is small at job construction.
    tree_impl: str = "auto"

    tuner_statistic = "accept_stat"

    def __post_init__(self):
        if self.tree_impl not in ("auto", "static", "looped"):
            raise ValueError(
                f"tree_impl must be 'auto', 'static' or 'looped', "
                f"got {self.tree_impl!r}"
            )
        jnp.dtype(self.ckpt_dtype)  # fail fast on a typo'd dtype string

    def _use_static(self):
        if self.tree_impl == "auto":
            return self.max_doublings <= 6
        return self.tree_impl == "static"

    def default_step_size(self):
        return self.leapstep

    def init(self, key, target: Target, position, step_size=None, tuner=None):
        position = jnp.asarray(position)
        lt, grad = target.logdensity_and_grad(position)
        tuner = tuner or self.default_tuner()
        if step_size is not None:
            step0 = jnp.asarray(step_size, position.dtype)
        elif isinstance(tuner, DualAveragingTuner):
            step0 = find_reasonable_step_size(key, target, position)
        else:
            step0 = jnp.asarray(self.leapstep, position.dtype)
        tune = tuner.init(step0)
        if isinstance(tuner, DualAveragingTuner):
            tune = tuner.set_mu_from_step(tune)
        return NUTSState(position, lt, grad, jnp.ones_like(position), tune)

    # ------------------------------------------------------------ subtree
    def _build_subtree(
        self, target, key, z_start: PhasePoint, v, depth, eps, u, h0, inv_mass
    ):
        """Iteratively build a subtree of 2^depth leaves in direction v.

        Returns (z_end, candidate, n', s', a', na', divergent')."""
        nbits = self.max_doublings + 2
        f = z_start.position.dtype
        # the (S, D) checkpoint math below assumes rank-1 positions: lift
        # 0-d to (1,) and FLATTEN rank>=2 to 1-d (the u-turn dot products
        # sum over all elements, so flattening is mathematically identical);
        # identity (and hence trace-identical) for the common 1-d case
        _lift = (
            (lambda t: t)
            if z_start.position.ndim == 1
            else (lambda t: t.reshape(-1))
        )

        n_leaves = jnp.left_shift(jnp.int32(1), depth)
        cdt = jnp.dtype(self.ckpt_dtype)
        ckpt_pos = jnp.zeros(
            (self.max_doublings + 1,) + _lift(z_start.position).shape, cdt
        )
        ckpt_mom = jnp.zeros_like(ckpt_pos)

        cand0 = _Candidate(z_start.position, z_start.logtarget, z_start.gradlogtarget)

        def cond(carry):
            k, _, _, _, s, _, _, _, _, _, _ = carry
            return (k < n_leaves) & s

        import os
        import sys as _sys

        # Probe-only ablation switches for runtime attribution of the
        # LOOPED tree (the r04 measurement behind the static-tree
        # default: ablating 'uturn' here showed the per-leaf checkpoint
        # arithmetic was 81% of looped step time).  'uturn' removes the
        # u-turn math, 'cand' freezes the candidate — NOT valid
        # samplers.  Has no effect on tree_impl='static'.  A stray env
        # var must not silently corrupt production sampling, so an
        # active ablation screams at every trace (ADVICE r04).
        _ablate = os.environ.get("KLARA_NUTS_ABLATE", "")
        if _ablate:
            print(
                f"WARNING: KLARA_NUTS_ABLATE={_ablate!r} is active — the "
                "looped NUTS tree is running a probe-only ABLATED kernel "
                "that is NOT a valid sampler (unset the env var unless "
                "you are running benchmarks/nuts_bisect.py)",
                file=_sys.stderr, flush=True,
            )

        def body(carry):
            k, z, cand, n_acc, s, a, na, div, cp, cm, key = carry
            z = leapfrog_step(target, z, v * eps, inv_mass)
            h = hamiltonian(z.logtarget, z.momentum, inv_mass)
            h = jnp.where(jnp.isnan(h), -jnp.inf, h)

            n_leaf = (u <= h).astype(jnp.int32)
            s_leaf = u < self.maxdelta + h  # divergence bound (NUTS.jl:421)

            key, k_take = jax.random.split(key)
            denom = (n_acc + n_leaf).astype(f)
            take = (n_leaf > 0) & (
                jax.random.uniform(k_take, dtype=f) * denom < n_leaf.astype(f)
            )
            if "cand" not in _ablate:
                cand = jax.tree.map(
                    lambda new, old: jnp.where(take, new, old),
                    _Candidate(z.position, z.logtarget, z.gradlogtarget),
                    cand,
                )
            n_acc = n_acc + n_leaf
            a = a + jnp.minimum(1.0, jnp.exp(jnp.minimum(h - h0, 0.0)))
            na = na + 1

            # --- checkpointed u-turn detection -------------------------
            # One-hot writes and masked-reduction reads instead of
            # per-chain dynamic scatter/gather: under vmap those lower to
            # scatter/gather HLO with batched indices, which compile
            # slowly and run slower than S x D vector math (S =
            # max_doublings+1 slots).
            is_even = (k % 2) == 0
            slot = jnp.clip(_popcount(k, nbits), 0, self.max_doublings)
            write = (jnp.arange(cp.shape[0]) == slot) & is_even   # (S,)
            p1, m1, im1 = _lift(z.position), _lift(z.momentum), _lift(inv_mass)
            if "uturn" in _ablate:
                turned = jnp.asarray(False)
            else:
                cp = jnp.where(write[:, None], p1[None, :].astype(cp.dtype), cp)
                cm = jnp.where(write[:, None], m1[None, :].astype(cm.dtype), cm)

                # u-turn criterion of the current point against EVERY stored
                # checkpoint at once (reference NUTS.jl:392-396 per pair):
                # d = v*(z - cp[s]); turn_s = d.(M^-1 p_z) < 0 or d.(M^-1 cm[s]) < 0
                # Both dots as elementwise multiply+reduce — a dot_general
                # here becomes a per-chain batched (S,D)@(D,1) matvec
                # under vmap: thousands of tiny matmuls per leaf.
                d_all = v * (p1[None, :] - cp.astype(f))          # (S, D)
                dot_hi = jnp.sum(d_all * (im1 * m1)[None, :], axis=-1)  # (S,)
                dot_lo = jnp.sum(d_all * (im1[None, :] * cm.astype(f)), axis=-1)
                turned_all = (dot_hi < 0.0) | (dot_lo < 0.0)      # (S,)

                turned = jnp.asarray(False)
                big_m = _trailing_zeros(k + 1, nbits)  # sizes 2^1..2^big_m
                for m in range(1, self.max_doublings + 1):
                    active = (~is_even) & (m <= big_m)
                    left = k + 1 - (1 << m)
                    lslot = jnp.clip(
                        _popcount(left, nbits), 0, self.max_doublings
                    )
                    t_m = jnp.any(
                        turned_all & (jnp.arange(cp.shape[0]) == lslot)
                    )
                    turned = turned | (active & t_m)

            s = s_leaf & ~turned
            div = div | ~s_leaf
            return (k + 1, z, cand, n_acc, s, a, na, div, cp, cm, key)

        init = (
            jnp.int32(0),
            z_start,
            cand0,
            jnp.int32(0),
            jnp.asarray(True),
            jnp.zeros((), f),
            jnp.int32(0),
            jnp.asarray(False),
            ckpt_pos,
            ckpt_mom,
            key,
        )
        k, z, cand, n_acc, s, a, na, div, _, _, _ = jax.lax.while_loop(cond, body, init)
        return z, cand, n_acc, s, a, na, div

    # ------------------------------------------------- static (unrolled)
    def _static_leaf(self, target, k_take, z_prev, v, eps, u, h0, inv_mass, acc):
        """One leaf, masked by acc['alive'] — contributes to n/cand/a/na/
        div exactly iff the looped form would have executed it."""
        f = z_prev.position.dtype
        z = leapfrog_step(target, z_prev, v * eps, inv_mass)
        h = hamiltonian(z.logtarget, z.momentum, inv_mass)
        h = jnp.where(jnp.isnan(h), -jnp.inf, h)

        alive = acc["alive"]
        n_leaf = ((u <= h) & alive).astype(jnp.int32)
        s_leaf = u < self.maxdelta + h  # divergence bound (NUTS.jl:421)

        denom = (acc["n"] + n_leaf).astype(f)
        take = (n_leaf > 0) & (
            jax.random.uniform(k_take, dtype=f) * denom < n_leaf.astype(f)
        )
        cand = jax.tree.map(
            lambda new, old: jnp.where(take, new, old),
            _Candidate(z.position, z.logtarget, z.gradlogtarget),
            acc["cand"],
        )
        acc = dict(
            acc,
            cand=cand,
            n=acc["n"] + n_leaf,
            a=acc["a"]
            + jnp.where(
                alive, jnp.minimum(1.0, jnp.exp(jnp.minimum(h - h0, 0.0))), 0.0
            ),
            na=acc["na"] + alive.astype(jnp.int32),
            div=acc["div"] | (alive & ~s_leaf),
            alive=alive & s_leaf,
        )
        return z, z, acc

    def _static_subtree(self, target, key, depth, z_in, v, eps, u, h0, inv_mass, acc):
        """Unrolled depth-`depth` subtree in direction v.

        Returns (z_start, z_end, acc): the subtree's boundary leaf states
        (for merge-node u-turn checks) and the threaded accumulator.
        Merge checks are plain (D,) dot products on those boundaries —
        the same (left, right) pair set the looped checkpoint stack
        evaluates, without any (S, D) per-leaf arithmetic."""
        if depth == 0:
            return self._static_leaf(
                target, key, z_in, v, eps, u, h0, inv_mass, acc
            )
        k_l, k_r = jax.random.split(key)
        zs_l, ze_l, acc = self._static_subtree(
            target, k_l, depth - 1, z_in, v, eps, u, h0, inv_mass, acc
        )
        zs_r, ze_r, acc = self._static_subtree(
            target, k_r, depth - 1, ze_l, v, eps, u, h0, inv_mass, acc
        )
        turned = _turn(
            ze_r.position, ze_r.momentum, zs_l.position, zs_l.momentum, v, inv_mass
        )
        acc = dict(acc, alive=acc["alive"] & ~turned)
        return zs_l, ze_r, acc

    def _step_static(self, key, state: NUTSState, target: Target):
        """Statically-unrolled NUTS step — same sampler as the looped
        form (identical contribution semantics via the alive mask), with
        an independent RNG stream."""
        k_mom, k_slice, k_loop = jax.random.split(key, 3)
        x, lt, grad = state.position, state.logtarget, state.gradlogtarget
        eps = state.tune.step
        inv_mass = state.inv_mass
        f = x.dtype

        p0 = sample_momentum(k_mom, x, inv_mass)
        h0 = hamiltonian(lt, p0, inv_mass)
        u = jnp.log(jax.random.uniform(k_slice, dtype=f)) + h0

        z0 = PhasePoint(x, p0, lt, grad)
        z_minus, z_plus = z0, z0
        acc = {
            "cand": _Candidate(x, lt, grad),
            "n": jnp.int32(1),
            "a": jnp.zeros((), f),
            "na": jnp.int32(0),
            "div": jnp.asarray(False),
            "alive": jnp.asarray(True),
        }
        ndoubl = jnp.int32(0)
        updated = jnp.asarray(False)

        for j in range(self.max_doublings):
            k_loop, k_v, k_sub, k_swap = jax.random.split(k_loop, 4)
            entry = acc["alive"]
            v = jnp.where(jax.random.bernoulli(k_v), 1.0, -1.0).astype(f)

            start = jax.tree.map(
                lambda m, p: jnp.where(v < 0, m, p), z_minus, z_plus
            )
            # the subtree streams its OWN candidate over a subtree-local
            # count (matching _build_subtree's cand0/n_acc=0), then the
            # doubling level swaps it in with prob n'/n
            n_before = acc["n"]
            cand_before = acc["cand"]
            acc = dict(
                acc,
                n=jnp.int32(0),
                cand=_Candidate(
                    start.position, start.logtarget, start.gradlogtarget
                ),
            )
            _, z_end, acc = self._static_subtree(
                target, k_sub, j, start, v, eps, u, h0, inv_mass, acc
            )
            s_p = acc["alive"]  # subtree finished without divergence/u-turn
            n_p = acc["n"]
            cand_p = acc["cand"]

            # edges update for every EXECUTED doubling (incl. a failing
            # one), matching the looped body which runs to completion
            # before s is re-evaluated
            z_minus = jax.tree.map(
                lambda e, old: jnp.where(entry & (v < 0), e, old), z_end, z_minus
            )
            z_plus = jax.tree.map(
                lambda e, old: jnp.where(entry & (v >= 0), e, old), z_end, z_plus
            )

            # replace proposal with prob n'/n (iterate/NUTS.jl:361)
            swap = s_p & (
                jax.random.uniform(k_swap, dtype=f)
                < n_p.astype(f) / n_before.astype(f)
            )
            acc = dict(
                acc,
                n=n_before + n_p,
                cand=jax.tree.map(
                    lambda new, old: jnp.where(swap, new, old),
                    cand_p,
                    cand_before,
                ),
            )
            updated = updated | swap
            ndoubl = ndoubl + entry.astype(jnp.int32)

            # whole-tree u-turn check (iterate/NUTS.jl:373)
            whole_turn = _turn(
                z_plus.position,
                z_plus.momentum,
                z_minus.position,
                z_minus.momentum,
                1.0,
                inv_mass,
            )
            acc = dict(acc, alive=acc["alive"] & ~whole_turn)

        cand = acc["cand"]
        new_state = NUTSState(
            cand.position, cand.logtarget, cand.gradlogtarget, inv_mass, state.tune
        )
        na = acc["na"]
        accept_stat = acc["a"] / jnp.maximum(na, 1).astype(f)
        info = Info(
            accept=updated,
            accept_stat=accept_stat,
            logtarget=cand.logtarget,
            extras={
                "ndoublings": ndoubl,
                "a": acc["a"],
                "na": na,
                "divergent": acc["div"],
            },
        )
        return new_state, info

    # --------------------------------------------------------------- step
    def step(self, key, state: NUTSState, target: Target):
        if self._use_static():
            return self._step_static(key, state, target)
        return self._step_looped(key, state, target)

    def _step_looped(self, key, state: NUTSState, target: Target):
        k_mom, k_slice, k_loop = jax.random.split(key, 3)
        x, lt, grad = state.position, state.logtarget, state.gradlogtarget
        eps = state.tune.step
        inv_mass = state.inv_mass
        f = x.dtype

        p0 = sample_momentum(k_mom, x, inv_mass)
        h0 = hamiltonian(lt, p0, inv_mass)
        # log-slice variable u = log(rand()) + H0 (iterate/NUTS.jl:261)
        u = jnp.log(jax.random.uniform(k_slice, dtype=f)) + h0

        z0 = PhasePoint(x, p0, lt, grad)
        cand0 = _Candidate(x, lt, grad)

        def cond(carry):
            _, _, _, _, n, s, j, _, _, _, _ = carry
            return s & (j < self.max_doublings)

        def body(carry):
            key, z_minus, z_plus, cand, n, s, j, a, na, updated, div = carry
            key, k_v, k_sub, k_swap = jax.random.split(key, 4)
            v = jnp.where(jax.random.bernoulli(k_v), 1.0, -1.0).astype(f)

            start = jax.tree.map(
                lambda m, p: jnp.where(v < 0, m, p), z_minus, z_plus
            )
            z_end, cand_p, n_p, s_p, a_p, na_p, div_p = self._build_subtree(
                target, k_sub, start, v, j, eps, u, h0, inv_mass
            )
            z_minus = jax.tree.map(
                lambda e, old: jnp.where(v < 0, e, old), z_end, z_minus
            )
            z_plus = jax.tree.map(
                lambda e, old: jnp.where(v < 0, old, e), z_end, z_plus
            )

            # replace proposal with prob n'/n (iterate/NUTS.jl:361)
            swap = s_p & (
                jax.random.uniform(k_swap, dtype=f) < n_p.astype(f) / n.astype(f)
            )
            cand = jax.tree.map(lambda new, old: jnp.where(swap, new, old), cand_p, cand)
            updated = updated | swap

            n = n + n_p
            j = j + 1
            s = s_p & ~_turn(
                z_plus.position,
                z_plus.momentum,
                z_minus.position,
                z_minus.momentum,
                1.0,
                inv_mass,
            )
            a = a + a_p
            na = na + na_p
            div = div | div_p
            return (key, z_minus, z_plus, cand, n, s, j, a, na, updated, div)

        init = (
            k_loop,
            z0,
            z0,
            cand0,
            jnp.int32(1),
            jnp.asarray(True),
            jnp.int32(0),
            jnp.zeros((), f),
            jnp.int32(0),
            jnp.asarray(False),
            jnp.asarray(False),
        )
        _, _, _, cand, n, s, j, a, na, updated, div = jax.lax.while_loop(
            cond, body, init
        )

        new_state = NUTSState(
            cand.position, cand.logtarget, cand.gradlogtarget, inv_mass, state.tune
        )
        accept_stat = a / jnp.maximum(na, 1).astype(f)
        info = Info(
            accept=updated,
            accept_stat=accept_stat,
            logtarget=cand.logtarget,
            extras={"ndoublings": j, "a": a, "na": na, "divergent": div},
        )
        return new_state, info
