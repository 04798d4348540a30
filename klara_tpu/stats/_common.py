"""Shared field extraction for the stats layer.

Every stats entry point accepts a Chain/GibbsChains (which carry
``.samples``), a plain ``samples`` dict keyed by field, or a raw array.  Extraction also PROMOTES sub-f32 floats
to f32: with reduced-precision trace storage (``MCJob``/``GibbsJob``
``trace_dtype='bfloat16'``) the draws arrive bf16, and reducing them
with a bf16 accumulator (8-bit mantissa) silently corrupts the result —
once a running sum is ~256x an element, further additions round away
entirely, so a multi-million-draw mean/autocovariance would be wrong by
far more than the ~0.4% storage rounding.  Promoting once here keeps
every estimator's arithmetic in f32 regardless of how the trace was
stored.
"""

from __future__ import annotations

import jax.numpy as jnp


def extract_f32(chain_or_array, field: str = "value"):
    x = (
        chain_or_array[field]
        if hasattr(chain_or_array, "samples") or isinstance(chain_or_array, dict)
        else chain_or_array
    )
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.floating) and jnp.finfo(x.dtype).bits < 32:
        x = x.astype(jnp.float32)
    return x
