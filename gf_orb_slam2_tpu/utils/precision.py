"""Full-f32 contraction helpers for jitted device code.

On an NVIDIA GPU an f32 dot or convolution left at default precision may run
in TF32, which keeps a 10-bit mantissa (about three decimal digits). That is
catastrophic for 3x3/4x4 pose math and normal equations, and it turns a
one-hot "pick" into a rounding of the value it picks. Every f32 contraction
in jitted code therefore states its precision: through these helpers, or as
an explicit bf16 cast with f32 accumulation where rounding is harmless.
tests/test_precision.py lowers the hot programs and rejects any f32
dot_general or convolution left at default precision.
"""
import functools

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

einsum = functools.partial(jnp.einsum, precision=HIGHEST)
matmul = functools.partial(jnp.matmul, precision=HIGHEST)
