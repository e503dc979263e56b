"""Fast counter-based RNG for the walk loop.

The walk loop needs one fresh batch of uniforms per iteration, so the
solver defaults to this stateless SplitMix32-style counter hash: ~12
elementwise u32 ops per value, computed the same way by the XLA step and,
in registers, by the fused walk kernel (``ops/pallas_walk.py``) — the two
backends draw identical uniforms. It passes the framework's statistical
solver gates (which compare MC estimates against analytic solutions at
4-sigma — exactly the property MC needs from its RNG).

Stream layout: ``value = mix3(lane ^ C1*stream ^ mix3(seed ^ C2*counter))``
— distinct walks/steps/streams decorrelate through two full avalanche
finalizers. ``jax.random`` remains available via ``SolverOptions
(rng="threefry")``.
"""

import numpy as np
import jax.numpy as jnp

__all__ = ["mix32", "counter_uniform", "counter_uniform_lanes",
           "C_STREAM", "C_COUNTER"]

# np.uint32, NOT jnp.uint32: module-level jnp constants initialize the
# JAX backend at package import, before a caller can choose the platform
# — and Pallas kernels cannot capture pre-created device arrays. numpy
# scalars promote identically inside traced arithmetic.
_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)
_C_STREAM = np.uint32(0x9E3779B9)   # golden-ratio odd constant
_C_COUNTER = np.uint32(0x85EBCA6B)
# public aliases: the Pallas kernel (ops/pallas_walk.py) builds its
# register-array hash from THESE constants — one source of truth for
# the draw-for-draw XLA/Pallas invariant
C_STREAM = _C_STREAM
C_COUNTER = _C_COUNTER
MIX_M1 = _M1
MIX_M2 = _M2


def mix32(x):
    """SplitMix32/murmur3-style 32-bit avalanche finalizer (vectorized)."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * _M1
    x = x ^ (x >> np.uint32(15))
    x = x * _M2
    x = x ^ (x >> np.uint32(16))
    return x


def counter_uniform_lanes(seed, counters, n_streams: int, lane_ids):
    """``(n_streams, L)`` uniforms from per-lane counters and lane ids.

    Unlike :func:`counter_uniform` (scalar counter = global loop
    iteration), the counter here is a *per-lane* value — e.g.
    ``walk_index * (max_steps + 2) + step_within_walk`` — so a walk's
    random sequence depends only on ``(lane_id, walk#, step#)``. Under
    common random numbers this keeps walk k of slot j at EVERY evaluation
    point on the same stream even after walks desynchronize in global
    iterations (otherwise only each slot's first walk is correlated).
    """
    seed = jnp.asarray(seed).astype(jnp.uint32)
    ctr = jnp.asarray(counters).astype(jnp.uint32)[None, :]
    lane = jnp.asarray(lane_ids).astype(jnp.uint32)[None, :]
    stream = (jnp.arange(n_streams, dtype=jnp.uint32) + jnp.uint32(1))[:, None]
    base = mix32(seed ^ (_C_COUNTER * ctr))
    h = mix32(lane ^ (_C_STREAM * stream) ^ base)
    return (h >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)


def counter_uniform(seed, counter, n_streams: int, lanes: int):
    """``(n_streams, lanes)`` uniforms in [0, 1) from (seed, counter).

    Args:
        seed: u32 scalar (traced or static).
        counter: u32/i32 scalar — e.g. the walk-loop iteration index.
        n_streams: static number of independent draws per lane.
        lanes: static lane count.
    """
    seed = jnp.asarray(seed).astype(jnp.uint32)
    counter = jnp.asarray(counter).astype(jnp.uint32)
    base = mix32(seed ^ (_C_COUNTER * counter))
    lane = jnp.arange(lanes, dtype=jnp.uint32)[None, :]
    stream = (jnp.arange(n_streams, dtype=jnp.uint32) + jnp.uint32(1))[:, None]
    h = mix32(lane ^ (_C_STREAM * stream) ^ base)
    return (h >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24)
