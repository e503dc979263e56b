"""Radial source/interior-point samplers for the 2D ball.

JAX rebuild of the reference's rejection-sampled radius caches
(``solvers/utils.py:64-217``). The reference fills a host-side 10k-entry
cache by rejection sampling a *wrong* density (``-log r`` instead of the
Green's-weighted area density ``-r log(r/R)``; see SURVEY.md §5 quirk 2-3)
and rescales unit samples by the ball radius even for the non-scale-
invariant screened kernel. Both are replaced with exact device-side
sampling:

* **Green's radial density** ``p(r) = r ln(R/r) / (R^2/4)`` on ``(0, R)``
  has CDF ``F(s) = s^2 (1 - 2 ln s)`` for ``s = r/R``, which is exactly the
  law of ``s = sqrt(U1 * U2)`` for independent uniforms (the density of
  ``V = U1*U2`` is ``-ln v``, and ``s = sqrt(V)``). One fused expression,
  no rejection, no cache, no bias.

* **Screened Green's radial density** ``p(r) ∝ r G_s(r; R, sigma_bar)`` is
  not scale invariant (its shape depends on ``z = R sqrt(sigma_bar)``). A
  per-lane table gather would need the table inside the fused walk kernel,
  so it ships two gather-free samplers, plain ``jnp`` code shared by the
  XLA step and the kernel, with one draw convention:

  - :func:`sample_screened_radius_exact` / ``_exact_rejection`` — exact
    two-regime rejection (``screened_sampler="exact"``), weight 1 on
    acceptance, importance-weighted finite-round cap;
  - :func:`sample_screened_radius_transport` — a fitted monotone transport
    map + exact importance weight (``screened_sampler="transport"``):
    loop-free straight-line code, one 4-uniform draw per sample, weight
    spread E[(w-1)^2] <= 3e-5 (coefficients generated and verified by
    ``tools/gen_transport_coeffs.py``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "sample_greens_radius",
    "sample_screened_radius_exact",
    "sample_screened_radius_transport",
    "greens_radial_pdf",
    "screened_radial_pdf",
]


def sample_greens_radius(R, u1, u2):
    """Exact sample of the Green's-weighted radius in a ball of radius R.

    ``r = R * sqrt(u1 * u2)`` has density ``r ln(R/r)/(R^2/4)`` — the
    normalized radial marginal of ``G(x, y)`` over the 2D ball. Replaces
    ``GreensDistribution2D`` (``solvers/utils.py:120-151``).
    """
    return R * jnp.sqrt(u1 * u2)


def greens_radial_pdf(r, R):
    """Normalized Green's radial density ``r ln(R/r) / (R^2/4)``."""
    rc = jnp.clip(r, 1e-12, R)
    return jnp.where((r > 0) & (r < R), rc * jnp.log(R / rc) / (R * R / 4.0), 0.0)


def sample_screened_radius_transport(draw, R, sigma_bar):
    """Exact screened-radius sample via a fitted TRANSPORT MAP plus an
    exact importance weight — the branch-free, loop-free fast sampler
    (``screened_sampler="transport"``). Returns ``(r, w)``.

    Replaces the per-step rejection loop (the measured dominant per-step
    cost at ``rejection_rounds=2``) with straight-line code shared by the
    XLA step and the Pallas kernel:

    * ``z = R sqrt(sigma_bar) <= Z_SW``: draw ``u``, warp
      ``v = sqrt(u)/(sqrt(u)+sqrt(1-u))`` (the closed-form inverse of the
      rational smoothstep ``m(v) = v^2/(v^2+(1-v)^2)``, whose quadratic
      endpoint contact absorbs the quantile function's sqrt singularities),
      and evaluate ``s = S(v; z)`` — a Chebyshev tensor fitted to the warped
      inverse CDF (``sampling/_transport_coeffs.py``, generated and
      VERIFIED monotone by ``tools/gen_transport_coeffs.py``). The proposal
      density ``q = m'(v)/S'(v)`` is exact for the monotone map, so the
      importance weight ``w = p(s; z)/q`` makes the draw EXACTLY unbiased
      for every z; the fit only controls the weight spread, measured
      worst-z ``E[(w-1)^2] ~ 3e-5`` (at the z ~ 11.5 seam; <= 5e-6
      elsewhere) — negligible even compounded over 1000-step walks.
      z below the fit range clamps to Z_LO and the weight absorbs the
      O(z^2) shape difference (measured 3.6e-6 at z = 1e-6).
    * ``z > Z_SW``: the reflection term is ~e^{-2z} and the ball
      truncation ~e^{-z}, so draw from the FREE density ``x K0(x)`` by its
      exact sech^2-mixture closed form ``x = -ln(u1 u2) sqrt(1 - u0^2)``
      (as in :func:`sample_screened_radius_exact`'s large-z branch) and
      weight ``w = (1 - K0(z) I0(x) / (I0(z) K0(x)))/ (1 - 1/I0(z))`` —
      no fit at all (E[(w-1)^2] = 4e-5 at z = 11.5, exactly 0 by z ~ 20).

    Weight contract (same as the rejection cap's): fold ``w`` into the
    walker weight; ``E[w f(r)] = E_p[f]`` exactly.

    Args:
        draw: ``draw(round_idx) -> (4, W) uniforms`` — same convention as
            ``_exact_rejection``; exactly one call ``draw(0)`` is made.
        R: ball radii. sigma_bar: screening majorant (scalar or per-lane).
    """
    from ._transport_coeffs import (
        A_RAT, COEFFS, OMEGA_R0, OMEGA_R1, Z_LO, Z_SW)
    from ..ops.bessel import i0e, k0e
    from ..ops.greens import _one_minus_inv_i0_scaled

    R = jnp.asarray(R, jnp.float32)
    sb = jnp.asarray(sigma_bar, jnp.float32)
    z = jnp.maximum(R * jnp.sqrt(sb), 1e-12)

    u4 = draw(jnp.int32(0))
    u = jnp.clip(u4[0], 1e-7, 1.0 - 1e-7)

    # ---- branch T: transport map at z_eff = clip(z, Z_LO, Z_SW) -------- #
    z_eff = jnp.clip(z, Z_LO, Z_SW)
    om = (2.0 * ((z_eff - A_RAT) / (z_eff + A_RAT) - OMEGA_R0)
          / (OMEGA_R1 - OMEGA_R0) - 1.0)
    su = jnp.sqrt(u)
    cu = jnp.sqrt(1.0 - u)
    v = su / (su + cu)
    tv = 2.0 * v - 1.0
    # Chebyshev basis in omega (recurrence), then contract the coefficient
    # rows (python-float constants — kernel-safe, no captured arrays)
    n_i = len(COEFFS)
    n_j = len(COEFFS[0])
    tw_prev = jnp.ones_like(om)
    tw_cur = om
    c = [row[0] + row[1] * om for row in COEFFS]
    for j in range(2, n_j):
        tw_prev, tw_cur = tw_cur, 2.0 * om * tw_cur - tw_prev
        for i in range(n_i):
            if COEFFS[i][j] != 0.0:
                c[i] = c[i] + COEFFS[i][j] * tw_cur
    # s = sum_i c_i T_i(tv) and S'(v) = 2 sum_i c_i T_i'(tv) via the
    # T/U recurrences (T_i' = i U_{i-1})
    t_prev = jnp.ones_like(tv)
    t_cur = tv
    u_prev = jnp.ones_like(tv)          # U_0
    u_cur = 2.0 * tv                    # U_1
    s_t = c[0] + c[1] * tv
    ds = c[1]                           # T_1' = U_0
    for i in range(2, n_i):
        t_prev, t_cur = t_cur, 2.0 * tv * t_cur - t_prev
        s_t = s_t + c[i] * t_cur
        ds = ds + (float(i) * c[i]) * u_cur
        u_prev, u_cur = u_cur, 2.0 * tv * u_cur - u_prev
    ds = 2.0 * ds                       # d(tv)/dv = 2
    mp = (2.0 * v * (1.0 - v)
          / jnp.square(v * v + (1.0 - v) * (1.0 - v)))

    # ---- branch F: exact free-density draw (z > Z_SW) ------------------ #
    u1 = jnp.maximum(u4[1], 1e-7)
    u2 = jnp.maximum(u4[2], 1e-7)
    u0 = u4[3]
    x_f = -jnp.log(u1 * u2) * jnp.sqrt(jnp.maximum(1.0 - u0 * u0, 1e-12))
    use_f = z > Z_SW
    s_raw = jnp.where(use_f, x_f / z, s_t)

    # ---- exact importance weight --------------------------------------- #
    invalid = s_raw >= 1.0              # beyond the ball: p = 0 -> w = 0
    s = jnp.clip(s_raw, 1e-7, 1.0)
    x = z * s
    i0e_z = i0e(z)
    k0e_z = k0e(z)
    i0e_x = i0e(x)
    k0e_x = k0e(x)
    ratio = (k0e_z * i0e_x) / (i0e_z * k0e_x) * jnp.exp(
        -2.0 * jnp.maximum(z - x, 0.0))
    one_m_ratio = jnp.maximum(1.0 - ratio, 0.0)
    norm = jnp.maximum(_one_minus_inv_i0_scaled(z, i0e_z), 1e-30)
    w_f = one_m_ratio / norm
    # p(s; z) = z^2 s K0(x) (1 - ratio) / norm;  q_T = m'(v)/S'(v)
    k0x = k0e_x * jnp.exp(-x)
    p = z * z * s * k0x * one_m_ratio / norm
    w_t = p * ds / jnp.maximum(mp, 1e-30)
    w = jnp.where(invalid, 0.0, jnp.where(use_f, w_f, w_t))
    return s * R, w


def _exact_rejection(draw, R, sigma_bar, max_rounds: int,
                     with_weight: bool = False):
    """Core two-regime rejection loop; ``draw(round) -> (4, W) uniforms``.

    See :func:`sample_screened_radius_exact` for the math.

    ``with_weight``: return ``(r, w)`` where ``w`` is an exact importance
    weight making a FINITE round cap unbiased. Rounds ``0..max_rounds-2``
    are ordinary rejection (``w = 1`` on acceptance); a lane still
    unaccepted entering round ``max_rounds-1`` takes that round's envelope
    candidate UNCONDITIONALLY with ``w = A(x) / a(z)``, where ``A`` is the
    acceptance probability and ``a(z) = E_env[A]`` the closed-form
    acceptance rate. Since the target density is ``p_env A / a`` (the
    Wronskian identity ``int_0^z x (K0 - c I0) dx = 1 - 1/I0(z)`` gives
    ``a`` in both regimes: ``4 (1 - 1/I0(z)) / z^2`` small-z,
    ``1 - 1/I0(z)`` large-z), ``E_env[w f(x)] = E_target[f]`` exactly —
    the old behavior (keep the candidate at weight 1) distorted the
    distribution toward the envelope instead.
    """
    R = jnp.asarray(R, jnp.float32)
    sb = jnp.asarray(sigma_bar, jnp.float32)
    sq = jnp.sqrt(sb)
    z = jnp.maximum(R * sq, 1e-12)
    small = z < 2.0

    from ..ops.bessel import i0e, k0e

    k0e_z = k0e(z)
    i0e_z = i0e(z)

    def accept_prob(x, s):
        ratio = (k0e_z * i0e(x)) / (i0e_z * k0e(x)) * jnp.exp(
            -2.0 * jnp.maximum(z - x, 0.0)
        )
        k0x = k0e(x) * jnp.exp(-x)
        num = k0x * (1.0 - ratio)
        ln_s = -jnp.log(jnp.clip(s, 1e-12, 1.0 - 1e-7))
        p_small = jnp.clip(num / jnp.maximum(ln_s, 1e-12), 0.0, 1.0)
        p_large = jnp.where(x <= z, jnp.clip(1.0 - ratio, 0.0, 1.0), 0.0)
        return jnp.where(small, p_small, p_large)

    if with_weight:
        # closed-form acceptance rate a(z) = E_env[accept_prob], reusing
        # the i0e(z) already computed for the acceptance test
        from ..ops.greens import _one_minus_inv_i0_scaled

        p_ii = _one_minus_inv_i0_scaled(z, i0e_z)
        a_rate = jnp.maximum(
            jnp.where(small, 4.0 * p_ii / (z * z), p_ii), 1e-12
        )

    def candidates(u):
        u0 = jnp.maximum(u[0], 1e-7)
        u1 = jnp.maximum(u[1], 1e-7)
        u2 = jnp.maximum(u[2], 1e-7)
        s_small = jnp.sqrt(u0 * u1)
        x_small = z * s_small
        x_large = -jnp.log(u1 * u2) * jnp.sqrt(
            jnp.maximum(1.0 - u0 * u0, 1e-12)
        )
        x = jnp.where(small, x_small, x_large)
        s = jnp.where(small, s_small, x_large / z)
        return x, s, u[3]

    x0, s0, ua0 = candidates(draw(jnp.int32(0)))
    # round-0 candidate, saved before any redraw round can replace it: for
    # z below meaningful screening (``tiny`` at the bottom) the small-z
    # candidate sqrt(U0 U1) IS the exact unscreened closed form, so the
    # fallback reuses this draw instead of paying a dedicated 4-stream
    # draw(-997) every step (the old extra call was discarded on every
    # non-tiny lane; dropping it leaves non-tiny lanes bit-identical)
    s_round0 = s0
    A0 = accept_prob(x0, s0)
    if with_weight and max_rounds == 1:
        acc0 = jnp.ones_like(s0) > 0.0  # pure IS: take round-0 candidate
        w0 = A0 / a_rate
    else:
        acc0 = ua0 < A0
        w0 = jnp.ones_like(s0)

    # the accepted mask rides the loop carry as int32, and "some lane
    # still rejecting" is a min over it: this function also runs inside
    # the Pallas kernel, whose Triton lowering reduces with min/max/sum
    # only
    def cond(carry):
        i, s_cur, w_cur, acc_i = carry
        return (i < max_rounds) & (jnp.min(acc_i) == 0)

    def body(carry):
        i, s_cur, w_cur, acc_i = carry
        accepted = acc_i != 0
        x, s, ua = candidates(draw(i + 1))
        A = accept_prob(x, s)
        if with_weight:
            is_final = i >= max_rounds - 1
            take = (~accepted) & ((ua < A) | is_final)
            w_new = jnp.where(is_final, A / a_rate, 1.0)
        else:
            take = (~accepted) & (ua < A)
            w_new = 1.0
        s_cur = jnp.where(take, s, s_cur)
        w_cur = jnp.where(take, w_new, w_cur)
        return i + 1, s_cur, w_cur, (accepted | take).astype(jnp.int32)

    if with_weight and 2 <= max_rounds <= 4:
        # static unroll for small caps (the production regime,
        # rejection_rounds=2): with >= 2^12 lock-step lanes some lane
        # rejects round 0 essentially always, so the while_loop runs its
        # full cap every step anyway — the unroll produces IDENTICAL
        # draws/selects while dropping the per-round cross-lane
        # jnp.any reduction and the loop-carry plumbing (measured +3%
        # headline throughput on the DCR bench)
        carry = (jnp.int32(1), s0, w0, acc0.astype(jnp.int32))
        for _ in range(max_rounds - 1):
            carry = body(carry)
        _, s_fin, w_fin, _ = carry
    else:
        _, s_fin, w_fin, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(1), s0, w0, acc0.astype(jnp.int32))
        )
    # z below any meaningful screening: unscreened closed form. tiny
    # implies ``small`` (z < 2), so round 0's candidate is exactly
    # s = sqrt(U0 U1) — the unscreened law — and no fresh draw is needed.
    # (Bookkeeping for bit-reproducibility across versions: this path
    # inherits candidates()'s 1e-7 uniform floor, where the pre-round-3
    # draw(-997) fallback floored at 1e-12 — a distributionally
    # negligible change, sup-ECDF error 0.0015 vs the unscreened CDF at
    # z=1e-4/n=200k, but tiny-lane draws differ from round-2 seeds.)
    tiny = z < 1e-3
    s_fin = jnp.where(tiny, s_round0, s_fin)
    r_fin = jnp.clip(s_fin, 0.0, 1.0) * R
    if not with_weight:
        return r_fin
    w_fin = jnp.where(tiny, 1.0, w_fin)
    return r_fin, w_fin


def sample_screened_radius_fast(seed, counter, R, sigma_bar,
                                max_rounds: int = 64):
    """Exact screened-radius sampling with the counter-hash RNG
    (:mod:`.rng`) — identical math to :func:`sample_screened_radius_exact`
    with the solver's default RNG instead of ``jax.random``.

    Args:
        seed: u32 scalar. counter: u32 scalar (e.g. walk-loop step index).
    """
    from .rng import counter_uniform, mix32

    lanes = int(np.prod(jnp.shape(R))) if jnp.shape(R) else 1
    base = mix32(jnp.asarray(seed).astype(jnp.uint32)
                 ^ (jnp.asarray(counter).astype(jnp.uint32)
                    * jnp.uint32(0xB5297A4D)))

    def draw(round_idx):
        u = counter_uniform(base ^ jnp.asarray(round_idx).astype(jnp.uint32)
                            * jnp.uint32(0x68E31DA4), 0, 4, lanes)
        return u.reshape((4,) + jnp.shape(R))

    return _exact_rejection(draw, R, sigma_bar, max_rounds)


def sample_screened_radius_exact(key, R, sigma_bar, max_rounds: int = 64):
    """Exact, gather-free sampling of the screened Green's-weighted radius.

    Gather-free replacement for the table sampler: this draws *exactly*
    from ``p(x) ∝ x [K0(x) - c I0(x)]``
    on ``(0, z)`` (``x = r sqrt(sigma_bar)``, ``z = R sqrt(sigma_bar)``,
    ``c = K0(z)/I0(z)``) via two-regime rejection with vectorized redraws:

    * **small z (< 2)**: envelope ``-s ln s`` (the unscreened Green's radial
      density, sampled in closed form as ``s = sqrt(U1 U2)``). The ratio
      ``[K0(zs) - c I0(zs)] / (-ln s) <= 1`` for every ``z`` (screening
      only attenuates the kernel; verified numerically to 1e-8), so the
      acceptance probability needs no safety factor. Acceptance rate
      ``4 (1 - 1/I0(z)) / z^2`` -> 1 as z -> 0.

    * **large z (>= 2)**: the free-space density ``x K0(x)`` has the exact
      mixture representation ``K0(x) = int_0^inf exp(-x cosh t) dt`` with
      logistic mixing ``sech^2 t``, giving the closed-form sample
      ``x = -ln(U2 U3) * sqrt(1 - U1^2)``; candidates beyond the ball
      (``x > z``) are rejected and the reflection term is absorbed by
      accepting with probability ``1 - c I0(x)/K0(x)`` (in ``[0, 1]`` for
      ``x <= z``). Acceptance rate ``1 - 1/I0(z)`` -> 1 as z -> inf.

    Worst-case acceptance ~0.56 at the crossover, so redraw rounds are
    geometric with mean < 2; lanes redraw in lock-step inside a bounded
    while-loop (un-accepted lanes keep their final candidate if
    ``max_rounds`` is exhausted — probability < 0.44^64).

    Args:
        key: scalar PRNG key (unique per solver step).
        R: ``(W,)`` ball radii. sigma_bar: scalar screening majorant.
    Returns:
        ``(W,)`` radii in ``(0, R)``.
    """
    def draw(round_idx):
        return jax.random.uniform(
            jax.random.fold_in(key, round_idx), (4,) + jnp.shape(R),
            minval=1e-7, maxval=1.0,
        )

    return _exact_rejection(draw, R, sigma_bar, max_rounds)


def screened_radial_pdf(r, R, sigma_bar):
    """Normalized screened radial density (host/numpy oracle for tests)."""
    from scipy.special import i0, k0

    r = np.asarray(r, np.float64)
    sq = np.sqrt(sigma_bar)
    c = k0(R * sq) / i0(R * sq)
    g = k0(r * sq) - c * i0(r * sq)
    dens = np.where((r > 0) & (r < R), r * g, 0.0)
    # normalize numerically
    s = np.concatenate([
        np.geomspace(1e-7 * R, 1e-2 * R, 2048, endpoint=False),
        np.linspace(1e-2 * R, R, 8192),
    ])
    gs = k0(s * sq) - c * i0(s * sq)
    norm = np.trapezoid(s * gs, s)
    return dens / norm
