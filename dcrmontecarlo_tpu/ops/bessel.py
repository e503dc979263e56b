"""Modified Bessel functions I0/K0 as pure-jnp elementwise functions.

The reference uses host-side ``scipy.special.i0 / k0`` inside the walk loop
(reference ``solvers/utils.py:1,21-26,43-44``), which forces a device->host
round trip per call. Here they are polynomial approximations (Abramowitz &
Stegun 9.8.1-9.8.8) evaluated elementwise, so the screened Green's
function math stays fused inside the compiled step function and lowers
unchanged into the Pallas walk kernel.

Exponentially-scaled variants ``i0e``/``k0e`` are provided because
``I0(x) ~ e^x`` overflows float32 near ``x = 88``; the solver only ever
needs ratios like ``1/I0`` and ``K0/I0`` which are computed stably from the
scaled forms.

Accuracy: |rel err| < 2e-7 in float64, < ~1e-6 in float32 (A&S bounds),
validated against scipy in ``tests/test_bessel_greens.py``.
"""

import jax.numpy as jnp

__all__ = ["i0", "i0e", "k0", "k0e", "i1", "i1e", "k1", "k1e",
           "ii0e", "ik0"]

# A&S 9.8.1: I0(x), |x| <= 3.75, t = (x/3.75)^2
_I0_SMALL = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732, 0.0360768, 0.0045813)
# A&S 9.8.2: I0(x) x >= 3.75, e^-x sqrt(x) I0(x) = P(3.75/x)
_I0_LARGE = (
    0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281,
    -0.02057706, 0.02635537, -0.01647633, 0.00392377,
)
# A&S 9.8.5: K0(x), 0 < x <= 2, t = (x/2)^2:
#   K0 = -ln(x/2) I0(x) + P(t)
_K0_SMALL = (-0.57721566, 0.42278420, 0.23069756, 0.03488590, 0.00262698,
             0.00010750, 0.00000740)
# A&S 9.8.6: K0(x), x >= 2, t = 2/x: e^x sqrt(x) K0(x) = P(t)
_K0_LARGE = (1.25331414, -0.07832358, 0.02189568, -0.01062446, 0.00587872,
             -0.00251540, 0.00053208)


def _polyval(coeffs, t):
    acc = jnp.zeros_like(t) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * t + c
    return acc


def _i0_small(x):
    t = (x / 3.75) ** 2
    return _polyval(_I0_SMALL, t)


def _i0e_large(x):
    # e^{-x} I0(x) for x >= 3.75
    t = 3.75 / x
    return _polyval(_I0_LARGE, t) / jnp.sqrt(x)


def i0e(x):
    """Exponentially scaled modified Bessel function: ``e^{-|x|} I0(x)``."""
    x = jnp.abs(x)
    small = _i0_small(x) * jnp.exp(-x)
    # guard the large branch against x=0 division
    xs = jnp.maximum(x, 3.75)
    return jnp.where(x < 3.75, small, _i0e_large(xs))


def i0(x):
    """Modified Bessel function of the first kind, order 0."""
    x = jnp.abs(x)
    xs = jnp.maximum(x, 3.75)
    return jnp.where(x < 3.75, _i0_small(x), _i0e_large(xs) * jnp.exp(xs))


def _k0_small(x):
    t = (x / 2.0) ** 2
    return -jnp.log(x / 2.0) * _i0_small(x) + _polyval(_K0_SMALL, t)


def _k0e_large(x):
    # e^{x} K0(x) for x >= 2
    t = 2.0 / x
    return _polyval(_K0_LARGE, t) / jnp.sqrt(x)


def k0(x):
    """Modified Bessel function of the second kind, order 0 (x > 0)."""
    xc = jnp.maximum(x, 1e-30)  # K0 -> +inf as x -> 0+
    xs = jnp.maximum(xc, 2.0)
    return jnp.where(xc <= 2.0, _k0_small(jnp.minimum(xc, 2.0)),
                     _k0e_large(xs) * jnp.exp(-xs))


def k0e(x):
    """Exponentially scaled: ``e^{x} K0(x)`` (x > 0)."""
    xc = jnp.maximum(x, 1e-30)
    xs = jnp.maximum(xc, 2.0)
    return jnp.where(xc <= 2.0, _k0_small(jnp.minimum(xc, 2.0)) * jnp.exp(xc),
                     _k0e_large(xs))


# A&S 9.8.3: I1(x)/x for |x| <= 3.75, t = (x/3.75)^2
_I1_SMALL = (0.5, 0.87890594, 0.51498869, 0.15084934, 0.02658733,
             0.00301532, 0.00032411)
# A&S 9.8.4: x >= 3.75, e^-x sqrt(x) I1(x) = P(3.75/x)
_I1_LARGE = (
    0.39894228, -0.03988024, -0.00362018, 0.00163801, -0.01031555,
    0.02282967, -0.02895312, 0.01787654, -0.00420059,
)
# A&S 9.8.7: 0 < x <= 2, x K1(x) = x ln(x/2) I1(x) + P((x/2)^2)
_K1_SMALL = (1.0, 0.15443144, -0.67278579, -0.18156897, -0.01919402,
             -0.00110404, -0.00004686)
# A&S 9.8.8: x >= 2, e^x sqrt(x) K1(x) = P(2/x)
_K1_LARGE = (1.25331414, 0.23498619, -0.03655620, 0.01504268, -0.00780353,
             0.00325614, -0.00068245)


def _i1_small(x):
    t = (x / 3.75) ** 2
    return x * _polyval(_I1_SMALL, t)


def _i1e_large(x):
    t = 3.75 / x
    return _polyval(_I1_LARGE, t) / jnp.sqrt(x)


def i1e(x):
    """Exponentially scaled modified Bessel function: ``e^{-|x|} I1(x)``."""
    x = jnp.abs(x)
    small = _i1_small(x) * jnp.exp(-x)
    xs = jnp.maximum(x, 3.75)
    return jnp.where(x < 3.75, small, _i1e_large(xs))


def i1(x):
    """Modified Bessel function of the first kind, order 1 (x >= 0)."""
    x = jnp.abs(x)
    xs = jnp.maximum(x, 3.75)
    return jnp.where(x < 3.75, _i1_small(x), _i1e_large(xs) * jnp.exp(xs))


def _k1_small(x):
    t = (x / 2.0) ** 2
    return (jnp.log(x / 2.0) * _i1_small(x) + _polyval(_K1_SMALL, t) / x)


def _k1e_large(x):
    t = 2.0 / x
    return _polyval(_K1_LARGE, t) / jnp.sqrt(x)


def k1(x):
    """Modified Bessel function of the second kind, order 1 (x > 0)."""
    xc = jnp.maximum(x, 1e-30)  # K1 ~ 1/x as x -> 0+
    xs = jnp.maximum(xc, 2.0)
    return jnp.where(xc <= 2.0, _k1_small(jnp.minimum(xc, 2.0)),
                     _k1e_large(xs) * jnp.exp(-xs))


def k1e(x):
    """Exponentially scaled: ``e^{x} K1(x)`` (x > 0)."""
    xc = jnp.maximum(x, 1e-30)
    xs = jnp.maximum(xc, 2.0)
    return jnp.where(xc <= 2.0, _k1_small(jnp.minimum(xc, 2.0)) * jnp.exp(xc),
                     _k1e_large(xs))


# --------------------------------------------------------------------- #
# Integrals int_0^z I0(s) ds and int_0^z K0(s) ds (for the Robin chord / #
# reflectance coefficient in ops/greens.py).                             #
#                                                                        #
# Small z: exact Taylor series. With a_k = 4^{-k}/(k!)^2 and             #
# h_k = sum_{j<=k} 1/j,                                                  #
#   int_0^z I0 = z * sum_k a_k z^{2k} / (2k+1)                           #
#   int_0^z K0 = -(ln(z/2)+gamma_E) int_0^z I0                           #
#                + z * sum_k a_k z^{2k} [1/(2k+1)^2 + h_k/(2k+1)]        #
# (integrate K0 = -(ln(z/2)+gamma_E) I0 + sum_{k>=1} a_k h_k z^{2k}      #
# term by term). Large z: least-squares fits of the A&S-style scaled     #
# forms against scipy.special.iti0k0 (rel err < 3e-5, adequate for a     #
# weight-correction coefficient; validated in tests/test_bessel_greens). #
# --------------------------------------------------------------------- #

_GAMMA_E = 0.5772156649015329
_HALF_PI = 1.5707963267948966


def _int_series_coeffs(n_terms=11):
    # (A, B, C): int I0 / z = P_A(z^2); the K0-integral extra sum / z
    # = P_B(z^2); the K0 regular part T/z^2 = P_C(z^2) where
    # K0 = -(ln(z/2)+gamma_E) I0 + T
    A, B, C = [], [], []
    fact = 1.0
    h = 0.0
    for k in range(n_terms):
        if k > 0:
            fact *= k
            h += 1.0 / k
        a = 0.25 ** k / (fact * fact)
        m = 2 * k + 1
        A.append(a / m)
        B.append(a * (1.0 / (m * m) + h / m))
        if k > 0:
            C.append(a * h)
    return tuple(A), tuple(B), tuple(C)


_II0_SER, _IK0_SER, _K0REG_SER = _int_series_coeffs()
# sqrt(z) e^{-z} int_0^z I0 = P(3.75/z), z in [3.75, 600] (constant ~
# 1/sqrt(2 pi) beyond; fit vs scipy.special.iti0k0, rel err < 3e-5)
_II0E_LARGE = (
    0.39892117833666013, 0.0683659380497933, -0.019199593449555692,
    0.5493053727171856, -2.987467946770637, 9.326451372102712,
    -15.800573705385947, 14.685752682422835, -7.138285073342126,
    1.4282994561660782,
)
# (pi/2 - int_0^z K0) e^{z} sqrt(z) = Q(2/z), z in [2, 15] (fit rel err
# < 2e-5; beyond z=15 the whole correction is < 1e-7 relative to pi/2,
# below float32 resolution, so extrapolating Q is harmless)
_IK0_TAIL = (
    1.2532603568891372, -0.39012360170047267, 0.29878153845917976,
    -0.30142804207123175, 0.2850220058180192, -0.2003588389084528,
    0.08645137263695717, -0.0167236317256414,
)


def _ii0_over_z_series(z2):
    """``(int_0^z I0) / z`` as a series in ``z^2`` (z <= 3.75)."""
    return _polyval(_II0_SER, z2)


def _ik0_reg_over_z_series(z2):
    """The K0-integral's regular sum over z: ``P_B(z^2)`` (z <= 2)."""
    return _polyval(_IK0_SER, z2)


def _k0_reg_over_z2_series(z2):
    """``T(z)/z^2`` where ``K0 = -(ln(z/2)+gamma_E) I0 + T`` (z <= 2)."""
    return _polyval(_K0REG_SER, z2)


def ii0e(z):
    """Exponentially scaled integral: ``e^{-|z|} \\int_0^z I0(s) ds``."""
    z = jnp.abs(z)
    small = z * _ii0_over_z_series(z * z) * jnp.exp(-z)
    zs = jnp.maximum(z, 3.75)
    large = _polyval(_II0E_LARGE, 3.75 / zs) / jnp.sqrt(zs)
    return jnp.where(z < 3.75, small, large)


def ik0(z):
    """``\\int_0^z K0(s) ds`` (monotone, ``-> pi/2`` as ``z -> inf``)."""
    zc = jnp.maximum(z, 1e-30)
    zsm = jnp.minimum(zc, 2.0)
    z2 = zsm * zsm
    L = jnp.log(0.5 * zsm) + _GAMMA_E
    small = zsm * (_ik0_reg_over_z_series(z2) - L * _ii0_over_z_series(z2))
    zs = jnp.maximum(zc, 2.0)
    large = _HALF_PI - jnp.exp(-zs) / jnp.sqrt(zs) * _polyval(
        _IK0_TAIL, 2.0 / zs)
    return jnp.where(zc <= 2.0, small, large)
