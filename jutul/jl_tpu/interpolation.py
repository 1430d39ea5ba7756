"""Table interpolation utilities (jittable, differentiable).

JAX-native counterpart of Jutul's interpolation module (reference:
src/interpolation.jl:69-391 — ``LinearInterpolant``, ``BilinearInterpolant``,
``get_1d_interpolator``, ``get_2d_interpolator``). Implementation is pure
``jnp``: works under jit/vmap/grad, with the constant-spacing fast path
replaced by vectorized ``searchsorted`` (uniform cost per query).

Extrapolation follows the reference default: constant-slope (linear)
extrapolation outside the table unless ``constant_dx`` tables are clamped by
``cap_end``/``cap_start``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


from .models.variables import SecondaryVariable as _SecondaryVariableBase


class LinearInterpolant:
    """Piecewise-linear 1D interpolant y(x) over sorted nodes.

    Jittable/differentiable callable; broadcasting over any query shape.
    Reference: src/interpolation.jl:69 (LinearInterpolant).
    """

    def __init__(self, xs, ys, cap_start: bool = False, cap_end: bool = False):
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        if xs.ndim != 1 or xs.shape != ys.shape:
            raise ValueError("xs and ys must be equal-length 1D arrays")
        if xs.size < 2:
            # single point: constant function
            xs = np.array([xs[0], xs[0] + 1.0])
            ys = np.array([ys[0], ys[0]])
        order = np.argsort(xs)
        xs, ys = xs[order], ys[order]
        if np.any(np.diff(xs) <= 0):
            raise ValueError("xs must be strictly increasing")
        self.xs = jnp.asarray(xs)
        self.ys = jnp.asarray(ys)
        self.cap_start = cap_start
        self.cap_end = cap_end

    def __call__(self, x):
        x = jnp.asarray(x)
        i = jnp.clip(jnp.searchsorted(self.xs, x, side="right") - 1, 0,
                     self.xs.shape[0] - 2)
        x0 = self.xs[i]
        x1 = self.xs[i + 1]
        y0 = self.ys[i]
        y1 = self.ys[i + 1]
        t = (x - x0) / (x1 - x0)
        y = y0 + t * (y1 - y0)
        if self.cap_start:
            y = jnp.where(x < self.xs[0], self.ys[0], y)
        if self.cap_end:
            y = jnp.where(x > self.xs[-1], self.ys[-1], y)
        return y


class BilinearInterpolant:
    """Bilinear interpolation on a rectilinear (xs × ys) grid of fs.

    Reference: src/interpolation.jl:211 (BilinearInterpolant).
    """

    def __init__(self, xs, ys, fs):
        xs = np.asarray(xs, dtype=np.float64)
        ys = np.asarray(ys, dtype=np.float64)
        fs = np.asarray(fs, dtype=np.float64)
        if fs.shape != (xs.size, ys.size):
            raise ValueError(f"fs must have shape {(xs.size, ys.size)}, got {fs.shape}")
        if np.any(np.diff(xs) <= 0) or np.any(np.diff(ys) <= 0):
            raise ValueError("grid vectors must be strictly increasing")
        self.xs = jnp.asarray(xs)
        self.ys = jnp.asarray(ys)
        self.fs = jnp.asarray(fs)

    def __call__(self, x, y):
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        i = jnp.clip(jnp.searchsorted(self.xs, x, side="right") - 1, 0,
                     self.xs.shape[0] - 2)
        j = jnp.clip(jnp.searchsorted(self.ys, y, side="right") - 1, 0,
                     self.ys.shape[0] - 2)
        x0, x1 = self.xs[i], self.xs[i + 1]
        y0, y1 = self.ys[j], self.ys[j + 1]
        tx = (x - x0) / (x1 - x0)
        ty = (y - y0) / (y1 - y0)
        f00 = self.fs[i, j]
        f10 = self.fs[i + 1, j]
        f01 = self.fs[i, j + 1]
        f11 = self.fs[i + 1, j + 1]
        return (
            f00 * (1 - tx) * (1 - ty)
            + f10 * tx * (1 - ty)
            + f01 * (1 - tx) * ty
            + f11 * tx * ty
        )


def get_1d_interpolator(
    xs,
    ys,
    cap_start: bool = False,
    cap_end: bool = False,
    cap_endpoints: bool | None = None,
    constant_dx: bool | None = None,  # accepted for API parity; unused
) -> LinearInterpolant:
    """Build a 1D interpolant (reference src/interpolation.jl:1).

    ``cap_endpoints`` caps both ends (reference keyword of the same name).
    """
    if cap_endpoints is not None:
        cap_start = cap_end = cap_endpoints
    return LinearInterpolant(xs, ys, cap_start=cap_start, cap_end=cap_end)


def get_2d_interpolator(xs, ys, fs, **kw) -> BilinearInterpolant:
    """Build a bilinear 2D interpolant (reference src/interpolation.jl:211)."""
    return BilinearInterpolant(xs, ys, fs)


class UnaryTabulatedVariable(_SecondaryVariableBase):
    """Secondary variable defined by 1D table lookup of one other variable
    (reference: src/interpolation.jl:330-391 UnaryTabulatedVariable — e.g.
    tabulated relative permeability vs saturation).

    One interpolant applied to every entity, or one interpolant per
    component when the dependency carries a trailing component axis and a
    list of tables is given. Follows the SecondaryVariable contract:
    elementwise along the entity axis, component axis last.
    """

    def __init__(self, variable: str, xs, ys, name: str | None = None,
                 cap_start: bool = False, cap_end: bool = False):
        self.dependencies = (variable,)
        self._var = variable
        if isinstance(ys, (list, tuple)) and np.ndim(ys[0]) == 1 \
                and not np.isscalar(ys[0]):
            per = list(ys)
        else:
            per = None
        if per is not None:
            xs_list = xs if isinstance(xs[0], (list, tuple, np.ndarray)) \
                and np.ndim(xs[0]) == 1 else [xs] * len(per)
            self._interp = [LinearInterpolant(x, y, cap_start, cap_end)
                            for x, y in zip(xs_list, per)]
        else:
            self._interp = LinearInterpolant(xs, ys, cap_start, cap_end)
        self._name = name

    def evaluate(self, model, **deps):
        x = deps[self._var]
        if isinstance(self._interp, list):
            cols = [f(x[..., c]) for c, f in enumerate(self._interp)]
            return jnp.stack(cols, axis=-1)
        return self._interp(x)
