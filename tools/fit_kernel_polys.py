#!/usr/bin/env python3
"""Fit the polynomials of the PyTorch/CUDA port's hand-written kernels.

    python tools/fit_kernel_polys.py

Prints, as C float literals, the coefficients used in
``diffusion_extensions_tpu_torch/csrc/gaussian_kernel_sum.cu`` (atan on
[0, 1]) and ``csrc/igso3_logpdf_score.cu`` (sin(h)/h and cos(h) on
[0, pi/2], sinh(x)/x and cosh(x) on [0, 1]), with the error of each when it
is evaluated in float32 by Horner's rule as the kernels evaluate it.

Each fit is a discrete minimax (Chebyshev) fit: a linear program over a
dense grid that minimises the largest absolute error of P(v) against the
target g(v), v = z^2.  numpy and scipy only; runs on a CPU in seconds.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linprog


def minimax(g, v, terms: int, scale=None) -> np.ndarray:
    """Coefficients c_0..c_{terms-1} minimising
    max_i |scale_i sum_k c_k v_i^k - g_i| (scale 1 when not given)."""
    basis = np.vander(v, terms, increasing=True)
    if scale is not None:
        basis = basis * scale[:, None]
    rows = len(v)
    # variables: c_0..c_{terms-1}, E;  +-(basis c - g) <= E
    a_ub = np.block([[basis, -np.ones((rows, 1))], [-basis, -np.ones((rows, 1))]])
    b_ub = np.concatenate([g, -g])
    cost = np.zeros(terms + 1)
    cost[-1] = 1.0
    res = linprog(cost, A_ub=a_ub, b_ub=b_ub, bounds=[(None, None)] * terms + [(0, None)],
                  method="highs")
    if not res.success:
        raise RuntimeError(res.message)
    return res.x[:terms]


def horner32(coef, v):
    """Horner's rule in float32 with fused multiply-adds emulated in
    float64 (one rounding a step), highest coefficient first."""
    acc = np.full_like(v, np.float32(coef[-1]), dtype=np.float32)
    for c in coef[-2::-1]:
        acc = (acc.astype(np.float64) * v.astype(np.float64) + np.float64(np.float32(c))
               ).astype(np.float32)
    return acc


def literals(coef) -> str:
    return ", ".join(f"{np.float32(c):.9e}f" for c in coef)


def report(name, coef, err_abs, note):
    print(f"{name}: {len(coef)} terms, {note}: {err_abs:.3e}")
    print(f"  {{{literals(coef)}}}")


def main() -> None:
    grid = np.cos(np.linspace(0.0, np.pi, 4001)) * 0.5 + 0.5  # Chebyshev nodes on [0, 1]
    dense = np.linspace(0.0, 1.0, 200_001)

    # atan(z) = z P(z^2) on [0, 1]; rows scaled by z so the error is of atan itself
    z = np.maximum(grid, 1e-6)
    for terms in (6, 7, 8, 9):
        coef = minimax(np.arctan(z), z * z, terms, scale=z)
        z32 = dense.astype(np.float32)
        p = horner32(coef, (z32 * z32).astype(np.float32))
        got = (p.astype(np.float64) * z32.astype(np.float64)).astype(np.float32)
        err = np.abs(got.astype(np.float64) - np.arctan(z32.astype(np.float64))).max()
        report(f"atan[{terms}]", coef, err, "max |error| in float32, rad")

    # sin(h) = h P(h^2), cos(h) = Q(h^2), h in [0, pi/2 (1 + 1e-6)]
    hmax = 0.5 * np.pi * (1.0 + 1e-6)
    h = np.maximum(grid * hmax, 1e-6)
    h32 = (dense * hmax).astype(np.float32)[1:]
    hv32 = (h32 * h32).astype(np.float32)
    for terms in (5, 6):
        coef = minimax(np.sin(h) / h, h * h, terms)
        got = (horner32(coef, hv32).astype(np.float64) * h32).astype(np.float32)
        want = np.sin(h32.astype(np.float64))
        report(f"sin[{terms}]", coef, np.abs(got / want - 1.0).max(),
               "max relative error in float32")
    for terms in (6, 7):
        coef = minimax(np.cos(h), h * h, terms)
        got = horner32(coef, hv32)
        report(f"cos[{terms}]", coef,
               np.abs(got.astype(np.float64) - np.cos(h32.astype(np.float64))).max(),
               "max |error| in float32")

    # sinh(x) = x P(x^2), cosh(x) = Q(x^2), x in [0, 1]
    x = np.maximum(grid, 1e-6)
    x32 = dense.astype(np.float32)[1:]
    xv32 = (x32 * x32).astype(np.float32)
    for terms in (3, 4):
        coef = minimax(np.sinh(x) / x, x * x, terms)
        got = (horner32(coef, xv32).astype(np.float64) * x32).astype(np.float32)
        report(f"sinh[{terms}]", coef,
               np.abs(got / np.sinh(x32.astype(np.float64)) - 1.0).max(),
               "max relative error in float32")
    for terms in (5, 6):
        coef = minimax(np.cosh(x), x * x, terms)
        got = horner32(coef, xv32)
        report(f"cosh[{terms}]", coef,
               np.abs(got / np.cosh(x32.astype(np.float64)) - 1.0).max(),
               "max relative error in float32")


if __name__ == "__main__":
    main()
