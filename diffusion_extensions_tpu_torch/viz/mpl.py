"""Axis ticks in multiples of pi."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["multiple_formatter", "setup_pi_axis"]


def multiple_formatter(denominator=2, number=np.pi, latex=r"\pi"):
    """Tick formatter writing multiples of ``number`` as reduced fractions
    of ``latex`` over ``denominator``."""

    def _formatter(x, pos):
        den = denominator
        num = int(np.rint(den * x / number))
        com = math.gcd(num, den)
        num, den = num // com, den // com
        if den == 1:
            if num == 0:
                return r"$0$"
            if num == 1:
                return r"$%s$" % latex
            if num == -1:
                return r"$-%s$" % latex
            return r"$%s%s$" % (num, latex)
        if num == 1:
            return r"$\frac{%s}{%s}$" % (latex, den)
        if num == -1:
            return r"$-\frac{%s}{%s}$" % (latex, den)
        if num < 0:
            return r"$-\frac{%s%s}{%s}$" % (-num, latex, den)
        return r"$\frac{%s%s}{%s}$" % (num, latex, den)

    return _formatter


def setup_pi_axis(ax, axis="y", major=np.pi / 2, minor=np.pi / 4, denominator=2):
    """pi-multiple locators and formatter on one axis of ``ax``."""
    import matplotlib.pyplot as plt

    a = ax.yaxis if axis == "y" else ax.xaxis
    a.set_major_locator(plt.MultipleLocator(major))
    a.set_minor_locator(plt.MultipleLocator(minor))
    a.set_major_formatter(plt.FuncFormatter(multiple_formatter(denominator)))
