"""Quadrature rules on reference simplices.

Replaces the FFCx quadrature-degree machinery (the reference compiles every
UFL form through FFCx which auto-selects a rule; reference ``hmm.py:259-274``).
Rules are given in local coordinates xi in the reference simplex
{xi_i >= 0, sum xi_i <= 1}; weights are normalized to sum to 1, so

    integral_T f dx  =  |T| * sum_q w_q f(x_q),   x_q = p0 + J xi_q.
"""

from __future__ import annotations

import numpy as np

__all__ = ["simplex_rule"]


def _interval_rules():
    # Gauss-Legendre on [0,1]
    rules = {}
    for npts in (1, 2, 3, 4, 5):
        x, w = np.polynomial.legendre.leggauss(npts)
        x = 0.5 * (x + 1.0)
        w = 0.5 * w
        deg = 2 * npts - 1
        rules[deg] = (x[:, None], w)
    return rules


_TRI_RULES = {
    1: (
        np.array([[1 / 3, 1 / 3]]),
        np.array([1.0]),
    ),
    2: (
        np.array([[0.5, 0.0], [0.5, 0.5], [0.0, 0.5]]),
        np.array([1 / 3, 1 / 3, 1 / 3]),
    ),
    3: (
        np.array([[1 / 3, 1 / 3], [1 / 5, 1 / 5], [3 / 5, 1 / 5], [1 / 5, 3 / 5]]),
        np.array([-27 / 48, 25 / 48, 25 / 48, 25 / 48]),
    ),
    4: (
        # Dunavant degree-4, 6 points
        np.array(
            [
                [0.445948490915965, 0.445948490915965],
                [0.445948490915965, 0.108103018168070],
                [0.108103018168070, 0.445948490915965],
                [0.091576213509771, 0.091576213509771],
                [0.091576213509771, 0.816847572980459],
                [0.816847572980459, 0.091576213509771],
            ]
        ),
        np.array(
            [
                0.223381589678011,
                0.223381589678011,
                0.223381589678011,
                0.109951743655322,
                0.109951743655322,
                0.109951743655322,
            ]
        ),
    ),
}

_a2 = (5.0 - np.sqrt(5.0)) / 20.0
_b2 = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0

_TET_RULES = {
    1: (
        np.array([[0.25, 0.25, 0.25]]),
        np.array([1.0]),
    ),
    2: (
        np.array(
            [
                [_b2, _a2, _a2],
                [_a2, _b2, _a2],
                [_a2, _a2, _b2],
                [_a2, _a2, _a2],
            ]
        ),
        np.array([0.25, 0.25, 0.25, 0.25]),
    ),
    3: (
        np.array(
            [
                [0.25, 0.25, 0.25],
                [0.5, 1 / 6, 1 / 6],
                [1 / 6, 0.5, 1 / 6],
                [1 / 6, 1 / 6, 0.5],
                [1 / 6, 1 / 6, 1 / 6],
            ]
        ),
        np.array([-0.8, 0.45 / 1, 0.45, 0.45, 0.45]),
    ),
}


def _keast_deg5():
    # Keast 14-point degree-5 rule (normalized weights)
    w1 = 0.012248840519393658 * 6.0
    w2 = 0.018781320953002642 * 6.0
    w3 = 0.0070910034628469110 * 6.0
    a1 = 0.092735250310891226
    a2 = 0.31088591926330060
    a3 = 0.045503704125649649
    pts, wts = [], []
    for a, w in ((a1, w1), (a2, w2)):
        b = 1.0 - 3.0 * a
        base = [
            [a, a, a],
            [b, a, a],
            [a, b, a],
            [a, a, b],
        ]
        pts += base
        wts += [w] * 4
    a, b = a3, 0.5 - a3
    base = [
        [a, a, b],
        [a, b, a],
        [b, a, a],
        [a, b, b],
        [b, a, b],
        [b, b, a],
    ]
    pts += base
    wts += [w3] * 6
    return np.array(pts), np.array(wts)


def _radon_deg5():
    # Radon 7-point degree-5 triangle rule (centroid + two 3-point orbits)
    s15 = np.sqrt(15.0)
    a = (6.0 - s15) / 21.0
    b = (6.0 + s15) / 21.0
    wa = (155.0 - s15) / 1200.0
    wb = (155.0 + s15) / 1200.0
    pts = np.array(
        [
            [1 / 3, 1 / 3],
            [a, a], [1.0 - 2.0 * a, a], [a, 1.0 - 2.0 * a],
            [b, b], [1.0 - 2.0 * b, b], [b, 1.0 - 2.0 * b],
        ]
    )
    wts = np.array([9.0 / 40.0, wa, wa, wa, wb, wb, wb])
    return pts, wts


_TET_RULES[4] = _keast_deg5()
_TET_RULES[5] = _TET_RULES[4]
_TRI_RULES[5] = _radon_deg5()


def simplex_rule(dim: int, degree: int):
    """(points (nq, dim), weights (nq,)) exact for polynomials of ``degree``.

    Weights sum to 1 (multiply by |T| for physical integrals).
    """
    if dim == 1:
        rules = _interval_rules()
        for deg in sorted(rules):
            if deg >= degree:
                return rules[deg]
        return rules[max(rules)]
    table = _TRI_RULES if dim == 2 else _TET_RULES
    degree = max(1, min(degree, max(table)))
    while degree not in table:
        degree += 1
    return table[degree]
