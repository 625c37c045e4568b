"""Seeded sets of hard rotated-box pairs for the rotated-IoU tests (numpy
only: the card's tests import it without JAX).

Each case maps to ``(a, b)``, two ``(P, 5)`` float32 arrays of boxes ``[cx cy
l s theta]`` whose rows pair up.  The geometry is exact where it matters:
axis-aligned boxes on integer coordinates and shifts by whole edge lengths,
so edges coincide, touch or run collinear bit for bit."""

import numpy as np

CASES = ("identical", "nested", "shared_edge", "touching", "collinear",
         "parallel", "turn90", "turn180", "zero_width", "angle_ties")


def _boxes(rng, n):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-50, 50, (n, 2))
    b[:, 2] = rng.uniform(10, 80, n)
    b[:, 3] = b[:, 2] * rng.uniform(0.2, 1.0, n)
    b[:, 4] = rng.uniform(-np.pi / 2, np.pi / 2, n)
    return b


def _shift(a, along, across):
    """``a`` moved by ``along`` of its long edge and ``across`` of its short
    edge (fractions of l and s)."""
    b = a.copy()
    ct, st = np.cos(a[:, 4]), np.sin(a[:, 4])
    b[:, 0] += along * a[:, 2] * ct - across * a[:, 3] * st
    b[:, 1] += -along * a[:, 2] * st - across * a[:, 3] * ct
    return b


def _axis_aligned(rng, n):
    """Boxes with theta = 0 on an integer grid (corners exact in float)."""
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.integers(-40, 40, (n, 2))
    b[:, 2] = 2 * rng.integers(5, 30, n)
    b[:, 3] = 2 * rng.integers(2, 5, n)
    return b


def hard_pairs(case: str, seed: int = 0, n: int = 24):
    rng = np.random.default_rng([seed, CASES.index(case)])
    if case == "identical":
        a = _boxes(rng, n)
        return a, a.copy()
    if case == "nested":  # b inside a, anywhere from centred to near an edge
        a = _boxes(rng, n)
        b = a.copy()
        b[:, 2:4] *= rng.uniform(0.2, 0.7, (n, 1)).astype(np.float32)
        return a, _shift(b, rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n))
    if case == "shared_edge":  # axis-aligned, b one short edge beside a
        a = _axis_aligned(rng, n)
        b = a.copy()
        b[:, 1] += a[:, 3]
        b[n // 2:, 0] += rng.integers(-3, 4, n - n // 2)  # sliding along it
        return a, b
    if case == "touching":  # axis-aligned, only corners meet
        a = _axis_aligned(rng, n)
        b = a.copy()
        b[:, 0] += a[:, 2]
        b[:, 1] += a[:, 3]
        return a, b
    if case == "collinear":  # long edges on one line, overlapping in part
        a = _axis_aligned(rng, n)
        b = a.copy()
        b[:, 0] += a[:, 2] // 2
        return a, b
    if case == "parallel":  # long edges parallel, b shifted across
        a = _axis_aligned(rng, n)
        b = a.copy()
        b[:, 1] += a[:, 3] // 2
        r = _boxes(rng, n)  # and rotated pairs with parallel edges
        return np.concatenate([a, r]), np.concatenate([b, _shift(r, 0, 0.5)])
    if case == "turn90":
        a = _boxes(rng, n)
        b = a.copy()
        b[:, 4] = a[:, 4] + np.float32(np.pi / 2)
        sq = a.copy()  # squares: a quarter turn gives the same square
        sq[:, 3] = sq[:, 2]
        sq_b = sq.copy()
        sq_b[:, 4] = sq[:, 4] + np.float32(np.pi / 2)
        return np.concatenate([a, sq]), np.concatenate([b, sq_b])
    if case == "turn180":
        a = _boxes(rng, n)
        b = a.copy()
        b[:, 4] = a[:, 4] + np.float32(np.pi)
        return a, b
    if case == "zero_width":  # a segment against a box, and two segments
        a = _boxes(rng, n)
        b = _shift(a, 0.1, 0.1)
        b[: n // 2, 3] = 0
        a[n // 2:, 3] = 0
        b[n // 2:, 3] = 0
        return a, b
    if case == "angle_ties":  # repeated candidate points around the ring
        a = _axis_aligned(rng, n)
        b = a.copy()
        b[:, 0] += a[:, 2] // 2  # a corner of b on each long edge of a
        c = a.copy()
        c[:, 2:4] = c[:, 2:3]  # squares on squares: crossings at vertices
        d = c.copy()
        d[:, 0] += c[:, 2] // 2
        d[:, 1] += c[:, 2] // 2
        return np.concatenate([a, c, c]), np.concatenate([b, d, c.copy()])
    raise ValueError(case)
