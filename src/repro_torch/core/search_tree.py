"""Asymmetric (distribution-optimal) binary search trees for SAR digitization.

The paper (Fig. 4) replaces the symmetric SAR binary search with an asymmetric
search tree matched to the skewed MAV distribution, reducing the mean number of
comparisons for 5-bit conversion from 5 to ~3.7.

A search tree here is an *alphabetic* binary tree: leaves are the 2^B output
codes in order; each internal node compares V_MAV against the threshold
between two adjacent codes (go left if below). Expected comparisons =
sum_k p[k] * depth(leaf k). We build:

  * ``symmetric_tree(bits)``        — the standard balanced SAR tree.
  * ``optimal_tree(pmf)``           — exact optimal alphabetic tree
                                      (interval DP with Knuth's speedup, O(n^2)).
  * ``weight_balanced_tree(pmf)``   — greedy median-of-mass splitting, O(n log n);
                                      near-optimal, used as a cheap online fallback.

Trees are lowered to flat integer tables (``TreeTables``) so ADC conversion can
traverse them in lockstep over a whole tensor of voltages (``core.adc``).

Pure numpy: a copy of ``repro.core.search_tree`` (the port imports nothing of
``repro``); the tables are equal array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "TreeTables",
    "symmetric_tree",
    "optimal_tree",
    "weight_balanced_tree",
    "expected_comparisons",
    "validate_tree",
]


@dataclasses.dataclass(frozen=True)
class TreeTables:
    """Flat representation of an alphabetic binary search tree.

    Node 0 is the root. For internal node ``i``:
      * ``threshold[i]`` — code-boundary index t; the comparison is
        ``v >= t * LSB`` (i.e. boundary between code t-1 and code t).
      * ``left[i]`` / ``right[i]`` — child indices. Negative entries encode
        leaves: child ``-(code+1)`` means "emit code".
    ``depth[k]`` — number of comparisons to reach leaf ``k``.
    """

    threshold: np.ndarray  # (n_internal,) int32
    left: np.ndarray  # (n_internal,) int32
    right: np.ndarray  # (n_internal,) int32
    depth: np.ndarray  # (n_codes,) int32
    n_codes: int

    @property
    def max_depth(self) -> int:
        return int(self.depth.max())

    def expected_depth(self, pmf: np.ndarray) -> float:
        pmf = np.asarray(pmf, dtype=np.float64)
        return float((pmf * self.depth).sum() / pmf.sum())


class _Node:
    __slots__ = ("lo", "hi", "split", "left", "right")

    def __init__(self, lo, hi, split=None, left=None, right=None):
        self.lo, self.hi = lo, hi
        self.split, self.left, self.right = split, left, right


def _flatten(root: _Node, n_codes: int) -> TreeTables:
    threshold, left, right = [], [], []
    depth = np.zeros(n_codes, dtype=np.int32)

    def alloc(node: _Node) -> int:
        idx = len(threshold)
        threshold.append(0)
        left.append(0)
        right.append(0)
        return idx

    def fill(node: _Node, idx: int, d: int) -> None:
        threshold[idx] = node.split
        for side, child in (("l", node.left), ("r", node.right)):
            if child.lo == child.hi:  # leaf
                enc = -(child.lo + 1)
                depth[child.lo] = d + 1
                if side == "l":
                    left[idx] = enc
                else:
                    right[idx] = enc
            else:
                cidx = alloc(child)
                if side == "l":
                    left[idx] = cidx
                else:
                    right[idx] = cidx
                fill(child, cidx, d + 1)

    if root.lo == root.hi:  # degenerate single-code tree
        return TreeTables(
            threshold=np.zeros(0, np.int32),
            left=np.zeros(0, np.int32),
            right=np.zeros(0, np.int32),
            depth=np.zeros(n_codes, np.int32),
            n_codes=n_codes,
        )
    ridx = alloc(root)
    fill(root, ridx, 0)
    return TreeTables(
        threshold=np.asarray(threshold, np.int32),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        depth=depth,
        n_codes=n_codes,
    )


def symmetric_tree(bits: int) -> TreeTables:
    """Standard balanced SAR search over 2**bits codes (depth == bits)."""
    n = 1 << bits

    def build(lo, hi):
        if lo == hi:
            return _Node(lo, hi)
        mid = (lo + hi + 1) // 2  # boundary index between mid-1 and mid
        node = _Node(lo, hi, split=mid)
        node.left = build(lo, mid - 1)
        node.right = build(mid, hi)
        return node

    return _flatten(build(0, n - 1), n)


def optimal_tree(pmf: np.ndarray) -> TreeTables:
    """Exact optimal alphabetic search tree for code distribution ``pmf``.

    Interval DP: ``cost[i][j]`` = minimal expected comparisons (unnormalized)
    for codes i..j; every split adds one comparison for the whole interval mass.
    Knuth's monotonicity bound on the optimal split keeps it O(n^2).
    """
    p = np.asarray(pmf, dtype=np.float64)
    n = p.size
    if n < 1:
        raise ValueError("pmf must be non-empty")
    if n == 1:
        return _flatten(_Node(0, 0), 1)
    if np.any(p < 0):
        raise ValueError("pmf entries must be >= 0")
    # Regularize zero-mass codes slightly so the tree stays total (every code
    # reachable), as the hardware must emit a code for every voltage.
    p = p + 1e-12
    csum = np.concatenate([[0.0], np.cumsum(p)])

    cost = np.zeros((n, n), dtype=np.float64)
    best = np.zeros((n, n), dtype=np.int32)
    for i in range(n):
        best[i, i] = i
    for length in range(2, n + 1):
        for i in range(0, n - length + 1):
            j = i + length - 1
            mass = csum[j + 1] - csum[i]
            lo = best[i, j - 1] if length > 2 else i + 1
            hi = best[i + 1, j] if length > 2 else j
            lo = max(lo, i + 1)
            hi = min(max(hi, lo), j)
            bval, bk = np.inf, lo
            for k in range(lo, hi + 1):
                c = cost[i, k - 1] + cost[k, j]
                if c < bval:
                    bval, bk = c, k
            cost[i, j] = bval + mass
            best[i, j] = bk

    def build(lo, hi):
        if lo == hi:
            return _Node(lo, hi)
        k = int(best[lo, hi])
        node = _Node(lo, hi, split=k)
        node.left = build(lo, k - 1)
        node.right = build(k, hi)
        return node

    return _flatten(build(0, n - 1), n)


def weight_balanced_tree(pmf: np.ndarray) -> TreeTables:
    """Greedy tree: split each interval at the boundary nearest half its mass."""
    p = np.asarray(pmf, dtype=np.float64) + 1e-12
    n = p.size
    csum = np.concatenate([[0.0], np.cumsum(p)])

    def build(lo, hi):
        if lo == hi:
            return _Node(lo, hi)
        target = 0.5 * (csum[lo] + csum[hi + 1])
        k = int(np.searchsorted(csum, target, side="left"))
        k = min(max(k, lo + 1), hi)
        node = _Node(lo, hi, split=k)
        node.left = build(lo, k - 1)
        node.right = build(k, hi)
        return node

    return _flatten(build(0, n - 1), n)


def expected_comparisons(tree: TreeTables, pmf: np.ndarray) -> float:
    return tree.expected_depth(pmf)


def validate_tree(tree: TreeTables) -> None:
    """Structural validation: every code reachable exactly once, thresholds
    consistent with the alphabetic ordering (in-order traversal of thresholds
    is strictly increasing and equals 1..n-1)."""
    n = tree.n_codes
    if n == 1:
        return
    seen_codes: list[int] = []
    seen_thresholds: list[int] = []

    def walk(ref: int) -> None:
        if ref < 0:
            seen_codes.append(-ref - 1)
            return
        walk(int(tree.left[ref]))
        seen_thresholds.append(int(tree.threshold[ref]))
        walk(int(tree.right[ref]))

    walk(0)
    if seen_codes != list(range(n)):
        raise AssertionError(f"codes not in order: {seen_codes}")
    if seen_thresholds != list(range(1, n)):
        raise AssertionError(f"thresholds not alphabetic: {seen_thresholds}")
