"""Carry-growth theory for N-operand addition (paper §2).

Copy of ``repro/core/carry.py`` for the PyTorch port, which imports
nothing of the JAX package (``tests/test_torch_plan.py`` holds the two
equal).

Implements, for any base ``k >= 2``:

* Lemma 1   — 2-operand, 1-column max carry/sum.
* Lemma 2   — carry/sum increments as rows are added (with the N = nk+1 stall).
* Theorem   — upper bound on the carry value of an N-operand addition: N-1,
              independent of base and word width.
* Tight forms — C = N-1 (N<k), C = N-n (N=nk), C = N-1-n (N=nk+r).
* Corollary — number of carry digits; total result width M + ceil(log_k N).
* Eqn (20)  — column-transition solver: the exact N past a k^p boundary at
              which the carry actually widens by one digit.

Everything here is exact integer arithmetic (Python bigints) so it can be
property-tested against brute force; the JAX/kernels layers consume the
binary (k=2) specializations via :mod:`repro.core.accum`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

__all__ = [
    "digits",
    "from_digits",
    "num_digits",
    "lemma1_max_carry_sum",
    "max_column_total",
    "exact_max_carry_1col",
    "carry_upper_bound",
    "tight_carry_bound",
    "max_total_sum",
    "max_carry_multicolumn",
    "carry_digits",
    "carry_digits_bound",
    "result_digits",
    "column_transition_delta",
    "column_transition_N",
    "CarryBudget",
    "carry_budget",
]


def _check_base(k: int) -> None:
    if k < 2:
        raise ValueError(f"base k must be >= 2, got {k}")


def digits(x: int, k: int) -> List[int]:
    """Digits of ``x`` in base ``k``, least-significant first. digits(0)==[0]."""
    _check_base(k)
    if x < 0:
        raise ValueError("digits() expects a non-negative integer")
    if x == 0:
        return [0]
    out = []
    while x:
        x, r = divmod(x, k)
        out.append(r)
    return out


def from_digits(ds: List[int], k: int) -> int:
    """Inverse of :func:`digits` (least-significant first)."""
    _check_base(k)
    v = 0
    for d in reversed(ds):
        if not (0 <= d < k):
            raise ValueError(f"digit {d} out of range for base {k}")
        v = v * k + d
    return v


def num_digits(x: int, k: int) -> int:
    """Number of base-k digits needed to represent ``x`` (>=1)."""
    return len(digits(x, k))


# ---------------------------------------------------------------------------
# Lemma 1 / Lemma 2 / single-column maxima
# ---------------------------------------------------------------------------

def lemma1_max_carry_sum(k: int) -> Tuple[int, int]:
    """Lemma 1: two-operand one-column max (carry, column-sum) = (1, k-2)."""
    _check_base(k)
    return 1, k - 2


def max_column_total(N: int, k: int) -> int:
    """Max total Z of a 1-column N-operand addition: N * (k-1)."""
    _check_base(k)
    if N < 1:
        raise ValueError("need at least one operand")
    return N * (k - 1)


def exact_max_carry_1col(N: int, k: int) -> int:
    """Exact maximum carry of a 1-column N-operand addition.

    Z = N(k-1); S = Z mod k; C = (Z - S) / k  — eqns (1)/(2).
    """
    z = max_column_total(N, k)
    return (z - (z % k)) // k


def carry_upper_bound(N: int) -> int:
    """Theorem: carry value of an N-operand addition is bounded by N-1,
    for every base k and every word width M."""
    if N < 1:
        raise ValueError("need at least one operand")
    return N - 1


def tight_carry_bound(N: int, k: int) -> int:
    """Tighter single-column bound per the Theorem's case analysis:

    * N <  k       : C = N - 1            (eqn 8)
    * N = n k      : C = N - n            (eqn 9)
    * N = n k + r  : C = N - 1 - n        (eqn 11)

    All three coincide with :func:`exact_max_carry_1col`.
    """
    _check_base(k)
    if N < 1:
        raise ValueError("need at least one operand")
    n, r = divmod(N, k)
    if N < k:
        return N - 1
    if r == 0:
        return N - n
    return N - 1 - n


# ---------------------------------------------------------------------------
# Multi-column maxima (eqns 16/17) and digit counts
# ---------------------------------------------------------------------------

def max_total_sum(N: int, M: int, k: int) -> int:
    """Eqn (17): max total of an N-operand, M-column addition: N (k^M - 1)."""
    _check_base(k)
    if M < 1:
        raise ValueError("need at least one column")
    return N * (k ** M - 1)


def max_carry_multicolumn(N: int, M: int, k: int) -> Tuple[int, int]:
    """(C, S) decomposition of the max multi-column total: C = Z // k^M,
    S = Z mod k^M (Table 2 layout: S is the low M digits)."""
    z = max_total_sum(N, M, k)
    return z // (k ** M), z % (k ** M)


def carry_digits(N: int, M: int, k: int) -> int:
    """Exact number of base-k digits of the worst-case carry (columns beyond
    the M data columns)."""
    c, _ = max_carry_multicolumn(N, M, k)
    return 0 if c == 0 else num_digits(c, k)


def carry_digits_bound(N: int, k: int) -> int:
    """Corollary: digits needed for the carry = digits of (N-1); i.e.
    ceil(log_k(N-1)) "columns" in the paper's phrasing. Exact digit count of
    the theorem's N-1 bound."""
    _check_base(k)
    if N < 2:
        return 0
    return num_digits(N - 1, k)


def result_digits(N: int, M: int, k: int) -> int:
    """Exact worst-case width of the full result: digits of N (k^M - 1).

    Always <= M + carry_digits_bound(N, k)."""
    return num_digits(max_total_sum(N, M, k), k)


# ---------------------------------------------------------------------------
# Column transition (eqn 20, Table 3)
# ---------------------------------------------------------------------------

def column_transition_delta(M: int, p: int, k: int) -> int:
    """Smallest value d = sum_{i<p} n_i k^i with d * (k^M - 1) >= k^p
    (eqn 20, with n_p = 1). Closed form: ceil(k^p / (k^M - 1))."""
    _check_base(k)
    if M < 1 or p < 1:
        raise ValueError("M and p must be >= 1")
    denom = k ** M - 1
    return -((-(k ** p)) // denom)  # ceil division


def column_transition_N(M: int, p: int, k: int) -> int:
    """The operand count at which the result of an N-operand M-column
    addition first needs one more digit past the k^p boundary:
    N = k^p + ceil(k^p / (k^M - 1)).

    Paper's example (Table 3): k=2, M=3, p=4 -> N = 16 + 3 = 19.
    """
    return k ** p + column_transition_delta(M, p, k)


# ---------------------------------------------------------------------------
# A convenience bundle for downstream consumers (kernels, collectives)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CarryBudget:
    """Width plan for an N-operand, M-digit, base-k addition."""

    N: int
    M: int
    k: int
    carry_value_bound: int      # Theorem: N-1
    carry_value_exact: int      # exact worst-case carry
    carry_digits: int           # exact digits of the worst-case carry
    result_digits: int          # exact digits of the worst-case result
    result_digits_bound: int    # M + digits(N-1)  (corollary; >= exact)

    def fits(self, total_digits: int) -> bool:
        """Can a ``total_digits``-wide register hold any N×M-digit sum?"""
        return total_digits >= self.result_digits


def carry_budget(N: int, M: int, k: int = 2) -> CarryBudget:
    """Compute the full width plan (the 'how many carry bits' question that
    the paper argues is the crux of a multi-operand adder)."""
    c_exact, _ = max_carry_multicolumn(N, M, k)
    return CarryBudget(
        N=N,
        M=M,
        k=k,
        carry_value_bound=carry_upper_bound(N),
        carry_value_exact=c_exact,
        carry_digits=carry_digits(N, M, k),
        result_digits=result_digits(N, M, k),
        result_digits_bound=M + carry_digits_bound(N, k),
    )


def _selfcheck() -> None:  # pragma: no cover - manual sanity hook
    # Paper Table 2 rows
    assert max_carry_multicolumn(4, 3, 2) == (3, 4)       # C=11, S=100
    assert max_carry_multicolumn(7, 3, 2) == (6, 1)       # C=110, S=001
    assert max_carry_multicolumn(10, 3, 10) == (9, 990)
    assert column_transition_N(3, 4, 2) == 19             # Table 3
    assert tight_carry_bound(20, 16) == 18                # Table 1b
    assert tight_carry_bound(48, 16) == 45                # Table 1c


if __name__ == "__main__":  # pragma: no cover
    _selfcheck()
    print("carry.py selfcheck OK")
