"""The work of the LPs the simplex kernel solves, counted from their inputs.

Counts what the LPs need, not what the port's tableau holds, so that a
change of layout cannot move the yardstick:

* a pivot on the condensed tableau (the m + 1 rows over the right-hand
  side and the n nonbasic columns): a multiply and a subtract for each
  of its (m + 1)(n + 1) entries, m ratio divides and n + 1 divides of
  the pivot row;
* an LP that starts infeasible prices phase I's objective row over its
  m rows once and phase II's once more at the switch: 2 m (n + 1)
  operations each;
* bytes: each LP's ``A``, ``b`` and ``c`` read once, its ``x``,
  objective, status and iteration count written once.
"""

#: Short names of the kernels whose device time this work is set against.
KERNELS = r"^simplex(_cluster)?_kernel$"


def pivot_flops(m: int, n: int) -> int:
    return 2 * (m + 1) * (n + 1) + m + (n + 1)


def phase1_flops(m: int, n: int) -> int:
    return 2 * 2 * m * (n + 1)


def flops(m: int, n: int, pivots: int, phase1_lps: int) -> int:
    return pivots * pivot_flops(m, n) + phase1_lps * phase1_flops(m, n)


def answer_bytes(n: int, itemsize: int) -> int:
    """``x`` and the objective in the LP's dtype, status and iterations as int32."""
    return (n + 1) * itemsize + 2 * 4


def work(m: int, n: int, itemsize: int, lps: int, pivots: int, phase1_lps: int, calls: int):
    """``(operations, bytes)`` of ``lps`` LPs, each with its own ``A``, over ``calls`` calls,
    that took ``pivots`` pivots, ``phase1_lps`` of them starting infeasible."""
    nbytes = lps * ((m * n + m + n) * itemsize + answer_bytes(n, itemsize))
    return flops(m, n, pivots, phase1_lps), nbytes
