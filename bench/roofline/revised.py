"""The work of the LPs the revised kernel solves, counted from their inputs.

The same LPs need the same pivots whichever way a solver stores its
basis, so the operations are the simplex count's
(``bench/roofline/simplex.py``): the least a pivot needs.  The bytes
differ: the LPs share ONE ``A``, read once for the call, and each LP
reads its own ``b`` and ``c`` and writes its answer once.
"""

from bench.roofline import simplex

#: Short names of the kernels whose device time this work is set against.
KERNELS = r"^revised(_sweep)?_kernel$"


def work(m: int, n: int, itemsize: int, lps: int, pivots: int, phase1_lps: int, calls: int):
    """``(operations, bytes)`` of ``calls`` calls of ``lps`` LPs in all over one ``A`` a call."""
    nbytes = (calls * m * n * itemsize
              + lps * ((m + n) * itemsize + simplex.answer_bytes(n, itemsize)))
    return simplex.flops(m, n, pivots, phase1_lps), nbytes
