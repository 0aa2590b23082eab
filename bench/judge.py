"""The comparison that decides ``correct``.

Two parts, both after the window has closed:

* every answer the window's calls returned is held to what it claims:
  an OPTIMAL ``x`` lies in its LP's feasible set and gives its objective
  (``infeasibility``, ``objective_mismatch``); an answer left without a
  verdict (a status other than OPTIMAL, UNBOUNDED or INFEASIBLE: the
  answer never came) makes ``infeasibility`` infinite;
* a sample of the answers, drawn from the seed, is held to the float64
  reference (``bench/reference/simplex64.py``) solved on the same LPs:
  ``status_mismatch`` (the number of LPs whose status differs from the
  reference's: a false UNBOUNDED or INFEASIBLE, which no certificate
  reads, or a false OPTIMAL; limit 0), ``answer_gap`` (the 99th
  percentile of an LP's relative objective gap over the LPs whose
  status agrees), ``x_gap`` (the same of the point's widest relative
  gap) and ``pivot_mismatch`` (the share of LPs that took another
  number of pivots than the reference under the same rule).  The
  percentile and not the widest gap: a float32 solve of the rare
  near-degenerate LP lands a few percent off the float64 optimum, so
  the widest gap over a sample swings from seed to seed by orders of
  magnitude (``PERF.md``).

Each number is lower-is-better and has its limit in the cell's file
(``limits``); ``correct`` means every number within its limit.  The
control (``bench/readings.py``) puts the reference computed in TF32 in
the program's place and goes through the same numbers.
"""

from __future__ import annotations

import math

import torch

from bench.reference import simplex64

OPTIMAL, UNBOUNDED, INFEASIBLE = simplex64.OPTIMAL, simplex64.UNBOUNDED, simplex64.INFEASIBLE

#: Rows of a block of the certificate check (float64 copies of ``A``).
BLOCK = 8192


def certificates(a, b, c, objective, x, status):
    """``(infeasibility, objective_mismatch, unresolved)`` of one block of answers."""
    a, b, c, x = (t.double() for t in (a, b, c, x))
    objective = objective.double()
    ok = status == OPTIMAL
    unresolved = int((~(ok | (status == UNBOUNDED) | (status == INFEASIBLE))).sum())
    if not bool(ok.any()):
        return 0.0, 0.0, unresolved
    a, b, c, x, objective = a[ok], b[ok], c[ok], x[ok], objective[ok]
    # Each row's residual against the row's own magnitude, so a large x
    # (an LP whose optimum lies far out) is held to float32's reach.
    size = torch.bmm(a.abs(), x.abs()[:, :, None])[..., 0] + b.abs()
    rows = (torch.bmm(a, x[:, :, None])[..., 0] - b) / size.clamp(min=1.0)
    scale = x.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    infeas = torch.maximum(rows.amax(dim=1), (-x / scale).amax(dim=1)).clamp(min=0.0)
    value = (c * x).sum(dim=1)
    mismatch = (value - objective).abs() / objective.abs().clamp(min=1.0)
    return _worst(infeas), _worst(mismatch), unresolved


def _worst(v: torch.Tensor) -> float:
    """The largest entry, a NaN counting as infinitely far off."""
    return float(torch.nan_to_num(v, nan=math.inf).max())


#: The percentile of the sample's per-LP gaps that is compared.
PERCENTILE = 0.99


def gaps(objective, x, status, ref):
    """Per-LP ``(objective gap, x gap)`` against the reference over the LPs whose status
    agrees with it, 0 where both agree the LP has no optimum."""
    same = status.to(torch.int64) == ref.status
    both = (ref.status == OPTIMAL)[same]
    gap = (objective.double() - ref.objective).abs() / ref.objective.abs().clamp(min=1.0)
    xg = (x.double() - ref.x).abs().amax(dim=1) / ref.x.abs().amax(dim=1).clamp(min=1.0)
    return [torch.where(both, torch.nan_to_num(g[same], nan=math.inf), torch.zeros_like(g[same]))
            for g in (gap, xg)]


def rank(v: torch.Tensor, q: float) -> float:
    """The nearest-rank ``q`` quantile of ``v``: at least a share ``q`` of it lies at or
    below; infinite for no entries."""
    if v.numel() == 0:
        return math.inf
    k = max(math.ceil(q * v.numel()) - 1, 0)
    return float(v.sort().values[k])


def compare(objective, x, status, iterations, ref):
    """The sample's numbers against the reference's answers ``ref``."""
    gap, xg = gaps(objective, x, status, ref)
    pivots = (iterations.to(torch.int64) != ref.iterations).double().mean()
    return dict(status_mismatch=float((status.to(torch.int64) != ref.status).sum()),
                answer_gap=rank(gap, PERCENTILE), x_gap=rank(xg, PERCENTILE),
                pivot_mismatch=float(pivots))


def draw_sample(counts, size, seed):
    """``size`` distinct ``(call, row)`` pairs over calls of ``counts`` LPs, from the seed."""
    total = sum(counts)
    g = torch.Generator().manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
    flat = torch.randperm(total, generator=g)[:min(size, total)].sort().values
    starts = torch.tensor([0] + counts[:-1]).cumsum(0)
    call = torch.searchsorted(starts, flat, right=True) - 1
    return call, flat - starts[call]


def window(traffic, pool, calls, seed, size):
    """Certificates of every answer of ``calls`` and the sample's inputs and answers.

    ``calls`` are ``(entry index, answers)`` pairs.  Returns
    ``(numbers, sample, unresolved)``: ``sample`` holds the sampled LPs ``(a, b, c)``
    and the program's answers for them, on the device.
    """
    infeas = mismatch = 0.0
    unresolved = 0
    for entry_ix, sol in calls:
        entry = pool[entry_ix]
        n_lps = traffic.lps(entry)
        for lo in range(0, n_lps, BLOCK):
            part = slice(lo, min(lo + BLOCK, n_lps))
            f, mm, u = certificates(*traffic.rows(entry, part), sol.objective[part], sol.x[part],
                                    sol.status[part])
            infeas, mismatch, unresolved = max(infeas, f), max(mismatch, mm), unresolved + u
    counts = [traffic.lps(pool[e]) for e, _ in calls]
    which, row = draw_sample(counts, size, seed)
    parts = {k: [] for k in ("a", "b", "c", "objective", "x", "status", "iterations")}
    for ci in which.unique().tolist():
        entry_ix, sol = calls[ci]
        idx = row[which == ci].to(sol.x.device)
        for key, t in zip("abc", traffic.rows(pool[entry_ix], idx)):
            parts[key].append(t)
        for key in ("objective", "x", "status", "iterations"):
            parts[key].append(getattr(sol, key)[idx])
    sample = {k: torch.cat(v) for k, v in parts.items()}
    numbers = dict(infeasibility=math.inf if unresolved else infeas, objective_mismatch=mismatch)
    return numbers, sample, unresolved


def against_reference(sample, ref=None):
    """The sample's numbers against the float64 reference (solved here unless given)."""
    if ref is None:
        ref = simplex64.solve(sample["a"], sample["b"], sample["c"])
    return compare(sample["objective"], sample["x"], sample["status"], sample["iterations"], ref)


def verdict(numbers, limits):
    """``(correct, checks)``: each number beside its limit, in the limits' order."""
    checks = {}
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and not math.isnan(value) and value <= limit
        checks[name] = dict(value=value, limit=limit, ok=ok)
    return all(c["ok"] for c in checks.values()), checks
