"""The port's engine blocks against ``repro.core.engine`` on random tableaus.

Same numpy-seeded inputs go through both packages.  Integer outputs
(entering column, leaving row, statuses, bases) must be equal; the RPC
noise must be bit-equal; float outputs computed by the same operations
in the same order must be equal, and the phase-II pricing (a dot product
whose summation order differs between XLA and the port) agrees to
rtol 1e-6 in float32 and 1e-13 in float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import engine as jengine
from repro.core.tableau import TableauSpec as JSpec
from repro_torch.core import engine as tengine
from repro_torch.core.tableau import TableauSpec as TSpec

DTYPES = [np.float32, np.float64]


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_state(rng, bsz, m, n, dtype, layout="compact"):
    """A random tableau with rounded entries (so ties occur) and a basis."""
    q = TSpec(m, n, layout).q
    tab = np.round(rng.uniform(-2.0, 2.0, size=(bsz, m + 1, q)), 1).astype(dtype)
    tab[:, :m, 0] = np.abs(tab[:, :m, 0])
    tab[:, :m, 0][rng.uniform(size=(bsz, m)) < 0.2] = 0.0
    basis = np.stack([rng.permutation(np.arange(1, 1 + n + 2 * m))[:m] for _ in range(bsz)])
    return tab, basis.astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed,step,row_offset", [(0, 0, 0), (7, 13, 5), (2**31 - 1, 999, 4096),
                                                  (-1, 2**20, 123456)])
def test_rpc_noise_bit_equal(dtype, seed, step, row_offset):
    ref = np.asarray(jengine.rpc_noise(seed, step, row_offset, 9, 37, jnp.dtype(dtype)))
    got = tengine.rpc_noise(seed, step, row_offset, 9, 37, _t(ref).dtype).numpy()
    assert got.dtype == ref.dtype
    assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rule", ["lpc", "bland", "rpc"])
def test_select_entering(dtype, rule):
    rng = np.random.default_rng(1)
    bsz, m, n = 16, 6, 5
    q = TSpec(m, n).q
    obj = np.round(rng.uniform(-1.0, 1.0, size=(bsz, q)), 1).astype(dtype)
    obj[3] = -1.0  # no positive column: bland/rpc fall back to index 0
    obj[4, 2] = obj[4, 7] = 0.9  # ties go to the lowest index
    noise = np.asarray(jengine.rpc_noise(3, 4, 0, bsz, q, jnp.dtype(dtype)))
    e_j, max_j = jengine.select_entering(
        jnp.asarray(obj), jengine.eligible_mask(q, m, n), rule, 1e-5,
        jnp.asarray(noise) if rule == "rpc" else None,
    )
    e_t, max_t = tengine.select_entering(
        _t(obj), tengine.eligible_mask(q, m, n), rule, 1e-5,
        _t(noise) if rule == "rpc" else None,
    )
    assert e_t.dtype == torch.int32
    assert np.array_equal(e_t.numpy(), np.asarray(e_j))
    assert np.array_equal(max_t.numpy(), np.asarray(max_j))


def test_bland_takes_first_positive_column():
    # torch.argmax refuses bool input; the port casts the mask first and
    # keeps the first-True (smallest index) rule.
    obj = torch.tensor([[5.0, 0.0, 0.2, 0.9, 0.2, 0.0]])
    e, _ = tengine.select_entering(obj, tengine.eligible_mask(6, 2, 3), "bland", 1e-5)
    assert int(e[0]) == 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["compact", "dense"])
def test_ratio_test_and_pivot_update(dtype, layout):
    rng = np.random.default_rng(2)
    bsz, m, n = 12, 7, 5
    tab, basis = _random_state(rng, bsz, m, n, dtype, layout)
    e = rng.integers(1, 1 + n + m, size=bsz).astype(np.int32)
    do_pivot = rng.uniform(size=bsz) < 0.7
    js, ts = JSpec(m, n, layout), TSpec(m, n, layout)
    l_j, r_j, col_j = jengine.ratio_test(jnp.asarray(tab), jnp.asarray(basis),
                                         jnp.asarray(e), js, 1e-5, gather=True)
    l_t, r_t, col_t = tengine.ratio_test(_t(tab), _t(basis), _t(e), ts, 1e-5)
    assert np.array_equal(l_t.numpy(), np.asarray(l_j))
    assert np.array_equal(r_t.numpy(), np.asarray(r_j))
    assert np.array_equal(col_t.numpy(), np.asarray(col_j))

    # float32: the port rounds the rank-1 update once, as XLA's jitted
    # block contracts it into a fused multiply-add; float64 stays unfused,
    # as the un-jitted block computes it.
    update = jengine.pivot_update
    if dtype == np.float32:
        update = jax.jit(update, static_argnames=("spec", "tol", "gather"))
    tab_j, basis_j = update(
        jnp.asarray(tab), jnp.asarray(basis), jnp.asarray(e), l_j, col_j,
        jnp.asarray(do_pivot), js, 1e-5, gather=True,
    )
    tab_t, basis_t = tengine.pivot_update(
        _t(tab), _t(basis), _t(e), l_t, col_t, _t(do_pivot), ts, 1e-5
    )
    assert np.array_equal(basis_t.numpy(), np.asarray(basis_j))
    assert np.array_equal(tab_t.numpy(), np.asarray(tab_j))


@pytest.mark.parametrize("dtype", DTYPES)
def test_phase_transition_and_pricing(dtype):
    rng = np.random.default_rng(3)
    bsz, m, n = 10, 6, 4
    tab, basis = _random_state(rng, bsz, m, n, dtype)
    # A consistent tableau: -z0 equals the sum of the basic artificials
    # (exact in binary), so the reference's test of -z0 and the port's sum
    # over the basic artificials decide alike.
    art = basis >= JSpec(m, n).art_start
    tab[:, :m, 0] = np.where(art, rng.choice([0.0, 0.5], size=(bsz, m)), tab[:, :m, 0])
    tab[:, m, 0] = np.where(art, tab[:, :m, 0], 0.0).sum(axis=1)
    c = rng.uniform(0.1, 1.0, size=(bsz, n)).astype(dtype)
    spec_j, spec_t = JSpec(m, n), TSpec(m, n)
    c_ext = np.zeros((bsz, spec_t.q), dtype)
    c_ext[:, 1 : 1 + n] = c
    phase = rng.choice([1, 2], size=bsz).astype(np.int32)
    status = rng.choice([0, 0, 0, 1], size=bsz).astype(np.int32)
    at_opt = rng.uniform(size=bsz) < 0.6
    feas = np.full(bsz, 1e-5, dtype)
    rtol = 1e-6 if dtype == np.float32 else 1e-13

    out_j = jengine.phase_transition(
        jnp.asarray(tab), jnp.asarray(basis), jnp.asarray(phase), jnp.asarray(status),
        jnp.asarray(at_opt), jnp.asarray(c_ext), jnp.asarray(feas), spec_j, gather=True,
    )
    out_t = tengine.phase_transition(
        _t(tab), _t(basis), _t(phase), _t(status), _t(at_opt), _t(c_ext), _t(feas), spec_t
    )
    assert np.array_equal(out_t[1].numpy(), np.asarray(out_j[1]))  # phase
    assert np.array_equal(out_t[2].numpy(), np.asarray(out_j[2]))  # status
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]), rtol=rtol, atol=rtol)

    pr_j = jengine.phase2_objective(jnp.asarray(tab), jnp.asarray(basis), spec_j,
                                    jnp.asarray(c_ext), gather=True)
    pr_t = tengine.phase2_objective(_t(tab), _t(basis), spec_t, _t(c_ext))
    np.testing.assert_allclose(pr_t.numpy(), np.asarray(pr_j), rtol=rtol, atol=rtol)


def test_phase1_feasibility_reads_the_basic_artificials():
    # After phase I, float32 -z0 keeps the cancellation residue of its
    # pivots.  The reference compares that residue with the threshold and
    # can call a feasible LP INFEASIBLE (2 of 256 type-2 LPs at 200x100,
    # ROADMAP queue 3); the port sums the basic artificials, here none.
    m, n = 3, 2
    spec_j, spec_t = JSpec(m, n), TSpec(m, n)
    tab = np.zeros((1, m + 1, spec_t.q), np.float32)
    tab[0, :m, 0] = [1.0, 2.0, 0.5]
    tab[0, m, 0] = 3e-5  # residue, above the threshold
    basis = np.array([[1, 2, 4]], np.int32)  # originals and a slack: no artificial
    args = (np.array([1], np.int32), np.zeros(1, np.int32), np.array([True]),
            np.zeros((1, spec_t.q), np.float32), np.array([2.9e-5], np.float32))
    out_t = tengine.phase_transition(_t(tab), _t(basis), *map(_t, args), spec_t)
    out_j = jengine.phase_transition(jnp.asarray(tab), jnp.asarray(basis),
                                     *map(jnp.asarray, args), spec_j, gather=True)
    assert int(out_j[2][0]) == jengine.INFEASIBLE
    assert (int(out_t[2][0]), int(out_t[1][0])) == (0, 2)  # RUNNING, in phase II
    assert float(tengine.phase1_value(_t(tab), _t(basis), spec_t)[0]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_extract_solution(dtype):
    rng = np.random.default_rng(4)
    bsz, m, n = 8, 5, 4
    tab, basis = _random_state(rng, bsz, m, n, dtype)
    status = rng.choice([1, 2, 3, 4], size=bsz).astype(np.int32)
    obj_j, x_j = jengine.extract_solution(jnp.asarray(tab), jnp.asarray(basis),
                                          jnp.asarray(status), JSpec(m, n), n, -np.inf)
    obj_t, x_t = tengine.extract_solution(_t(tab), _t(basis), _t(status), TSpec(m, n), n,
                                          -np.inf)
    assert np.array_equal(obj_t.numpy(), np.asarray(obj_j))
    assert np.array_equal(x_t.numpy(), np.asarray(x_j))


def test_feasibility_threshold_and_tolerance():
    b = np.array([[3.0, -250.5], [0.1, 0.2]], np.float32)
    assert np.array_equal(tengine.phase1_feasibility_tol(_t(b)).numpy(),
                          np.asarray(jengine.phase1_feasibility_tol(jnp.asarray(b))))
    assert tengine.default_tolerance(torch.float32) == jengine.default_tolerance(jnp.float32)
    assert tengine.default_tolerance(torch.float64) == jengine.default_tolerance(jnp.float64)
