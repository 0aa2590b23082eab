"""The port's tableau layer against ``repro.core.tableau``.

Cold tableaus are built by the same element-wise operations in both
packages and must be equal; warm tableaus go through a linear solve and
an einsum whose reduction orders differ, so they agree to rtol 1e-5
(float32) or 1e-9 (float64) with equal bases, phases and fallback masks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import lp as jlp
from repro.core import tableau as jtab
from repro_torch.core import lp as tlp
from repro_torch.core import tableau as ttab


def _batches(seed, bsz, m, n, feasible, dtype):
    jb = jlp.random_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible, dtype=dtype)
    tb = tlp.random_lp_batch(np.random.default_rng(seed), bsz, m, n, feasible, dtype=dtype,
                             device="cpu")
    for name in ("a", "b", "c"):
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    return jb, tb


def test_spec_column_map_matches_reference():
    for layout in ttab.LAYOUTS:
        t, j = ttab.TableauSpec(12, 6, layout), jtab.TableauSpec(12, 6, layout)
        assert (t.q, t.art_start, t.slack_start, t.num_eligible) == (
            j.q, j.art_start, j.slack_start, j.num_eligible)
        assert t.bytes_per_lp(torch.float32) == j.bytes_per_lp(jnp.float32)
        assert ttab.TableauSpec.from_tableau(12, 6, t.q).layout == layout
    with pytest.raises(ValueError):
        ttab.TableauSpec(3, 3, "sparse")


@pytest.mark.parametrize("layout", ["compact", "dense"])
@pytest.mark.parametrize("feasible,m,n", [(True, 9, 7), (False, 20, 8)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cold_tableau_equal(layout, feasible, m, n, dtype):
    jb, tb = _batches(11, 6, m, n, feasible, dtype)
    tab_j, basis_j, phase_j = jtab.build_tableau(jb.a, jb.b, jb.c,
                                                 spec=jtab.TableauSpec(m, n, layout))
    tab_t, basis_t, phase_t = ttab.build_tableau(tb.a, tb.b, tb.c,
                                                 spec=ttab.TableauSpec(m, n, layout))
    assert basis_t.dtype == torch.int32 and phase_t.dtype == torch.int32
    assert np.array_equal(basis_t.numpy(), np.asarray(basis_j))
    assert np.array_equal(phase_t.numpy(), np.asarray(phase_j))
    assert np.array_equal(tab_t.numpy(), np.asarray(tab_j))


@pytest.mark.parametrize("layout", ["compact", "dense"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_warm_tableau_matches_reference(layout, dtype):
    m, n = 8, 6
    jb, tb = _batches(12, 5, m, n, True, dtype)
    # A solved basis (feasible), an out-of-range row, a duplicated
    # (singular) basis, and the slack basis.
    from repro.core import simplex as jsimplex

    solved = np.asarray(jsimplex.solve_batched(jb.a, jb.b, jb.c).basis).copy()
    basis0 = solved.copy()
    basis0[1, 0] = 0  # out of range
    basis0[2, 1] = basis0[2, 0]  # duplicated column: singular
    basis0[3] = np.arange(n + 1, n + m + 1)  # slack basis
    spec_j, spec_t = jtab.TableauSpec(m, n, layout), ttab.TableauSpec(m, n, layout)
    tab_j, basis_j, phase_j = jtab.build_tableau(jb.a, jb.b, jb.c, jnp.asarray(basis0), spec_j)
    tab_t, basis_t, phase_t = ttab.build_tableau(tb.a, tb.b, tb.c, torch.from_numpy(basis0),
                                                 spec_t)
    assert np.array_equal(basis_t.numpy(), np.asarray(basis_j))
    assert np.array_equal(phase_t.numpy(), np.asarray(phase_j))
    assert list(phase_t.numpy()) == [2, 2, 2, 2, 2]  # feasible-start batch
    rtol = 1e-5 if dtype == np.float32 else 1e-9
    np.testing.assert_allclose(tab_t.numpy(), np.asarray(tab_j), rtol=rtol, atol=rtol)


def test_singular_warm_basis_falls_back_cold_without_raising():
    m, n = 6, 4
    _, tb = _batches(13, 3, m, n, True, np.float64)
    basis0 = np.tile(np.arange(1, m + 1), (3, 1)).astype(np.int32)
    basis0[:, 1] = basis0[:, 0]  # every row singular
    cold = ttab.build_tableau(tb.a, tb.b, tb.c)
    warm = ttab.build_tableau(tb.a, tb.b, tb.c, torch.from_numpy(basis0))
    for x, y in zip(cold, warm):
        assert torch.equal(x, y)
