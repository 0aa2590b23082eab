"""The variant planning of the simplex, PDHG and revised kernels (``kernels/cluster.py``).

Pure functions of the shape, the element type and the device's largest
schedulable cluster: they run here without a card.  The kernels' own
layouts are held against these byte counts on the card
(``tests/test_torch_gpu.py::test_cluster_layouts_match_the_kernels`` and
``::test_revised_past_the_resident_limit_takes_the_global_variant``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core import lp as tlp
from repro_torch.core import pdhg
from repro_torch.core.simplex import phase2_costs
from repro_torch.core.tableau import TableauSpec, build_tableau
from repro_torch.core import revised
from repro_torch.kernels import cluster, pdhg_cuda, revised_cuda, simplex_cuda

F32, F64 = torch.float32, torch.float64


def _q(m, n, layout="compact"):
    return TableauSpec(m, n, layout).q


# The main paths' shapes: type 1 (100x100), type 2 (200x100), the list
# buckets, a 500x500 crossover tile (warm compact tableau).
@pytest.mark.parametrize("m,n,dtype,k", [
    (100, 100, F32, 1), (100, 100, F64, 1),
    (200, 100, F32, 2), (200, 100, F64, 3),
    (5, 5, F32, 1), (28, 28, F32, 1),
    (500, 500, F32, 10),
])
def test_simplex_plan_for_the_main_paths(m, n, dtype, k):
    p = cluster.plan_simplex(m, _q(m, n), dtype, cluster.MAX_CLUSTER)
    assert (p.variant, p.k) == ("cluster", k)
    assert p.smem == cluster.simplex_smem(m, _q(m, n), dtype.itemsize, k)


@pytest.mark.parametrize("m,n,dtype,k", [
    (500, 500, F32, 5), (500, 500, F64, 10), (200, 200, F64, 2), (100, 100, F32, 1),
])
def test_pdhg_plan_for_the_main_paths(m, n, dtype, k):
    p = cluster.plan_pdhg(m, n, dtype, cluster.MAX_CLUSTER)
    assert (p.variant, p.k) == ("cluster", k)
    assert p.k <= 8 or dtype == F64
    assert p.smem == cluster.pdhg_smem(m, n, dtype.itemsize, k)


def test_layout_arithmetic():
    # Type 1: 100 rows of 201 floats, the objective row, the pivot row, the
    # pivot column (101) and 100 basis entries.
    assert cluster.simplex_smem(100, 201, 4, 1) == 4 * (100 * 201 + 2 * 201 + 101) + 4 * 100
    # 500x500 float32 PDHG at k = 5: 100 rows of A, partial A'y and x1, six
    # row and four column vectors of 100, 8 + 8 x 16 partials.
    assert cluster.pdhg_smem(500, 500, 4, 5) == 4 * (100 * 500 + 1000 + 600 + 400 + 136)
    # A ragged last slice is sized as the others.
    assert cluster.simplex_smem(7, 10, 8, 3) == cluster.simplex_smem(9, 10, 8, 3)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_no_plan_exceeds_a_ctas_shared_memory(dtype):
    item = dtype.itemsize
    for m in (1, 2, 5, 28, 99, 100, 200, 333, 500, 640, 700, 1000):
        for n in (1, 5, 28, 100, 300, 500, 1000):
            for max_k in (1, 4, 8, 16):
                for p, smem_of in [
                    (cluster.plan_simplex(m, _q(m, n), dtype, max_k),
                     lambda k: cluster.simplex_smem(m, _q(m, n), item, k)),
                    (cluster.plan_pdhg(m, n, dtype, max_k),
                     lambda k: cluster.pdhg_smem(m, n, item, k)),
                ]:
                    if p.variant != "cluster":
                        # Nothing up to max_k fits.
                        assert not any(cluster.fits(smem_of(k)) for k in range(1, max_k + 1))
                        continue
                    assert 1 <= p.k <= max_k
                    assert p.smem + cluster.STATIC_RESERVE <= cluster.SMEM_LIMIT == 232_448
                    # The least k that fits.
                    assert p.k == 1 or not cluster.fits(smem_of(p.k - 1))


def test_second_variant_past_the_largest_cluster():
    # 700x700 simplex needs 18 CTAs and 1000x1000 PDHG (A 4 MB) more than 16.
    assert cluster.plan_simplex(700, _q(700, 700), F32, 16) == cluster.Plan("global")
    assert cluster.plan_pdhg(1000, 1000, F32, 16) == cluster.Plan("streaming")
    # A device that schedules fewer CTAs a cluster moves the switch.
    assert cluster.plan_pdhg(500, 500, F32, 4).variant == "streaming"
    assert cluster.plan_pdhg(500, 500, F32, 5).k == 5
    assert cluster.plan_simplex(500, _q(500, 500), F32, 9).variant == "global"
    assert cluster.plan_simplex(200, _q(200, 100), F32, 1).variant == "global"
    assert cluster.plan_simplex(100, _q(100, 100), F32, 0).variant == "global"


def test_forced_cluster_size():
    q = _q(60, 60)
    assert cluster.plan_simplex(60, q, F32, 16, k=3) == \
        cluster.Plan("cluster", 3, cluster.simplex_smem(60, q, 4, 3))
    assert cluster.plan_simplex(60, q, F32, 16, k=0) == cluster.Plan("global")
    assert cluster.plan_pdhg(60, 40, F64, 16, k=0) == cluster.Plan("streaming")
    assert cluster.plan_pdhg(500, 500, F32, 16, k=16).k == 16
    with pytest.raises(ValueError, match="at most 4"):
        cluster.plan_pdhg(500, 500, F32, 4, k=8)
    with pytest.raises(ValueError, match="shared memory"):
        cluster.plan_pdhg(500, 500, F32, 16, k=4)
    with pytest.raises(ValueError, match="outside"):
        cluster.plan_simplex(60, q, F32, 16, k=17)
    with pytest.raises(ValueError, match="outside"):
        cluster.plan_simplex(60, q, F32, 16, k=-1)


def test_plans_are_pure():
    a = [cluster.plan_pdhg(500, 500, F32, 16) for _ in range(3)]
    b = [cluster.plan_simplex(200, 301, F64, 8) for _ in range(3)]
    assert a[0] == a[1] == a[2] and b[0] == b[1] == b[2]


def _simplex_inputs(m=24, n=12):
    batch = tlp.random_lp_batch(np.random.default_rng(5), 8, m, n, False, dtype=np.float32,
                                device="cpu")
    spec = TableauSpec(m, n, "dense")
    tab, basis, phase = build_tableau(batch.a, batch.b, batch.c, spec=spec)
    return (tab, basis, phase, phase2_costs(batch.c, spec),
            engine.phase1_feasibility_tol(batch.b).contiguous(), spec)


def test_simplex_wrapper_raises_on_a_cluster_the_device_cannot_take(monkeypatch):
    tab, basis, phase, c_ext, feas, spec = _simplex_inputs()
    kw = dict(spec=spec, tol=engine.default_tolerance(tab.dtype))
    monkeypatch.setattr(simplex_cuda, "device_max_k", lambda dtype, device: 4)
    with pytest.raises(ValueError, match="at most 4"):
        simplex_cuda.simplex(tab.clone(), basis.clone(), phase.clone(), c_ext, feas, 200,
                             _k=8, **kw)
    # A cluster the device takes: on CPU tensors the plain version runs.
    got = simplex_cuda.simplex(tab.clone(), basis.clone(), phase.clone(), c_ext, feas, 200,
                               _k=3, **kw)
    want = simplex_cuda.simplex_plain(tab.clone(), basis.clone(), phase.clone(), c_ext, feas,
                                      200, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pdhg_wrapper_raises_on_a_cluster_the_device_cannot_take(monkeypatch):
    batch = tlp.random_lp_batch(np.random.default_rng(3), 4, 30, 20, dtype=np.float32,
                                device="cpu")
    a, b, c = batch.a, batch.b, batch.c
    tau, sigma, scales = pdhg.step_sizes(a, b, c)
    kw = dict(tol=1e-4, restart=64)
    monkeypatch.setattr(pdhg_cuda, "device_max_k", lambda dtype, device: 2)
    with pytest.raises(ValueError, match="at most 2"):
        pdhg_cuda.pdhg(a, b, c, pdhg.init_state(4, 30, 20, a.dtype), tau, sigma, scales, 50,
                       _k=4, **kw)
    st1, st2 = pdhg.init_state(4, 30, 20, a.dtype), pdhg.init_state(4, 30, 20, a.dtype)
    got = pdhg_cuda.pdhg(a, b, c, st1, tau, sigma, scales, 50, _k=2, **kw)
    want = pdhg_cuda.pdhg_plain(a, b, c, st2, tau, sigma, scales, 50, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(st1.x, st2.x)


def test_cpu_tensors_never_count_a_launch():
    tab, basis, phase, c_ext, feas, spec = _simplex_inputs()
    before = (simplex_cuda.launches, dict(simplex_cuda.variant_launches))
    simplex_cuda.simplex(tab, basis, phase, c_ext, feas, 50, spec=spec)
    assert (simplex_cuda.launches, simplex_cuda.variant_launches) == before
    assert set(simplex_cuda.variant_launches) == {"cluster", "global"}
    assert set(pdhg_cuda.variant_launches) == {"cluster", "streaming"}


# The revised kernel's resident variant: the paper's shared types 1 and 2,
# the two reach rows' canonical polytopes (5-dim: m = n = 10; helicopter:
# m = n = 56), float32.
@pytest.mark.parametrize("m,n,smem", [
    (100, 100, 44_416), (200, 100, 228_848), (10, 10, 1_000), (56, 56, 15_920),
])
def test_revised_plan_for_the_main_paths(m, n, smem):
    p = cluster.plan_revised(m, n, F32)
    assert p == cluster.Plan("resident", 1, smem)
    assert smem == cluster.revised_smem(m, n, 4)


@pytest.mark.parametrize("m,n,dtype", [(300, 100, F32), (200, 100, F64), (235, 100, F32),
                                       (164, 100, F64), (1000, 10, F32)])
def test_revised_plan_past_the_resident_limit(m, n, dtype):
    assert cluster.plan_revised(m, n, dtype) == cluster.Plan("global")
    assert cluster.plan_revised(m, n, dtype, "global") == cluster.Plan("global")
    with pytest.raises(ValueError, match="shared memory"):
        cluster.plan_revised(m, n, dtype, "resident")


def test_revised_resident_limit_is_the_largest_that_fits():
    for dtype, last in [(F32, 234), (F64, 163)]:
        item = dtype.itemsize
        assert cluster.fits(cluster.revised_smem(last, 100, item))
        assert not cluster.fits(cluster.revised_smem(last + 1, 100, item))
        assert cluster.plan_revised(last, 100, dtype).variant == "resident"
    with pytest.raises(ValueError, match="unknown variant"):
        cluster.plan_revised(10, 10, F32, "cluster")


def test_revised_layout_arithmetic():
    # Type 1: binv in 100 rows of 100 floats (25 vectors of 16 bytes, an odd
    # number), seven vectors of 100, the costs (100), the objective row (201,
    # padded to 204), the basis (100 ints).
    assert cluster.revised_smem(100, 100, 4) == 4 * (100 * 100 + 700 + 100 + 204) + 4 * 100
    # The row stride is an odd number of 16-byte vectors, at least m.
    assert [cluster.binv_ld(m, 4) for m in (1, 10, 55, 56, 100, 200)] == [4, 12, 60, 60, 100, 204]
    assert [cluster.binv_ld(m, 8) for m in (1, 7, 28, 30, 163)] == [2, 10, 30, 30, 166]
    for m in range(1, 300):
        for item in (4, 8):
            vw = 16 // item
            ld = cluster.binv_ld(m, item)
            assert ld >= m and ld % vw == 0 and (ld // vw) % 2 == 1 and ld - m < 2 * vw
    # float64: 7 rows of stride 10, vectors padded to 8, costs to 4, the
    # objective row (11) to 12.
    assert cluster.revised_smem(7, 3, 8) == 8 * (7 * 10 + 7 * 8 + 4 + 12) + 4 * 7


def test_revised_stages_a_only_where_a_cta_has_its_sm():
    # Type 1: four CTAs an SM, A (40 KB) stays in L1 beside them.
    assert cluster.revised_stage_rows(100, 100, 4) == 0
    # Type 2: one CTA an SM; two buffers of 72 rows of A (28.8 KB each).
    assert cluster.revised_stage_rows(200, 100, 4) == 72
    assert cluster.revised_smem(200, 100, 4) == (
        cluster._revised_base(200, 100, 4, 0) + 4 * 2 * (72 * 100 + 4))
    # More columns than threads, or no room left: no staging.
    assert cluster.revised_stage_rows(200, 300, 4) == 0
    assert cluster.revised_stage_rows(234, 100, 4) == 0
    for m in range(1, 240):
        for n, item in [(100, 4), (37, 4), (100, 8), (5, 8)]:
            rows = cluster.revised_stage_rows(m, n, item)
            assert rows % (16 // item) == 0 and rows <= m + 16 // item
            smem = cluster.revised_smem(m, n, item)
            if cluster.fits(cluster._revised_base(m, n, item, 0)):
                assert cluster.fits(smem)
            if rows:  # one CTA an SM either way
                assert 2 * (smem + cluster.STATIC_RESERVE + cluster.CTA_RESERVE) > cluster.SM_SMEM


def _revised_inputs(m=12, n=6, bsz=4):
    sb = tlp.random_shared_lp_batch(np.random.default_rng(2), bsz, m, n, False, device="cpu")
    state = revised.init_traced(sb.a, sb.b, None)
    bufs = [t.clone() for t in (state.binv, state.basis, state.xb, state.phase)]
    return sb, bufs, engine.phase1_feasibility_tol(sb.b).contiguous()


def test_revised_wrapper_forces_a_variant_or_raises():
    sb, bufs, feas = _revised_inputs()
    want = revised_cuda.revised_plain(sb.a, sb.b, sb.c, *[t.clone() for t in bufs], feas, 100)
    for variant in ("resident", "global"):
        got = revised_cuda.revised(sb.a, sb.b, sb.c, *[t.clone() for t in bufs], feas, 100,
                                   _variant=variant)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unknown variant"):
        revised_cuda.revised(sb.a, sb.b, sb.c, *bufs, feas, 100, _variant="cluster")
    with pytest.raises(ValueError, match="c is"):  # a sweep's stack is not one cost row a LP
        revised_cuda.revised(sb.a, sb.b, sb.c[None], *bufs, feas, 100)
    with pytest.raises(ValueError, match="c is"):
        revised_cuda.revised_sweep(sb.a, sb.b, sb.c, feas, 100)
    big = tlp.random_shared_lp_batch(np.random.default_rng(3), 2, 300, 4, True, device="cpu")
    state = revised.init_traced(big.a, big.b, None)
    with pytest.raises(ValueError, match="shared memory"):
        revised_cuda.revised(big.a, big.b, big.c, state.binv, state.basis, state.xb,
                             state.phase, engine.phase1_feasibility_tol(big.b), 5,
                             _variant="resident")
    with pytest.raises(ValueError, match="shared memory"):
        revised_cuda.revised_sweep(big.a, big.b, big.c[None], engine.phase1_feasibility_tol(big.b),
                                   5, _variant="resident")


def test_revised_cpu_tensors_never_count_a_launch():
    sb, bufs, feas = _revised_inputs()
    before = (revised_cuda.launches, dict(revised_cuda.variant_launches))
    revised_cuda.revised(sb.a, sb.b, sb.c, *bufs, feas, 50)
    revised_cuda.revised_sweep(sb.a, sb.b, torch.stack([sb.c, sb.c]), feas, 50)
    assert (revised_cuda.launches, revised_cuda.variant_launches) == before
    assert set(revised_cuda.variant_launches) == {"resident", "global"}
