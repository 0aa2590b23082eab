"""The LP generators: seeded, the paper's sign patterns, type 2's m >= 2n."""

import pytest
import torch

from bench import harness

TYPE1 = harness.load_module("generators", "paper_type1")
TYPE2 = harness.load_module("generators", "paper_type2")


def draw(module, kind, seed, lps=6, m=8, n=4):
    g = torch.Generator().manual_seed(seed)
    return getattr(module, kind)(g, lps, m, n, torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("module", [TYPE1, TYPE2], ids=["type1", "type2"])
@pytest.mark.parametrize("kind", ["dense", "shared"])
def test_the_same_seed_draws_the_same_lps(module, kind):
    one, two, other = draw(module, kind, 7), draw(module, kind, 7), draw(module, kind, 8)
    assert all(torch.equal(x, y) for x, y in zip(one, two))
    assert not all(torch.equal(x, y) for x, y in zip(one, other))


@pytest.mark.parametrize("kind", ["dense", "shared"])
def test_type1_starts_feasible(kind):
    a, b, c = draw(TYPE1, kind, 3, m=6, n=4)
    diag = a.diagonal(dim1=-2, dim2=-1)
    assert bool((diag >= 1.0).all()) and bool((a.abs() <= 2.0).all())
    assert bool((b >= 1.0).all() & (b <= 10.0).all())
    assert bool((c >= 0.1).all() & (c <= 1.0).all())
    assert a.shape == ((6, 4) if kind == "shared" else (6, 6, 4))


@pytest.mark.parametrize("kind", ["dense", "shared"])
def test_type2_is_a_box_that_starts_infeasible(kind):
    n = 4
    a, b, c = draw(TYPE2, kind, 5, m=2 * n + 3, n=n)
    eye = torch.eye(n)
    a = a.expand(6, *a.shape[-2:]) if kind == "shared" else a
    assert torch.equal(a[:, :n], eye.expand(6, n, n))
    assert torch.equal(a[:, n:2 * n], -eye.expand(6, n, n))
    hi, lo = b[:, :n], -b[:, n:2 * n]
    assert bool((lo >= 0.5).all() & (hi > lo).all())
    assert bool((b[:, n:2 * n] < 0).all()), "the slack basis must start infeasible"
    # The cover rows hold at hi, so the box's top corner is feasible.
    assert bool(((a[:, 2 * n:] @ hi[:, :, None])[..., 0] <= b[:, 2 * n:]).all())
    assert bool((c >= 0.1).all() & (c <= 1.0).all())


@pytest.mark.parametrize("kind", ["dense", "shared"])
def test_type2_needs_two_rows_a_variable(kind):
    with pytest.raises(ValueError, match="m >= 2n"):
        draw(TYPE2, kind, 1, m=7, n=4)


def test_the_shared_cell_draws_one_set_of_matrices_for_every_seed():
    cell = harness.load_cell("type1.shared50k")
    traffic = harness.load_module("traffic", cell.file["traffic"])
    config = dict(cell.config, m=6, n=4, torch_dtype=torch.float32)
    params = dict(cell.params, lps_per_call=5, pool=6)

    def pool(seed):
        g = torch.Generator().manual_seed(seed)
        return traffic.make_pool(TYPE1, config, params, g, torch.device("cpu"))

    one, two = pool(2**31 + 11), pool(2**31 + 12)
    key = lambda entry: tuple(entry[0].flatten().tolist())  # noqa: E731
    assert sorted(map(key, one)) == sorted(map(key, two))
    assert len(set(map(key, one))) == 6
    assert not torch.equal(one[0][1], two[0][1])
