"""The port's logical-axis partitioning (``repro_torch.sharding.partition``)
against the reference's ``repro.sharding.partition``.

Every parameter of every config, at full size, resolves to the same spec
in both packages on the meshes of the reference's runs: one device, 8
devices, 2 x 4, the 16 x 16 pod and the 2 x 16 x 16 multi-pod mesh.
The meshes are abstract (``{axis: size}`` in the port, ``AbstractMesh``
in the reference), so all of them are checked in one process.  The
port's own parameter tree (one entry a layer) and the reference's
(layers stacked on a leading ``"layer"`` axis) are both walked.
"""

import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config
from repro.models import Model as RefModel
from repro.sharding import partition as rpart
from repro_torch.configs import get_config as tget_config
from repro_torch.models.model import Model
from repro_torch.sharding import partition as tpart

MESHES = {
    "1": ((1,), ("data",)),
    "8": ((8,), ("data",)),
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _ref_spec(mesh, shape, axes):
    with rpart.activate(mesh):
        return tuple(rpart.resolve_spec(shape, axes))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_matches_reference_for_every_parameter(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    ref_mesh = AbstractMesh(sizes, names)
    shape = dict(zip(names, sizes))
    ref_specs = list(_leaves(RefModel(get_config(arch)).abstract_params()))
    port_specs = list(Model(tget_config(arch), device="meta").abstract_params().values())
    assert ref_specs and port_specs
    with tpart.activate(shape):
        for spec in ref_specs + port_specs:
            got = tpart.resolve_spec(spec.shape, spec.axes)
            assert got == _ref_spec(ref_mesh, spec.shape, spec.axes), (arch, spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_axis_size_matches_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    ref_mesh = AbstractMesh(sizes, names)
    with tpart.activate(dict(zip(names, sizes))), rpart.activate(ref_mesh):
        for logical in list(tpart.DEFAULT_RULES) + ["unknown"]:
            assert tpart.axis_size(logical) == rpart.axis_size(logical), logical


def test_divisibility_fallback_drops_trailing_axes():
    """A dimension that the pod x data product does not divide keeps the
    leading axes that do, then replicates (the reference's fallback)."""
    sizes, names = MESHES["2x16x16"]
    ref_mesh = AbstractMesh(sizes, names)
    cases = [((8, 64), ("batch", "embed_tp")), ((2, 3), ("batch", "heads_tp")),
             ((0, 16), ("batch", None)), ((64, 64), (("batch", "embed_tp"), None)),
             ((32, 32), ("fsdp", "batch"))]
    with tpart.activate(dict(zip(names, sizes))):
        for shape, axes in cases:
            assert tpart.resolve_spec(shape, axes) == _ref_spec(ref_mesh, shape, axes)
    assert tpart.resolve_spec((8, 64), ("batch", "embed_tp")) == ()


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    with tpart.activate({"pod": 2, "data": 16, "model": 16}):
        assert tpart.placements((64, 4096), ("batch", "embed_tp")) == (Shard(0), Shard(0),
                                                                       Shard(1))
        assert tpart.placements((3, 5), ("batch", None)) == (Replicate(),) * 3
    assert tpart.placements((4,), ("batch",)) is None


def test_constrain_without_a_device_mesh_returns_its_input():
    import torch

    x = torch.ones(4, 4)
    assert tpart.constrain(x, ("batch", None)) is x
    with tpart.activate({"data": 4}):
        assert tpart.constrain(x, ("batch", None)) is x
        assert tpart.active_mesh() == {"data": 4}
    assert tpart.active_mesh() is None


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch import mesh as mesh_lib

    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh_lib.make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("mesh_name", ["8", "2x4", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shape_is_the_reference_shard_shape(arch, mesh_name):
    """Every parameter's slice on a rank (``local_slices`` at any
    coordinates) has the shape of the reference's ``NamedSharding`` shard
    of the same spec."""
    from jax.sharding import NamedSharding, PartitionSpec

    sizes, names = MESHES[mesh_name]
    ref_mesh = AbstractMesh(sizes, names)
    last = {ax: n - 1 for ax, n in zip(names, sizes)}
    specs = Model(tget_config(arch), device="meta").abstract_params().values()
    with tpart.activate(dict(zip(names, sizes))):
        for spec in specs:
            want = NamedSharding(ref_mesh, PartitionSpec(*_ref_spec(ref_mesh, spec.shape,
                                                                    spec.axes)))
            want = tuple(want.shard_shape(spec.shape))
            for coords in ({ax: 0 for ax in names}, last):
                got = tuple(sl.stop - sl.start for sl in
                            tpart.local_slices(spec.shape, spec.axes, coords))
                assert got == want, (arch, spec)


def test_local_slices_cut_row_major_over_the_axes():
    """A dimension split over (pod, data) is cut into pod x data blocks, the
    rank taking block ``pod_index * data + data_index``; without a
    ``DeviceMesh`` and without coordinates every range is whole."""
    with tpart.activate({"pod": 2, "data": 4, "model": 2}):
        sl = tpart.local_slices((16, 6), ("batch", "embed_tp"), {"pod": 1, "data": 2, "model": 1})
        assert sl == (slice(12, 14), slice(3, 6))
        assert tpart.local_slices((16, 6), ("batch", "embed_tp")) == (slice(0, 16), slice(0, 6))
        assert tpart.local_shape((16, 6), ("batch", "embed_tp")) == (16, 6)
        assert tpart.batch_rows(16) == slice(0, 16)
        assert tpart.split_axes(16, "batch") == ()  # an abstract mesh holds everything
    assert tpart.coordinates() == {}
