"""The port's int8 error-feedback transform (``repro_torch.train.compression``)
against the reference's ``repro.train.compression``.

The quantized gradient is bit-equal to the reference's (``torch.round``
rounds half to even, as ``jnp.round`` does).  The error state ``(g + e) -
g'`` agrees within one float32 ulp of ``g + e``'s largest magnitude: XLA's
CPU backend may fuse ``g'``'s product into the subtraction.  A stacked
reference leaf split into the port's per-layer parameters shares one
scale (``leaf_of``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as rcomp
from repro_torch.train import compression as comp


def _ulp_close(got, want, tot):
    """Within one float32 ulp of ``tot``'s (``g + e``) largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= np.spacing(np.float32(np.abs(tot).max()))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e-14])
def test_quantize_bit_equal_to_reference(scale):
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((257,)) * scale).astype(np.float32)
    g[3] = 0.0
    rq, rs = jax.jit(rcomp._quantize)(jnp.asarray(g))
    q, s = comp._quantize(torch.as_tensor(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(comp._dequantize(q, s).numpy(),
                                  np.asarray(rcomp._dequantize(rq, rs)))


def test_round_half_to_even_as_the_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.as_tensor(x)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x))))


def test_compress_matches_reference_over_steps():
    rng = np.random.default_rng(1)
    shapes = {"a": (16, 9), "b": (5,)}
    r_init, r_compress = rcomp.make_ef_compressor()
    init_fn, compress = comp.make_ef_compressor()
    r_ef = r_init({k: jnp.zeros(s) for k, s in shapes.items()})
    ef = init_fn({k: torch.zeros(s) for k, s in shapes.items()})
    r_step = jax.jit(r_compress)
    for _ in range(6):
        g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32) for k, s in shapes.items()}
        r_out, r_ef = r_step({k: jnp.asarray(v) for k, v in g.items()}, r_ef)
        out, ef = compress({k: torch.as_tensor(v) for k, v in g.items()}, ef)
        # feed the reference's error state to both, so each step starts equal
        ef = {k: torch.as_tensor(np.array(v)) for k, v in r_ef.items()}
        for k in shapes:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(r_out[k]))
    for k in shapes:
        _ulp_close(compress({k: torch.as_tensor(g[k])}, {k: ef[k]})[1][k].numpy(),
                   np.asarray(r_step({k: jnp.asarray(g[k])}, {k: r_ef[k]})[1][k]),
                   g[k] + ef[k].numpy())


def test_leaf_of_shares_the_scale_of_a_stacked_leaf():
    """Two layers' gradients compressed as one reference leaf (stacked)
    give the reference's result on the stack; apart, each has its own
    scale."""
    rng = np.random.default_rng(2)
    g = (rng.standard_normal((2, 6, 4)) * np.array([1.0, 1e-2])[:, None, None]).astype(np.float32)
    r_out, r_ef = jax.jit(rcomp.make_ef_compressor()[1])({"w": jnp.asarray(g)},
                                                         {"w": jnp.zeros(g.shape, jnp.float32)})
    names = {"layers.0.w": "w", "layers.1.w": "w"}
    _, compress = comp.make_ef_compressor(names)
    grads = {n: torch.as_tensor(g[i]) for i, n in enumerate(names)}
    out, ef = compress(grads, {n: torch.zeros(6, 4) for n in names})
    np.testing.assert_array_equal(np.stack([out[n].numpy() for n in names]), np.asarray(r_out["w"]))
    _ulp_close(np.stack([ef[n].numpy() for n in names]), np.asarray(r_ef["w"]), g)
    apart, _ = comp.make_ef_compressor()[1](grads, {n: torch.zeros(6, 4) for n in names})
    assert not torch.equal(apart["layers.1.w"], out["layers.1.w"])


def test_ef_compressor_preserves_sum_over_steps():
    """The twin of ``tests/test_distributed.py::
    test_ef_compressor_preserves_sum_over_steps`` on one device."""
    init_fn, compress = comp.make_ef_compressor()
    ef = init_fn({"w": torch.zeros(32)})
    rng = np.random.default_rng(1)
    total_true = np.zeros(32, np.float32)
    total_comp = np.zeros(32, np.float32)
    for _ in range(50):
        g = {"w": torch.as_tensor(rng.normal(size=32).astype(np.float32))}
        total_true += g["w"].numpy()
        gc, ef = compress(g, ef)
        total_comp += gc["w"].numpy()
    resid = float(np.abs(total_true - (total_comp + ef["w"].numpy())).max())
    assert resid < 1e-3, resid  # error feedback closes the gap exactly
    rel = np.abs(total_true - total_comp).max() / np.abs(total_true).max()
    assert rel < 0.2, rel  # the compressed sum tracks the true sum


# -- dp_allreduce_int8 on 8 gloo ranks -----------------------------------------

_INT8_REFERENCE = """
import os, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.train.compression import dp_allreduce_int8

tmp = sys.argv[1]
arr = dict(np.load(os.path.join(tmp, "inputs.npz")))
mesh = jax.make_mesh((8,), ("data",))
grads = {k: jax.device_put(jnp.asarray(arr[k]), NamedSharding(mesh, P("data")))
         for k in ("int8_g", "int8_h")}
out = dp_allreduce_int8(grads, mesh)
np.savez(os.path.join(tmp, "reference.npz"), **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def int8_runs(tmp_path_factory):
    """Each of 8 ranks reduces its row block of two gradient leaves; the
    reference reduces the same leaves sharded over 8 forced CPU devices."""
    import os
    import subprocess
    import sys

    import torch_mesh_worker as worker

    tmp = tmp_path_factory.mktemp("int8")
    g = np.random.default_rng(8).normal(size=(8, 64)).astype(np.float32)
    h = (np.random.default_rng(9).normal(size=(8, 3, 5)) * 1e-3).astype(np.float32)
    h[2] = 0.0  # a rank whose block is all zero
    np.savez(tmp / "inputs.npz", int8_g=g, int8_h=h)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": os.path.join(root, "src")}
    ref = subprocess.Popen([sys.executable, "-c", _INT8_REFERENCE, str(tmp)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = worker.spawn("int8", 8, tmp)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err
    assert not [r for r in ranks if "error" in r], [r["error"] for r in ranks if "error" in r]
    port = {k: np.concatenate([r[k].numpy() for r in ranks]) for k in ("int8_g", "int8_h")}
    return {"g": g, "h": h}, port, dict(np.load(tmp / "reference.npz"))


@pytest.mark.parametrize("leaf", ["int8_g", "int8_h"])
def test_dp_allreduce_int8_bit_equal_to_reference_on_8_ranks(int8_runs, leaf):
    _, port, ref = int8_runs
    assert port[leaf].dtype == ref[leaf].dtype == np.float32
    np.testing.assert_array_equal(port[leaf].view(np.int32), ref[leaf].view(np.int32))


@pytest.mark.parametrize("leaf", ["g", "h"])
def test_dp_allreduce_int8_is_the_mean_of_the_int8_payloads(int8_runs, leaf):
    """The plain computation: one scale from the global max, each block
    quantized, the int32 sum dequantized over 8; within one quantum of
    the float32 mean."""
    inputs, port, _ = int8_runs
    x = torch.as_tensor(inputs[leaf])
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    want = q.sum(dim=0, keepdim=True).to(torch.float32) * scale / torch.tensor(8.0)
    got = port[f"int8_{leaf}"]
    np.testing.assert_array_equal(got, np.broadcast_to(want.numpy(), got.shape))
    assert np.abs(got - inputs[leaf].mean(axis=0, keepdims=True)).max() <= float(scale)
