"""The port's train step (``repro_torch.train.train_step``: the chunked
cross-entropy, remat, gradient accumulation, the optional int8
error-feedback transform, ``optimizer.update``) and its eval step
against the reference's ``repro.train.train_step`` on reduced configs.

Both packages take the same NumPy weights (``models/convert.py:
reference_weights``) and the same batches (``configs.make_inputs``; under
M-RoPE, positions whose coordinates differ).  The reference runs jitted
on the CPU, the port with ``device="cpu"``.

Tolerances.  A train step is ill-conditioned at rounding level: the loss
gradient carries the float32 rounding of the cross-entropy amplified by
cancellation (per-leaf relative errors near 3e-5 for reduced gemma2,
3e-4 for seamless), and Adam's first steps move each element by about
``lr * sign(g)``, so an element whose gradient lies at rounding level may
move the other way.  Every quantity is held to the reference's own
float32 error on the case, by the rule of ``chip_smoke.py:lm_tolerances``
for the slice-11 rows: the loss and ``grad_norm`` of every step by
relative error (floor ``SCALAR_FLOOR``), and per parameter leaf, the
change ``p_2 - p_0`` and the moments ``m`` and ``v`` by relative L2
(floor ``LEAF_FLOOR``), each within the largest of its floor,
``NOISE_FACTOR`` times its noise (its largest change when every initial
weight moves one float32 ulp up or down, a seeded coin a weight, over
``NUDGES``) and ``F64_FACTOR`` times the reference's own float32 error
against the same run with every step in float64 (``_wide``); and the
port's float32 run no further from that float64 run than the larger of
the floor and ``F64_FACTOR`` times the reference's error.  ``lr`` must
be equal.  Reduced zamba2 and seamless are ill-conditioned
(``tests/test_torch_models.py``): their errors are larger, and so are
their gates; on seamless the port's float32 gradients lie nearer the
float64 ones than the reference's do.

Every step in float64: ``_wide`` reads ``float32`` as ``float64`` in the
reference's model and train modules (its attention scores, the logits'
cast before the cross-entropy, the optimizer state), as
``tools/lm_reference_fixture.py`` does for its float64 logits, and in the
port's (``torch.float32`` and ``Tensor.float``).  In that mode the two
packages agree within ``F64_TOL`` (``test_train_steps_float64_match_reference``).
With ``dtype="float64"`` alone both keep those steps in float32 (and the
reference's mamba2 scan does not trace), so that mode is not compared.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import Model as RModel
from repro.models import attention as rattention
from repro.models import layers as rlayers
from repro.models import mamba2 as rmamba2
from repro.models import model as rmodel_mod
from repro.models import moe as rmoe
from repro.train import compression as rcompression
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch import configs
from repro_torch.kernels import simplex_cuda
from repro_torch.models import Model, attention, blocks, layers, mamba2, moe
from repro_torch.models import model as model_mod
from repro_torch.models.convert import (_to_reference, load_reference_params,
                                        reference_leaf_of, reference_opt_state,
                                        reference_params, reference_weights, trimmed_rel)
from repro_torch.sharding import leaves
from repro_torch.train import compression, optimizer
from repro_torch.train import train_step as ts

SEQ, BATCH, ACCUM, STEPS = 24, 4, 2, 2
NUDGES = (11, 12, 13)
NOISE_FACTOR = 4.0
SCALAR_FLOOR = 2e-6
LEAF_FLOOR = 1e-5
F64_FACTOR = 2.0
FLIP_SHARE = 1e-3  # the share of a change's elements ``trimmed_rel`` leaves out
F64_TOL = 1e-9
OPT = dict(lr=1e-3, warmup_steps=2)


class _Wide:
    """A module's ``jnp`` or ``torch`` with ``float32`` read as ``float64``."""

    def __init__(self, mod, wide):
        self._mod, self._wide = mod, wide

    def __getattr__(self, name):
        return self._wide if name == "float32" else getattr(self._mod, name)


@contextlib.contextmanager
def _wide():
    """Both packages' model and train modules with every float32 step in
    float64 (run float64 weights under it, and trace the reference in it)."""
    saved = [(m, "jnp", m.jnp) for m in (rattention, rlayers, rmamba2, rmodel_mod, rmoe, rts, ropt)]
    saved.append((rattention, "np", rattention.np))
    saved += [(m, "torch", m.torch) for m in (attention, blocks, layers, mamba2, model_mod, moe,
                                               ts, optimizer)]
    saved.append((torch.Tensor, "float", torch.Tensor.float))
    wide = {"jnp": jnp.float64, "np": np.float64, "torch": torch.float64}
    try:
        for m, name, orig in saved[:-1]:
            setattr(m, name, _Wide(orig, wide[name]))
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
        yield
    finally:
        for m, name, orig in saved:
            setattr(m, name, orig)


def _cfgs(arch, **kw):
    return (dataclasses.replace(configs.get_config(arch, reduced=True), **kw),
            dataclasses.replace(rconfigs.get_config(arch, reduced=True), **kw))


def _inputs(rcfg, step, seq=SEQ, batch=BATCH):
    """Step ``step``'s NumPy batch (``make_inputs`` seeded by the step)."""
    out = {k: np.array(v) for k, v in rconfigs.make_inputs(
        rcfg, rconfigs.Shape("t", seq, batch, "train"), seed=step).items()}
    if rcfg.mrope_sections:
        out["positions"] = configs.mrope_positions(batch, seq, rcfg.num_patches, step)
    return out


def _np_tree(tree):
    return {"/".join(p): np.asarray(a) for p, a in leaves(tree)}


def _summary(metrics, params, m, v):
    return dict(loss=[float(x["loss"]) for x in metrics],
                grad_norm=[float(x["grad_norm"]) for x in metrics],
                lr=[float(x["lr"]) for x in metrics],
                params=_np_tree(params), m=_np_tree(m), v=_np_tree(v))


def _reference_step(rcfg, accum=ACCUM, remat=True, with_ef=False):
    """The reference's jitted train step; with ``with_ef`` the error-feedback
    transform, its state passed through: ``(params, opt, ef, batch) ->
    (params, opt, ef, metrics)``."""
    rmodel = RModel(rcfg)
    ocfg = ropt.OptConfig(**OPT)
    if not with_ef:
        step = rts.make_train_step(rmodel, ocfg, accum=accum, remat=remat)
        return jax.jit(lambda p, o, ef, b: _no_ef(step, p, o, ef, b))
    _, compress = rcompression.make_ef_compressor()

    def run(p, o, ef, b):
        box = {}

        def comp(g, opt_state):
            g2, box["ef"] = compress(g, ef)
            return g2, opt_state

        p2, o2, m = rts.make_train_step(rmodel, ocfg, accum=accum, remat=remat,
                                        compression=comp)(p, o, b)
        return p2, o2, box["ef"], m

    return jax.jit(run)


def _no_ef(step, p, o, ef, b):
    p2, o2, m = step(p, o, b)
    return p2, o2, ef, m


def _reference_run(rcfg, step_fn, tree, steps=STEPS, with_ef=False):
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = ropt.init(params, ropt.OptConfig(**OPT))
    ef = rcompression.make_ef_compressor()[0](params) if with_ef else None
    metrics = []
    for s in range(steps):
        batch = {k: jnp.asarray(v) for k, v in _inputs(rcfg, s).items()}
        params, opt, ef, m = step_fn(params, opt, ef, batch)
        metrics.append(m)
    out = _summary(metrics, jax.tree_util.tree_map(np.asarray, params),
                   jax.tree_util.tree_map(np.asarray, opt.m),
                   jax.tree_util.tree_map(np.asarray, opt.v))
    if with_ef:
        out["ef"] = _np_tree(jax.tree_util.tree_map(np.asarray, ef))
    out["dtypes"] = dict(loss=metrics[0]["loss"].dtype.name, lr=metrics[0]["lr"].dtype.name,
                         grad_norm=metrics[0]["grad_norm"].dtype.name,
                         m=jax.tree_util.tree_leaves(opt.m)[0].dtype.name,
                         master=jax.tree_util.tree_leaves(opt.master)[0].dtype.name,
                         params=jax.tree_util.tree_leaves(params)[0].dtype.name)
    return out


def _port_model(cfg, tree):
    return load_reference_params(Model(cfg, device="cpu"), tree)


def _port_run(cfg, rcfg, tree, steps=STEPS, accum=ACCUM, remat=True, with_ef=False):
    model = _port_model(cfg, tree)
    ocfg = optimizer.OptConfig(**OPT)
    opt = optimizer.init(dict(model.named_parameters()), ocfg)
    comp, ef = None, {}
    if with_ef:
        init_fn, compress = compression.make_ef_compressor(reference_leaf_of(model))
        ef["state"] = init_fn(dict(model.named_parameters()))

        def comp(g, opt_state):
            g2, ef["state"] = compress(g, ef["state"])
            return g2, opt_state

    step = ts.make_train_step(model, ocfg, accum=accum, remat=remat, compression=comp)
    metrics = []
    for s in range(steps):
        batch = {k: torch.as_tensor(v) for k, v in _inputs(rcfg, s).items()}
        opt, m = step(opt, batch)
        metrics.append(m)
    ref_opt = reference_opt_state(model, opt)
    out = _summary(metrics, reference_params(model),
                   jax.tree_util.tree_map(lambda t: t.numpy(), ref_opt.m),
                   jax.tree_util.tree_map(lambda t: t.numpy(), ref_opt.v))
    if with_ef:
        out["ef"] = _np_tree(jax.tree_util.tree_map(lambda t: t.numpy(),
                                                    _to_reference(model, ef["state"], True)))
    out["dtypes"] = dict(loss=str(metrics[0]["loss"].dtype)[6:], lr=str(metrics[0]["lr"].dtype)[6:],
                         grad_norm=str(metrics[0]["grad_norm"].dtype)[6:],
                         m=str(next(iter(opt.m.values())).dtype)[6:],
                         master=str(next(iter(opt.master.values())).dtype)[6:],
                         params=str(next(model.parameters()).dtype)[6:])
    return out, model, opt


def _nudged(tree, seed):
    """Every weight one float32 ulp up or down (a seeded coin a weight)."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        up = rng.random(a.shape) < 0.5
        return np.nextafter(a, np.where(up, np.float32(np.inf), np.float32(-np.inf)))

    return jax.tree_util.tree_map(nudge, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    if nb == 0:
        return 0.0 if np.array_equal(a, b) else np.inf
    return float(np.linalg.norm(a - b) / nb)


def _noise(run, tree, base):
    """The largest change of each gated quantity of ``run(tree)`` (``base``)
    over ``NUDGES``."""
    t0 = _np_tree(tree)
    worst = {}
    for seed in NUDGES:
        nt = _nudged(tree, seed)
        got = _measures(run(nt), base, _np_tree(nt), t0)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _measures(run, base, tree0, ref0):
    """Each gated quantity of ``run`` (started from ``tree0``) against
    ``base`` (started from ``ref0``): scalars by relative error, leaves by
    relative L2 (the parameters by their change from the start)."""
    out = {}
    for k in ("loss", "grad_norm"):
        for i, (a, b) in enumerate(zip(run[k], base[k])):
            out[f"{k}[{i}]"] = abs(a / b - 1.0)
    for path, p in run["params"].items():
        out[f"dparams/{path}"] = trimmed_rel(p - tree0[path], base["params"][path] - ref0[path],
                                             FLIP_SHARE)
    for k in ("m", "v", "ef"):
        for path, a in run.get(k, {}).items():
            out[f"{k}/{path}"] = _rel(a, base[k][path])
    return out


def _gate(port, ref, f64, noise, tree0):
    """Every quantity of the port's float32 run, against the reference's and
    against the float64 run ``f64``, within the largest of its floor,
    ``NOISE_FACTOR`` times its noise and ``F64_FACTOR`` times the
    reference's own error against ``f64``; ``lr`` equal.  Returns each
    quantity's error over its gate."""
    assert port["lr"] == ref["lr"], (port["lr"], ref["lr"])
    own = _measures(ref, f64, tree0, tree0)
    err = _measures(port, ref, tree0, tree0)
    err64 = _measures(port, f64, tree0, tree0)
    ratios, bad = {}, {}
    for k in err:
        floor = SCALAR_FLOOR if "[" in k else LEAF_FLOOR
        tol = max(floor, NOISE_FACTOR * noise[k], F64_FACTOR * own[k])
        ratios[k] = max(err[k], err64[k]) / tol
        if not ratios[k] <= 1.0:
            bad[k] = dict(err=err[k], err_f64=err64[k], tol=tol)
    assert not bad, bad
    return ratios


def _reference_wide(arch, tree, **kw):
    """The reference's run on ``tree`` widened to float64 with every step in
    float64 (``_wide``)."""
    _, rcfg = _cfgs(arch, dtype="float64")
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    with _wide():
        return _reference_run(rcfg, _reference_step(rcfg, **kw), tree, **kw)


def _compare(arch, with_ef=False):
    cfg, rcfg = _cfgs(arch)
    tree = reference_weights(cfg, 3)
    step_fn = _reference_step(rcfg, with_ef=with_ef)
    ref = _reference_run(rcfg, step_fn, tree, with_ef=with_ef)
    port, model, opt = _port_run(cfg, rcfg, tree, with_ef=with_ef)
    assert port["dtypes"] == ref["dtypes"], (port["dtypes"], ref["dtypes"])
    noise = _noise(lambda t: _reference_run(rcfg, step_fn, t, with_ef=with_ef), tree, ref)
    port_noise = _noise(lambda t: _port_run(cfg, rcfg, t, with_ef=with_ef)[0], tree, port)
    noise = {k: max(v, port_noise[k]) for k, v in noise.items()}
    f64 = _reference_wide(arch, tree, with_ef=with_ef)
    _gate(port, ref, f64, noise, _np_tree(tree))
    return port, ref, model, opt


# ---------------------------------------------------------------------------
# The chunked cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, 16, 512])
def test_chunked_ce_loss_matches_reference(chunk):
    """S = 37 (not a multiple of the chunk), labels of -1 scattered, a vocab
    padded from 250 to 256 rows: the loss and its gradients with respect to
    the hidden states and the table."""
    cfg, rcfg = _cfgs("gemma2-2b", vocab_size=250)
    tree = reference_weights(cfg, 5)
    model = _port_model(cfg, tree)
    rng = np.random.default_rng(chunk)
    hidden = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 37)).astype(np.int32)
    labels[rng.random((2, 37)) < 0.2] = -1
    rmodel = RModel(rcfg)

    def rloss(params, h):
        return rts.chunked_ce_loss(rmodel, params, h, jnp.asarray(labels), chunk=chunk)

    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    want, (g_params, g_hidden) = jax.value_and_grad(rloss, argnums=(0, 1))(rp, jnp.asarray(hidden))
    h = torch.tensor(hidden, requires_grad=True)
    got = ts.chunked_ce_loss(model, h, torch.as_tensor(labels), chunk=chunk)
    got.backward()
    assert got.dtype == torch.float32
    assert abs(float(got) / float(want) - 1.0) <= SCALAR_FLOOR, (float(got), float(want))
    assert _rel(h.grad.numpy(), np.asarray(g_hidden)) <= LEAF_FLOOR
    table = model.get_parameter("embed.embedding").grad.numpy()
    assert _rel(table, np.asarray(g_params["embed"]["embedding"])) <= LEAF_FLOOR
    # the padded rows take no gradient
    assert not table[cfg.vocab_size:].any()


def test_chunked_ce_loss_ignores_every_label_of_minus_one():
    cfg, _ = _cfgs("gemma2-2b")
    model = _port_model(cfg, reference_weights(cfg, 5))
    h = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(0))
    labels = torch.full((2, 9), -1, dtype=torch.int32)
    assert float(ts.chunked_ce_loss(model, h, labels, chunk=4)) == 0.0


# ---------------------------------------------------------------------------
# Two train steps against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_steps_match_reference(arch):
    """The twin of ``tests/test_models.py::test_smoke_forward_and_train_step``:
    float32, ``accum=2``, remat on, two steps; the loss, ``grad_norm`` and
    ``lr`` of each step, then the parameters, ``m`` and ``v``."""
    port, ref, model, opt = _compare(arch)
    assert int(opt.step) == STEPS
    assert all(np.isfinite(port["loss"])) and port["loss"] != port["loss"][::-1]


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-130m", "deepseek-v2-lite-16b"])
def test_train_steps_float64_match_reference(arch):
    """Every step in float64 in both packages (``_wide``): the hidden
    states, then two train steps (the loss, ``grad_norm``, ``lr``, the
    parameters' change, ``m`` and ``v``), each within ``F64_TOL``."""
    cfg, rcfg = _cfgs(arch, dtype="float64")
    tree = reference_weights(cfg, 3, "float64")
    inputs = _inputs(rcfg, 0)
    inputs.pop("labels")
    with _wide():
        want = RModel(rcfg).forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                    {k: jnp.asarray(v) for k, v in inputs.items()})
        with torch.no_grad():
            got = _port_model(cfg, tree).forward({k: torch.as_tensor(v)
                                                  for k, v in inputs.items()})
        ref = _reference_run(rcfg, _reference_step(rcfg), tree)
        port, _, _ = _port_run(cfg, rcfg, tree)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), np.asarray(want)) <= F64_TOL
    # lr stays float32 in both: the int32 step's true division gives float32
    assert port["dtypes"] == ref["dtypes"] == dict(loss="float64", lr="float32",
                                                   grad_norm="float64", m="float64",
                                                   master="float64", params="float64")
    assert port["lr"] == ref["lr"]
    t0 = _np_tree(tree)
    err = _measures(port, ref, t0, t0)
    assert max(err.values()) <= F64_TOL, sorted((v, k) for k, v in err.items())[-3:]


def test_accum_one_matches_reference_and_keeps_the_parameter_dtype():
    """``accum=1``: the gradients reach ``update`` in the parameters' dtype
    (bfloat16 here), as the reference's do."""
    cfg, rcfg = _cfgs("gemma2-2b", dtype="bfloat16")
    tree = reference_weights(cfg, 3)
    model = _port_model(cfg, tree)
    seen = {}
    orig = optimizer.update

    def spy(grads, *a, **kw):
        seen.update({k: g.dtype for k, g in grads.items()})
        return orig(grads, *a, **kw)

    ocfg = optimizer.OptConfig(**OPT)
    opt = optimizer.init(dict(model.named_parameters()), ocfg)
    step = ts.make_train_step(model, ocfg, accum=1)
    batch = _inputs(rcfg, 0)
    try:
        ts.opt_mod.update = spy
        opt, m = step(opt, {k: torch.as_tensor(v) for k, v in batch.items()})
    finally:
        ts.opt_mod.update = orig
    assert seen == {n: p.dtype for n, p in model.named_parameters()}
    assert torch.bfloat16 in seen.values()
    rmodel = RModel(rcfg)
    rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    rocfg = ropt.OptConfig(**OPT)
    rp2, ro2, rm = jax.jit(rts.make_train_step(rmodel, rocfg, accum=1))(
        rp, ropt.init(rp, rocfg), {k: jnp.asarray(v) for k, v in batch.items()})
    # bfloat16 forward: the loss within bfloat16's rounding of the logits
    assert abs(float(m["loss"]) / float(rm["loss"]) - 1.0) <= 1e-2
    assert float(m["lr"]) == float(rm["lr"])
    assert next(model.parameters()).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_remat_on_equals_off_bit_for_bit(arch):
    """Remat recomputes each layer in the backward pass and changes no bit
    of the loss, the gradient norm, the parameters or the moments."""
    cfg, rcfg = _cfgs(arch)
    tree = reference_weights(cfg, 3)
    on, model_on, _ = _port_run(cfg, rcfg, tree, steps=1, remat=True)
    off, model_off, _ = _port_run(cfg, rcfg, tree, steps=1, remat=False)
    assert on["loss"] == off["loss"] and on["grad_norm"] == off["grad_norm"]
    for (n, a), b in zip(model_on.named_parameters(), model_off.parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for path, a in on[k].items():
            assert np.array_equal(a, off[k][path]), (k, path)


def test_compression_path_matches_reference():
    """The int8 error-feedback transform between the accumulation and the
    update, its state carried across two steps: the train step's outputs
    and the error state against the reference's."""
    port, ref, _, _ = _compare("gemma2-2b", with_ef=True)
    assert port["ef"].keys() == ref["ef"].keys()
    for path, e in port["ef"].items():
        assert np.isfinite(e).all() and e.any(), path


# ---------------------------------------------------------------------------
# The eval step under the LP router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v2-lite-16b"])
def test_eval_step_under_lp_matches_reference(arch, monkeypatch):
    """``make_eval_step`` under ``router="lp"``: a forward only, one router
    LP a MoE layer, solved by ``ops.simplex_solve`` (the plain version on
    CPU tensors); the loss against the reference's eval loss."""
    cfg, rcfg = _cfgs(arch, router="lp")
    tree = reference_weights(cfg, 3)
    batch = _inputs(rcfg, 0)
    want = jax.jit(rts.make_eval_step(RModel(rcfg)))(
        jax.tree_util.tree_map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(cfg, tree)
    calls = []
    orig = simplex_cuda.simplex_plain
    monkeypatch.setattr(simplex_cuda, "simplex_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    got = ts.make_eval_step(model)({k: torch.as_tensor(v) for k, v in batch.items()})
    assert len(calls) == sum(k.endswith("_moe") for k in model.kinds())
    assert abs(float(got) / float(want) - 1.0) <= SCALAR_FLOOR, (float(got), float(want))
    assert not torch.is_grad_enabled() or not got.requires_grad
