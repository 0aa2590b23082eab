#!/usr/bin/env python3
"""Write the JAX reference's LM logits for a config at full width as a fixture.

    PYTHONPATH=src python3 tools/lm_reference_fixture.py [--out tests/data/lm_gemma2_2b_reference.npz]
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --arch deepseek-v2-lite-16b \
        --layers 3 --router topk,lp --out tests/data/lm_deepseek_v2_lite_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --arch mamba2-130m --prompt-len 100 \
        --out tests/data/lm_mamba2_130m_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --arch zamba2-7b --layers 7 \
        --prompt-len 100 --out tests/data/lm_zamba2_7b_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --arch seamless-m4t-large-v2 \
        --out tests/data/lm_seamless_m4t_large_v2_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --arch qwen2-vl-72b --layers 2 \
        --prompt-len 320 --out tests/data/lm_qwen2_vl_72b_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --train \
        --out tests/data/lm_train_gemma2_2b_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --train --layers 4 --mesh 2,2 \
        --out tests/data/lm_train_gemma2_2b_mesh_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --eval --arch deepseek-v2-lite-16b \
        --layers 3 --router lp --out tests/data/lm_eval_deepseek_v2_lite_reference.npz
    PYTHONPATH=src python3 tools/lm_reference_fixture.py --arch deepseek-v2-lite-16b \
        --layers 3 --router lp --mesh 2,2 --prompts 4 \
        --out tests/data/lm_deepseek_v2_lite_mesh_reference.npz

Runs ``repro.models.Model`` (JAX on the CPU: ``JAX_PLATFORMS`` defaults
to ``cpu`` here, so that no float32 product is rounded to TF32) on
weights from
``repro_torch.models.convert.reference_weights(cfg, seed)``: prefill of
``prompts`` prompts of ``prompt_len`` tokens (``repro.configs.make_inputs``),
then ``steps`` greedy decode steps, in float32 (config dtype replaced, so
the cache is float32 too).  The same tokens then go through the bfloat16
model (the config's own dtype; weights cast from the float32 arrays).

The fixture holds the tokens, the vocabulary subset, and for each
(prompt, step) the float32 logits on the subset, the argmax, logsumexp
and top-2 margin over the whole vocabulary
(``repro_torch.models.convert.logit_summary``), and the bfloat16 run's
relative L2 error against the float32 logits on the subset: per row
(``bf16_rel_l2``) and over all rows (``bf16_rel_l2_all``); the float32
noise of the function itself, the same float32 run with every weight
moved one ulp up or down (a seeded coin a weight) against the fixture's
logits (``f32_noise_rel_l2``, ``f32_noise_max_abs``, per row); the
reference's logits with every step in float64 (``logits_f64``, on the
subset: the weights, products, norms, rotary angles, attention scores
and softmax all float64, the reference's own float32 steps widened by
``_float64_everywhere``) and its float32 run's error against them
(``f64_rel_l2``, ``f64_max_abs``, per row); and the first values of
every weight leaf (``weights_digest``), which a run that regenerates the
weights checks first.

Configs that take more than tokens get their prompt's other inputs
from the same ``make_inputs`` call (the encoder-decoder's frames, the
vision frontend's patch embeddings, in the config's dtype) and, under
M-RoPE, positions whose coordinates differ
(``repro_torch.configs.mrope_positions``, or the caller's): the
positions are stored (``positions``), the float inputs are regenerated
by whoever reads the fixture and checked against ``extras_digest``
(their first values, ``weights_digest``'s rule); ``input_dtype`` names
the dtype they were made in.  The decode steps take tokens alone, as
``Engine.generate`` runs them; the encoder-decoder's cache is sized to
its frames (``enc_len``).

``--layers`` cuts the config's depth, the encoder's too (the widths
stay).  ``--router``
names the MoE routers to run, comma-separated: each router's arrays are
stored under its name (``topk__logits``, ``lp__logits``, ...; see
``repro_torch.models.convert.fixture_view``), and under ``lp`` every
router LP the float32 run solves, one per MoE layer per call, in call
order (``router_a``, ``router_b``, ``router_c``, ``router_status``,
``router_iterations``, ``router_basis``, ``router_x``, with
``router_call``, 0 for the prefill and i for decode step i, and
``router_layer``, the model's layer index), captured from inside the
jitted run by :func:`capture_router_lps`.
``chip_smoke.py``'s ``lm_reference`` and ``lm_serve`` phases hold the
port against it on the card; ``tests/test_torch_lm_serve.py`` builds the
same fixture for the reduced config in memory.

``--mesh DATA,MODEL`` runs every reference run of the fixture under
``partition.activate`` of a ``("data", "model")`` mesh of that shape over
forced host devices (``XLA_FLAGS``' device count is set before JAX
loads), its axes ``Auto`` (the reference's sharded code needs them): its
MoE layers then cut the batch into ``data`` token groups, a different
function from one group.  ``--prompts`` sets the batch (the groups must
drop tokens for the fixture to tell the two apart).  The router LPs are
captured by unordered callbacks there (JAX refuses ordered effects on
more than one device); each jitted call is waited for before the next,
and within a call each MoE layer's LP depends on the layer before it,
so they arrive in call and layer order.

``--train`` writes the training fixture instead
(:func:`build_train_fixture`): gemma2-2b at full width cut to 2 layers
(``--layers``), the reference's train step (``accum=2``, remat, lr 1e-3
after 2 warm-up steps) three times on ``SyntheticLM`` batches of 4 x 128
tokens, in float32, with the weights one ulp away (two draws: the
largest change of each quantity is its noise), and with every step in
float64 (``_float64_everywhere(train=True)``); each run's loss,
``grad_norm`` and ``lr`` a step, and each leaf's parameter change at
8,192 sampled elements (:func:`change_samples`).  ``--eval`` writes the
eval-step fixture (:func:`build_eval_fixture`): ``make_eval_step`` under
``--router`` (default ``lp``) on one batch of 2 x 256 tokens, the same
three runs' losses and the count of router LPs.  On the chip machine's
CPU they took 273 s and 146 s.  ``--train --mesh DATA,MODEL`` runs every
one of the training fixture's runs under that mesh (``Auto`` axes, as
above; the fixture stores ``mesh``): the reference's sharded train step,
which ``chip_smoke.py``'s ``lm_train_mesh`` phase holds the port's ranks
against.

Full width needs about 45 GB of host memory (the float32 weights as
NumPy and as JAX arrays, then a nudged and a float64 copy) and a few
minutes on eight cores.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

#: The fixture's run: prompts, their length, decode steps, vocabulary subset.
PROMPTS = 2
PROMPT_LEN = 40
STEPS = 8
SUBSET = 2048
SEED = 0


def _run(model, params, prompts, steps, feed=None, extras=None):
    """Prefill (the prompt's tokens and ``extras``: frames, patch
    embeddings, positions), then ``steps`` decode steps, greedy unless
    ``feed`` gives the tokens; returns (tokens (B, P + steps), logits
    (B, steps + 1, V))."""
    import jax
    import jax.numpy as jnp

    b, p = prompts.shape
    extras = extras or {}
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step, donate_argnums=(2,))
    enc_len = extras["frames"].shape[1] if "frames" in extras else 0
    cache = model.init_cache(b, p + steps, enc_len=enc_len)
    first = {"tokens": jnp.asarray(prompts)}
    for k, v in extras.items():
        first[k] = jnp.asarray(v, model.cfg.dtype if v.dtype.kind == "f" else v.dtype)
    logits, cache = prefill(params, first, cache)
    rows = [np.asarray(logits[:, -1], np.float32)]
    tokens = [prompts]
    for i in range(steps):
        cur = rows[-1].argmax(axis=-1).astype(np.int32) if feed is None else feed[:, p + i]
        tokens.append(cur[:, None])
        logits, cache = decode(params, {"tokens": jnp.asarray(cur[:, None])}, cache, p + i)
        rows.append(np.asarray(logits[:, -1], np.float32))
    return np.concatenate(tokens, axis=1), np.stack(rows, axis=1)


def _ulp_nudge(params, seed):
    """Every weight moved one float32 ulp up or down (a seeded coin a weight)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def nudge(a):
        up = rng.random(a.shape, dtype=np.float32) < 0.5
        return jnp.nextafter(a, jnp.where(up, np.float32(np.inf), np.float32(-np.inf)))

    return jax.tree_util.tree_map(nudge, params)


@contextlib.contextmanager
def _float64_everywhere(train: bool = False):
    """Trace the reference with every ``jnp.float32`` of its layers,
    attention, Mamba2 mixer, model and MoE read as ``jnp.float64`` (its
    norms, rotary angles, attention scores and softmax, SSD scan and
    states, sinusoidal positions, logits, the router and its LP): with
    float64 weights, a run with no float32 step.  With ``train``, the
    train step's and the optimizer's too (the logits' cast before the
    cross-entropy, the accumulators, the moments and master weights), and
    the attention's ``np.float32`` score scale.  Only this tool's view of
    the modules changes."""
    import jax.numpy as jnp

    from repro.models import attention, layers, mamba2, model, moe
    from repro.train import optimizer, train_step

    class Wide:
        def __init__(self, mod, wide):
            self.mod, self.wide = mod, wide

        def __getattr__(self, name):
            return self.wide if name == "float32" else getattr(self.mod, name)

    mods = [attention, layers, mamba2, model, moe] + ([train_step, optimizer] if train else [])
    saved = [(mod, "jnp", mod.jnp) for mod in mods]
    if train:
        saved.append((attention, "np", attention.np))
    for mod, name, orig in saved:
        setattr(mod, name, Wide(orig, jnp.float64 if name == "jnp" else np.float64))
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


class RouterLPs:
    """The router LPs of the reference's runs, recorded while ``active``."""

    FIELDS = ("a", "b", "c", "status", "iterations", "basis", "x")

    def __init__(self):
        self.active = False
        self.rows = []

    def record(self, *arrays):
        if self.active:
            self.rows.append([np.asarray(a) for a in arrays])

    def arrays(self, calls, layers) -> dict:
        """The recorded LPs as stacked arrays (``router_*``), given each
        one's call and layer."""
        out = {f"router_{name}": np.stack([r[i][0] for r in self.rows])
               for i, name in enumerate(self.FIELDS)}
        out["router_b"] = out["router_b"].astype(np.float32)  # 1.0 and cap: exact
        out["router_call"] = np.asarray(calls, np.int32)
        out["router_layer"] = np.asarray(layers, np.int32)
        return out


@contextlib.contextmanager
def capture_router_lps(ordered: bool = True):
    """Record every LP the reference's MoE router solves: the reference's
    ``core.simplex.solve_batched``, as ``models/moe.py`` reaches it, is
    wrapped (in this tool's view only) so that each solve hands its
    inputs and solution to the host through a ``jax.debug.callback``,
    inside jit and scan too (``ordered=False`` under a mesh: see the
    module's docstring)."""
    import jax

    from repro.core import simplex

    rec = RouterLPs()
    orig = simplex.solve_batched

    def spy(a, b, c, *args, **kw):
        sol = orig(a, b, c, *args, **kw)
        jax.debug.callback(rec.record, a, b, c, sol.status, sol.iterations, sol.basis, sol.x,
                           ordered=ordered)
        return sol

    simplex.solve_batched = spy
    try:
        yield rec
    finally:
        simplex.solve_batched = orig


def prompt_inputs(cfg, prompts: int, prompt_len: int, seed: int, positions=None) -> dict:
    """The prompt's inputs for ``cfg`` as NumPy arrays: ``make_inputs``'
    tokens, frames and patch embeddings (float32 holding values of the
    config's dtype), and under M-RoPE ``positions`` (the caller's, else
    ``mrope_positions``)."""
    from repro.configs import Shape, make_inputs
    from repro_torch.configs import mrope_positions

    made = make_inputs(cfg, Shape("lm_reference", prompt_len, prompts, "prefill"), seed=seed)
    out = {k: np.asarray(v, np.float32) if k in ("frames", "patch_embeds") else np.asarray(v)
           for k, v in made.items()}
    if cfg.mrope_sections:
        out["positions"] = (np.asarray(positions, np.int32) if positions is not None else
                            mrope_positions(prompts, prompt_len, cfg.num_patches, seed))
    else:
        out.pop("positions", None)
    return out


def build_fixture(arch: str = "gemma2-2b", *, reduced: bool = False, seed: int = SEED,
                  prompts: int = PROMPTS, prompt_len: int = PROMPT_LEN, steps: int = STEPS,
                  subset: int = SUBSET, layers: int = 0, router: str = "",
                  positions=None, mesh=None) -> dict:
    """The fixture's arrays for ``arch`` (reduced or full width), cut to
    ``layers`` layers if given (the encoder too), with the MoE ``router``
    if given, and M-RoPE ``positions`` (B, prompt_len, 3) if given; every
    run under ``partition.activate(mesh)`` if a JAX ``mesh`` is given."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import Model
    from repro.models.blocks import plan
    from repro_torch.configs import get_config as port_config
    from repro_torch.models.convert import (logit_summary, reference_weights, rel_l2,
                                           vocab_subset, weights_digest)

    cut = {}
    if layers:
        cut["num_layers"] = layers
        if get_config(arch, reduced=reduced).enc_layers:
            cut["enc_layers"] = layers
    if router:
        cut["router"] = router
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), **cut)
    tree = reference_weights(dataclasses.replace(port_config(arch, reduced=reduced), **cut), seed)
    extras = prompt_inputs(cfg, prompts, prompt_len, seed, positions)
    prompt = extras.pop("tokens")
    floats = {k: v for k, v in extras.items() if k != "positions"}
    digest = weights_digest(tree)
    params = {}
    for key in list(tree):  # one leaf at a time: the NumPy copy goes as the JAX one comes
        params[key] = jax.tree_util.tree_map(jnp.asarray, tree.pop(key))
    from repro.sharding import partition

    with capture_router_lps(ordered=mesh is None) as lps, partition.activate(mesh):
        t0 = time.perf_counter()
        model32 = Model(dataclasses.replace(cfg, dtype="float32"))
        lps.active = True
        tokens, logits32 = _run(model32, params, prompt, steps, extras=extras)
        jax.effects_barrier()
        lps.active = False
        t32 = time.perf_counter() - t0
        # the function's own float32 sensitivity: every weight one ulp away
        _, logits_ulp = _run(model32, _ulp_nudge(params, seed + 2), prompt, steps, feed=tokens,
                             extras=extras)
        # the reference with every step in float64
        with _float64_everywhere():
            _, logits64 = _run(Model(dataclasses.replace(cfg, dtype="float64")),
                               jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params),
                               prompt, steps, feed=tokens, extras=extras)
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
        t0 = time.perf_counter()
        _, logits16 = _run(Model(dataclasses.replace(cfg, dtype="bfloat16")), params, prompt,
                           steps, feed=tokens, extras=extras)
        t16 = time.perf_counter() - t0
    del params
    ids = vocab_subset(cfg.vocab_size, subset, seed + 1)
    out = {f"{k}": v for k, v in logit_summary(logits32, ids).items()}
    a, b = logits16[..., ids].astype(np.float64), logits32[..., ids].astype(np.float64)
    ulp, f64 = logits_ulp[..., ids].astype(np.float64), logits64[..., ids].astype(np.float64)
    out.update(
        f32_noise_rel_l2=rel_l2(ulp, b).astype(np.float32),
        f32_noise_max_abs=np.abs(ulp - b).max(axis=-1).astype(np.float32),
        logits_f64=f64,
        f64_rel_l2=rel_l2(b, f64).astype(np.float32),
        f64_max_abs=np.abs(b - f64).max(axis=-1).astype(np.float32),
    )
    out.update(
        arch=np.array(arch), seed=np.int64(seed), tokens=tokens.astype(np.int32),
        prompt_len=np.int64(prompt_len), steps=np.int64(steps), vocab_ids=ids,
        bf16_rel_l2=rel_l2(a, b).astype(np.float32),
        bf16_rel_l2_all=np.float64(np.linalg.norm(a - b) / np.linalg.norm(b)),
        weights_digest=digest, reference_seconds=np.array([t32, t16]),
        layers=np.int64(cfg.num_layers), router=np.array(cfg.router),
        input_dtype=np.array(cfg.dtype), extras_keys=np.array(sorted(floats), dtype=str),
        extras_digest=weights_digest(floats) if floats else np.zeros(0),
        mesh=np.asarray([] if mesh is None else list(mesh.shape.values()), np.int64),
    )
    if "positions" in extras:
        out["positions"] = extras["positions"]
    if cfg.enc_layers:
        out["enc_layers"] = np.int64(cfg.enc_layers)
    if lps.rows:
        offset, moe_layers = 0, []
        for g in plan(cfg):
            if g.kind.endswith("_moe"):
                moe_layers += list(range(offset, offset + g.count))
            offset += g.count
        calls = np.repeat(np.arange(steps + 1), len(moe_layers))
        if len(lps.rows) != calls.size:
            raise RuntimeError(f"recorded {len(lps.rows)} router LPs, expected {calls.size}")
        out.update(lps.arrays(calls, moe_layers * (steps + 1)))
    return out


# ---------------------------------------------------------------------------
# Training fixtures (``--train``, ``--eval``)
# ---------------------------------------------------------------------------

#: ``--train``: the run (steps, tokens a row, rows, microbatches, the
#: optimizer's lr and warm-up), the seeds of the one-ulp nudges, the
#: elements sampled from each leaf's change, and the share of the most
#: differing samples a comparison leaves out
#: (``repro_torch.models.convert.trimmed_rel``).
TRAIN_STEPS = 3
TRAIN_SEQ = 128
TRAIN_BATCH = 4
TRAIN_ACCUM = 2
TRAIN_LR = 1e-3
TRAIN_WARMUP = 2
TRAIN_NUDGES = (2, 3)
TRAIN_SAMPLE = 8192
FLIP_SHARE = 1e-3
#: ``--eval``: the batch of the eval step.
EVAL_SEQ = 256
EVAL_BATCH = 2


def _leaf_paths(tree):
    from repro_torch.sharding import leaves

    return [(path, np.asarray(arr)) for path, arr in leaves(tree)]


def change_samples(tree, seed: int, size: int = TRAIN_SAMPLE):
    """Each leaf's sampled flat indices (sorted; all of a leaf of at most
    ``size`` elements), drawn leaf by leaf in sorted-path order."""
    rng = np.random.default_rng(seed)
    out = []
    for path, arr in _leaf_paths(tree):
        n = arr.size
        idx = np.arange(n) if n <= size else np.sort(rng.choice(n, size, replace=False))
        out.append(("/".join(path), idx.astype(np.int64)))
    return out


def _train_run(cfg, tree, batches, samples, dtype, mesh=None):
    """The reference's jitted train step (``TRAIN_ACCUM`` microbatches,
    remat) over ``batches`` from ``tree`` (NumPy) in ``dtype``, under
    ``mesh`` if given: the metrics of each step and each leaf's change at
    its samples (float64)."""
    from repro.sharding import partition

    with partition.activate(mesh):
        return _train_steps(cfg, tree, batches, samples, dtype)


def _train_steps(cfg, tree, batches, samples, dtype):
    import jax
    import jax.numpy as jnp

    from repro.models import Model
    from repro.sharding import partition
    from repro.train import optimizer, train_step

    ocfg = optimizer.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    model = Model(dataclasses.replace(cfg, dtype=dtype))
    step = jax.jit(train_step.make_train_step(model, ocfg, accum=TRAIN_ACCUM, remat=True))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)
    opt = optimizer.init(params, ocfg)
    put = jnp.asarray
    if partition.named_sharding((), ()) is not None:
        # under a mesh: the parameters and the state laid out by their
        # placements (one copy over the devices, not one a device), and
        # each batch over the batch axes, as the reference's launcher puts them
        ps = model.param_shardings()
        params = jax.device_put(params, ps)
        opt = jax.device_put(opt, optimizer.OptState(partition.named_sharding((), ()), ps, ps,
                                                     ps if opt.master is not None else None))
        rows = partition.named_sharding(batches[0]["tokens"].shape, ("batch", None))

        def put(v):
            return jax.device_put(v, rows)
    metrics = {"loss": [], "grad_norm": [], "lr": []}
    for b in batches:
        params, opt, m = step(params, opt, {k: put(v) for k, v in b.items()})
        for k in metrics:
            metrics[k].append(float(m[k]))
    del opt
    final = dict(("/".join(p), a) for p, a in _leaf_paths(jax.tree_util.tree_map(np.asarray, params)))
    start = dict(("/".join(p), a) for p, a in _leaf_paths(tree))
    delta = {path: final[path].ravel()[idx].astype(np.float64)
             - start[path].ravel()[idx].astype(np.float64) for path, idx in samples}
    return {k: np.asarray(v) for k, v in metrics.items()}, delta


def _nudge_np(tree, seed):
    """``_ulp_nudge`` on a NumPy tree."""
    rng = np.random.default_rng(seed)

    def nudge(a):
        up = rng.random(a.shape, dtype=np.float32) < 0.5
        return np.nextafter(a, np.where(up, np.float32(np.inf), np.float32(-np.inf)))

    import jax

    return jax.tree_util.tree_map(nudge, tree)


def build_train_fixture(arch: str = "gemma2-2b", *, reduced: bool = False, seed: int = SEED,
                        layers: int = 2, steps: int = TRAIN_STEPS, seq: int = TRAIN_SEQ,
                        batch: int = TRAIN_BATCH, sample: int = TRAIN_SAMPLE, mesh=None) -> dict:
    """The training fixture: the reference's train step ``steps`` times on
    ``SyntheticLM`` batches (seed ``seed``), from ``reference_weights``
    (cut to ``layers``): in float32, with the weights one ulp away
    (``TRAIN_NUDGES``), and with every step in float64; each run's loss,
    ``grad_norm`` and ``lr`` a step, and each leaf's change at its
    samples (``change_samples``).  With ``mesh`` the float32 runs are the
    reference's sharded step under it; the float64 run too for a config
    whose function the mesh changes (MoE token groups), and without it
    for a dense one (the mesh only orders the float32 sums otherwise;
    under a mesh of host devices the float64 run of gemma2-2b's 4 layers
    passes the 96 GiB of the chip machine's host).  ``f64_mesh`` says
    which."""
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.configs import get_config as port_config
    from repro_torch.models.convert import reference_weights, trimmed_rel, weights_digest

    cut = {"num_layers": layers} if layers else {}
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), dtype="float32", **cut)
    tree = reference_weights(dataclasses.replace(port_config(arch, reduced=reduced), **cut), seed)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=seed))
    batches = [data.batch(s) for s in range(steps)]
    samples = change_samples(tree, seed + 7, sample)
    t0 = time.perf_counter()
    m32, d32 = _train_run(cfg, tree, batches, samples, "float32", mesh)
    t32 = time.perf_counter() - t0
    _progress("float32 run", t0)
    noise = {"loss": np.zeros(steps), "grad_norm": np.zeros(steps)}
    noise_delta = np.zeros(len(samples))
    for nudge in TRAIN_NUDGES:
        mn, dn = _train_run(cfg, _nudge_np(tree, seed + nudge), batches, samples, "float32",
                            mesh)
        for k in noise:
            noise[k] = np.maximum(noise[k], np.abs(mn[k] / m32[k] - 1.0))
        noise_delta = np.maximum(noise_delta, [trimmed_rel(dn[p], d32[p], FLIP_SHARE)
                                               for p, _ in samples])
        _progress(f"nudged run {nudge}", t0)
    f64_mesh = mesh if cfg.num_experts else None
    with _float64_everywhere(train=True):
        m64, d64 = _train_run(cfg, tree, batches, samples, "float64", f64_mesh)
    _progress("float64 run", t0)
    paths = [p for p, _ in samples]
    sizes = np.asarray([idx.size for _, idx in samples], np.int64)
    return dict(
        kind=np.array("train"), arch=np.array(arch), seed=np.int64(seed),
        layers=np.int64(cfg.num_layers), steps=np.int64(steps), seq=np.int64(seq),
        batch=np.int64(batch), accum=np.int64(TRAIN_ACCUM), lr=np.float64(TRAIN_LR),
        warmup_steps=np.int64(TRAIN_WARMUP), nudges=np.asarray(TRAIN_NUDGES),
        flip_share=np.float64(FLIP_SHARE), weights_digest=weights_digest(tree),
        tokens_digest=np.concatenate([b["tokens"].ravel()[:16] for b in batches]),
        loss=m32["loss"], grad_norm=m32["grad_norm"], lr_steps=m32["lr"],
        f64_loss=m64["loss"], f64_grad_norm=m64["grad_norm"], f64_lr=m64["lr"],
        noise_loss=noise["loss"], noise_grad_norm=noise["grad_norm"],
        leaf_paths=np.asarray(paths), sample_sizes=sizes,
        sample_idx=np.concatenate([idx for _, idx in samples]),
        delta=np.concatenate([d32[p] for p in paths]),
        f64_delta=np.concatenate([d64[p] for p in paths]),
        noise_delta=noise_delta, reference_seconds=np.float64(t32),
        mesh=np.asarray(tuple(mesh.shape.values()) if mesh is not None else (), np.int64),
        f64_mesh=np.bool_(f64_mesh is not None),
    )


def _progress(what: str, t0: float) -> None:
    """A line on stderr: the run done, the seconds since ``t0``, the peak RSS."""
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"{what}: {time.perf_counter() - t0:.1f} s, peak RSS {rss:.1f} GiB", file=sys.stderr,
          flush=True)


def build_eval_fixture(arch: str = "deepseek-v2-lite-16b", *, reduced: bool = False,
                       seed: int = SEED, layers: int = 3, router: str = "lp",
                       seq: int = EVAL_SEQ, batch: int = EVAL_BATCH) -> dict:
    """The eval fixture: the reference's ``make_eval_step`` (under
    ``router``) on one ``SyntheticLM`` batch, from ``reference_weights``
    (cut to ``layers``), in float32, with the weights one ulp away, and
    with every step in float64; and the router LPs it solved."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import Model
    from repro.train import train_step
    from repro_torch.configs import get_config as port_config
    from repro_torch.models.convert import reference_weights, weights_digest

    cut = {"router": router, **({"num_layers": layers} if layers else {})}
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), dtype="float32", **cut)
    tree = reference_weights(dataclasses.replace(port_config(arch, reduced=reduced), **cut), seed)
    b = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=seed)).batch(0)

    def loss(t, dtype="float32"):
        step = jax.jit(train_step.make_eval_step(Model(dataclasses.replace(cfg, dtype=dtype))))
        return float(step(jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t),
                          {k: jnp.asarray(v) for k, v in b.items()}))

    with capture_router_lps() as lps:
        lps.active = True
        l32 = loss(tree)
        jax.effects_barrier()
        lps.active = False
    noise = max(abs(loss(_nudge_np(tree, seed + n)) / l32 - 1.0) for n in TRAIN_NUDGES)
    with _float64_everywhere(train=True):
        l64 = loss(tree, "float64")
    return dict(kind=np.array("eval"), arch=np.array(arch), seed=np.int64(seed),
                layers=np.int64(cfg.num_layers), router=np.array(router), seq=np.int64(seq),
                batch=np.int64(batch), weights_digest=weights_digest(tree),
                tokens_digest=b["tokens"].ravel()[:64], loss=np.float64(l32),
                noise_loss=np.float64(noise), f64_loss=np.float64(l64),
                router_lps=np.int64(len(lps.rows)))


#: Arrays every router's run shares in a fixture of several routers.
SHARED = ("arch", "seed", "prompt_len", "steps", "vocab_ids", "weights_digest", "layers", "mesh",
          "input_dtype", "extras_keys", "extras_digest")


def build_router_fixtures(arch: str, routers, **kw) -> dict:
    """One fixture for several MoE routers: the shared arrays once, and
    each router's under ``<router>__<key>``."""
    out = {}
    for router in routers:
        fx = build_fixture(arch, router=router, **kw)
        for k, v in fx.items():
            if k in SHARED:
                if k in out and not np.array_equal(out[k], v):
                    raise RuntimeError(f"{k} differs between the routers' runs")
                out[k] = v
            else:
                out[f"{router}__{k}"] = v
    out["routers"] = np.array(list(routers))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--prompt-len", type=int, default=PROMPT_LEN, help="tokens a prompt")
    ap.add_argument("--router", default="",
                    help="MoE routers to run, comma-separated (e.g. topk,lp)")
    ap.add_argument("--train", action="store_true",
                    help="write the training fixture (build_train_fixture) instead")
    ap.add_argument("--eval", action="store_true",
                    help="write the eval-step fixture (build_eval_fixture) instead")
    ap.add_argument("--prompts", type=int, default=PROMPTS, help="prompts of the batch")
    ap.add_argument("--mesh", default="",
                    help="DATA,MODEL: run the reference under a mesh of that shape")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is None:
        name = (("lm_train_gemma2_2b_mesh_reference.npz" if args.mesh else
                 "lm_train_gemma2_2b_reference.npz") if args.train else
                "lm_eval_deepseek_v2_lite_reference.npz" if args.eval else
                "lm_gemma2_2b_reference.npz")
        args.out = str(ROOT / "tests" / "data" / name)
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    shape = tuple(int(v) for v in args.mesh.split(",")) if args.mesh else ()
    if shape:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count={shape[0] * shape[1]}")
    import jax

    jax.config.update("jax_enable_x64", True)  # as the tests run the reference
    mesh = None
    if shape:
        from jax.sharding import AxisType

        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    t0 = time.perf_counter()
    if args.train or args.eval:
        if args.train:
            fx = build_train_fixture(args.arch, layers=args.layers or 2, mesh=mesh)
        else:
            fx = build_eval_fixture(args.arch, layers=args.layers or 3, router=args.router or "lp")
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.out, **fx)
        print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")
        print({k: (v.tolist() if v.size <= 8 else f"{v.shape} {v.dtype}") for k, v in fx.items()
               if k not in ("sample_idx", "delta", "f64_delta")})
        return 0
    routers = [r for r in args.router.split(",") if r]
    if routers:
        fx = build_router_fixtures(args.arch, routers, layers=args.layers,
                                   prompt_len=args.prompt_len, prompts=args.prompts, mesh=mesh)
    else:
        fx = build_fixture(args.arch, layers=args.layers, prompt_len=args.prompt_len,
                           prompts=args.prompts, mesh=mesh)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **fx)
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")
    for prefix in [f"{r}__" for r in routers] or [""]:
        print(f"{prefix or 'run'}: tokens {fx[prefix + 'tokens'].shape}, "
              f"logits {fx[prefix + 'logits'].shape}, "
              f"margin min {float(fx[prefix + 'margin'].min()):.3g}, bf16 rel L2 "
              f"{float(fx[prefix + 'bf16_rel_l2_all']):.4g} (rows "
              f"{float(fx[prefix + 'bf16_rel_l2'].min()):.4g}.."
              f"{float(fx[prefix + 'bf16_rel_l2'].max()):.4g}), f32 noise rel L2 "
              f"{float(fx[prefix + 'f32_noise_rel_l2'].max()):.4g} max abs "
              f"{float(fx[prefix + 'f32_noise_max_abs'].max()):.4g}, f32 vs f64 rel L2 "
              f"{float(fx[prefix + 'f64_rel_l2'].max()):.4g} max abs "
              f"{float(fx[prefix + 'f64_max_abs'].max()):.4g}, "
              f"argmax {fx[prefix + 'argmax'].tolist()}, reference s "
              f"{fx[prefix + 'reference_seconds'].tolist()}"
              + (f", router LPs {fx[prefix + 'router_c'].shape}, iterations "
                 f"{sorted(set(fx[prefix + 'router_iterations'].ravel().tolist()))}"
                 if prefix + "router_c" in fx else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
