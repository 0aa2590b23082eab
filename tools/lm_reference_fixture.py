#!/usr/bin/env python3
"""Write the JAX reference's LM logits for gemma2-2b at full width as a fixture.

    PYTHONPATH=src python3 tools/lm_reference_fixture.py [--out tests/data/lm_gemma2_2b_reference.npz]

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
``chip_smoke.py``'s ``lm_reference`` and ``lm_serve`` phases hold the
port against it on the card; ``tests/test_torch_lm_serve.py`` builds the
same fixture for the reduced config in memory.

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


def _run(model, params, prompts, steps, feed=None):
    """Prefill, then ``steps`` decode steps, greedy unless ``feed`` gives the
    tokens; returns (tokens (B, P + steps), logits (B, steps + 1, V))."""
    import jax
    import jax.numpy as jnp

    b, p = prompts.shape
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step, donate_argnums=(2,))
    cache = model.init_cache(b, p + steps)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)}, cache)
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
def _float64_everywhere():
    """Trace the reference with every ``jnp.float32`` of its layers and
    attention read as ``jnp.float64`` (its norms, rotary angles, attention
    scores and softmax, logits): with float64 weights, a run with no
    float32 step.  Only this tool's view of the modules changes."""
    import jax.numpy as jnp

    from repro.models import attention, layers

    class Wide:
        def __getattr__(self, name):
            return jnp.float64 if name == "float32" else getattr(jnp, name)

    saved = [(mod, mod.jnp) for mod in (attention, layers)]
    for mod, _ in saved:
        mod.jnp = Wide()
    try:
        yield
    finally:
        for mod, orig in saved:
            mod.jnp = orig


def build_fixture(arch: str = "gemma2-2b", *, reduced: bool = False, seed: int = SEED,
                  prompts: int = PROMPTS, prompt_len: int = PROMPT_LEN, steps: int = STEPS,
                  subset: int = SUBSET) -> dict:
    """The fixture's arrays for ``arch`` (reduced or full width)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import Shape, get_config, make_inputs
    from repro.models import Model
    from repro_torch.configs import get_config as port_config
    from repro_torch.models.convert import (logit_summary, reference_weights, rel_l2,
                                           vocab_subset, weights_digest)

    cfg = get_config(arch, reduced=reduced)
    tree = reference_weights(port_config(arch, reduced=reduced), seed)
    prompt = np.asarray(make_inputs(cfg, Shape("lm_reference", prompt_len, prompts, "prefill"),
                                    seed=seed)["tokens"])
    digest = weights_digest(tree)
    params = {}
    for key in list(tree):  # one leaf at a time: the NumPy copy goes as the JAX one comes
        params[key] = jax.tree_util.tree_map(jnp.asarray, tree.pop(key))
    t0 = time.perf_counter()
    model32 = Model(dataclasses.replace(cfg, dtype="float32"))
    tokens, logits32 = _run(model32, params, prompt, steps)
    t32 = time.perf_counter() - t0
    # the function's own float32 sensitivity: every weight one ulp away
    _, logits_ulp = _run(model32, _ulp_nudge(params, seed + 2), prompt, steps, feed=tokens)
    # the reference with every step in float64
    with _float64_everywhere():
        _, logits64 = _run(Model(dataclasses.replace(cfg, dtype="float64")),
                           jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params),
                           prompt, steps, feed=tokens)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    t0 = time.perf_counter()
    _, logits16 = _run(Model(dataclasses.replace(cfg, dtype="bfloat16")), params, prompt,
                       steps, feed=tokens)
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
    )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" / "lm_gemma2_2b_reference.npz"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)  # as the tests run the reference
    t0 = time.perf_counter()
    fx = build_fixture(args.arch)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **fx)
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s: tokens {fx['tokens'].shape}, "
          f"logits {fx['logits'].shape}, margin min {float(fx['margin'].min()):.3g}, "
          f"bf16 rel L2 {float(fx['bf16_rel_l2_all']):.4g} "
          f"(rows {float(fx['bf16_rel_l2'].min()):.4g}..{float(fx['bf16_rel_l2'].max()):.4g}), "
          f"f32 noise rel L2 {float(fx['f32_noise_rel_l2'].max()):.4g} max abs "
          f"{float(fx['f32_noise_max_abs'].max()):.4g}, f32 vs f64 rel L2 "
          f"{float(fx['f64_rel_l2'].max()):.4g} max abs {float(fx['f64_max_abs'].max()):.4g}, "
          f"argmax {fx['argmax'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
