#!/usr/bin/env python3
"""Where the float32 error of the LM's logits comes from, against the reference fixture.

    PYTHONPATH=src python3 tools/lm_precision_probe.py            # full width: needs a card
    PYTHONPATH=src python3 tools/lm_precision_probe.py --reduced  # reduced gemma2 on the CPU

Full width (gemma2-2b, the committed ``tests/data/lm_gemma2_2b_reference.npz``):
on the fixture's tokens and vocabulary subset, per row (prompt, step),
the logits of each run below against the exact ones and against the
fixture (the JAX reference in float32 on a CPU).  The exact logits are
the port's with every step in float64 on the card
(``_float64_everywhere``).  The runs: the port in float64 with its
float32 norms, rotary embeddings and attention (``port64``); in float32
on the card (TF32 off); the same with every weight one ulp away, with
TF32 on, and with bfloat16-rounded weights; in float32 on the host's
CPU.  Also the residual stream after every layer at the last prompt
position (``port64`` and both float32 runs against the exact one), layer
0's attention scores before the softcap, and the largest error of tanh,
exp, the tanh GELU and rsqrt (in ulps) and of one float32 projection, in
torch on the CPU and the card and in JAX on the CPU.  About 45 GB of
host memory and 25 GB on the card; ``--out`` also writes the readings
as one JSON object.

``--reduced`` builds the fixture of reduced gemma2 in memory
(``tools/lm_reference_fixture.py``; imports JAX) for seeds 0 and 2 and
prints the float32 port's error beside the fixture's float32 noise
(every weight one ulp away, worst row), the ratios that
``chip_smoke.py``'s ``lm_reference`` gate bounds; then, for the four
dense configs, how the CPU parity tests' tolerance and two elementwise
forms of it read on correct float32 evaluations (``_tolerance_forms``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _rel(a, b) -> dict:
    """Relative L2 over everything and its largest row, and the max abs error."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rows = np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)
    return {"rel_l2": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            "rel_l2_rows_max": float(rows.max()), "max_abs": float(np.abs(a - b).max())}


def _float64_everywhere():
    """A context in which the model code's float32 upcasts (norms, rotary
    angles and embeddings, attention scores and softmax, logits) stay in
    float64: with float64 weights, an evaluation with no float32 step."""
    import contextlib

    from repro_torch.models import layers

    @contextlib.contextmanager
    def ctx():
        orig_float, orig_freqs = torch.Tensor.float, layers.rope_freqs
        torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
        layers.rope_freqs = lambda dim, theta, device=None: 1.0 / (theta ** (
            torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim))
        try:
            yield
        finally:
            torch.Tensor.float, layers.rope_freqs = orig_float, orig_freqs

    return ctx()


def _trace(model, fixture) -> np.ndarray:
    """The residual stream after every layer at the last prompt position of
    a prefill of the fixture's prompts: (layers, B, D) float64."""
    rows = []
    hooks = [layer.register_forward_hook(
        lambda mod, inp, out: rows.append(out[0][:, -1].double().cpu().numpy()))
        for layer in model.layers]
    p = int(fixture["prompt_len"])
    tokens = torch.as_tensor(np.asarray(fixture["tokens"])[:, :p], device=model.device)
    try:
        model.prefill({"tokens": tokens}, model.init_cache(tokens.shape[0], p))
    finally:
        for h in hooks:
            h.remove()
    return np.stack(rows)


def _rows(a, b) -> dict:
    """Per (prompt, step) relative L2 and max abs of ``a`` against ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return {"rel_l2": (np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).tolist(),
            "max_abs": np.abs(a - b).max(axis=-1).tolist()}


def _scores_layer0(model, fixture) -> dict:
    """Layer 0's attention scores before the softcap on the fixture's
    prompts: their RMS, and the share past 2 x the cap (tanh > 0.96)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import embed, rmsnorm

    cfg, layer = model.cfg, model.layers[0]
    p = int(fixture["prompt_len"])
    tokens = torch.as_tensor(np.asarray(fixture["tokens"])[:, :p], device=model.device)
    with torch.inference_mode():
        x = rmsnorm(embed(tokens, model.embed["embedding"], cfg), layer.ln_attn, cfg.norm_eps)
        pos = torch.arange(p, device=model.device)[None].expand(tokens.shape[0], p)
        q, k, _ = attn._project_qkv(x, layer.attn, cfg, pos)
        g = cfg.num_heads // cfg.num_kv_heads
        s = torch.einsum("bhgqd,bhkd->bhgqk", q.double().unflatten(1, (cfg.num_kv_heads, g)),
                         k.double()) / math.sqrt(cfg.head_dim)
        causal = torch.ones(p, p, dtype=torch.bool, device=s.device).tril()
        s = s[..., causal]
    return {"q_rms": float(q.double().pow(2).mean().sqrt()),
            "k_rms": float(k.double().pow(2).mean().sqrt()),
            "scores_rms": float(s.pow(2).mean().sqrt()),
            "share_past_2cap": float((s.abs() > 2 * cfg.attn_softcap).double().mean())}


def _elementwise_ulps() -> dict:
    """Largest error, in float32 ulps of max(|float64 value|, 1), of tanh, exp,
    the tanh GELU and rsqrt on the CPU and the card, and of one float32
    projection (80 x 2304 @ 2304 x 9216, relative L2) against float64."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 20) * 4).astype(np.float32)
    x64 = x.astype(np.float64)
    want = {"tanh": np.tanh(x64), "exp": np.exp(np.clip(x64, -80, 80)),
            "gelu_tanh": 0.5 * x64 * (1 + np.tanh(np.sqrt(2 / np.pi) * (x64 + 0.044715 * x64 ** 3))),
            "rsqrt": 1 / np.sqrt(np.abs(x64) + 1e-6)}
    # ulps of max(|value|, 1): the error a float32 result near 1 would carry
    ulp = {k: np.spacing(np.maximum(np.abs(v), 1).astype(np.float32)).astype(np.float64)
           for k, v in want.items()}
    a = rng.standard_normal((80, 2304)).astype(np.float32)
    w = (rng.standard_normal((2304, 9216)) / 48).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    out = {}
    for dev in ("cpu", "cuda"):
        t = torch.as_tensor(x, device=dev)
        got = {"tanh": torch.tanh(t), "exp": torch.exp(t.clamp(-80, 80)),
               "gelu_tanh": torch.nn.functional.gelu(t, approximate="tanh"),
               "rsqrt": torch.rsqrt(t.abs() + 1e-6)}
        out[f"torch_{dev}"] = {k: float((np.abs(v.cpu().numpy() - want[k]) / ulp[k]).max())
                               for k, v in got.items()}
        prod = (torch.as_tensor(a, device=dev) @ torch.as_tensor(w, device=dev)).cpu().numpy()
        out[f"torch_{dev}"]["projection_rel_l2"] = float(
            np.linalg.norm(prod - ref) / np.linalg.norm(ref))
    try:
        import jax
        import jax.numpy as jnp
    except ImportError:
        return out
    with jax.default_device(jax.devices("cpu")[0]):
        got = {"tanh": jnp.tanh(x), "exp": jnp.exp(jnp.clip(x, -80, 80)),
               "gelu_tanh": jax.nn.gelu(x, approximate=True),
               "rsqrt": jax.lax.rsqrt(jnp.abs(x) + np.float32(1e-6))}
        out["jax_cpu"] = {k: float((np.abs(np.asarray(v, np.float64) - want[k]) / ulp[k]).max())
                          for k, v in got.items()}
        prod = np.asarray(jnp.einsum("td,df->tf", a, w), np.float64)
        out["jax_cpu"]["projection_rel_l2"] = float(np.linalg.norm(prod - ref) / np.linalg.norm(ref))
        out["jax_version"] = jax.__version__
    return out


def full_width(out_path) -> None:
    import chip_smoke as smoke
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fx = dict(np.load(smoke.LM_FIXTURE))
    cfg = configs.get_config("gemma2-2b")
    tree = reference_weights(cfg, int(fx["seed"]))
    ids = fx["vocab_ids"]
    out = {"nvidia_smi": smoke.smi_line(), "elementwise": _elementwise_ulps()}
    print(json.dumps(out), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(fx["seed"]) + 2)

    def nudge(t):
        up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
        return torch.nextafter(t, torch.where(up, torch.inf, -torch.inf).to(t.dtype))

    # name, dtype, device, weight transform, TF32, every step in float64
    plan = (("truth64_card", "float64", "cuda", None, False, True),
            ("port64_card", "float64", "cuda", None, False, False),
            ("port32_card", "float32", "cuda", None, False, False),
            ("port32_card_ulp", "float32", "cuda", nudge, False, False),
            ("port32_card_tf32", "float32", "cuda", None, True, False),
            ("port32_card_bf16_weights", "float32", "cuda",
             lambda t: t.to(torch.bfloat16).float(), False, False),
            ("port32_cpu", "float32", "cpu", None, False, False))
    runs, traces = {"fixture": fx["logits"].astype(np.float64)}, {}
    for name, dtype, device, transform, tf32, wide in plan:
        model = load_reference_params(Model(dataclasses.replace(cfg, dtype=dtype),
                                            device=device), tree)
        if transform is not None:
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(transform(p))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        t0 = time.perf_counter()
        with _float64_everywhere() if wide else contextlib.nullcontext():
            runs[name] = smoke.lm_fixture_logits(model, fx).double().cpu().numpy()[..., ids]
            if name in ("truth64_card", "port64_card", "port32_card", "port32_cpu"):
                traces[name] = _trace(model, fx)
            if name == "truth64_card":
                out["layer0_scores"] = _scores_layer0(model, fx)
        torch.backends.cuda.matmul.allow_tf32 = False
        print(json.dumps({"run": name, "seconds": time.perf_counter() - t0}), flush=True)
        del model
        torch.cuda.empty_cache()
    for name, logits in runs.items():
        if name != "truth64_card":
            out[f"{name}_vs_truth64"] = _rows(logits, runs["truth64_card"])
        if name != "fixture":
            out[f"{name}_vs_fixture"] = _rows(logits, runs["fixture"])
    out["port32_card_ulp_vs_port32_card"] = _rows(runs["port32_card_ulp"], runs["port32_card"])
    truth = traces["truth64_card"]
    for name in ("port64_card", "port32_card", "port32_cpu"):
        out[f"layers_{name}_vs_truth64"] = _rows(traces[name], truth)["rel_l2"]
    out["layers_truth64_rms"] = np.sqrt((truth ** 2).mean(axis=-1)).tolist()
    text = json.dumps(out)
    print(text, flush=True)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(text + "\n")


def reduced() -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    import chip_smoke as smoke
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights

    spec = importlib.util.spec_from_file_location("lm_reference_fixture",
                                                  ROOT / "tools" / "lm_reference_fixture.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg = configs.get_config("gemma2-2b", reduced=True)
    for seed in (0, 2):
        fx = tool.build_fixture("gemma2-2b", reduced=True, seed=seed, subset=100)
        model = load_reference_params(Model(cfg, device="cpu"), reference_weights(cfg, seed))
        got = _rel(smoke.lm_fixture_logits(model, fx).double().numpy()[..., fx["vocab_ids"]],
                   fx["logits"])
        noise = {"rel_l2": float(fx["f32_noise_rel_l2"].max()),
                 "max_abs": float(fx["f32_noise_max_abs"].max())}
        print(json.dumps({"seed": seed, "port32_cpu_vs_fixture": got, "f32_noise": noise,
                          "ratio_rel_l2": got["rel_l2_rows_max"] / noise["rel_l2"],
                          "ratio_max_abs": got["max_abs"] / noise["max_abs"]}), flush=True)
    # the CPU parity tests' tolerance forms, on the four dense configs' hidden states
    for arch in ("gemma2-2b", "qwen1.5-4b", "internlm2-20b", "command-r-plus-104b"):
        print(json.dumps({"arch": arch, **_tolerance_forms(arch)}), flush=True)


def _tolerance_forms(arch, seed=3, seq=24, batch=2) -> dict:
    """Reduced ``arch``'s final hidden states: the port's and the
    reference's float32 forwards against each other and against an
    all-float64 evaluation (``_float64_everywhere``), as the ratio of the
    largest error to three bounds: elementwise ``2e-5 + 1e-5 |b|``,
    ``2e-5 max(1, |b|)``, and ``2e-5 max(1, max |b|)`` (the parity tests'
    ``_close``), beside the relative L2 error."""
    import jax
    import jax.numpy as jnp

    from repro import configs as rconfigs
    from repro.models import Model as RModel
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights

    cfg = configs.get_config(arch, reduced=True)
    rcfg = rconfigs.get_config(arch, reduced=True)
    tree = reference_weights(cfg, seed)
    tokens = np.asarray(rconfigs.make_inputs(rcfg, rconfigs.Shape("t", seq, batch, "prefill"),
                                             seed=1)["tokens"])
    port = load_reference_params(Model(cfg, device="cpu"), tree)
    wide = load_reference_params(Model(dataclasses.replace(cfg, dtype="float64"),
                                       device="cpu"), tree)
    with torch.inference_mode():
        h32 = port.forward({"tokens": torch.as_tensor(tokens)}).double().numpy()
        with _float64_everywhere():
            h64 = wide.forward({"tokens": torch.as_tensor(tokens)}).numpy()
    ref = np.asarray(RModel(rcfg).forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                          {"tokens": jnp.asarray(tokens)}), np.float64)

    def forms(a, b):
        d = np.abs(a - b)
        return {"elementwise": float((d / (2e-5 + 1e-5 * np.abs(b))).max()),
                "per_entry_scaled": float((d / (2e-5 * np.maximum(1, np.abs(b)))).max()),
                "tensor_scaled": float(d.max() / (2e-5 * max(1.0, float(np.abs(b).max())))),
                "rel_l2": float(np.linalg.norm(a - b) / np.linalg.norm(b))}

    return {"port32_vs_ref32": forms(h32, ref), "ref32_vs_all64": forms(ref, h64),
            "port32_vs_all64": forms(h32, h64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reduced", action="store_true", help="reduced gemma2 on the CPU")
    ap.add_argument("--out", help="also write the full-width readings (JSON) here")
    args = ap.parse_args(argv)
    if args.reduced:
        reduced()
    else:
        if not torch.cuda.is_available():
            raise SystemExit("lm_precision_probe: full width needs a CUDA device (or --reduced)")
        full_width(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
