"""Rank processes for the LM mesh tests (gloo on the CPU, or ranks on the card).

Imported by spawned children (``torch_mesh_worker.spawn`` with the
scenario ``"torch_lm_mesh_worker:<function>"``), so it imports torch,
NumPy and ``repro_torch`` only.  Every rank builds each case's model
under the mesh (its own slice of every parameter, from the same NumPy
weights), runs the prefill and two decode steps on the whole batch's
inputs and ``Engine.generate``, and saves its rows of the logits, its
parameter and cache shapes, its tokens and a digest of every router LP
it solved.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

#: Mesh name -> (data, model); no group here has 3 ranks: (1, 3) is the
#: training tests' mesh, whose streams the JAX subprocess lays out too.
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "8x1": (8, 1), "1x8": (1, 8), "2x2": (2, 2),
          "4x1": (4, 1), "1x3": (1, 3)}
#: (arch, router); the router applies to the MoE configs only.
ARCHS = {
    "core": [("gemma2-2b", "topk"), ("qwen1.5-4b", "topk"), ("deepseek-v2-lite-16b", "topk"),
             ("deepseek-v2-lite-16b", "lp"), ("dbrx-132b", "topk")],
    "families": [("mamba2-130m", "topk"), ("zamba2-7b", "topk"),
                 ("seamless-m4t-large-v2", "topk"), ("qwen2-vl-72b", "topk")],
}
SEED = 3
#: The batch, the prompt and the decode steps fed (the fed logits), and
#: the tokens ``Engine.generate`` makes.
BATCH, PROMPT, FED_STEPS, GEN_STEPS = 8, 32, 2, 3
#: The odd batch: 6 prompts on data = 4 (the groups straddle sequences).
ODD_BATCH = 6
#: The reduced mesh fixture's vocabulary subset.
FIXTURE_SUBSET = 64
#: The cases the 4-rank group also runs in bfloat16 on (2, 2): the split's
#: bfloat16 sums (row-parallel products, the split softmax over a bfloat16
#: cache, the experts' partial outputs).
BF16_MESH = "2x2"
BF16_ARCHS = [("gemma2-2b", "topk"), ("deepseek-v2-lite-16b", "lp")]


def config(arch: str, router: str, dtype: str = ""):
    from repro_torch import configs

    cfg = configs.get_config(arch, reduced=True)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return dataclasses.replace(cfg, router=router) if cfg.num_experts else cfg


#: The negative control of the head-split mixer: mamba2 on (2, 4) with the
#: gated RMSNorm's sum of squares left to each rank's heads (no sum over
#: the model axis).
CONTROL_MESH, CONTROL_ARCH = "2x4", "mamba2-130m"


def control_key() -> str:
    return "control|" + case_key(CONTROL_MESH, CONTROL_ARCH, "topk")


class NoNormSum:
    """``models/mamba2.py:_norm_sum`` as the identity for a ``with``."""

    def __enter__(self):
        from repro_torch.models import mamba2

        self.mod, self.orig = mamba2, mamba2._norm_sum
        mamba2._norm_sum = lambda sq, axes: sq
        return self

    def __exit__(self, *exc):
        self.mod._norm_sum = self.orig


#: A prompt the model axis of (2, 2) does not divide (the stream stays
#: whole), on the 4-rank group: gemma2's prefill of ODD_PROMPT tokens and
#: one decode step.
ODD_PROMPT, ODD_PROMPT_MESH, ODD_PROMPT_ARCH = PROMPT - 1, "2x2", "gemma2-2b"


def odd_prompt_key() -> str:
    return "oddprompt|" + case_key(ODD_PROMPT_MESH, ODD_PROMPT_ARCH, "topk")


def stream_key(mesh: str, batch: int, seq: int, width: int) -> str:
    """The key of the reference's layout of a (batch, seq, width) residual
    stream under ``mesh`` (the JAX subprocess's ``stream|`` cases)."""
    return f"stream|{mesh}|{batch}|{seq}|{width}"


def bf16_key(arch: str, router: str) -> str:
    return "bf16|" + case_key(BF16_MESH, arch, router)


def case_key(mesh: str, arch: str, router: str, batch: int = BATCH) -> str:
    return f"{mesh}|{arch}|{router}|{batch}"


def inputs_of(arr, arch: str, router: str, batch: int):
    """The case's fed tokens (B, PROMPT + FED_STEPS) and the prompt's extras."""
    stem = f"{arch}|{batch}"
    tokens = arr[f"{stem}|tokens"]
    extras = {k.split("|")[2]: arr[k] for k in arr if k.startswith(stem + "|")
              and k.split("|")[2] != "tokens"}
    return tokens, extras


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()).hexdigest()


class LPCapture:
    """Wraps ``kernels/ops.py:simplex_solve``: a digest of every router LP's
    ``(a, b, c)`` and of its solution ``x``, in call order."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig, self.calls = ops, ops.simplex_solve, []

    def __enter__(self):
        def solve(a, b, c, **kw):
            sol = self.orig(a, b, c, **kw)
            self.calls.append((digest(a) + digest(b) + digest(c), digest(sol.x)))
            return sol

        self.ops.simplex_solve = solve
        return self

    def __exit__(self, *exc):
        self.ops.simplex_solve = self.orig


def mixer_spy():
    """The repo's ``tools/mixer_spy.py`` (``MixerSpy``, ``mixer_parent_gathers``,
    ``lm_mesh_mixer_step``), which ``chip_smoke.py`` uses too."""
    import sys

    tools = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import mixer_spy as spy

    return spy


def run_case(cfg, tokens, extras, device="cpu"):
    """One case on this rank under the active mesh: what the test compares
    (the residual stream that ``mixer_spy.ResidualSpy`` saw in the prefill
    and each fed decode step; for the SSM and hybrid families also what
    ``mixer_spy.MixerSpy`` saw of the mixers, and
    ``mixer_spy.lm_mesh_mixer_step``)."""
    import contextlib

    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights
    from repro_torch.serve.engine import Engine
    from repro_torch.sharding import partition

    b = tokens.shape[0]
    enc_len = extras["frames"].shape[1] if "frames" in extras else 0
    model = load_reference_params(Model(cfg, device=device), reference_weights(cfg, SEED))
    prompt = {"tokens": torch.as_tensor(tokens[:, :PROMPT], device=device),
              **{k: torch.as_tensor(v, device=device) for k, v in extras.items()}}
    spies = mixer_spy() if cfg.supports_long_context else None
    streams = []  # the residual stream of the prefill and of each fed decode step
    with (spies.MixerSpy() if spies else contextlib.nullcontext()) as spy:
        with LPCapture() as lps:
            cache = model.init_cache(b, PROMPT + FED_STEPS, enc_len=enc_len)
            with mixer_spy().ResidualSpy() as stream:
                lg, _ = model.prefill(prompt, cache)
            streams.append(stream)
            logits = [lg[:, -1]]
            for i in range(FED_STEPS):
                step = torch.as_tensor(tokens[:, PROMPT + i:PROMPT + i + 1], device=device)
                with mixer_spy().ResidualSpy() as stream:
                    lg, _ = model.decode_step({"tokens": step}, cache, PROMPT + i)
                streams.append(stream)
                logits.append(lg[:, -1])
        engine = Engine(model, max_len=PROMPT + GEN_STEPS, enc_len=enc_len, device=device)
        gen = engine.generate(prompt, steps=GEN_STEPS)
    rows = partition.batch_rows(b)
    mixer = None
    if spies:
        mixer = spy.summary(spies.mixer_parent_gathers(model, engine.cache))
        mixer["step"] = spies.lm_mesh_mixer_step(model, prompt["tokens"], gen)
    return {
        "mixer": mixer,
        "stream": [dict(records=st.records, scatters=st.scatters) for st in streams],
        "rows": (rows.start, rows.stop),
        "logits": torch.stack(logits, dim=1).float().cpu(),
        "params": {n: tuple(p.shape) for n, p in model.named_parameters()},
        "param_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
        "cache": [{k: tuple(v.shape) for k, v in layer.items()} for layer in engine.cache],
        "tokens": gen.cpu(),
        "lps": lps.calls,
    }


def stream_case(cfg, tokens, prompt_len: int, device="cpu"):
    """The prefill of ``tokens[:, :prompt_len]`` and one fed decode step under
    ``mixer_spy.ResidualSpy``: each call's stream and last logits."""
    from repro_torch.models import Model
    from repro_torch.models.convert import load_reference_params, reference_weights

    model = load_reference_params(Model(cfg, device=device), reference_weights(cfg, SEED))
    tok = torch.as_tensor(tokens, device=device)
    cache = model.init_cache(tok.shape[0], prompt_len + 1)
    with mixer_spy().ResidualSpy() as pre:
        first, _ = model.prefill({"tokens": tok[:, :prompt_len]}, cache)
    with mixer_spy().ResidualSpy() as step:
        second, _ = model.decode_step({"tokens": tok[:, prompt_len:prompt_len + 1]}, cache,
                                      prompt_len)
    spies, logits = (pre, step), (first[:, -1], second[:, -1])
    from repro_torch.sharding import partition

    rows = partition.batch_rows(tok.shape[0])
    return {"stream": [dict(records=st.records, scatters=st.scatters) for st in spies],
            "rows": (rows.start, rows.stop), "logits": torch.stack(logits, dim=1).float().cpu()}


def _mesh(shape, device="cpu"):
    from torch.distributed.device_mesh import DeviceMesh

    world = shape[0] * shape[1]
    return DeviceMesh(device, torch.arange(world).reshape(shape), mesh_dim_names=("data", "model"))


def _cases(rank, world, tmp, which):
    from repro_torch.sharding import partition

    arr = dict(np.load(os.path.join(tmp, "inputs.npz")))
    out = {}
    for name, shape in MESHES.items():
        if shape[0] * shape[1] != world:
            continue
        mesh = _mesh(shape)
        with partition.activate(mesh):
            out[f"{name}|coords"] = partition.coordinates()
            batches = [BATCH] + ([ODD_BATCH] if name == "4x1" else [])
            for arch, router in ARCHS[which]:
                for b in batches:
                    tokens, extras = inputs_of(arr, arch, router, b)
                    out[case_key(name, arch, router, b)] = run_case(config(arch, router),
                                                                    tokens, extras)
            if name == CONTROL_MESH and which == "families":
                tokens, extras = inputs_of(arr, CONTROL_ARCH, "topk", BATCH)
                with NoNormSum():
                    out[control_key()] = run_case(config(CONTROL_ARCH, "topk"), tokens, extras)
            if name == ODD_PROMPT_MESH and which == "core":
                tokens, _ = inputs_of(arr, ODD_PROMPT_ARCH, "topk", BATCH)
                out[odd_prompt_key()] = stream_case(config(ODD_PROMPT_ARCH, "topk"), tokens,
                                                    ODD_PROMPT)
            if name == BF16_MESH and which == "core":
                for arch, router in BF16_ARCHS:
                    tokens, extras = inputs_of(arr, arch, router, BATCH)
                    out[bf16_key(arch, router)] = run_case(config(arch, router, "bfloat16"),
                                                           tokens, extras)
    return out


def core(rank, world, tmp):
    return _cases(rank, world, tmp, "core")


def families(rank, world, tmp):
    return _cases(rank, world, tmp, "families")


def _card_run(cfg, tokens, extras, dev):
    """``run_case`` on the card with the simplex launches counted."""
    from repro_torch.kernels import simplex_cuda

    simplex_cuda.launches = 0
    for v in simplex_cuda.variant_launches:
        simplex_cuda.variant_launches[v] = 0
    out = run_case(cfg, tokens, extras, device=dev)
    out["launches"] = (simplex_cuda.launches, dict(simplex_cuda.variant_launches))
    out["device"] = str(dev)
    return out


def card_nccl(rank, world, tmp):
    """NCCL with one rank on the card: reduced deepseek under ``lp`` without
    a mesh and on a (1, 1) mesh (every group of one rank)."""
    from repro_torch import configs
    from repro_torch.sharding import partition

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = config("deepseek-v2-lite-16b", "lp")
    tokens = configs.make_inputs(cfg, configs.Shape("t", PROMPT + FED_STEPS, BATCH, "prefill"),
                                 seed=1, device="cpu")["tokens"].numpy()
    out = {"plain": _card_run(cfg, tokens, {}, dev)}
    with partition.activate(_mesh((1, 1), "cuda")):
        out["mesh"] = _card_run(cfg, tokens, {}, dev)
    return out


def card_gloo(rank, world, tmp):
    """Gloo ranks sharing the card: reduced gemma2 on the (1, world) and
    (world, 1) meshes, and the one-process run under each abstract mesh."""
    from repro_torch import configs
    from repro_torch.sharding import partition

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = config("gemma2-2b", "topk")
    tokens = configs.make_inputs(cfg, configs.Shape("t", PROMPT + FED_STEPS, BATCH, "prefill"),
                                 seed=1, device="cpu")["tokens"].numpy()
    out = {}
    for shape in ((1, world), (world, 1)):
        with partition.activate(_mesh(shape, "cuda")):
            out[shape] = _card_run(cfg, tokens, {}, dev)
        with partition.activate({"data": shape[0], "model": shape[1]}):
            out[("one",) + shape] = _card_run(cfg, tokens, {}, dev)
    return out


def collectives(rank, world, tmp):
    """Each collective of ``sharding/collectives.py`` on a (2, 2) mesh."""
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import partition

    with partition.activate(_mesh((2, 2))):
        x = torch.full((3,), float(rank))
        return {
            "sum_model": coll.all_reduce(x, "model"),
            "sum_data": coll.all_reduce(x, "data"),
            "max_all": coll.all_reduce(x, ("data", "model"), "max"),
            "gather_model": coll.all_gather(torch.tensor([[rank]]), "model", 1),
            "gather_all": coll.all_gather(torch.tensor([rank]), ("data", "model"), 0),
            "to_all": coll.all_to_all(torch.arange(4 * rank, 4 * rank + 4), "model", 0, 0),
        }


#: The reference's side, run in one JAX subprocess with 8 forced host
#: devices: argv = (tmp, output name, case keys...).  Each case's mesh is
#: ``jax.make_mesh`` over the first data x model devices, its axes
#: ``Auto`` (the reference's sharded code needs them); the prefill and
#: the fed decode steps are jitted under ``partition.activate(mesh)``.
REFERENCE = '''
import dataclasses, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs as rconfigs
from repro.models import Model
from repro.sharding import partition
from repro_torch.models.convert import reference_weights
import torch_lm_mesh_worker as lw

tmp, name, keys = sys.argv[1], sys.argv[2], sys.argv[3:]
inputs = os.path.join(tmp, "inputs.npz")
arr = dict(np.load(inputs)) if os.path.exists(inputs) else {}


def logits(arch, router, b, mesh_name, params=None):
    cfg = rconfigs.get_config(arch, reduced=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, router=router)
    model = Model(cfg)
    if params is None:
        params = jax.tree_util.tree_map(jnp.asarray,
                                        reference_weights(lw.config(arch, router), lw.SEED))
    tokens, extras = lw.inputs_of(arr, arch, router, b)
    enc_len = extras["frames"].shape[1] if "frames" in extras else 0
    mesh = None
    if mesh_name is not None:
        shape = lw.MESHES[mesh_name]
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
    with partition.activate(mesh):
        cache = model.init_cache(tokens.shape[0], lw.PROMPT + lw.FED_STEPS, enc_len=enc_len)
        prompt = {"tokens": jnp.asarray(tokens[:, :lw.PROMPT]),
                  **{k: jnp.asarray(v) for k, v in extras.items()}}
        lg, cache = jax.jit(model.prefill)(params, prompt, cache)
        rows = [np.asarray(lg[:, -1])]
        decode = jax.jit(model.decode_step)
        for i in range(lw.FED_STEPS):
            step = {"tokens": jnp.asarray(tokens[:, lw.PROMPT + i:lw.PROMPT + i + 1])}
            lg, cache = decode(params, step, cache, lw.PROMPT + i)
            rows.append(np.asarray(lg[:, -1]))
    return np.stack(rows, axis=1)


def nudged(params, seed):
    rng = np.random.default_rng(seed)

    def nudge(a):
        up = rng.random(a.shape) < 0.5
        return jnp.nextafter(a, jnp.where(up, np.float32(np.inf), np.float32(-np.inf)))

    return jax.tree_util.tree_map(nudge, params)


out = {}
for key in keys:
    if key.startswith("stream|"):  # the reference's layout of the residual stream
        _, mesh_name, b, s, d = key.split("|")
        shape, dims = lw.MESHES[mesh_name], (int(b), int(s), int(d))
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        with partition.activate(mesh):
            spec = partition.resolve_spec(dims, ("batch", "seq_tp", None))
        index = jax.sharding.NamedSharding(mesh, spec).devices_indices_map(dims)
        blocks = np.zeros(shape + (4,), np.int64)  # rows lo, hi; positions lo, hi
        for i in range(shape[0]):
            for j in range(shape[1]):
                sl = index[mesh.devices[i, j]]
                blocks[i, j] = [*sl[0].indices(dims[0])[:2], *sl[1].indices(dims[1])[:2]]
        out[key] = blocks
        continue
    if key.startswith("fixture|"):  # the fixture tool's mesh mode, reduced
        sys.path.insert(0, os.path.join(os.path.dirname(lw.__file__), os.pardir, "tools"))
        import lm_reference_fixture as tool

        _, arch, router, b = key.split("|")
        mesh = jax.make_mesh(lw.MESHES["2x2"], ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2, devices=jax.devices()[:4])
        fx = tool.build_router_fixtures(arch, [router], reduced=True, prompts=int(b),
                                        prompt_len=lw.PROMPT, steps=lw.FED_STEPS,
                                        subset=lw.FIXTURE_SUBSET, mesh=mesh)
        out.update({f"{key}|{k}": v for k, v in fx.items()})
        continue
    if key.startswith("noise|"):  # the meshless reference's float32 noise on the case
        _, arch, router, b = key.split("|")
        params = jax.tree_util.tree_map(jnp.asarray,
                                        reference_weights(lw.config(arch, router), lw.SEED))
        want = logits(arch, router, int(b), None, params).astype(np.float64)
        worst = [0.0, 0.0]
        for seed in lw.NUDGES:
            got = logits(arch, router, int(b), None, nudged(params, seed)).astype(np.float64)
            worst[0] = max(worst[0], float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max())))
            worst[1] = max(worst[1], float(np.linalg.norm(got - want) / np.linalg.norm(want)))
        out[key] = np.asarray(worst)
        continue
    mesh_name, arch, router, b = key.split("|")
    out[key] = logits(arch, router, int(b), mesh_name)
np.savez(os.path.join(tmp, name), **out)
'''


# ---------------------------------------------------------------------------
# The test side (no JAX in this process either: the reference runs in its
# own subprocess)
# ---------------------------------------------------------------------------

#: The LM CPU gates (``tests/test_torch_models.py:_close``), and its noise
#: rule for the ill-conditioned reduced zamba2 and seamless (``_gate``):
#: the bounds rise to NOISE_FACTOR times the reference's own float32 noise
#: on the case (its largest change when every weight moves one ulp, over
#: the NUDGES draws), where that is the larger.  The noise is the meshless
#: reference's: a mesh changes the function of neither family.
RTOL, ATOL = 1e-5, 2e-5
NOISE_FACTOR, NUDGES = 4.0, (11, 12, 13)
NOISY = ("zamba2-7b", "seamless-m4t-large-v2")
REFERENCE_TIMEOUT_S = 400


def gate(got, want, noise=(0.0, 0.0)):
    """``(ok, max abs error, its bound, relative L2)`` of ``got`` against
    ``want``, the bounds raised by the case's ``noise`` (abs, rel)."""
    atol, rtol = max(ATOL, NOISE_FACTOR * noise[0]), max(RTOL, NOISE_FACTOR * noise[1])
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    bound = atol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    return err <= bound and rel <= rtol, err, bound, rel


def write_inputs(path, which: str) -> dict:
    """Every case's fed tokens and prompt extras (``configs.make_inputs``,
    seeded; M-RoPE positions whose coordinates differ; 16 encoder frames)."""
    from repro_torch import configs

    arr = {}
    for arch, router in ARCHS[which]:
        cfg = config(arch, router)
        for b in (BATCH, ODD_BATCH):
            inp = configs.make_inputs(cfg, configs.Shape("t", PROMPT + FED_STEPS, b, "prefill"),
                                      seed=1, device="cpu")
            stem = f"{arch}|{b}"
            arr[f"{stem}|tokens"] = inp["tokens"].numpy()
            if "frames" in inp:
                arr[f"{stem}|frames"] = inp["frames"][:, :16].numpy()
            if "patch_embeds" in inp:
                arr[f"{stem}|patch_embeds"] = inp["patch_embeds"].numpy()
                arr[f"{stem}|positions"] = configs.mrope_positions(b, PROMPT, cfg.num_patches, 1)
    np.savez(path, **arr)
    return arr


def reference_process(tmp, name: str, keys, root: str):
    """The reference's cases ``keys`` (:data:`REFERENCE`) in a JAX subprocess
    with 8 forced host devices, started: it writes ``tmp/name``."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([os.path.join(root, "src"), here])}
    return subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp), name, *keys], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def run_all(tmp, which: str, groups, reference_keys, root: str):
    """The spawned gloo groups (``groups``: ranks a group) and the reference's
    cases, split over two JAX subprocesses that run while the groups do.

    Returns ``(inputs, {ranks: [each rank's dict]}, {case key: reference logits})``.
    """
    import torch_mesh_worker as tw

    tmp = str(tmp)
    arr = write_inputs(os.path.join(tmp, "inputs.npz"), which)
    halves = [reference_keys[0::2], reference_keys[1::2]]
    procs = [reference_process(tmp, f"reference{i}.npz", keys, root)
             for i, keys in enumerate(halves) if keys]
    try:
        ranks = {}
        for n in groups:
            sub = os.path.join(tmp, f"group{n}")
            os.makedirs(sub, exist_ok=True)
            os.link(os.path.join(tmp, "inputs.npz"), os.path.join(sub, "inputs.npz"))
            ranks[n] = tw.spawn(f"torch_lm_mesh_worker:{which}", n, sub)
        errs = [p.communicate(timeout=REFERENCE_TIMEOUT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    ref = {}
    for i in range(len(procs)):
        ref.update(dict(np.load(os.path.join(tmp, f"reference{i}.npz"))))
    return arr, ranks, ref


def one_process(arr, key: str, *, g_one: bool = False, dtype: str = ""):
    """The case of ``key`` on one process under the abstract mesh of its
    shape (every group of the split run), in ``dtype`` if given; ``g_one``
    forces the MoE layers to one token group (the negative control)."""
    from repro_torch.models import moe
    from repro_torch.sharding import partition

    mesh, arch, router, b = key.split("|")
    data, model = MESHES[mesh]
    tokens, extras = inputs_of(arr, arch, router, int(b))
    if g_one:
        moe.partition = _OneGroup(partition)
    try:
        with partition.activate({"data": data, "model": model}):
            return run_case(config(arch, router, dtype), tokens, extras)
    finally:
        moe.partition = partition


class _OneGroup:
    """``sharding.partition`` as ``models/moe.py`` sees it, with the batch
    axes' size read as 1 (a port that kept g = 1 under a data axis)."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def axis_size(self, logical):
        return 1 if logical == "batch" else self._mod.axis_size(logical)


def whole_logits(ranks, case, key: str = "") -> np.ndarray:
    """The batch's logits (B, calls, V) put together from the ranks' rows (of
    ``key``, by default the case's); ranks that run the same rows (the
    model axis) hold the same bits."""
    key = key or case_key(*case)
    vocab = config(*case[1:3]).padded_vocab
    calls = ranks[0][key]["logits"].shape[1]
    out = np.full((case[3], calls, vocab), np.nan, np.float32)
    for r, rank in enumerate(ranks):
        got = rank[key]
        r0, r1 = got["rows"]
        mine = got["logits"].numpy()
        seen = ~np.isnan(out[r0:r1])
        assert np.array_equal(out[r0:r1][seen], mine[seen]), r
        out[r0:r1] = mine
    assert not np.isnan(out).any()
    return out


def check_local_shapes(ranks, case, enc_len: int = 0) -> None:
    """Every rank's parameters and cache leaves have the shapes of their
    placements' slices (``partition.local_slices`` at the rank's
    coordinates), and a split mesh stores less than the whole model."""
    from repro_torch.models import Model
    from repro_torch.sharding import partition

    mesh, arch, router, b = case
    data, model_axis = MESHES[mesh]
    meta = Model(config(arch, router), device="meta")
    whole = sum(p.numel() * p.element_size() for p in meta.parameters())
    cache_specs = meta.cache_specs(b, PROMPT + GEN_STEPS, enc_len)

    def local(spec, coords):
        return tuple(sl.stop - sl.start for sl in
                     partition.local_slices(spec.shape, spec.axes, coords))

    for rank in ranks:
        got, coords = rank[case_key(*case)], rank[f"{mesh}|coords"]
        with partition.activate({"data": data, "model": model_axis}):
            for name, spec in meta.abstract_params().items():
                assert got["params"][name] == local(spec, coords), name
            assert len(got["cache"]) == len(cache_specs)
            for layer, specs in zip(got["cache"], cache_specs):
                assert {k: local(s, coords) for k, s in specs.items()} == layer
        if data * model_axis > 1:
            assert got["param_bytes"] < whole


#: The stream's float64 sums over the width (``mixer_spy.ResidualSpy``) of a
#: rank against the one-process run's at the rank's block: within this
#: share of the one-process record's largest magnitude (at least 1).  The
#: split's float32 sums round otherwise than one process's; a block taken
#: at other rows or positions misses by the values' own size.
STREAM_TOL = 1e-3


def stream_keys(meshes, cases) -> list:
    """The reference's layout of each case's streams: the prompt's (and the
    encoder's 16 frames') positions, the decode step's one, and the odd
    prompt's, for each case's batch."""
    keys = []
    for mesh, arch, router, b in cases:
        cfg = config(arch, router)
        seqs = [PROMPT, 1] + ([16] if cfg.family == "encdec" else [])
        keys += [stream_key(mesh, b, s, cfg.d_model) for s in seqs]
    if ODD_PROMPT_MESH in meshes:
        cfg = config(ODD_PROMPT_ARCH, "topk")
        keys += [stream_key(ODD_PROMPT_MESH, BATCH, s, cfg.d_model) for s in (ODD_PROMPT, 1)]
    return sorted(set(keys))


def stream_errors(ranks, mesh: str, key: str, ref, width: int, one=None) -> list:
    """What differs between each rank's residual stream in the case ``key``
    (its ``stream``: the prefill's, then each decode step's) and the
    reference's layout (``ref``: the JAX subprocess's ``stream|`` blocks):
    every record's rows and positions must be the rank's block of the
    reference's ``resolve_spec``, its shape that block's, every decode
    step's stream whole and without a reduce-scatter, and (given ``one``,
    the one-process run's case) each record's sums within ``STREAM_TOL``
    of the one-process run's at that block."""
    errors, batch = [], int(key.split("|")[-1])
    for r, rank in enumerate(ranks):
        d, m = rank[f"{mesh}|coords"]["data"], rank[f"{mesh}|coords"]["model"]
        calls = rank[key]["stream"]
        for c, call in enumerate(calls):
            if not call["records"]:
                errors.append((r, c, "no block boundary seen"))
            for i, rec in enumerate(call["records"]):
                rows_lo, rows_hi, lo, hi = (int(v) for v in ref[stream_key(
                    mesh, batch, rec["positions"], width)][d, m])
                got = (rec["rows"], rec["seq"], rec["shape"][:2])
                want = ((rows_lo, rows_hi), (lo, hi), (rows_hi - rows_lo, hi - lo))
                if got != want:
                    errors.append((r, c, i, got, want))
                if one is not None:
                    base = one["stream"][c]["records"][i]["sums"]
                    part = base[rows_lo:rows_hi, lo:hi]
                    bound = STREAM_TOL * max(1.0, float(base.abs().max()))
                    err = float((rec["sums"] - part).abs().max())
                    if not err <= bound:
                        errors.append((r, c, i, "sums", err, bound))
            if c > 0 and (call["scatters"] or any(rec["seq"] != (0, 1) for rec in call["records"])):
                errors.append((r, c, "a decode step's stream is cut or reduce-scattered"))
    return errors

