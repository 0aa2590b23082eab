"""Model orchestration: init, forward, prefill and decode for every family.

Follows ``repro/models/model.py``.  ``Model`` is an ``nn.Module`` with one
block a layer, over the groups of ``blocks.plan`` in order (for the
encoder-decoder, the encoder's layers first): the reference's stacked
``g0``, ``g1``, ... leaves are unstacked (``models/convert.py`` moves
weights between the two layouts).  The zamba2 hybrid's one shared
attention block is ``shared_attn``, run before each sub-stack of
``shared_attn_every`` mamba layers; the encoder-decoder's encoder norm
is ``enc_norm``.  The reference's ``params`` argument is gone: the
module holds its parameters.

``forward(inputs, remat=True)`` recomputes each layer in the backward
pass: one ``torch.utils.checkpoint.checkpoint`` a layer (and a zamba2
shared-block site), where the reference wraps its scanned layers in
``jax.checkpoint`` with the ``nothing_saveable`` policy.  Only the layer
boundaries stay alive between the forward and the backward; the losses
and gradients are the same bits as without it.

Caches are preallocated tensors, written in place by ``prefill`` and
``decode_step`` (the reference donates them to its jitted step): a list
with one dict a layer, then one a shared-attention site (zamba2).  GQA
layers and sites hold k/v (B, Hkv, T, hd); MLA layers the latents
``ckv`` (B, T, R) and rotary keys ``kpe`` (B, T, rope); mamba layers
``conv`` (B, ssm_conv - 1, conv channels) and ``state`` (B, H, P, N),
float32; decoder layers k/v and the cross attention's ``ck``/``cv``
(B, H, enc_len, hd); encoder layers an empty dict.

**Under a mesh** (``with partition.activate(mesh)``, a ``DeviceMesh``):
a ``Model`` built there stores only this rank's slice of every
parameter (``partition.local_slices`` of its spec's axes; the whole
model never exists on one rank), and ``init_cache`` only its slice of
every cache leaf (``cache_specs``' axes: KV and MLA caches split over
positions by the model axis and over rows by the batch axes, the mamba
``conv`` leaf over channels, its ``state`` over heads).  ``forward``,
``prefill`` and ``decode_step`` take the whole batch's inputs on every
rank, run this rank's rows (``partition.batch_rows``; every row where
the batch axes do not divide the batch) and return those rows: logits
with the whole vocabulary.  Between the layers a rank holds its block
of the rows' positions (``partition.global_seq``: the reference's
sequence-parallel residual stream, ``models/blocks.py``); the final
norm runs on the block, which is then gathered, so the hidden states
and logits have every position.  Parameters and cache leaves keep their
``ParamSpec`` as ``.spec``.  Under an abstract mesh (``{axis: size}``)
one process holds and runs everything, and computes the function of the
split run (the MoE token groups follow the mesh's batch axes).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.lp import resolve_device
from ..sharding import ParamSpec, leaves, partition
from ..sharding import collectives as coll
from ..sharding.rules import draw, shardings
from . import blocks as blk
from .config import ModelConfig
from .layers import embed, embed_specs, rmsnorm, rmsnorm_spec, sinusoidal_positions, unembed
from .mamba2 import CACHE_AXES as MAMBA_CACHE_AXES
from .mamba2 import mamba_cache_specs

#: Logical axes of the KV and cross caches (B, H, T, hd) and the MLA
#: latents (B, T, .), as the reference's ``cache_specs`` names them.
KV_AXES = ("batch", None, "kv_seq_tp", None)
MLA_AXES = ("batch", "kv_seq_tp", None)

_GLOBAL_WINDOW = 1 << 30  # the reference's "no window" value of a global layer


class Model(nn.Module):
    """A model of any family on ``device`` (the card unless the caller
    passes ``device="cpu"``).  Its parameters are uninitialised until
    ``init`` or ``convert.load_reference_params`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg.validate()
        self.groups = blk.plan(cfg)
        device = resolve_device(device)
        self.embed = blk.empty_params(embed_specs(cfg), device)
        self.layers = nn.ModuleList(
            blk.make_block(kind, cfg, window=w, device=device)
            for kind, w in zip(self.kinds(), self.windows())
        )
        self.final_norm = blk.empty_param(rmsnorm_spec(cfg.d_model, cfg.dtype), device)
        if self._hybrid():
            self.shared_attn = blk.make_shared_block(cfg, device=device)
        if cfg.family == "encdec":
            self.enc_norm = blk.empty_param(rmsnorm_spec(cfg.d_model, cfg.dtype), device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def kinds(self) -> List[str]:
        """Each layer's block kind, the groups of ``blocks.plan`` in order."""
        return [g.kind for g in self.groups for _ in range(g.count)]

    def windows(self) -> List[Optional[int]]:
        """Each layer's sliding window, counted within its group as the
        reference's scan counts it: gemma2 alternates local (even layers)
        and global (odd layers, ``_GLOBAL_WINDOW``); None where there is none."""
        cfg = self.cfg
        out = []
        for g in self.groups:
            if cfg.local_global_pattern and cfg.sliding_window:
                out += [cfg.sliding_window if i % 2 == 0 else _GLOBAL_WINDOW
                        for i in range(g.count)]
            else:
                out += [cfg.sliding_window or None] * g.count
        return out

    def _hybrid(self) -> bool:
        return self.cfg.family == "hybrid" and bool(self.cfg.shared_attn_every)

    def shared_sites(self) -> int:
        """Application sites of zamba2's shared block: one before each
        sub-stack of ``shared_attn_every`` mamba layers (0 if none)."""
        if not self._hybrid():
            return 0
        return math.ceil(self.cfg.num_layers / self.cfg.shared_attn_every)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def abstract_params(self) -> Dict[str, ParamSpec]:
        """A ``ParamSpec`` for every parameter, by its ``named_parameters`` name."""
        cfg = self.cfg
        tree = {
            "embed": embed_specs(cfg),
            "layers": {str(i): blk.block_specs(kind, cfg) for i, kind in enumerate(self.kinds())},
            "final_norm": rmsnorm_spec(cfg.d_model, cfg.dtype),
        }
        if self._hybrid():
            tree["shared_attn"] = blk.shared_attn_specs(cfg)
        if cfg.family == "encdec":
            tree["enc_norm"] = rmsnorm_spec(cfg.d_model, cfg.dtype)
        return {".".join(path): spec for path, spec in leaves(tree)}

    def param_shardings(self) -> Dict[str, object]:
        """Each parameter's placements on the active mesh, by name (the
        reference's ``param_shardings``; None entries without a mesh)."""
        return shardings(self.abstract_params())

    def set_param(self, name: str, value: torch.Tensor) -> None:
        """Replace the parameter ``name`` by ``value`` (shape checked)."""
        owner, _, leaf = name.rpartition(".")
        mod = self.get_submodule(owner) if owner else self
        old = getattr(mod, leaf)
        if tuple(old.shape) != tuple(value.shape):
            raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(old.shape)}")
        new = nn.Parameter(value, requires_grad=old.requires_grad)
        if hasattr(old, "spec"):
            new.spec = old.spec
        setattr(mod, leaf, new)

    def init(self, generator: torch.Generator, dtype_override: Optional[str] = None) -> "Model":
        """Fill every parameter from ``generator`` (on the model's device),
        drawn as ``sharding.materialize`` draws them (sorted names); each
        replaces its unset parameter before the next is drawn, so the model
        never holds two copies of its weights (a 38 GB model fits an 80 GB
        card).  ``dtype_override`` sets their dtype."""
        specs = self.abstract_params()
        for name in sorted(specs):
            self.set_param(name, draw(specs[name], generator, self.device, dtype_override))
        return self

    # ------------------------------------------------------------------
    # Caches
    # ------------------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int, enc_len: int = 0) -> List[Dict[str, ParamSpec]]:
        """A ``ParamSpec`` (zeros) for every cache leaf: one dict a layer, then
        one a shared site (the module's docstring), with the reference's
        axes."""
        cfg = self.cfg
        dt = cfg.dtype

        def kv():
            shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
            return {"k": ParamSpec(shape, KV_AXES, dt, "zeros"),
                    "v": ParamSpec(shape, KV_AXES, dt, "zeros")}

        out = []
        for kind in self.kinds():
            if kind in ("mla_dense", "mla_moe"):
                out.append({"ckv": ParamSpec((batch, max_len, cfg.kv_lora_rank), MLA_AXES, dt, "zeros"),
                            "kpe": ParamSpec((batch, max_len, cfg.qk_rope_dim), MLA_AXES, dt, "zeros")})
            elif kind == "mamba":
                out.append({k: ParamSpec(shape, MAMBA_CACHE_AXES[k], d, "zeros") for k, (shape, d)
                            in mamba_cache_specs(cfg, batch, cfg.dtype).items()})
            elif kind == "enc":
                out.append({})  # the encoder keeps no decode state
            elif kind == "dec_cross":
                cross = (batch, cfg.num_heads, enc_len, cfg.head_dim)
                out.append({**kv(), "ck": ParamSpec(cross, KV_AXES, dt, "zeros"),
                            "cv": ParamSpec(cross, KV_AXES, dt, "zeros")})
            else:
                out.append(kv())
        out += [kv() for _ in range(self.shared_sites())]
        return out

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0) -> List[Dict[str, torch.Tensor]]:
        """Zeroed caches (see the module's docstring), in ``cfg.dtype`` but
        the SSM states (float32): one dict a layer, then one a shared
        site.  ``enc_len`` sizes the decoder's cross-attention caches.
        Under a ``DeviceMesh``, this rank's slice of each leaf."""

        def zeros(spec: ParamSpec) -> torch.Tensor:
            t = torch.zeros(partition.local_shape(spec.shape, spec.axes),
                            dtype=getattr(torch, spec.dtype), device=self.device)
            t.spec = spec
            return t

        return [{k: zeros(spec) for k, spec in layer.items()}
                for layer in self.cache_specs(batch, max_len, enc_len)]

    # ------------------------------------------------------------------
    # Forward, prefill, decode
    # ------------------------------------------------------------------

    def _positions(self, inputs, batch: int, s: int, offset: int = 0) -> torch.Tensor:
        """The inputs' ``positions`` if given, else ``offset + arange(s)``
        for every row (on all three coordinates under M-RoPE)."""
        if "positions" in inputs:
            return inputs["positions"]
        pos = (offset + torch.arange(s, device=self.device)[None, :]).expand(batch, s)
        if self.cfg.mrope_sections:
            return pos[..., None].expand(batch, s, 3)
        return pos

    def _embed_inputs(self, inputs) -> torch.Tensor:
        """Token embeddings, the stream's block of positions; under the
        vision frontend, ``patch_embeds`` (B, P, D) overwrite the first P
        of them (P <= S), each on the rank that holds its position."""
        cfg = self.cfg
        x = embed(inputs["tokens"], self.embed["embedding"], cfg)
        if cfg.frontend == "vision" and "patch_embeds" in inputs:
            pe, s = inputs["patch_embeds"], inputs["tokens"].shape[1]
            if pe.shape[1] > s:
                raise ValueError(f"{pe.shape[1]} patch embeddings for a prompt of {s} tokens")
            if partition.current_seq() is None:
                raise RuntimeError("_embed_inputs cuts the patches to the stream's block: "
                                   "call it inside partition.global_seq")
            lo, hi, _ = coll.stream_range()
            n = min(hi, pe.shape[1]) - lo
            if n > 0:
                x[:, :n] = pe[:, lo:lo + n].to(x.dtype)
        return x

    def _layer_cache(self, cache, i):
        return cache[i] if cache is not None else None

    @staticmethod
    def _block_out(block, x, remat: bool, **kw) -> torch.Tensor:
        """``block(x, **kw)``'s hidden states; with ``remat`` (and grad mode
        on) recomputed in the backward pass instead of kept, with the whole
        batch and the stream's positions the forward named
        (``partition.global_batch``, ``global_seq``: the MoE token groups
        and the stream's layout read them, and the backward runs outside
        ``forward``).  The layer input kept is the stream's block."""
        if remat and torch.is_grad_enabled():
            batch, seq = partition.current_batch(), partition.current_seq()

            def run(h):
                with partition.global_batch(batch), partition.global_seq(seq):
                    return block(h, **kw)[0]

            return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
        return block(x, **kw)[0]

    def _run(self, inputs, *, cache=None, cache_index=None, offset: int = 0,
             remat: bool = False) -> torch.Tensor:
        """The layers over the stream's block of positions (``positions``
        whole: each sublayer cuts them where it cuts q); the final norm on
        the block, then every position gathered."""
        b, s = inputs["tokens"].shape
        with partition.global_seq(s):
            x = self._embed_inputs(inputs)
            positions = self._positions(inputs, b, s, offset)
            if self._hybrid():
                x = self._run_hybrid(x, positions, cache, cache_index, remat=remat)
            else:
                for i, layer in enumerate(self.layers):
                    x = self._block_out(layer, x, remat, positions=positions,
                                        cache=self._layer_cache(cache, i),
                                        cache_index=cache_index)
            return coll.seq_whole(rmsnorm(x, self.final_norm, self.cfg.norm_eps))

    def _run_hybrid(self, x, positions, cache, cache_index, remat: bool = False):
        """zamba2: the shared block (site j's own cache) before each
        sub-stack of ``shared_attn_every`` mamba layers."""
        every, n = self.cfg.shared_attn_every, self.cfg.num_layers
        for site, lo in enumerate(range(0, n, every)):
            x = self._block_out(self.shared_attn, x, remat, positions=positions,
                            cache=self._layer_cache(cache, n + site), cache_index=cache_index)
            for i in range(lo, min(lo + every, n)):
                x = self._block_out(self.layers[i], x, remat, cache=self._layer_cache(cache, i),
                                cache_index=cache_index)
        return x

    def _encode(self, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """The encoder: frames (B, Senc, D) plus sinusoidal positions,
        the encoder layers, ``enc_norm``."""
        cfg = self.cfg
        frames = frames.to(getattr(torch, cfg.dtype))
        b, senc, _ = frames.shape
        pos_table = sinusoidal_positions(senc, cfg.d_model, frames.device).to(frames.dtype)
        with partition.global_seq(senc):
            x = coll.seq_part(frames + pos_table[None])
            x = partition.constrain(x, ("batch", "seq_tp", None))
            positions = self._positions({}, b, senc)
            for layer in self.layers[:cfg.enc_layers]:
                x = self._block_out(layer, x, remat, positions=positions)
            # cross attention reads every encoder position: gathered once
            return coll.seq_whole(rmsnorm(x, self.enc_norm, cfg.norm_eps))

    def _decode_stack(self, tokens, *, enc_out=None, cache=None, cache_index=None,
                      offset: int = 0, remat: bool = False) -> torch.Tensor:
        """The decoder layers over ``tokens`` at positions from ``offset``."""
        cfg = self.cfg
        b, s = tokens.shape
        with partition.global_seq(s):
            x = embed(tokens, self.embed["embedding"], cfg)
            positions = self._positions({}, b, s, offset)
            for i in range(cfg.enc_layers, len(self.layers)):
                x = self._block_out(self.layers[i], x, remat, positions=positions,
                                    enc_out=enc_out, cache=self._layer_cache(cache, i),
                                    cache_index=cache_index)
            return coll.seq_whole(rmsnorm(x, self.final_norm, cfg.norm_eps))

    def _forward_encdec(self, inputs, *, cache=None, cache_index=None,
                        remat: bool = False) -> torch.Tensor:
        enc_out = self._encode(inputs["frames"], remat=remat)
        return self._decode_stack(inputs["tokens"], enc_out=enc_out, cache=cache,
                                  cache_index=cache_index, offset=cache_index or 0, remat=remat)

    @staticmethod
    def _local(inputs) -> Dict[str, torch.Tensor]:
        """This rank's rows of every input (all of them without a
        ``DeviceMesh``, or where the batch axes do not divide the batch)."""
        rows = partition.batch_rows(inputs["tokens"].shape[0])
        return {k: v[rows] for k, v in inputs.items()}

    def forward(self, inputs: Dict[str, torch.Tensor], remat: bool = False) -> torch.Tensor:
        """Final hidden states (B, S, D) of the full forward; ``remat``
        recomputes each layer in the backward pass (the module's docstring).
        Under a mesh, this rank's rows (the module's docstring)."""
        with partition.global_batch(inputs["tokens"].shape[0]):
            inputs = self._local(inputs)
            if self.cfg.family == "encdec":
                return self._forward_encdec(inputs, remat=remat)
            return self._run(inputs, remat=remat)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return unembed(hidden, self.embed.get("unembed", self.embed["embedding"]), self.cfg)

    @torch.inference_mode()
    def prefill(self, inputs, cache):
        """Run the prompt once and fill the cache; returns (last logits (B, 1, V), cache).

        ``inputs``: ``tokens``, and as the config needs them ``frames``
        (encoder-decoder), ``patch_embeds`` and ``positions`` (B, S, 3)
        (vision, M-RoPE).  Under a mesh, the whole batch's inputs, and this
        rank's rows of the logits."""
        with partition.global_batch(inputs["tokens"].shape[0]):
            inputs = self._local(inputs)
            if self.cfg.family == "encdec":
                hidden = self._forward_encdec(inputs, cache=cache, cache_index=0)
            else:
                hidden = self._run(inputs, cache=cache, cache_index=0)
            return self.logits(hidden[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, inputs, cache, cache_index: int):
        """One decode step: ``inputs["tokens"]`` (B, 1), and ``positions``
        if given (else ``cache_index``) -> (logits (B, 1, V), cache).  The
        encoder-decoder runs its decoder only, against the cached cross
        k/v.  Under a mesh, the whole batch's tokens, and this rank's rows of
        the logits."""
        step = self._local({k: inputs[k] for k in ("tokens", "positions") if k in inputs})
        with partition.global_batch(inputs["tokens"].shape[0]):
            if self.cfg.family == "encdec":
                hidden = self._decode_stack(step["tokens"], cache=cache,
                                            cache_index=cache_index, offset=cache_index)
            else:
                hidden = self._run(step, cache=cache, cache_index=cache_index, offset=cache_index)
            return self.logits(hidden), cache
