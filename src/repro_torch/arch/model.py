"""Composable LM over the six architecture families, in float32 or
bfloat16 (the reference's ``dtype``): layers mix by causal self-attention,
cross-attention onto image embeddings (the vision model) or SSD (Mamba-2),
and feed forward through a dense MLP, an MoE layer or nothing.

A model is a repeating block *pattern* (``ArchConfig.pattern``): parameters
are stacked per pattern position with a leading repeat axis ``R``, as in the
reference, and decode caches are ``(R, B, ...)`` leaves. The module holds the
configuration, the dtype of its parameters and caches, and the device;
parameters are a tree of tensors made by
:meth:`TransformerLM.init_params` (or installed from the reference's tree by
:mod:`repro_torch.arch.convert`) and passed to every call.

Four entry points:
  ``forward``      full-sequence logits (+ the MoE aux loss)
  ``loss``         mean next-token NLL of a batch (the trainer's objective)
  ``prefill``      full sequence -> (last logits, decode caches)
  ``decode_step``  one token against the caches, updated in place

``forward`` runs its layers repeat-major, ``prefill`` and ``decode_step``
pattern-major, each as the reference's entry point of the same name does,
and every MoE layer routes over ``n_groups = B`` groups where a sequence
has more than one token and over one group of all B rows where it has one
(a decode step), the reference's rule.

``remat`` checkpoints each repeat's block under autograd, and
``layer_remat`` each layer inside it, as the reference's ``remat`` and
``layer_remat`` do (``torch.utils.checkpoint``, non-reentrant): the
backward recomputes the block's forward from its input, and holds one
block's (or one layer's) activations at a time in place of all of them.
The recomputed forward runs the same ops in the same order, so losses and
gradients are the same, bit for bit. ``prefill`` and ``decode_step`` run
without gradients, where a checkpoint changes nothing, and take no
checkpoint.

``partitioner`` (None by default) is the reference's hook: a
``launch.sharding.Partitioner`` whose ``constrain`` the model calls at the
reference's sites (the embedding and each repeat's residual, each
prefill layer's residual, the logits, and the loss's fp32 logits, its
log-sum-exp and its gathered gold logit; the MoE layers get it as
``constrain``). On plain tensors it changes nothing; on the dry-run's
DTensors it places the activations (``launch/dryrun.py``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from . import layers as L
from . import ssm as S
from .config import ArchConfig, LayerSpec

META = torch.device("meta")
SUPPORTED_MIXERS = ("attn", "cross_attn", "ssm")
SUPPORTED_FFNS = ("dense", "moe", "none")
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _unbind(tree, n: int) -> list:
    """A tree whose leaves have a leading axis of ``n`` as ``n`` trees of
    the leaves' slices (views, from one ``unbind`` per leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: p[r] for k, p in parts.items()} for r in range(n)]
    return list(tree.unbind(0))


def _stack(trees: list):
    """Stack a list of same-shaped dict trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _checkpointed(fn, *args):
    """``fn(*args)`` checkpointed where autograd records (non-reentrant).
    The model draws no random numbers, so no generator state is read: the
    CUDA generator a graph capture registers is never met."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype=torch.float32, *, device=None,
                 remat: bool = False):
        """``dtype``: of the parameters and the decode caches, float32 or
        bfloat16 (as the reference's ``dtype``); the loss is taken in
        float32 either way. ``remat``: checkpoint each repeat's block in
        ``forward`` (training memory). The reference's ``unroll`` has no
        counterpart: the repeats here are already a Python loop."""
        super().__init__()
        if dtype not in SUPPORTED_DTYPES:
            raise ValueError(f"{cfg.name}: dtype {dtype} is not one of "
                             f"{SUPPORTED_DTYPES}")
        for spec in cfg.pattern:
            if spec.mixer not in SUPPORTED_MIXERS:
                raise ValueError(
                    f"{cfg.name}: layer spec {spec} has an unknown mixer "
                    f"{spec.mixer!r} (one of {SUPPORTED_MIXERS})")
            if spec.ffn not in SUPPORTED_FFNS:
                raise ValueError(
                    f"{cfg.name}: layer spec {spec} has an unknown ffn "
                    f"{spec.ffn!r} (one of {SUPPORTED_FFNS})")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.remat = remat
        # Nested remat: checkpoint each layer inside the block too, so the
        # backward holds one layer's activations (not the block's)
        self.layer_remat = False
        # Optional launch.sharding.Partitioner: when set, activations are
        # constrained at the reference's residual, logits and loss sites
        # (the identity on plain tensors; the dry-run's DTensors move)
        self.partitioner = None

    def _wsc(self, x, kind: str):
        if self.partitioner is None:
            return x
        return self.partitioner.constrain(x, kind)

    # -- parameters ----------------------------------------------------------

    def _init_layer(self, gen, spec: LayerSpec, dev: torch.device):
        cfg, dt = self.cfg, self.dtype
        p: dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), device=dev,
                                                 dtype=dt)}
        if spec.mixer == "attn":
            p["attn"] = L.init_attention(gen, cfg, device=dev, dtype=dt)
        elif spec.mixer == "cross_attn":
            p["attn"] = L.init_attention(gen, cfg, cross=True, device=dev,
                                         dtype=dt)
        else:
            p["ssm"] = S.init_ssm(gen, cfg, device=dev, dtype=dt)
        if spec.ffn == "dense":
            p["norm2"] = torch.ones((cfg.d_model,), device=dev, dtype=dt)
            p["mlp"] = L.init_mlp(gen, cfg, device=dev, dtype=dt)
        elif spec.ffn == "moe":
            p["norm2"] = torch.ones((cfg.d_model,), device=dev, dtype=dt)
            p["moe"] = L.init_moe(gen, cfg, device=dev, dtype=dt)
        return p

    def init_params(self, gen: torch.Generator):
        """Random parameters with the reference's scales, drawn from
        ``gen`` (on its own device) and placed on the model's device. The
        tree has the reference's structure: ``blocks`` holds one dict per
        pattern position, each leaf with a leading repeat axis."""
        return self._params(gen, self.device)

    def param_specs(self):
        """The parameter tree as empty ``meta`` tensors of the reference's
        structure, shapes and the model's dtype, for the dry-run: nothing
        is allocated and nothing drawn, whatever the model's size and
        device."""
        return self._params(None, META)

    def _params(self, gen, dev: torch.device):
        cfg, dt = self.cfg, self.dtype
        blocks = tuple(
            _stack([self._init_layer(gen, spec, dev)
                    for _ in range(cfg.n_repeats)])
            for spec in cfg.pattern)
        return {
            "embed": L._normal(gen, (cfg.vocab, cfg.d_model), 0.02, dev, dt),
            "blocks": blocks,
            "final_norm": torch.ones((cfg.d_model,), device=dev, dtype=dt),
            "lm_head": L._normal(gen, (cfg.d_model, cfg.vocab),
                                 cfg.d_model ** -0.5, dev, dt),
        }

    # -- layer application ---------------------------------------------------

    def _ffn(self, x, lp, spec: LayerSpec):
        """The layer's feed-forward half: ``(x + ffn(norm(x)), aux)``, aux
        the MoE load-balance loss (None without an MoE)."""
        if spec.ffn == "dense":
            x = x + L.mlp(lp["mlp"], L.rmsnorm(x, lp["norm2"],
                                               self.cfg.norm_eps), self.cfg)
        elif spec.ffn == "moe":
            h = L.rmsnorm(x, lp["norm2"], self.cfg.norm_eps)
            B_, S_, D_ = h.shape
            y, aux = L.moe(lp["moe"], h.reshape(B_ * S_, D_), self.cfg,
                           n_groups=B_ if S_ > 1 else 1,
                           constrain=self.partitioner)
            return x + y.view(B_, S_, D_), aux
        return x, None

    def _apply_layer(self, x, lp, spec: LayerSpec, positions, image_embeds):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if spec.mixer == "attn":
            mix = L.attention(lp["attn"], h, cfg, positions)
        elif spec.mixer == "cross_attn":
            mix = L.attention(lp["attn"], h, cfg, positions, kv=image_embeds)
        else:
            mix, _ = S.ssm_block(lp["ssm"], h, cfg)
        return self._ffn(x + mix, lp, spec)

    def _positions(self, B: int, S_: int):
        return torch.arange(S_, device=self.device)[None].expand(B, S_)

    def _image(self, image_embeds):
        """Image embeddings, which must be in the model's dtype: one of
        another dtype is refused, as the reference refuses it (its bf16
        ``forward``, ``prefill`` and ``loss`` raise ``TypeError`` on an
        fp32 embedding). The caller casts."""
        if image_embeds is not None and image_embeds.dtype != self.dtype:
            raise ValueError(
                f"{self.cfg.name}: image embeddings are "
                f"{str(image_embeds.dtype).removeprefix('torch.')}, the "
                f"model is {str(self.dtype).removeprefix('torch.')}; cast "
                f"them to the model's dtype")
        return image_embeds

    def forward(self, params, tokens, image_embeds=None):
        """tokens: (B, S), image_embeds (B, n_image_tokens, D) for a model
        with cross-attention layers -> logits (B, S, V), aux_loss scalar
        (the MoE layers' summed; 0 without them). Layers run repeat-major,
        as the reference's ``forward`` scans. ``image_embeds`` must be in
        the model's dtype (:meth:`_image`)."""
        cfg = self.cfg
        B, S_ = tokens.shape
        image_embeds = self._image(image_embeds)
        x = self._wsc(params["embed"][tokens], "residual")
        positions = self._positions(B, S_)
        aux = torch.zeros((), device=self.device)
        # Each stacked leaf unbound once: under autograd one unbind's
        # backward stacks the repeats' gradients, where a select per repeat
        # would write a full-size zero gradient of the leaf for each.
        repeats = [_unbind(blk, cfg.n_repeats) for blk in params["blocks"]]

        def layer(x, aux, lp, spec):
            x, a = self._apply_layer(x, lp, spec, positions, image_embeds)
            return x, aux if a is None else aux + a

        def block(x, aux, lps):
            # one repeat: the MoE aux loss is carried through, as the
            # reference's scan carries it, never added outside a checkpoint
            for spec, lp in zip(cfg.pattern, lps):
                x, aux = (_checkpointed(layer, x, aux, lp, spec)
                          if self.layer_remat else layer(x, aux, lp, spec))
            return self._wsc(x, "residual"), aux

        for r in range(cfg.n_repeats):
            lps = [layers[r] for layers in repeats]
            x, aux = (_checkpointed(block, x, aux, lps) if self.remat
                      else block(x, aux, lps))
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return self._wsc(x @ params["lm_head"], "logits"), aux

    def loss(self, params, batch):
        """Mean next-token NLL over ``batch["labels"]`` under
        ``batch["loss_mask"]`` (all ones if absent) plus 0.01 x the MoE
        aux loss, as the reference's ``loss``. ``batch`` holds tensors on
        the model's device: ``tokens`` and ``labels`` (B, S) integer, and
        ``image_embeds`` for a model with cross-attention layers. The NLL
        is the logsumexp minus the gold logit, gathered (no (B, S, V)
        one-hot)."""
        logits, aux = self.forward(params, batch["tokens"],
                                   batch.get("image_embeds"))
        logits32 = self._wsc(logits.float(), "logits")
        lse = self._wsc(torch.logsumexp(logits32, dim=-1), "nll")
        # on vocab-sharded logits the gathered gold logit is a masked
        # partial sum: placed as the nll while it keeps its unit dim
        gold = self._wsc(L.gold_logit(logits32, batch["labels"]),
                         "nll")[..., 0]
        nll = lse - gold
        mask = batch.get("loss_mask")
        mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0) + 0.01 * aux

    # -- serving -------------------------------------------------------------

    def init_cache(self, batch: int, seq_len: int):
        """Zeroed decode caches of the model's dtype, one stacked entry per
        pattern position."""
        return self._caches(batch, seq_len, self.device)

    def cache_specs(self, batch: int, seq_len: int):
        """:meth:`init_cache`'s tree as empty ``meta`` tensors, for the
        dry-run: nothing is allocated."""
        return self._caches(batch, seq_len, META)

    def _caches(self, batch: int, seq_len: int, dev: torch.device):
        cfg, dt = self.cfg, self.dtype
        T = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
        R = cfg.n_repeats
        caches = []
        for spec in cfg.pattern:
            if spec.mixer in ("attn", "cross_attn"):
                rows = T if spec.mixer == "attn" else cfg.n_image_tokens
                shape = (R, batch, rows, cfg.n_kv_heads, cfg.d_head)
                caches.append({"k": torch.zeros(shape, device=dev, dtype=dt),
                               "v": torch.zeros(shape, device=dev, dtype=dt)})
            else:
                c = S.init_ssm_cache(cfg, batch, device=META)  # shapes
                caches.append({k: torch.zeros((R,) + tuple(a.shape),
                                              device=dev, dtype=dt)
                               for k, a in c.items()})
        return tuple(caches)

    def _decode_layer(self, x, lp, cache, spec: LayerSpec, pos):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if spec.mixer == "attn":
            mix, _ = L.attention_with_cache(lp["attn"], h, cfg, cache, pos)
        elif spec.mixer == "cross_attn":
            # the cross cache holds the projected image K/V: plain SDPA
            q = L._split_heads(h @ lp["attn"]["wq"], cfg.n_heads, cfg.d_head)
            mix = L._sdpa(q, cache["k"], cache["v"], None, h.dtype) \
                @ lp["attn"]["wo"]
        else:
            mix, new = S.ssm_decode(lp["ssm"], h, cfg, cache)
            for key, value in new.items():
                cache[key].copy_(value)
        return self._ffn(x + mix, lp, spec)[0]

    def decode_step(self, params, token, caches, pos):
        """token: (B,) int64; caches from init_cache/prefill, updated in
        place; pos: a scalar or a (B,) tensor of absolute positions.
        Returns (logits (B, V), caches). Pattern-major, as the reference's
        ``decode_step`` scans."""
        cfg = self.cfg
        x = params["embed"][token][:, None]            # (B, 1, D)
        for spec, blk, cache in zip(cfg.pattern, params["blocks"], caches):
            for r in range(cfg.n_repeats):
                x = self._decode_layer(
                    x, tree_map(lambda a: a[r], blk),
                    {k: v[r] for k, v in cache.items()}, spec, pos)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x[:, 0] @ params["lm_head"], caches

    def prefill(self, params, tokens, image_embeds=None, cache_len: int = 0):
        """Run the full prompt, returning (last-position logits, caches of
        capacity ``max(cache_len, S)`` for continued decoding; a cross
        layer's cache is the projected ``image_embeds``, which must be in the
        model's dtype). Pattern-major, as the reference's ``prefill``
        scans."""
        cfg = self.cfg
        B, S_ = tokens.shape
        image_embeds = self._image(image_embeds)
        pad = max(cache_len, S_) - S_
        x = self._wsc(params["embed"][tokens], "residual")
        positions = self._positions(B, S_)
        new_caches = []
        for spec, blk in zip(cfg.pattern, params["blocks"]):
            per_repeat = []
            for r in range(cfg.n_repeats):
                x, c = self._prefill_layer(x, tree_map(lambda a: a[r], blk),
                                           spec, positions, pad, image_embeds)
                x = self._wsc(x, "residual")
                per_repeat.append(c)
            new_caches.append(_stack(per_repeat))
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return x[:, -1] @ params["lm_head"], tuple(new_caches)

    def _prefill_layer(self, x, lp, spec: LayerSpec, positions, pad: int,
                       image_embeds):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["norm1"], cfg.norm_eps)
        if spec.mixer == "attn":
            mix, k, v = L.self_attention(lp["attn"], h, cfg, positions)
            if pad:
                k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            cache = {"k": k, "v": v}
        elif spec.mixer == "cross_attn":
            # no RoPE and no padding: the image rows are the whole cache
            mix, k, v = L.cross_attention(lp["attn"], h, cfg, image_embeds)
            cache = {"k": k, "v": v}
        else:
            mix, cache = S.ssm_block(lp["ssm"], h, cfg, return_cache=True)
        return self._ffn(x + mix, lp, spec)[0], cache
