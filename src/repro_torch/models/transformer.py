"""Decoder stacks: block init/apply/prefill/decode and the layer-stack layout.

Port of ``repro.models.transformer`` for every block kind: ``attn``,
``local_attn``, ``moe``, ``ssm`` and ``rglru``; and the port's own
``ssm_moe`` (Granite-4.0-H: a Mamba-2 mixer, then an MoE FFN), ``mla``
and ``mla_moe`` (DeepSeek-V3: latent attention, then a dense SwiGLU or an
MoE FFN), ``kda`` and ``kda_moe`` (Kimi Linear: Kimi Delta Attention,
then a dense SwiGLU or an MoE FFN), which train but do not serve.  Each
block's branches are scaled by ``cfg.residual_multiplier`` where it is not
1.  While the default registry records spans, each Mamba-2 mixer's, each
latent attention's, each KDA mixer's and each MoE FFN's forward pass is a
fenced ``ssm`` / ``mla`` / ``kda`` / ``moe`` span labelled with its
``layer`` (not the recomputation of a checkpointed block in the backward
pass).  The sigmoid router's selection bias (``route_bias``, one row a MoE
layer) is an argument of the stack, not a parameter, handed to every MoE
block (a softmax router takes no notice of it).

The stack layout is the reference's: a homogeneous stack deeper than one
layer (``_is_scannable``) keeps its layers' parameters and caches stacked
under ``scan`` with the layer axis leading, after ``layer_{i}`` entries for
any ``first_k_dense`` head (deepseek-moe's dense ``layer_0``); other stacks
(a hybrid ``block_pattern``, one layer) are ``layer_{i}`` throughout.  A
Python loop over the layer axis (views, no copies) replaces ``lax.scan``.
Decode caches (KV, SSM and RG-LRU states) are updated in place.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.core import telemetry as tele
from repro_torch.kernels import prf
from repro_torch.models import kda as K
from repro_torch.models import layers as L
from repro_torch.models import mla as A
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

_ATTN_KINDS = ("attn", "local_attn", "moe")
# block kinds that train but have no prefill or decode path
TRAIN_ONLY_KINDS = ("ssm_moe", "mla", "mla_moe", "kda", "kda_moe")
# each block kind's FFN after its mixer: a dense SwiGLU ("mlp"), an MoE
# ("moe": the kinds of ``moe.MOE_KINDS``) or none
FFN_KIND = {"attn": "mlp", "local_attn": "mlp", "rglru": "mlp", "mla": "mlp",
            "kda": "mlp", "ssm": None, **{k: "moe" for k in M.MOE_KINDS}}


def _window(cfg, kind: str):
    return cfg.attention_window \
        if (kind == "local_attn" or cfg.attention_window) else None


# ---------------------------------------------------------------------------
# Single blocks
# ---------------------------------------------------------------------------
def block_shapes(cfg, kind: str, lead=()) -> Dict:
    """The parameter tree of one block as ``torch.Size`` leaves; ``lead``
    prefixes every shape (the stacked layer axis)."""
    d = cfg.d_model
    if kind in ("attn", "local_attn"):
        return {"norm1": L.norm_shapes(cfg, d, lead),
                "attn": L.attention_shapes(cfg, lead),
                "norm2": L.norm_shapes(cfg, d, lead),
                "mlp": L.mlp_shapes(cfg, cfg.d_ff, lead)}
    if kind == "moe":
        return {"norm1": L.norm_shapes(cfg, d, lead),
                "attn": L.attention_shapes(cfg, lead),
                "norm2": L.norm_shapes(cfg, d, lead),
                "moe": M.moe_shapes(cfg, lead)}
    if kind == "ssm":
        return {"norm1": L.norm_shapes(cfg, d, lead),
                "mamba": S.mamba2_shapes(cfg, lead)}
    if kind == "ssm_moe":
        return {"norm1": L.norm_shapes(cfg, d, lead),
                "mamba": S.mamba2_shapes(cfg, lead),
                "norm2": L.norm_shapes(cfg, d, lead),
                "moe": M.moe_shapes(cfg, lead)}
    if kind == "rglru":
        return {"norm1": L.norm_shapes(cfg, d, lead),
                "rec": R.rglru_shapes(cfg, lead),
                "norm2": L.norm_shapes(cfg, d, lead),
                "mlp": L.mlp_shapes(cfg, cfg.d_ff, lead)}
    if kind in ("mla", "mla_moe", "kda", "kda_moe"):
        mixer = ({"attn": A.mla_shapes(cfg, lead)} if kind.startswith("mla")
                 else {"kda": K.kda_shapes(cfg, lead)})
        ffn = ({"moe": M.moe_shapes(cfg, lead)} if FFN_KIND[kind] == "moe"
               else {"mlp": L.mlp_shapes(cfg, cfg.d_ff, lead)})
        return {"norm1": L.norm_shapes(cfg, d, lead), **mixer,
                "norm2": L.norm_shapes(cfg, d, lead), **ffn}
    raise ValueError(kind)


def init_block(key, cfg, kind: str, device=None):
    """The reference's ``init_block``: ``split(key, 4)``; the first key
    draws the attention (or the Mamba-2 / RG-LRU mixer), the second the
    MLP (or the MoE); unit norm scales."""
    k1, k2, _, _ = prf.split(key, 4)
    d = cfg.d_model
    if kind in ("attn", "local_attn"):
        return {"norm1": L.init_norm(cfg, d, device),
                "attn": L.init_attention(k1, cfg, device),
                "norm2": L.init_norm(cfg, d, device),
                "mlp": L.init_mlp(k2, cfg, cfg.d_ff, device)}
    if kind == "moe":
        return {"norm1": L.init_norm(cfg, d, device),
                "attn": L.init_attention(k1, cfg, device),
                "norm2": L.init_norm(cfg, d, device),
                "moe": M.init_moe(k2, cfg, device)}
    if kind == "ssm":
        return {"norm1": L.init_norm(cfg, d, device),
                "mamba": S.init_mamba2(k1, cfg, device)}
    if kind == "ssm_moe":
        return {"norm1": L.init_norm(cfg, d, device),
                "mamba": S.init_mamba2(k1, cfg, device),
                "norm2": L.init_norm(cfg, d, device),
                "moe": M.init_moe(k2, cfg, device)}
    if kind == "rglru":
        return {"norm1": L.init_norm(cfg, d, device),
                "rec": R.init_rglru_block(k1, cfg, device),
                "norm2": L.init_norm(cfg, d, device),
                "mlp": L.init_mlp(k2, cfg, cfg.d_ff, device)}
    if kind in ("mla", "mla_moe", "kda", "kda_moe"):
        mixer = ({"attn": A.init_mla(k1, cfg, device)}
                 if kind.startswith("mla")
                 else {"kda": K.init_kda(k1, cfg, device)})
        ffn = ({"moe": M.init_moe(k2, cfg, device)} if FFN_KIND[kind] == "moe"
               else {"mlp": L.init_mlp(k2, cfg, cfg.d_ff, device)})
        return {"norm1": L.init_norm(cfg, d, device), **mixer,
                "norm2": L.init_norm(cfg, d, device), **ffn}
    raise ValueError(kind)


def _add(cfg, x, branch):
    """The residual add, the branch times ``cfg.residual_multiplier``."""
    r = cfg.residual_multiplier
    return x + branch if r == 1.0 else x + r * branch


def _forward_span(name: str, layer):
    """A fenced span of one layer's forward pass, while the default
    registry records spans, outside the backward pass."""
    tel = tele.get_default()
    if not tel.record_spans or torch._C._current_graph_task_id() != -1:
        return tele._NULL_SPAN
    return tel.span(name, layer=layer)


def _moe(cfg, p, x, use_ragged, layer, bias=None):
    with _forward_span("moe", layer) as sp:
        y, aux = M.apply_moe(cfg, p["moe"], L.apply_norm(cfg, p["norm2"], x),
                             use_ragged=use_ragged, bias=bias)
        sp.fence(y)
    return _add(cfg, x, y), aux


def _mla(cfg, p, x, positions, layer):
    with _forward_span("mla", layer) as sp:
        y = A.apply_mla(cfg, p["attn"], L.apply_norm(cfg, p["norm1"], x),
                        positions)
        sp.fence(y)
    return _add(cfg, x, y)


def _kda(cfg, p, x, layer):
    with _forward_span("kda", layer) as sp:
        y = K.apply_kda(cfg, p["kda"], L.apply_norm(cfg, p["norm1"], x))
        sp.fence(y)
    return _add(cfg, x, y)


def _mamba(cfg, p, x, layer):
    with _forward_span("ssm", layer) as sp:
        y = S.apply_mamba2(cfg, p["mamba"], L.apply_norm(cfg, p["norm1"], x))
        sp.fence(y)
    return _add(cfg, x, y)


def apply_block(cfg, p, x, positions, kind: str, *, use_ragged_moe=None,
                layer=None, route_bias=None):
    """(B,S,d) -> ((B,S,d), aux_loss); ``layer`` labels the spans;
    ``route_bias`` (E,) is an MoE block's selection bias."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _ATTN_KINDS:
        h = L.attention(cfg, p["attn"], L.apply_norm(cfg, p["norm1"], x),
                        positions, window=_window(cfg, kind))
        x = _add(cfg, x, h)
    elif kind in ("ssm", "ssm_moe"):
        x = _mamba(cfg, p, x, layer)
    elif kind == "rglru":
        x = _add(cfg, x, R.apply_rglru_block(
            cfg, p["rec"], L.apply_norm(cfg, p["norm1"], x)))
    elif kind in ("mla", "mla_moe"):
        x = _mla(cfg, p, x, positions, layer)
    elif kind in ("kda", "kda_moe"):
        x = _kda(cfg, p, x, layer)
    else:
        raise ValueError(kind)
    if FFN_KIND[kind] == "moe":
        x, aux = _moe(cfg, p, x, use_ragged_moe, layer, route_bias)
    elif FFN_KIND[kind] == "mlp":
        x = _add(cfg, x, L.apply_mlp(cfg, p["mlp"],
                                     L.apply_norm(cfg, p["norm2"], x)))
    return x, aux


def init_block_cache(cfg, kind: str, batch_size: int, max_len: int, dtype,
                     device=None):
    if kind in _ATTN_KINDS:
        return L.init_kv_cache(cfg, batch_size, max_len, dtype, device)
    if kind == "ssm":
        return S.init_mamba2_cache(cfg, batch_size, dtype, device)
    if kind == "rglru":
        return R.init_rglru_cache(cfg, batch_size, dtype, device)
    raise ValueError(kind)


def _fill(cache, new):
    """Copy a block's prefill state into its (preallocated) cache."""
    if cache is None:
        return new
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def prefill_block(cfg, p, x, positions, kind: str, batch_size: int,
                  max_len: int, dtype, *, cache=None):
    """apply_block that also fills a decode cache (``cache`` in place, else
    a new one).  Returns (x, cache)."""
    if kind in _ATTN_KINDS:
        h, (k, v) = L.attention(cfg, p["attn"],
                                L.apply_norm(cfg, p["norm1"], x), positions,
                                window=_window(cfg, kind), return_kv=True)
        x = _add(cfg, x, h)
        if cache is None:
            cache = L.init_kv_cache(cfg, batch_size, max_len, dtype,
                                    x.device)
        L.fill_kv_cache(cfg, cache, k, v, positions)
        del k, v
        if kind == "moe":
            y, _ = M.apply_moe(cfg, p["moe"],
                               L.apply_norm(cfg, p["norm2"], x))
            x = _add(cfg, x, y)
        else:
            x = _add(cfg, x, L.apply_mlp(cfg, p["mlp"],
                                         L.apply_norm(cfg, p["norm2"], x)))
    elif kind == "ssm":
        y, new = S.apply_mamba2(cfg, p["mamba"],
                                L.apply_norm(cfg, p["norm1"], x),
                                return_cache=True)
        x = _add(cfg, x, y)
        cache = _fill(cache, new)
    elif kind == "rglru":
        y, new = R.apply_rglru_block(cfg, p["rec"],
                                     L.apply_norm(cfg, p["norm1"], x),
                                     return_cache=True)
        x = _add(cfg, x, y)
        x = _add(cfg, x, L.apply_mlp(cfg, p["mlp"],
                                     L.apply_norm(cfg, p["norm2"], x)))
        cache = _fill(cache, new)
    else:
        raise ValueError(kind)
    return x, cache


def decode_block(cfg, p, x, cache, pos: int, kind: str):
    """x: (B,1,d) -> ((B,1,d), cache updated in place)."""
    if kind in _ATTN_KINDS:
        h, cache = L.attention_decode(cfg, p["attn"],
                                      L.apply_norm(cfg, p["norm1"], x),
                                      cache, pos, window=_window(cfg, kind))
        x = _add(cfg, x, h)
        if kind == "moe":
            y, _ = M.apply_moe(cfg, p["moe"],
                               L.apply_norm(cfg, p["norm2"], x))
            x = _add(cfg, x, y)
        else:
            x = _add(cfg, x, L.apply_mlp(cfg, p["mlp"],
                                         L.apply_norm(cfg, p["norm2"], x)))
    elif kind == "ssm":
        y, cache = S.decode_mamba2(cfg, p["mamba"],
                                   L.apply_norm(cfg, p["norm1"], x), cache)
        x = _add(cfg, x, y)
    elif kind == "rglru":
        y, cache = R.decode_rglru_block(cfg, p["rec"],
                                        L.apply_norm(cfg, p["norm1"], x),
                                        cache)
        x = _add(cfg, x, y)
        x = _add(cfg, x, L.apply_mlp(cfg, p["mlp"],
                                     L.apply_norm(cfg, p["norm2"], x)))
    else:
        raise ValueError(kind)
    return x, cache


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------
def _is_scannable(cfg) -> bool:
    kinds = cfg.layer_kinds
    tail = kinds[cfg.first_k_dense:]
    return cfg.block_pattern is None and len(set(tail)) == 1 and len(tail) > 1


def _layers(cfg, tree, *, unbind: bool = False) -> Iterator[Tuple[str, Dict]]:
    """(kind, one layer's subtree) in stack order; a stacked layer's leaves
    are views into the ``scan`` tensors.  ``unbind`` takes all of a scan
    leaf's layers in one ``unbind`` (whose gradient is one ``stack``, where
    per-layer indexing would add a full-size zero tensor per layer); it
    gives views that must not be written in place, so caches index."""
    kinds = cfg.layer_kinds
    if not _is_scannable(cfg):
        for i, kind in enumerate(kinds):
            yield kind, tree[f"layer_{i}"]
        return
    for i in range(cfg.first_k_dense):
        yield kinds[i], tree[f"layer_{i}"]
    n = cfg.num_layers - cfg.first_k_dense
    if unbind:
        paths, leaves = T.flatten(tree["scan"])
        per = [a.unbind(0) for a in leaves]
        for j in range(n):
            yield kinds[-1], T.unflatten(paths, [u[j] for u in per])
        return
    for j in range(n):
        yield kinds[-1], T.tree_map(lambda a: a[j], tree["scan"])


def _stack_tree(cfg, one) -> Dict:
    """{layer_i / scan: one(kind, lead)} in the stack's layout."""
    kinds = cfg.layer_kinds
    if not _is_scannable(cfg):
        return {f"layer_{i}": one(kind, ()) for i, kind in enumerate(kinds)}
    tree = {f"layer_{i}": one(kinds[i], ())
            for i in range(cfg.first_k_dense)}
    tree["scan"] = one(kinds[-1], (cfg.num_layers - cfg.first_k_dense,))
    return tree


def stack_shapes(cfg) -> Dict:
    return _stack_tree(cfg, lambda kind, lead: block_shapes(cfg, kind, lead))


def init_stack(key, cfg, device=None) -> Dict:
    """The reference's ``init_stack``: head layer ``i`` from ``fold_in(key,
    i)``; a scanned tail's layers from ``split(fold_in(key, 10_000),
    n_tail)`` (the reference ``vmap``s the block init over those keys),
    stacked one layer at a time."""
    kinds = cfg.layer_kinds
    if not _is_scannable(cfg):
        return {f"layer_{i}": init_block(prf.fold_in(key, i), cfg, kind,
                                         device)
                for i, kind in enumerate(kinds)}
    p = {f"layer_{i}": init_block(prf.fold_in(key, i), cfg, kinds[i], device)
         for i in range(cfg.first_k_dense)}
    n_tail = cfg.num_layers - cfg.first_k_dense
    p["scan"] = T.stacked(lambda k: init_block(k, cfg, kinds[-1], device),
                          prf.split(prf.fold_in(key, 10_000), n_tail))
    return p


def apply_stack(cfg, p, x, positions, *, use_ragged_moe: bool = False,
                route_bias=None):
    """The blocks in order.  With ``cfg.remat`` each block of a scanned
    tail (every block of an unscanned stack) is checkpointed, as the
    reference ``jax.checkpoint``s its scan body: its activations are
    recomputed in the backward pass instead of kept.  ``route_bias``
    (``moe.route_bias_shape``): row ``j`` is the ``j``-th MoE block's
    selection bias."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    head = cfg.first_k_dense if _is_scannable(cfg) else 0
    j = 0  # MoE blocks so far
    for i, (kind, lp) in enumerate(_layers(cfg, p, unbind=True)):
        bias = None
        if route_bias is not None and kind in M.MOE_KINDS:
            bias, j = route_bias[j], j + 1

        def block(h, lp=lp, kind=kind, i=i, bias=bias):
            return apply_block(cfg, lp, h, positions, kind,
                               use_ragged_moe=use_ragged_moe, layer=i,
                               route_bias=bias)
        if cfg.remat and i >= head:
            # the blocks draw no random numbers: no RNG state to replay
            x, aux = checkpoint(block, x, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = block(x)
        aux_total = aux_total + aux
    return x, aux_total


def init_stack_cache(cfg, batch_size: int, max_len: int,
                     dtype=torch.float32, device=None) -> Dict:
    def one(kind, lead):
        c = init_block_cache(cfg, kind, batch_size, max_len, dtype, device)
        if not lead:
            return c
        return {k: t.expand(lead + tuple(t.shape)).clone()
                for k, t in c.items()}
    return _stack_tree(cfg, one)


def prefill_stack(cfg, p, x, positions, max_len: int, dtype=torch.float32):
    """Run the stack over a prompt, returning (x, cache) for decode."""
    B = x.shape[0]
    cache = init_stack_cache(cfg, B, max_len, dtype, x.device)
    for (kind, lp), (_, lc) in zip(_layers(cfg, p), _layers(cfg, cache)):
        x, _ = prefill_block(cfg, lp, x, positions, kind, B, max_len, dtype,
                             cache=lc)
    return x, cache


def decode_stack(cfg, p, x, cache, pos: int):
    """One token through the stack; ``cache`` is updated in place and
    returned."""
    for (kind, lp), (_, lc) in zip(_layers(cfg, p), _layers(cfg, cache)):
        x, _ = decode_block(cfg, lp, x, lc, pos, kind)
    return x, cache
