"""The aggregation engine of the buffered-async server and the sync round
(port).

Port of the ``repro.core.fl.aggregation`` functions that ``AsyncServer``
and the synchronous round (``core/fl/round.py``) run: the tree-shaped
encode/mask/decode of the round (``encode_tree`` through
``kernels.secure_agg.quantize_mask``, ``decode_tree`` through
``dequantize``, ``privatize_contribution`` with its clip norm from
``kernels.dp_clip.sq_norms``, ``finalize_aggregate``), the flat batched
``aggregate_buffer``, the static :class:`AggregationSpec`, the pytree-native
:class:`ParamPlan` (model leaves grouped into flat chunks, each chunk its own
mask session and its own slice of the model-wide stochastic-rounding
stream), the per-session compression operators (``plan_operators``), the
streamed per-arrival encode (``encode_plan_flat``, uncompressed or onto the
compressed wire) with its modular-sum flush
(``aggregate_plan_masked_buffer``), the batched flush
(``aggregate_plan_buffer``), and the same protocol on one flat row
(``encode_contribution``, ``encode_masked_contribution`` through K1,
``aggregate_masked_buffer``).

The fused kernels of that path are called unconditionally —
``kernels.secure_agg.quantize_mask_prf`` for every uncompressed masked
streamed push, ``rotate_quantize_prf`` for every sketch push and
``weighted_quantize_accum`` for every batched flush — and the tensor's
device picks the implementation (plain PyTorch on the CPU, the Hopper kernel
on the card).  The streamed unmasked encode, the subsample encode and the
wire-width masks of a compressed push are plain PyTorch, as in the JAX
package.

Bit-exactness with the JAX package holds for every integer and every float
op here except two reductions: the whole-model squared norm is summed in
another order, and (with noise on) XLA adds the Gaussian draws
(``jax.random.normal``, rebuilt bit for bit by ``kernels.prf.normal``) as
one FMA where the port rounds the product first.  While no row is clipped and the noise is off the clip scale is
exactly 1.0 and the engines agree bit for bit.  Scalar divisions use 0-dim
tensors on the data's device (a CUDA division by a Python scalar is a
multiply by its reciprocal), except where the reference divides by a
compile-time constant inside ``jit``: XLA compiles that as a multiply by
the f32 reciprocal, and the port's decode does the same.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core.fl import compression as comp
from repro_torch.core.fl import dp
from repro_torch.core.fl import secure_agg as sa
from repro_torch.device import is_abstract
from repro_torch.kernels import dp_clip as kdp
from repro_torch.kernels import prf
from repro_torch.kernels import secure_agg as ksa


class AggregationSpec(NamedTuple):
    """Static description of one aggregation (see the JAX module)."""

    num_contributors: int
    clip_norm: float
    use_secure_agg: bool
    sa_scale: float
    dev_noise: float
    tee_noise: float
    mask_degree: int = 0
    random_graph: bool = False
    field_modulus: int = 1 << 32
    compression: comp.CompressionSpec = comp.CompressionSpec()


def fixed_point_scale(fl_cfg, num_contributors: int) -> float:
    """Fixed-point scale such that a full-aggregate sum cannot wrap int32."""
    levels = (2 ** (fl_cfg.secure_agg_bits - 1) - 1) / num_contributors - 1.0
    return max(levels, 1.0) / fl_cfg.secure_agg_range


def make_spec(fl_cfg, num_contributors: int) -> AggregationSpec:
    use_sa = fl_cfg.secure_agg_bits > 0
    degree = sa.effective_degree(
        num_contributors, getattr(fl_cfg, "secure_agg_degree", 0))
    return AggregationSpec(
        num_contributors=num_contributors,
        clip_norm=fl_cfg.clip_norm,
        use_secure_agg=use_sa,
        sa_scale=fixed_point_scale(fl_cfg, num_contributors) if use_sa else 1.0,
        dev_noise=dp.noise_stddev(fl_cfg, num_contributors, "device")
        if fl_cfg.noise_placement == "device" else 0.0,
        tee_noise=dp.noise_stddev(fl_cfg, num_contributors, "tee")
        if fl_cfg.noise_placement == "tee" else 0.0,
        mask_degree=degree,
        random_graph=(degree > 0
                      and not getattr(fl_cfg, "secure_agg_circulant", False)),
        field_modulus=sa.field_modulus(fl_cfg.secure_agg_bits,
                                       num_contributors)
        if use_sa else 1 << 32,
        compression=comp.CompressionSpec(
            mode=getattr(fl_cfg, "compress_mode", "none"),
            rate=getattr(fl_cfg, "compress_rate", 1.0)),
    )


def make_mask_session(spec: AggregationSpec, key, *,
                      num_slots: Optional[int] = None,
                      slot_offset: int = 0) -> Optional[sa.MaskSession]:
    """The :class:`secure_agg.MaskSession` of one aggregation, or None."""
    if key is None:
        return None
    n = spec.num_contributors if num_slots is None else num_slots
    return sa.make_session(key, n, degree=spec.mask_degree,
                           random_graph=spec.random_graph,
                           slot_offset=slot_offset,
                           modulus=spec.field_modulus)


def kernel_session(session: sa.MaskSession, device=None) -> ksa.SessionMeta:
    """The kernels' ``SessionMeta`` view of a protocol-layer session."""
    return ksa.SessionMeta(
        key_words=session.key_words(), num_slots=session.num_slots,
        degree=session.degree, slot_offset=session.slot_offset,
        neighbors=session.neighbor_table(device=device))


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


clip_scales = kdp.clip_scales


def add_mod32_(acc: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``acc += q`` mod 2^32 in place on int32 tensors of one shape, in
    tiles (int64 words, so no tile needs more than a few of ``TILE``)."""
    a, b = acc.view(-1), q.reshape(-1)
    for s in range(0, a.numel(), prf.TILE):
        t = slice(s, s + prf.TILE)
        a[t] = prf.to_int32(prf.words_of(a[t]) + prf.words_of(b[t]))
    return acc


# ---------------------------------------------------------------------------
# Fixed-point secure-aggregation encode / decode (tree- and array-shaped)
# ---------------------------------------------------------------------------
def encode_array(x: torch.Tensor, scale: float, rng) -> torch.Tensor:
    """Stochastic-rounding fixed-point encode of one tensor to int32, with
    the reference's ``jax.random.uniform(rng, x.shape)`` draw, through
    ``kernels.secure_agg.quantize_mask`` (no clip: ``value_range=inf``)."""
    u = prf.uniform(rng, x.numel(), device=x.device)
    q = ksa.quantize_mask(x.reshape(-1).to(torch.float32).contiguous(), None,
                          u, scale, math.inf)
    return q.reshape(x.shape)


def encode_tree(tree, scale: float, rng):
    """Per-leaf :func:`encode_array`, leaf ``i`` keyed ``split(rng)[i]``."""
    paths, leaves = T.flatten(tree)
    keys = prf.split(rng, len(leaves))
    return T.unflatten(paths, [encode_array(x, scale, k)
                               for x, k in zip(leaves, keys)])


def decode_tree(tree, scale: float):
    """``q / scale`` per leaf through ``kernels.secure_agg.dequantize``,
    with the jitted reference's multiplier ``f32(1) / f32(scale)``."""
    inv = ksa.jit_inverse(scale)
    return T.tree_map(
        lambda q: ksa.dequantize(q.reshape(-1).contiguous(), inv)
        .reshape(q.shape), tree)


def mask_tree(tree, slot: int, session: sa.MaskSession):
    """Session masks shaped like ``tree`` for one slot: leaf ``i`` draws its
    pairwise streams under ``fold_in(session.key, i)``."""
    paths, leaves = T.flatten(tree)
    return T.unflatten(paths, [
        sa.session_mask(x.shape, slot, session.num_slots,
                        prf.fold_in(session.key, i), session.degree,
                        session.perm, device=x.device)
        for i, x in enumerate(leaves)])


def client_sq_norms(stacked: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whole-model squared norms of ``C`` stacked contributions (leaves in
    flatten order, each ``(C, ...)``): one ``kernels.dp_clip.sq_norms``
    launch per leaf over its ``(C, leaf)`` rows, the leaf partials added in
    flatten order (``dp.global_norm``'s left fold)."""
    sq = None
    for x in stacked:
        part = kdp.sq_norms(x.reshape(x.shape[0], -1).to(torch.float32)
                            .contiguous())
        sq = part if sq is None else sq + part
    return sq


def privatize_contribution(delta, spec: "AggregationSpec", rng) -> Tuple:
    """Clip one contribution by its whole-model norm (+ local noise under
    ``device`` placement).  Returns (delta, pre_clip_norm, was_clipped)."""
    nrm = prf.sqrt_f32(client_sq_norms(
        [x.reshape(1, -1) for x in T.leaves(delta)])[0])
    scale = clip_scales(nrm, spec.clip_norm)
    delta = T.tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                       delta)
    if spec.dev_noise > 0.0:
        delta = dp.add_noise(delta, prf.fold_in(rng, 1), spec.dev_noise)
    return delta, nrm, scale < 1.0


def accumulator_dtype(spec: "AggregationSpec"):
    return torch.int32 if spec.use_secure_agg else torch.float32


def zero_accumulator(params, spec: "AggregationSpec",
                     leading: Tuple[int, ...] = ()):
    """A zeroed aggregation accumulator shaped like ``params`` (+ leading)."""
    dt = accumulator_dtype(spec)
    return T.tree_map(lambda x: torch.zeros(tuple(leading) + tuple(x.shape),
                                            dtype=dt, device=x.device),
                      params)


def _host_float(w: torch.Tensor) -> float:
    """``float(w)``; an abstract ``w`` (the cost harness) has no value to
    read, and the noise's scale does not change its cost: 1.0."""
    return 1.0 if is_abstract(w) else float(w)


def finalize_aggregate(acc, total_weight, spec: "AggregationSpec", rng):
    """Decode the summed accumulator tree into the noised mean delta; the
    TEE draw (``tee`` placement) is rescaled to the effective weight."""
    leaf = T.leaves(acc)[0]
    w = torch.clamp(torch.as_tensor(total_weight, dtype=torch.float32,
                                    device=leaf.device), min=1e-9)
    agg = decode_tree(acc, spec.sa_scale) if spec.use_secure_agg else acc
    mean = T.tree_map(lambda a: a / w, agg)
    if spec.tee_noise > 0.0:
        mean = dp.add_noise(mean, rng, spec.tee_noise * spec.num_contributors
                            / _host_float(w))
    return mean


def sum_rows(rows: torch.Tensor, gate: Optional[Sequence[bool]] = None
             ) -> torch.Tensor:
    """Modular (mod 2^32) sum of int32 rows, optionally gated -> int32.

    Accumulated row by row in int64, so a (B, D) buffer never gets a
    (B, D) int64 copy."""
    acc = torch.zeros(rows.shape[1:], dtype=torch.int64, device=rows.device)
    for b in range(rows.shape[0]):
        if gate is None or gate[b]:
            acc += rows[b]
    return prf.to_int32(acc)


# ---------------------------------------------------------------------------
# ParamPlan — the pytree-native chunk layout
# ---------------------------------------------------------------------------
CHUNK_SESSION_TAG = 0xC401
DEFAULT_CHUNK_BLOCK = 512


class ChunkSpec(NamedTuple):
    """One flat chunk of a :class:`ParamPlan` — consecutive WHOLE leaves."""

    leaf_lo: int
    leaf_hi: int
    size: int
    padded: int
    offset: int


@dataclasses.dataclass(frozen=True)
class ParamPlan:
    """Static layout of a model tree over flat aggregation chunks.

    ``paths`` are the leaf paths in JAX's flatten order (sorted dict keys);
    see the JAX class for the contract.
    """

    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    chunks: Tuple[ChunkSpec, ...]

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def total(self) -> int:
        return sum(c.size for c in self.chunks)

    @property
    def chunk_widths(self) -> Tuple[int, ...]:
        """Per-chunk storage widths (padded)."""
        return tuple(c.padded for c in self.chunks)

    @property
    def leaf_sizes(self) -> Tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)

    def leaves_of(self, tree) -> list:
        """Flatten ``tree`` and check it has the plan's structure."""
        paths, leaves = T.flatten(tree)
        if tuple(paths) != self.paths:
            raise ValueError(
                f"tree structure does not match the ParamPlan: got "
                f"{paths}, plan was built for {list(self.paths)}")
        return leaves

    def chunk_arrays(self, tree, *, leading: int = 0,
                     pad: bool = False) -> Tuple[torch.Tensor, ...]:
        """``tree`` -> tuple of per-chunk flat f32 tensors."""
        leaves = self.leaves_of(tree)
        out = []
        for ck in self.chunks:
            segs = [leaves[i].reshape(tuple(leaves[i].shape[:leading]) + (-1,))
                    .to(torch.float32) for i in range(ck.leaf_lo, ck.leaf_hi)]
            arr = segs[0] if len(segs) == 1 else torch.cat(segs, dim=-1)
            if pad and ck.padded > ck.size:
                arr = torch.nn.functional.pad(arr, (0, ck.padded - ck.size))
            out.append(arr)
        return tuple(out)

    def unchunk(self, chunk_arrays: Sequence[torch.Tensor]):
        """Per-chunk flat tensors (padded or not) -> the model tree."""
        sizes = self.leaf_sizes
        leaves = []
        for ck, arr in zip(self.chunks, chunk_arrays):
            off = 0
            for i in range(ck.leaf_lo, ck.leaf_hi):
                leaves.append(arr[off:off + sizes[i]].reshape(self.shapes[i]))
                off += sizes[i]
        return T.unflatten(self.paths, leaves)

    def session_keys(self, key) -> Tuple:
        """Per-chunk mask-session keys (single chunk: the key verbatim)."""
        if self.num_chunks == 1:
            return (prf.key_words(key),)
        base = prf.fold_in(key, CHUNK_SESSION_TAG)
        return tuple(prf.fold_in(base, c) for c in range(self.num_chunks))

    def chunk_noise_key(self, rng, c: int):
        k = prf.fold_in(rng, 1)
        return k if self.num_chunks == 1 else prf.fold_in(k, c)


def make_param_plan(params, *, chunk_elems: int = 0,
                    block: int = DEFAULT_CHUNK_BLOCK) -> ParamPlan:
    """Build the chunk layout of a model tree (greedy whole-leaf groups)."""
    paths, leaves = T.flatten(params)
    if not leaves:
        raise ValueError("cannot build a ParamPlan for an empty tree")
    shapes = tuple(tuple(int(d) for d in x.shape) for x in leaves)
    dtypes = tuple(str(x.dtype).replace("torch.", "") for x in leaves)
    sizes = [math.prod(s) for s in shapes]
    if chunk_elems <= 0:
        groups = [(0, len(leaves))]
    else:
        groups, lo, cur = [], 0, 0
        for i, sz in enumerate(sizes):
            if cur > 0 and cur + sz > chunk_elems:
                groups.append((lo, i))
                lo, cur = i, 0
            cur += sz
        groups.append((lo, len(leaves)))
    multi = len(groups) > 1
    chunks, off = [], 0
    for (g_lo, g_hi) in groups:
        size = sum(sizes[g_lo:g_hi])
        padded = -(-size // block) * block if multi else size
        chunks.append(ChunkSpec(g_lo, g_hi, size, padded, off))
        off += size
    return ParamPlan(paths=tuple(paths), shapes=shapes, dtypes=dtypes,
                     chunks=tuple(chunks))


def plan_for(params, fl_cfg) -> ParamPlan:
    return make_param_plan(
        params, chunk_elems=getattr(fl_cfg, "param_chunk_elems", 0))


def plan_sq_norms(plan: ParamPlan,
                  chunk_arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Whole-model squared L2 norms: the left fold over leaf segments.

    Arrays may carry one leading batch axis; each row is summed on its own
    (so a batched row and a streamed row of the same delta fold the same
    way, and no (B, D) temporary is formed).
    """
    sizes = plan.leaf_sizes
    first = chunk_arrays[0]
    lead = tuple(first.shape[:-1])
    sq = torch.zeros(lead, dtype=torch.float32, device=first.device)
    for ck, arr in zip(plan.chunks, chunk_arrays):
        x = arr.to(torch.float32)
        off = 0
        for i in range(ck.leaf_lo, ck.leaf_hi):
            seg = x[..., off:off + sizes[i]]
            if lead:
                part = torch.stack([torch.sum(r * r) for r in seg])
            else:
                part = torch.sum(seg * seg)
            sq = sq + part
            off += sizes[i]
    return sq


def plan_mask_tree(tree, slot: int, plan: ParamPlan, sessions):
    """Plan form of :func:`mask_tree`: leaf ``i`` of chunk ``c`` draws under
    chunk ``c``'s session key folded by its chunk-LOCAL leaf index."""
    return T.unflatten(plan.paths, [
        plan_leaf_mask(plan, sessions, i, slot, x.shape, x.device)
        for i, x in enumerate(plan.leaves_of(tree))])


def plan_leaf_mask(plan: ParamPlan, sessions, i: int, slot: int, shape,
                   device=None) -> torch.Tensor:
    """Leaf ``i``'s mask of :func:`plan_mask_tree` alone."""
    for c, ck in enumerate(plan.chunks):
        if ck.leaf_lo <= i < ck.leaf_hi:
            s = sessions[c]
            return sa.session_mask(shape, slot, s.num_slots,
                                   prf.fold_in(s.key, i - ck.leaf_lo),
                                   s.degree, s.perm, device=device)
    raise IndexError(f"leaf {i} outside the plan")


def plan_sessions(spec: AggregationSpec, plan: ParamPlan, key, *,
                  num_slots: Optional[int] = None, slot_offset: int = 0):
    """One :class:`secure_agg.MaskSession` per chunk (or None if no key)."""
    if key is None:
        return None
    return tuple(make_mask_session(spec, k, num_slots=num_slots,
                                   slot_offset=slot_offset)
                 for k in plan.session_keys(key))


def plan_wire_chunks(spec: AggregationSpec, plan: ParamPlan):
    return comp.wire_chunks(spec.compression, plan.chunks)


def plan_operators(spec: AggregationSpec, plan: ParamPlan, session_key, *,
                   device=None):
    """Per-chunk compression operators on ``device``, or None (identity).

    Chunk c's operator key is ``fold_in(session_keys[c], COMPRESSION_TAG)``:
    it depends on the session key alone, so the engine derives the
    operators once per session and shares them between push and flush.
    """
    c = spec.compression
    if c.identity:
        return None
    return tuple(
        comp.chunk_operators(prf.fold_in(k, comp.COMPRESSION_TAG), c.mode,
                             ck.size, c.rate, device=device)
        for k, ck in zip(plan.session_keys(session_key), plan.chunks))


# ---------------------------------------------------------------------------
# Streamed per-arrival encode and its flush
# ---------------------------------------------------------------------------
def encode_plan_flat(xs: Sequence[torch.Tensor], weight, slot: int,
                     spec: AggregationSpec, plan: ParamPlan, sessions, rng, *,
                     masked: bool = True, ops=None):
    """The streamed per-arrival encode on pre-chunked flat tensors.

    One GLOBAL clip scale from the whole-model norm, the
    ``fold_in(rng, 2)`` TAG_UNIFORM stream at each chunk's global offset,
    and (``masked``) each chunk's pairwise mask under its own session —
    fused in ``kernels.secure_agg.quantize_mask_prf``.

    ``ops`` (from :func:`plan_operators`) puts the chunks on the COMPRESSED
    wire: quantize in the operator domain (the sketch through
    ``rotate_quantize_prf``; uniform positions are operator-domain indices
    at the chunk's global offset), keep the ``op.idx`` coordinates, then
    mask at the wire width.  Returns (tuple of PADDED (wire padded_c,)
    int32 rows, pre-clip norm, was_clipped).
    """
    dev = xs[0].device
    nrm = prf.sqrt_f32(plan_sq_norms(plan, xs))
    clip_scale = clip_scales(nrm, spec.clip_norm)
    weight = torch.as_tensor(weight, dtype=torch.float32, device=dev)
    u_words = prf.fold_in(rng, 2)
    wire = plan_wire_chunks(spec, plan) if ops is not None else None
    rows = []
    for c, (ck, x) in enumerate(zip(plan.chunks, xs)):
        xw = _weight_noise(x, weight, clip_scale, spec,
                           plan.chunk_noise_key(rng, c))
        if ops is not None:
            rows.append(_encode_compressed(xw, ck, ops[c], wire[c], slot,
                                           spec, sessions, c, u_words,
                                           masked))
            continue
        if masked:
            row = ksa.quantize_mask_prf(
                xw, spec.sa_scale, slot, u_words,
                kernel_session(sessions[c], dev), u_offset=ck.offset)
        else:
            row = _stream_quantize(xw, spec.sa_scale, rng, offset=ck.offset)
        if ck.padded > ck.size:
            row = torch.nn.functional.pad(row, (0, ck.padded - ck.size))
        rows.append(row)
    return tuple(rows), nrm, (clip_scale < 1.0).to(torch.float32)


def _weight_noise(x: torch.Tensor, weight: torch.Tensor,
                  clip_scale: torch.Tensor, spec: AggregationSpec,
                  noise_key) -> torch.Tensor:
    """The pre-encode prologue of one flat delta, given its clip scale:
    ``x * (weight * clip_scale)`` plus, under device placement, the
    reference's ``normal(noise_key)`` draw times ``dev_noise * weight``.
    Shared by the streamed encodes, so their arithmetic cannot fork."""
    xw = x * (weight * clip_scale)
    if spec.dev_noise > 0.0:
        noise = prf.normal(noise_key, x.shape, device=x.device)
        xw = xw + noise * (spec.dev_noise * weight)
    return xw


def _stream_quantize(xw: torch.Tensor, sa_scale: float, rng, *,
                     offset: int = 0) -> torch.Tensor:
    """Stochastic fixed-point encode of a flat row against the
    ``fold_in(rng, 2)`` TAG_UNIFORM stream at positions ``offset + e``: the
    plain form of K1's encode, bit for bit."""
    u = prf.uniform_block(*prf.fold_in(rng, 2), xw.shape[0], offset=offset,
                          device=xw.device)
    return ksa.stochastic_round(xw * sa_scale, u)


def _clip_weight_noise(x: torch.Tensor, weight, spec: AggregationSpec, rng):
    """Clip one flat delta by its L2 norm, weight it, add device noise
    (``fold_in(rng, 1)``).  Returns (xw f32, pre-clip norm, was_clipped)."""
    x = x.to(torch.float32)
    nrm = prf.sqrt_f32(torch.sum(x * x))
    clip_scale = clip_scales(nrm, spec.clip_norm)
    weight = torch.as_tensor(weight, dtype=torch.float32, device=x.device)
    xw = _weight_noise(x, weight, clip_scale, spec, prf.fold_in(rng, 1))
    return xw, nrm, (clip_scale < 1.0).to(torch.float32)


def encode_contribution(x: torch.Tensor, weight, spec: AggregationSpec, rng):
    """The unmasked streamed encode of one flat delta: clip -> weight ->
    [device noise] -> stochastic fixed-point encode.  Returns (int32 (D,),
    pre-clip norm, was_clipped)."""
    xw, nrm, was_clipped = _clip_weight_noise(x, weight, spec, rng)
    return _stream_quantize(xw, spec.sa_scale, rng), nrm, was_clipped


def encode_masked_contribution(x: torch.Tensor, weight, slot: int,
                               spec: AggregationSpec,
                               session: sa.MaskSession, rng, *,
                               use_kernel: bool = True):
    """The client side of the masked protocol on one flat delta: the
    :func:`encode_contribution` pipeline plus the pairwise mask of ``slot``
    (an absolute position) in ``session``, wrapping mod 2^32.

    The encode and mask run fused in ``kernels.secure_agg.quantize_mask_prf``
    (K1); ``use_kernel=False`` computes them apart (``_stream_quantize``
    plus ``session.mask``), as the reference's host path does: both give
    the same bits.  Returns (masked int32 (D,), pre-clip norm,
    was_clipped)."""
    xw, nrm, was_clipped = _clip_weight_noise(x, weight, spec, rng)
    if use_kernel:
        masked = ksa.quantize_mask_prf(
            xw, spec.sa_scale, slot, prf.fold_in(rng, 2),
            kernel_session(session, xw.device))
    else:
        q = _stream_quantize(xw, spec.sa_scale, rng)
        m = session.mask(xw.shape, slot, device=xw.device)
        masked = prf.to_int32(prf.words_of(q) + prf.words_of(m))
    return masked, nrm, was_clipped


def aggregate_masked_buffer(mbuf: torch.Tensor, present, total_weight,
                            spec: AggregationSpec,
                            session: Optional[sa.MaskSession], rng, *,
                            recover: bool = True, masked: bool = True):
    """The server side of the masked protocol on a (B, D) int32 buffer:
    modular sum + decode.

    With ``recover`` the absent slots (``present``, one host flag per row)
    are gated out and, when ``masked``, the session's recovery sweep
    re-adds their uncancelled mask shares, so the decode is the survivors'
    exact sum; without it the session is known complete and the masks
    cancel in the plain sum.  ``masked=False`` is a buffer of unmasked
    :func:`encode_contribution` rows (no shares to recover).  Returns the
    weight-normalized mean delta (D,), TEE noise under
    ``fold_in(rng, 0xDEE)``."""
    B, D = mbuf.shape
    if recover:
        pres = sa.present_flags(present)
        acc = sum_rows(mbuf, [p == 1 for p in pres])
        if masked:
            rec = session.recovery((D,), pres, device=mbuf.device)
            acc = prf.to_int32(prf.words_of(acc) + prf.words_of(rec))
    else:
        acc = sum_rows(mbuf)
    return finalize_aggregate(acc, total_weight, spec,
                              prf.fold_in(rng, 0xDEE))


def _encode_compressed(xw: torch.Tensor, ck: ChunkSpec, op: comp.ChunkOps,
                       wc: comp.WireChunk, slot: int, spec: AggregationSpec,
                       sessions, c: int, u_words, masked: bool):
    """One chunk onto the compressed wire: (wc.padded,) int32."""
    dev = xw.device
    if op.mode == "sketch":
        q_full = ksa.rotate_quantize_prf(xw.contiguous(), spec.sa_scale,
                                         op.key_words, u_words,
                                         u_offset=ck.offset)
    else:
        u = prf.uniform_block(*u_words, op.full, offset=ck.offset, device=dev)
        q_full = ksa.stochastic_round(xw * spec.sa_scale, u)
    row = q_full.index_select(0, op.idx)
    del q_full
    if masked:
        m = sessions[c].mask((wc.size,), slot, device=dev)
        row = prf.to_int32(prf.words_of(row) + prf.words_of(m))
    if wc.padded > wc.size:
        row = torch.nn.functional.pad(row, (0, wc.padded - wc.size))
    return row


def encode_plan_contribution(delta, weight, slot: int, spec: AggregationSpec,
                             plan: ParamPlan, sessions, rng, *,
                             masked: bool = True, ops=None):
    """Tree form of :func:`encode_plan_flat` — the client-side encode."""
    return encode_plan_flat(plan.chunk_arrays(delta), weight, slot, spec,
                            plan, sessions, rng, masked=masked, ops=ops)


def aggregate_plan_masked_buffer(bufs: Sequence[torch.Tensor], present,
                                 total_weight, spec: AggregationSpec,
                                 plan: ParamPlan, sessions, rng, *,
                                 recover: bool = True, masked: bool = True,
                                 ops=None):
    """Modular sum of the streamed int32 rows + dropout recovery + decode.

    ``present`` is host metadata (one flag per slot).  With ``recover``,
    absent rows are gated out and (``masked``) each chunk's recovery sweep
    re-adds the absent slots' mask shares at the unpadded WIRE width;
    without it the session is known complete and the masks cancel in the
    plain sum.  ``ops`` decodes operator-domain (compressed) buffers.
    """
    pres = sa.present_flags(present)
    wire = plan_wire_chunks(spec, plan)
    accs = []
    for c, (wc, mbuf) in enumerate(zip(wire, bufs)):
        if recover:
            acc = sum_rows(mbuf, [p == 1 for p in pres])
            if masked:
                rec = sessions[c].recovery((wc.size,), pres,
                                           device=mbuf.device)
                if wc.padded > wc.size:
                    rec = torch.nn.functional.pad(rec, (0, wc.padded - wc.size))
                acc = prf.to_int32(prf.words_of(acc) + prf.words_of(rec))
        else:
            acc = sum_rows(mbuf)
        accs.append(acc)
    return finalize_plan_aggregate(accs, total_weight, spec, plan,
                                   prf.fold_in(rng, 0xDEE), ops=ops)


# ---------------------------------------------------------------------------
# Batched flush (mask_mode "tee" and the unstreamed "off" engine)
# ---------------------------------------------------------------------------
def row_uniform_keys(rng, B: int):
    """Per-row key words of the batched TAG_UNIFORM stream: one Threefry of
    the row index under ``fold_in(rng, 2)``."""
    u0, u1 = prf.fold_in(rng, 2)
    return prf.threefry2x32(u0, u1, torch.arange(B, dtype=torch.int64), 0)


def plan_buffer_noise_and_uniforms(rng, B: int, spec: AggregationSpec,
                                   plan: ParamPlan, device=None):
    """Per-chunk tuples of the batched flush's stochastic draws.

    Uniforms: the per-row counter streams at each chunk's global offset
    (bit-identical to the JAX draw).  Device noise: the reference's
    ``normal(chunk_noise_key(rng, c), (B, size))`` (bit-equal); padded tails
    get zero noise.
    """
    noise = None
    if spec.dev_noise > 0.0:
        noise = []
        for c, ck in enumerate(plan.chunks):
            n = prf.normal(plan.chunk_noise_key(rng, c), (B, ck.size),
                           device=device)
            if ck.padded > ck.size:
                n = torch.nn.functional.pad(n, (0, ck.padded - ck.size))
            noise.append(n)
        noise = tuple(noise)
    uniforms = None
    if spec.use_secure_agg:
        r0, r1 = row_uniform_keys(rng, B)
        uniforms = tuple(prf.uniform_block(r0, r1, ck.padded,
                                           offset=ck.offset, device=device)
                         for ck in plan.chunks)
    return noise, uniforms


def encode_and_sum_rows(buf: torch.Tensor, weights: torch.Tensor, uniforms,
                        noise, spec: AggregationSpec, *,
                        session: Optional[sa.MaskSession] = None,
                        row_sq: Optional[torch.Tensor] = None):
    """Clip/weight/[noise]/encode[+mask] a block of rows and modular-sum it.

    The secure-agg lane is ``kernels.secure_agg.weighted_quantize_accum``
    (with the session's in-kernel PRF masks when ``session`` is given).
    Returns (acc (D,) int32|f32, pre-clip norms (B,), was_clipped (B,)).
    """
    if session is not None and not spec.use_secure_agg:
        raise ValueError("pairwise masks require the secure-agg integer field "
                         "(spec.use_secure_agg)")
    B, D = buf.shape
    if row_sq is None:
        row_sq = kdp.sq_norms(buf.to(torch.float32).contiguous())
    nrm = prf.sqrt_f32(row_sq)
    clip_scale = clip_scales(nrm, spec.clip_norm)
    was_clipped = (clip_scale < 1.0).to(torch.float32)
    row_w = weights * clip_scale
    if spec.use_secure_agg:
        if noise is None:
            qx, qw = buf.to(torch.float32), row_w
        else:
            qx = buf.to(torch.float32) * row_w[:, None] + noise
            qw = torch.ones((B,), dtype=torch.float32, device=buf.device)
        acc = ksa.weighted_quantize_accum(
            qx.contiguous(), qw.contiguous(), uniforms, spec.sa_scale,
            session=None if session is None
            else kernel_session(session, buf.device))
    else:
        x = buf.to(torch.float32) * row_w[:, None]
        if noise is not None:
            x = x + noise
        acc = x.sum(0)
    return acc, nrm, was_clipped


def buffer_noise_and_uniforms(rng, B: int, D: int, spec: AggregationSpec,
                              device=None):
    """The flat batched aggregation's draws: ``jax.random.normal(
    fold_in(rng, 1), (B, D))`` device noise and the per-row TAG_UNIFORM
    streams (both bit-equal)."""
    noise = (prf.normal(prf.fold_in(rng, 1), (B, D), device=device)
             if spec.dev_noise > 0.0 else None)
    uniforms = None
    if spec.use_secure_agg:
        r0, r1 = row_uniform_keys(rng, B)
        uniforms = prf.uniform_block(r0, r1, D, device=device)
    return noise, uniforms


def aggregate_buffer(buf: torch.Tensor, weights: torch.Tensor,
                     spec: AggregationSpec, rng, *,
                     session: Optional[sa.MaskSession] = None):
    """One batched aggregation of a flat (B, D) contribution buffer: the
    row norms through ``kernels.dp_clip.sq_norms``, the clip, weight and
    encode (+ the session's masks) through ``weighted_quantize_accum``,
    then decode and the TEE draw.  Returns (mean (D,), stats)."""
    B, D = buf.shape
    noise, uniforms = buffer_noise_and_uniforms(rng, B, D, spec, buf.device)
    if noise is not None:
        noise = noise * (spec.dev_noise * weights)[:, None]
    acc, nrm, was_clipped = encode_and_sum_rows(
        buf, weights, uniforms, noise, spec, session=session)
    w_total = weights.sum()
    mean = finalize_aggregate(acc, w_total, spec, prf.fold_in(rng, 0xDEE))
    denom = torch.clamp(w_total, min=1e-9)
    stats = {
        "update_norm": (nrm * weights).sum() / denom,
        "clip_fraction": (was_clipped * weights).sum() / denom,
        "weight_total": w_total,
    }
    return mean, stats


def encode_plan_rows(bufs: Sequence[torch.Tensor], weights: torch.Tensor,
                     uniforms, noise, spec: AggregationSpec, plan: ParamPlan,
                     *, sessions=None, row_sq=None):
    """Per-chunk :func:`encode_and_sum_rows`, every chunk clipped by the
    whole-model row norms.  Returns (per-chunk accumulators, norms (B,),
    was_clipped (B,))."""
    if row_sq is None:
        row_sq = plan_sq_norms(plan, bufs)
    accs, nrm, was_clipped = [], None, None
    for c in range(plan.num_chunks):
        acc, nrm, was_clipped = encode_and_sum_rows(
            bufs[c], weights, None if uniforms is None else uniforms[c],
            None if noise is None else noise[c], spec,
            session=None if sessions is None else sessions[c], row_sq=row_sq)
        accs.append(acc)
    return tuple(accs), nrm, was_clipped


def aggregate_plan_buffer(bufs: Sequence[torch.Tensor], weights: torch.Tensor,
                          spec: AggregationSpec, plan: ParamPlan, rng, *,
                          sessions=None):
    """The batched tee/off flush over per-chunk (B, padded_c) f32 buffers.

    Returns (mean tree, stats)."""
    B = bufs[0].shape[0]
    noise, uniforms = plan_buffer_noise_and_uniforms(rng, B, spec, plan,
                                                     bufs[0].device)
    if noise is not None:
        noise = tuple(n * (spec.dev_noise * weights)[:, None] for n in noise)
    accs, nrm, was_clipped = encode_plan_rows(
        bufs, weights, uniforms, noise, spec, plan, sessions=sessions)
    del uniforms, noise
    w_total = weights.sum()
    mean = finalize_plan_aggregate(accs, w_total, spec, plan,
                                   prf.fold_in(rng, 0xDEE))
    denom = torch.clamp(w_total, min=1e-9)
    stats = {
        "update_norm": (nrm * weights).sum() / denom,
        "clip_fraction": (was_clipped * weights).sum() / denom,
        "weight_total": w_total,
    }
    return mean, stats


def finalize_plan_aggregate(accs: Sequence[torch.Tensor], total_weight,
                            spec: AggregationSpec, plan: ParamPlan, rng, *,
                            ops=None):
    """Decode, divide by the total weight, reassemble the tree, TEE noise.

    The decode multiplies by the f32 reciprocal of the fixed-point scale:
    the JAX engine divides by that compile-time constant inside ``jit``,
    and XLA compiles such a division as a multiply by the f32-rounded
    reciprocal, whose results differ from a true division for most scales.
    ``ops`` expands each chunk's operator-domain aggregate once; XLA folds
    the reciprocal and the expand's ``full/m`` into one f32 constant there,
    and so does :func:`compression.expand` given ``descale``.
    """
    dev = accs[0].device
    w = torch.clamp(torch.as_tensor(total_weight, dtype=torch.float32,
                                    device=dev), min=1e-9)
    descale = float(_scalar(1.0, "cpu") / _scalar(spec.sa_scale, "cpu"))
    inv_scale = _scalar(descale, dev)
    flats = []
    for c, (ck, acc) in enumerate(zip(plan.chunks, accs)):
        op = None if ops is None else ops[c]
        a = acc[:ck.size] if op is None else acc[:op.m]
        if spec.use_secure_agg:
            a = sa.recenter(a, spec.field_modulus).to(torch.float32)
            if op is None:
                a = a * inv_scale
            else:
                a = comp.expand(a, op, ck.size, descale=descale)
        elif op is not None:
            a = comp.expand(a, op, ck.size)
        flats.append(a / w)
    mean = plan.unchunk(flats)
    if spec.tee_noise > 0.0:
        mean = dp.add_noise(mean, rng,
                            spec.tee_noise * spec.num_contributors
                            / _host_float(w))
    return mean
