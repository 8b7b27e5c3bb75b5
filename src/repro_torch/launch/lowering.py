"""Cost builders for every (architecture x input-shape x mesh) (port of
``repro.launch.lowering``).

The reference lowers and compiles each step with XLA and reads its cost
and memory analyses.  The port runs the step itself, op by op, on tensors
without data:

- a fake process group of ``prod(mesh)`` ranks (``FakeStore``: collectives
  return at once), this process being rank 0, and a ``DeviceMesh`` over it;
- params, batch and cache as ``DTensor`` s over that mesh, laid out by
  ``launch.sharding`` (the reference's ``PartitionSpec`` rules), each rank's
  shard a ``FakeTensor`` (``FakeTensorMode``: shapes, no storage);
- ``analysis.CostMode`` counts what each op does on rank 0's LOCAL shards,
  the collectives ``DTensor`` issues to move them, and the bytes alive.

``DTensor`` has no sharding rule for some of the port's ops (a GQA reshape
whose heads do not split like the mesh, in-place masks of partial sums,
gathers out of a vocabulary split).  Such an op runs replicated: its inputs
are gathered (the collectives issued and counted), it runs on the whole
tensors, and its result is replicated; each one is listed, with its count,
under ``replicated_regions``.  A mesh of one device runs on plain fake
tensors.

Train shapes cost the full DP-FL round step (the paper's technique);
prefill shapes ``prefill``; decode shapes one ``decode_step`` against a
``seq_len``-deep cache.  Two probes keep a full-width count short, and both
are exact where the step repeats identical work: the train round runs one
client chunk and is multiplied by ``cohort / m`` (``cost_probe_multiplier``,
as the reference's probe), and a deep stack runs at two or three cut depths
whose per-layer differences extrapolate to its full depth (``depth_probe``
lists them).  ``cost_probe=False`` runs the whole step as it is.
"""
from __future__ import annotations

import contextlib
import math
import warnings
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import FLConfig, ModelConfig, ShapeConfig
from repro_torch.launch import analysis
from repro_torch.launch.mesh import ShapeMesh, batch_axes
from repro_torch.launch.sharding import (cache_specs, infer_batch_specs,
                                         param_shardings, to_shardings,
                                         train_batch_specs)

DRYRUN_DTYPE = "bfloat16"


def default_fl_config(cohort: int) -> FLConfig:
    """Paper-faithful round: clip + secure agg (int32 fixed point) + TEE noise."""
    return FLConfig(cohort_size=cohort, local_steps=1, local_lr=1.0,
                    clip_norm=1.0, noise_multiplier=1.0, noise_placement="tee",
                    secure_agg_bits=32, server_opt="fedavg", server_lr=1.0)


def _prep_cfg(cfg: ModelConfig, opts: Dict) -> ModelConfig:
    over = {"param_dtype": opts.get("dtype", DRYRUN_DTYPE),
            "compute_dtype": opts.get("dtype", DRYRUN_DTYPE)}
    for k in ("remat", "attn_seq_shard", "attention_window", "attn_q_chunk",
              "capacity_factor", "moe_dispatch"):
        if k in opts:
            over[k] = opts[k]
    return cfg.with_overrides(**over)


def _model_flops(cfg: ModelConfig, shape: ShapeConfig, fl_cfg: Optional[FLConfig]) -> float:
    n = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len * (fl_cfg.local_steps if fl_cfg else 1)
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(shape, axes):
    """A fake process group of ``prod(shape)`` ranks and ``FakeTensorMode``;
    yields the :class:`ShapeMesh` over ``axes``, carrying a ``DeviceMesh``
    when it has more than one rank.  Nothing is allocated on any device."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    dm = None
    if n > 1:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        if dist.is_initialized():
            raise RuntimeError("the cost harness needs its own fake process "
                               "group; torch.distributed is initialised")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    try:
        if n > 1:
            dm = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        with FakeTensorMode(allow_non_fake_inputs=True):
            yield ShapeMesh(axes, shape, dm)
    finally:
        if n > 1:
            dist.destroy_process_group()


def _local_shape(shape, placements, mesh) -> tuple:
    local = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            local[pl.dim] //= mesh.axis_sizes[i]
    return tuple(local)


def _place(shapes, dtypes, shardings, mesh):
    """Tree of abstract tensors: ``DTensor`` s of fake shards laid out by
    ``shardings`` (plain fake tensors on a one-device mesh).  ``dtypes`` is
    one dtype or a tree of them."""
    paths, leaves = T.flatten(shapes)
    shs = T.leaves(shardings)
    dts = T.leaves(dtypes) if isinstance(dtypes, dict) else [dtypes] * len(
        leaves)
    out = []
    for s, sh, dt in zip(leaves, shs, dts):
        s = tuple(s)
        if mesh.device_mesh is None:
            out.append(torch.empty(s, dtype=dt))
            continue
        from torch.distributed.tensor import DTensor
        local = torch.empty(_local_shape(s, sh.placements, mesh), dtype=dt)
        out.append(DTensor.from_local(local, mesh.device_mesh,
                                      sh.placements, run_check=False))
    return T.unflatten(paths, out)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (each
    storage once)."""
    seen, n = set(), 0
    for t in analysis._tensors(tree):
        t = analysis.local(t)
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


# ---------------------------------------------------------------------------
# ops DTensor cannot shard: replicated, and listed
# ---------------------------------------------------------------------------
# ops whose DTensor rule is not used: ``gather`` out of a vocabulary split
# yields a masked partial sum that the next op cannot always reduce, and
# whether it can depends on what DTensor has cached, so the count would
# depend on the order pairs run in
_NO_RULE = ("gather",)


class _Replicated:
    """Runs an op whose ``DTensor`` sharding propagation fails.  First with
    each ``DTensor`` input split only over the mesh dimensions that split
    its leading (batch) dimension and gathered over the others; failing
    that, on whole tensors with a replicated result.  The gathers are
    issued as collectives (an all-gather; an all-reduce for a partial sum)
    so the count sees them, and an input the op writes is rebound to its
    new layout.  ``regions`` counts such ops by name (``"<op> (batch
    split)"`` for the first kind)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        owner = self
        self.regions: Dict[str, int] = {}

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return owner._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        return False

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor, Shard
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        name = str(func.overloadpacket.__name__)
        if name not in _NO_RULE:
            try:
                return func(*args, **kwargs)
            except Exception:  # no sharding rule
                pass

        def batch(pl):
            return type(pl) is Shard and pl.dim == 0

        try:
            out = self._run(func, args, kwargs, batch)
            name += " (batch split)"
        except Exception:
            out = self._run(func, args, kwargs, lambda pl: False)
        self.regions[name] = self.regions.get(name, 0) + 1
        return out

    @staticmethod
    def _run(func, args, kwargs, keep):
        """``func`` with each ``DTensor`` input regathered to the placements
        that ``keep`` keeps (whole tensors, run as plain ones, when it keeps
        none)."""
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_map
        new: Dict[int, Any] = {}
        mesh = None

        def regather(x):
            nonlocal mesh
            if not isinstance(x, DTensor):
                return x
            mesh = x.device_mesh
            if id(x) not in new:
                new[id(x)] = (x, _regathered(x, keep))
            return new[id(x)][1]

        a = tree_map(regather, args)
        k = tree_map(regather, kwargs)
        out = func(*a, **k)
        rebound = {}
        for orig, x in new.values():
            if _written(func, args, kwargs, orig):
                d = x if isinstance(x, DTensor) else _replicated(x, mesh)
                orig._local_tensor, orig._spec = d._local_tensor, d._spec
                rebound[id(x)] = orig
        plain = {id(x) for x in analysis._tensors((args, kwargs))}

        def wrap(o):
            if not isinstance(o, torch.Tensor):
                return o
            if id(o) in rebound:
                return rebound[id(o)]
            if isinstance(o, DTensor) or id(o) in plain:
                return o
            return _replicated(o, mesh)

        return tree_map(wrap, out)


def _regathered(x, keep):
    """``DTensor`` ``x`` gathered over each mesh dimension whose placement
    ``keep`` does not keep: an all-gather where it splits ``x``, an
    all-reduce where it holds a partial sum.  A ``DTensor`` with the kept
    placements, or the whole tensor when none is kept."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    t = x.to_local()
    placements, gathered = [], set()
    for i, pl in enumerate(x.placements):
        if keep(pl):
            placements.append(pl)
            continue
        placements.append(Replicate())
        if pl.is_replicate():
            continue
        if pl.is_partial():
            t = funcol.wait_tensor(funcol.all_reduce(
                t, "sum", (x.device_mesh, i)))
        else:  # Shard, or a strided shard (the values' order is moot)
            gathered.add(pl.dim)
            with warnings.catch_warnings():  # renamed in newer torch
                warnings.simplefilter("ignore", FutureWarning)
                t = funcol.wait_tensor(funcol.all_gather_tensor(
                    t.contiguous(), pl.dim, (x.device_mesh, i)))
    # an uneven split gathers its padding too: cut each gathered dimension
    # back to its size under the kept placements
    for d in gathered:
        kept = math.prod(x.device_mesh.size(i) for i, pl in
                         enumerate(placements)
                         if pl.is_shard() and pl.dim == d)
        if t.shape[d] * kept > x.shape[d]:
            t = t.narrow(d, 0, x.shape[d] // kept)
    if all(pl.is_replicate() for pl in placements):
        return t
    return DTensor.from_local(t, x.device_mesh, placements, run_check=False)


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _written(func, args, kwargs, x) -> bool:
    """Whether ``func`` writes its argument ``x`` (in place, or ``out=``)."""
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(a.name)
        if v is x or (isinstance(v, (list, tuple)) and any(e is x for e in v)):
            return True
    return False


# ---------------------------------------------------------------------------
# measuring one step
# ---------------------------------------------------------------------------
class Measured(NamedTuple):
    """One run of a step: its :class:`analysis.Counts`, its
    :class:`analysis.MemoryCounts` and the ops it ran replicated."""

    counts: analysis.Counts
    memory: analysis.MemoryCounts
    regions: Dict[str, int]


def measure(fn, args, mesh: ShapeMesh) -> Measured:
    """Run ``fn(*args)`` under :class:`analysis.CostMode` (and, on a mesh of
    several devices, ``DTensor``'s implicit replication of plain tensors and
    the replicated fallback)."""
    arg_bytes = local_bytes(args)
    arg_storages = {analysis.local(t).untyped_storage()._cdata
                    for t in analysis._tensors(args)}
    rep = _Replicated()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_quiet())
        stack.enter_context(_scaled_draws())
        cm = stack.enter_context(analysis.CostMode())
        if mesh.device_mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
            stack.enter_context(rep)
        out = fn(*args)
    outs = [t for t in analysis._tensors(out)
            if analysis.local(t).untyped_storage()._cdata not in arg_storages]
    mem = analysis.MemoryCounts(arg_bytes, local_bytes(outs),
                                arg_bytes + cm.peak_bytes)
    return Measured(cm.counts, mem, rep.regions)


@contextlib.contextmanager
def _quiet():
    """DTensor's advice while the fallback replicates (a 1-element tensor
    taken as replicated, two all-reduces where one would do, the CPU group
    lacking all-to-all) says nothing about the port: not printed."""
    import logging
    log = logging.getLogger("torch.distributed")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="Found a non-scalar")
            yield
    finally:
        log.setLevel(level)


_DRAW_N = 1 << 12
_DRAW_COUNTS: Dict[str, analysis.Counts] = {}


@contextlib.contextmanager
def _scaled_draws():
    """While active, ``prf.uniform`` and ``prf.normal`` return an
    uninitialised tensor of their shape and add to the count what the real
    draw does: the operations of its op sequence, the same for every
    element, counted once at 4096 elements (outside any other count) and
    scaled to the call's size, and the bytes of its f32 output.  A draw is
    one elementwise chain from a counter, run a tile at a time: its
    intermediates need not leave the chip (on an H100 a tile's fit in the
    50 MB L2), so only the output is charged at the HBM rate.  A full-width
    round draws ~1e10 numbers, which op by op on fake tensors would take
    minutes of host time."""
    from repro_torch.kernels import prf
    orig = {name: getattr(prf, name) for name in ("uniform", "normal")}
    for name, real in orig.items():
        if name not in _DRAW_COUNTS:
            with analysis.CostMode() as cm:
                real((0, 0), (_DRAW_N,), device="cpu")
            cm.counts.bytes = 4.0 * _DRAW_N
            _DRAW_COUNTS[name] = cm.counts

    def scaled(name):
        def draw(key, shape, *, device=None):
            shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
            analysis.add_counts(_DRAW_COUNTS[name],
                                math.prod(shape) / _DRAW_N)
            return torch.empty(shape, dtype=torch.float32, device=device)
        return draw

    for name in orig:
        setattr(prf, name, scaled(name))
    try:
        yield
    finally:
        for name, real in orig.items():
            setattr(prf, name, real)


@contextlib.contextmanager
def _placed_caches(mesh: ShapeMesh, shard_seq: bool):
    """While active, the decode caches that ``prefill`` makes are laid out
    by ``launch.sharding.cache_specs``, as the reference's ``out_shardings``
    place them, instead of whole on every device."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TR
    if mesh.device_mesh is None:
        yield
        return
    orig_stack, orig_kv = TR.init_stack_cache, L.init_kv_cache

    def placed(make):
        def f(*a, **kw):
            with analysis.paused():  # the whole cache: shapes only
                c = make(*a, **kw)
            specs = to_shardings(cache_specs(c, mesh, shard_seq=shard_seq),
                                 mesh)
            dts = T.tree_map(lambda t: t.dtype, c)
            return _place(T.tree_map(lambda t: t.shape, c), dts, specs, mesh)
        return f

    TR.init_stack_cache, L.init_kv_cache = placed(orig_stack), \
        placed(orig_kv)
    try:
        yield
    finally:
        TR.init_stack_cache, L.init_kv_cache = orig_stack, orig_kv


# ---------------------------------------------------------------------------
# builders: (fn, example args, meta); call inside fake_world
# ---------------------------------------------------------------------------
def _build_model(cfg, opts):
    from repro_torch.models.model import build_model
    return build_model(cfg, use_ragged_moe=opts.get("use_ragged_moe", False),
                       device="cpu")


def _params(cfg, mesh, fsdp_axis=None):
    from repro_torch.models.model import param_shapes
    shapes = param_shapes(cfg)
    return _place(shapes, getattr(torch, cfg.param_dtype),
                  param_shardings(shapes, mesh, tp="model",
                                  fsdp_axis=fsdp_axis), mesh)


def _batch(specs, shapes, mesh):
    dts = {k: s.dtype for k, s in shapes.items()}
    return _place({k: torch.Size(s.shape) for k, s in shapes.items()}, dts,
                  to_shardings(specs, mesh), mesh)


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                fl_cfg: Optional[FLConfig] = None, opts: Optional[Dict] = None):
    """(round_step, (state, batch, rng), meta) for the DP-FL round step."""
    from repro_torch.core import telemetry as tele
    from repro_torch.core.fl.round import build_round_step, init_fl_state
    from repro_torch.kernels import prf
    opts = opts or {}
    cfg = _prep_cfg(cfg, opts)
    fl_cfg = fl_cfg or default_fl_config(shape.global_batch)
    if "deferred_agg" in opts or "noise_placement" in opts or "local_steps" in opts:
        fl_cfg = FLConfig(**{**fl_cfg.__dict__,
                             **{k: opts[k] for k in
                                ("deferred_agg", "noise_placement", "local_steps")
                                if k in opts}})
    model = _build_model(cfg, opts)

    cohort = shape.global_batch
    ba = batch_axes(mesh)
    n_batch_shards = int(np.prod([mesh.shape[a] for a in ba]))
    client_parallel = opts.get("client_parallel", not cfg.fsdp)
    if client_parallel:
        m = n_batch_shards
        client_axis, seq_axis = ba, None
    else:
        # sequential clients; each client's sequence shards over `data` and
        # (multi-pod) a small client chunk shards over `pod`.
        m = mesh.shape.get("pod", 1)
        client_axis = ("pod",) if "pod" in mesh.shape else None
        seq_axis = "data"
    m = opts.get("clients_per_chunk", m)

    round_step = build_round_step(
        model.loss_fn, fl_cfg, cohort_size=cohort,
        client_parallel=client_parallel, clients_per_chunk=m,
        telemetry=tele.Telemetry(record_spans=False), device="cpu")

    fsdp_axis = "data" if (cfg.fsdp and not client_parallel) else None
    state = init_fl_state(_params(cfg, mesh, fsdp_axis), fl_cfg)
    raw = registry.input_specs(cfg, shape)
    shapes = {k: registry.TensorSpec((s.shape[0], 1) + s.shape[1:], s.dtype)
              for k, s in raw.items()}
    batch = _batch(train_batch_specs(
        {k: torch.Size(s.shape) for k, s in shapes.items()}, mesh,
        client_axis=client_axis, seq_axis=seq_axis), shapes, mesh)
    return round_step, (state, batch, prf.PRNGKey(0)), {
        "fl_cfg": fl_cfg, "m": m, "client_parallel": client_parallel}


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                  opts: Optional[Dict] = None):
    opts = opts or {}
    cfg = _prep_cfg(cfg, opts)
    model = _build_model(cfg, opts)
    max_len = shape.seq_len
    shard_seq = opts.get("shard_seq", False)

    def prefill_fn(params, batch):
        with _placed_caches(mesh, shard_seq):
            return model.prefill(params, batch, max_len)

    raw = registry.input_specs(cfg, shape)
    batch = _batch(infer_batch_specs(
        {k: torch.Size(s.shape) for k, s in raw.items()}, mesh), raw, mesh)
    return prefill_fn, (_params(cfg, mesh), batch), {}


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 opts: Optional[Dict] = None):
    opts = opts or {}
    cfg = _prep_cfg(cfg, opts)
    model = _build_model(cfg, opts)
    B = shape.global_batch
    max_len = shape.seq_len
    whole = model.init_cache(B, max_len)  # fake: shapes only
    cache = _place(T.tree_map(lambda t: t.shape, whole),
                   T.tree_map(lambda t: t.dtype, whole),
                   to_shardings(cache_specs(whole, mesh, shard_seq=opts.get(
                       "shard_seq", False)), mesh), mesh)
    del whole
    tok = {"tokens": registry.TensorSpec((B, 1), torch.int32)}
    tokens = _batch(infer_batch_specs({"tokens": torch.Size((B, 1))}, mesh),
                    tok, mesh)["tokens"]

    def decode_fn(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    # the new token's position: the last of a full cache
    return decode_fn, (_params(cfg, mesh), cache, tokens, max_len - 1), {}


# ---------------------------------------------------------------------------
# cost probes
# ---------------------------------------------------------------------------
def _cut(cfg: ModelConfig, depth: int) -> ModelConfig:
    pattern = cfg.block_pattern
    return cfg.with_overrides(
        num_layers=depth,
        block_pattern=None if pattern is None else pattern[:depth])


def depth_plan(cfg: ModelConfig) -> Optional[List[tuple]]:
    """[(depth, weight)]: cut depths whose counts, so weighted and summed,
    are the full stack's, for a stack of repeated layers (None: count the
    stack as it is).  Each layer kind costs the same wherever it sits, so a
    count is linear in the number of layers of each kind; the cut depths
    keep the full stack's layout (a scanned tail stays scanned)."""
    if cfg.family == "audio":
        return None
    kinds = cfg.layer_kinds
    L = len(kinds)
    names = sorted(set(kinds))

    def vec(d):
        ks = kinds[:d]
        return [1.0] + [float(ks.count(k)) for k in names]

    start = cfg.first_k_dense + 2 if cfg.block_pattern is None else 1
    target = np.array(vec(L))
    depths = []
    for d in range(start, L):
        depths.append(d)
        A = np.array([vec(x) for x in depths]).T
        w, *_ = np.linalg.lstsq(A, target, rcond=None)
        if np.allclose(A @ w, target, atol=1e-9):
            return [(x, float(round(wi, 9))) for x, wi in zip(depths, w)]
    return None


def _linear(parts: List[tuple]) -> Measured:
    """Sum of ``weight * Measured`` over ``parts`` [(weight, Measured)]."""
    counts = analysis.Counts.linear([(w, m.counts) for w, m in parts])
    mem = analysis.MemoryCounts(
        *(int(round(sum(w * getattr(m.memory, f) for w, m in parts)))
          for f in ("argument_bytes", "output_bytes", "peak_bytes")))
    regions: Dict[str, int] = {}
    for w, m in parts:
        for k, v in m.regions.items():
            regions[k] = regions.get(k, 0) + w * v
    return Measured(counts, mem, {k: int(round(v)) for k, v in
                                  regions.items() if round(v)})


def _run(build, cfg, shape, mesh_shape, axes, opts, **kw) -> Measured:
    with fake_world(mesh_shape, axes) as mesh:
        fn, args, _ = build(cfg, shape, mesh, opts=opts, **kw)
        return measure(fn, args, mesh)


def run_step(build, cfg, shape, mesh_shape=(1, 1), axes=("data", "model"),
             opts: Optional[Dict] = None, depth_probe: bool = True, **kw):
    """Count one step that ``build`` (a builder above) makes for ``cfg`` and
    ``shape`` on a fake mesh of ``mesh_shape`` over ``axes``: (the
    :class:`Measured` run, the cut depths it extrapolates from or None).
    ``kw`` goes to the builder (``fl_cfg``)."""
    opts = opts or {}
    plan = depth_plan(cfg) if depth_probe else None
    if plan is None:
        return _run(build, cfg, shape, mesh_shape, axes, opts, **kw), None
    parts = [(w, _run(build, _cut(cfg, d), shape, mesh_shape, axes, opts,
                      **kw)) for d, w in plan]
    return _linear(parts), [d for d, _ in plan]


def _combine_counts(cfg, opts, mesh: ShapeMesh, tp: int, fl_cfg) -> analysis.Counts:
    """The client-parallel round's one cross-client reduction: each
    device's int32 (f32 at ``secure_agg_bits=0``) accumulator, a TP shard
    of the params, summed over the batch axes; issued as all-reduces on the
    full mesh's fake group and counted."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.models.model import param_shapes
    cfg = _prep_cfg(cfg, opts)
    shapes = param_shapes(cfg)
    probe = ShapeMesh(("data", "model"), (1, tp))
    shs = T.leaves(param_shardings(shapes, probe, tp="model"))
    dt = torch.int32 if fl_cfg.secure_agg_bits else torch.float32
    ba = batch_axes(mesh)
    strides = {a: math.prod(mesh.axis_sizes[i + 1:])
               for i, a in enumerate(mesh.axis_names)}
    # rank 0's batch group: every combination of batch coordinates, model 0
    ranks = [0]
    for a in ba:
        ranks = [r + j * strides[a] for r in ranks
                 for j in range(mesh.shape[a])]
    group = dist.new_group(sorted(ranks))
    with analysis.CostMode() as cm:
        for s, sh in zip(T.leaves(shapes), shs):
            acc = torch.empty(_local_shape(tuple(s), sh.placements, probe),
                              dtype=dt)
            funcol.wait_tensor(funcol.all_reduce(acc, "sum", group))
    return cm.counts


def _mesh_axes(mesh) -> tuple:
    return tuple(mesh.axis_names), tuple(mesh.shape[a] for a in
                                          mesh.axis_names)


def lower_pair(arch: str, shape_name: str, mesh, *, reduced: bool = False,
               opts: Optional[Dict] = None, compile_: bool = True,
               cost_probe: bool = True) -> Dict[str, Any]:
    """Count one (arch, shape) on the given mesh (a ``ShapeMesh`` or any
    object with ``axis_names`` and ``shape``); return the analysis."""
    opts = dict(opts or {})
    cfg = registry.config_for_pair(arch, shape_name, reduced=reduced)
    if cfg is None:
        return {"arch": arch, "shape": shape_name,
                "skipped": registry.SKIPS[(arch, shape_name)]}
    shape = registry.get_shape(shape_name)
    if reduced:
        shape = ShapeConfig(shape.name, min(shape.seq_len, 256),
                            min(shape.global_batch, 8), shape.mode)
    axes, sizes = _mesh_axes(mesh)
    chips = math.prod(sizes)

    fl_cfg = None
    meta: Dict[str, Any] = {}
    if shape.mode == "train":
        fl_cfg = opts.pop("fl_cfg", None) or default_fl_config(shape.global_batch)
        # the meta (m, client_parallel) of the full round, on a shape mesh
        cp = opts.get("client_parallel", not _prep_cfg(cfg, opts).fsdp)
        n_batch = math.prod(mesh.shape[a] for a in batch_axes(mesh))
        m = n_batch if cp else mesh.shape.get("pod", 1)
        meta = {"m": opts.get("clients_per_chunk", m), "client_parallel": cp}
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": dict(zip(axes, sizes)), "reduced": reduced,
                           "mode": shape.mode, **meta}
    if not compile_:
        return out
    model_flops = _model_flops(_prep_cfg(cfg, opts), shape, fl_cfg)

    probe_coll, mult = None, 1.0
    if shape.mode == "train" and cost_probe:
        # one client chunk: one client on a TP-only mesh (data=1) when
        # clients split the batch axes, else the chunk on the full mesh
        cp = meta["client_parallel"]
        pm = 1 if cp else meta["m"]
        pshape = ShapeConfig(shape.name, shape.seq_len, pm, "train")
        pfl = FLConfig(**{**fl_cfg.__dict__, "cohort_size": pm})
        popts = {**opts, "clients_per_chunk": pm}
        tp = mesh.shape["model"]
        paxes, psizes = (("data", "model"), (1, tp)) if cp else (axes, sizes)
        run, depths = run_step(build_train, cfg, pshape, psizes, paxes,
                               popts, fl_cfg=pfl)
        mult = float(shape.global_batch // meta["m"])
        counts = analysis.Counts.linear([(mult, run.counts)])
        if cp and chips // tp > 1:
            with fake_world(sizes, axes) as full:
                comb = _combine_counts(cfg, opts, full, tp, fl_cfg)
            probe_coll = analysis.collective_summary(counts.collectives)
            counts = analysis.Counts.linear([(1.0, counts), (1.0, comb)])
    elif shape.mode == "train":
        run, depths = run_step(build_train, cfg, shape, sizes, axes, opts,
                               depth_probe=False, fl_cfg=fl_cfg)
        counts = run.counts
    else:
        build = build_prefill if shape.mode == "prefill" else build_decode
        run, depths = run_step(build, cfg, shape, sizes, axes, opts,
                               depth_probe=cost_probe)
        counts = run.counts

    # a train probe's memory is one client chunk's, as each device holds it
    # (the rest of the cohort's token batch, a few MB, is not in it)
    out["memory"] = analysis.memory_summary(run.memory)
    out["roofline"] = analysis.roofline(counts, model_flops=model_flops,
                                        chips=chips)
    if probe_coll is not None:
        out["roofline"]["collectives"]["probe_tp_only"] = probe_coll
    if cost_probe:
        out["roofline"]["cost_probe_multiplier"] = mult
    if depths is not None:
        out["depth_probe"] = depths
    out["replicated_regions"] = run.regions
    return out
