"""Roofline analysis of one step of the port, counted without running it
on a card (port of ``repro.launch.analysis``).

Three terms per (arch, shape, mesh), in seconds, per device:
  compute    = matmul FLOPs / the tensor-core rate of their dtype
               + other float ops / the f32 rate
               + integer ops / the integer issue rate
  memory     = bytes / HBM rate
  collective = sum over collectives of wire bytes / link rate

The reference reads XLA's cost analysis of a per-partition module.  Here
:class:`CostMode`, a ``TorchDispatchMode``, sees every ATen op that the
step runs on the LOCAL shards (fake tensors, or the fake shards of
``DTensor`` s on a fake process group; ``launch.lowering`` sets that up)
and counts it: matmul FLOPs from ``torch.utils.flop_counter``'s formulas,
one operation per element for everything else, the bytes each op reads and
writes (views move none; gathers read only the rows they pick), and every
``_c10d_functional`` collective with the bytes of its result shard.  The
hand-written kernels' wrappers add their own operations and bytes
(:func:`record_kernel`), the formulas behind each kernel's bound.  Eager
torch runs op by op, so ``bytes`` is what the unfused program moves: more
than XLA's post-fusion count.

Collective wire factors are the reference's: all-reduce 2x (ring =
reduce-scatter + all-gather), all-gather / reduce-scatter / all-to-all /
collective-permute 1x of the result-shard size.

Hardware constants: NVIDIA H100 80GB HBM3 (SXM), at its 700 W limit.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

# The rates every bound is taken against: NVIDIA H100 80GB HBM3 (SXM) at
# its 700 W limit.  A card held below 700 W runs slower under load.
# NVIDIA H100 80GB HBM3, 700 W: HBM3 bandwidth, the H100 SXM data sheet's
# 3.35 TB/s.
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700 W: f32 on the CUDA cores, the data sheet's
# 67 TFLOP/s (an FMA counted as two operations).  The port's f32 matmuls
# run here too: it does not use TF32.
F32_FLOPS = 67e12
# NVIDIA H100 80GB HBM3, 700 W: dense bf16 (and f16) on the tensor cores,
# 132 SMs x 4096 flop/clk x 1.83 GHz = 989 TFLOP/s, the data sheet's dense
# figure.
PEAK_FLOPS = 132 * 4096 * 1.83e9
# NVIDIA H100 80GB HBM3, 700 W: integer (and other non-FMA) instructions
# against the issue rate: each SM issues at most 4 warp-instructions, 128
# lane-operations, per clock, so SMs x 128 x the maximum SM clock
# (nvidia-smi clocks.max.sm: 1980 MHz, ~33.4 T/s at 132 SMs).
# :func:`set_int_rate` sets it from the card.
INT_OPS_PER_S = 132 * 128 * 1.98e9
# NVIDIA H100 80GB HBM3, 700 W: integer instructions of one
# Threefry-2x32-13 evaluation, counted in the SASS of K1's main loop for
# the 8-slot graph (tools/threefry_sass.py, H100 build): 16 evaluations an
# iteration in 752 IMAD/IADD3/VIADD/LOP3/SHF, 28 of them the mask's sign
# multiply-adds, so (752 - 28) / 16 = 45.25: a round is an add, a
# funnel-shift rotate and an xor, plus the x1 key injections and some adds
# the compiler did not fold
THREEFRY_OPS = 45
# NVIDIA H100 80GB HBM3, 700 W: NVLink 4, one direction: 18 links x
# 25 GB/s = 450 GB/s (the data sheet's 900 GB/s counts both directions).
LINK_BW = 450e9

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# torch's functional collectives (``_c10d_functional.<op>``) by the
# reference's kind; ``all_to_all_single`` with one source and one
# destination is a permute (``permute_tensor`` lowers to it)
KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def set_int_rate(sms: int, max_sm_mhz: float) -> float:
    """Set :data:`INT_OPS_PER_S` from the card: SMs x 128 lane-operations
    per clock x its maximum SM clock.  Returns the rate."""
    global INT_OPS_PER_S
    INT_OPS_PER_S = sms * 128 * float(max_sm_mhz) * 1e6
    return INT_OPS_PER_S


def kernel_bound_ms(ops: float, nbytes: float, *,
                    integer: bool = False) -> tuple:
    """(bound ms, "bytes" or "operations") of one kernel: its bytes over the
    HBM rate against its operations over the f32 rate (``integer``: the
    issue rate), the larger."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / (INT_OPS_PER_S if integer else F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------
@dataclass
class Counts:
    """What one step did on one device: matmul FLOPs by dtype, other float
    and integer operations, bytes moved, the collectives (records of
    ``{"op", "kind", "bytes", "in_entry"}``) and the hand-written kernels'
    share (``kernels[name] = {"calls", "ops", "bytes"}``)."""

    matmul_flops: Dict[str, float] = field(default_factory=dict)
    float_ops: float = 0.0
    int_ops: float = 0.0
    bytes: float = 0.0
    collectives: List[Dict] = field(default_factory=list)
    kernels: Dict[str, Dict] = field(default_factory=dict)

    @staticmethod
    def linear(parts: List[tuple]) -> "Counts":
        """``sum(weight * counts)`` over ``parts`` [(weight, Counts)].  The
        collectives are summed per (op, kind, in_entry): their weighted
        count of records, each with the group's mean bytes."""
        out = Counts()
        groups: Dict[tuple, List[float]] = {}
        for w, c in parts:
            for dt, f in c.matmul_flops.items():
                out.matmul_flops[dt] = out.matmul_flops.get(dt, 0.0) + w * f
            out.float_ops += w * c.float_ops
            out.int_ops += w * c.int_ops
            out.bytes += w * c.bytes
            for n, e in c.kernels.items():
                s = out.kernels.setdefault(n, dict.fromkeys(e, 0.0))
                for key, v in e.items():
                    s[key] += w * v
            for r in c.collectives:
                g = groups.setdefault((r["op"], r["kind"], r["in_entry"]),
                                      [0.0, 0.0])
                g[0] += w
                g[1] += w * r["bytes"]
        for (op, kind, in_entry), (n, b) in groups.items():
            k = int(round(n))
            out.collectives += [{"op": op, "kind": kind, "bytes": b / k,
                                 "in_entry": in_entry}] * max(k, 0)
        return out


_ACTIVE: List["CostMode"] = []


def record_kernel(name: str, *, ops: float, nbytes: float) -> None:
    """A hand-written kernel's wrapper, called on abstract tensors, adds its
    float operations and bytes to the innermost active :class:`CostMode`;
    outside one it does nothing."""
    if not _ACTIVE:
        return
    c = _ACTIVE[-1].counts
    c.float_ops += ops
    c.bytes += nbytes
    e = c.kernels.setdefault(name, {"calls": 0.0, "ops": 0.0, "bytes": 0.0})
    e["calls"] += 1
    e["ops"] += ops
    e["bytes"] += nbytes


@contextlib.contextmanager
def paused():
    """While active, the innermost :class:`CostMode` neither counts nor
    tracks what runs (work done only to set up what the step sees)."""
    mode = _ACTIVE[-1] if _ACTIVE else None
    if mode is not None:
        mode._paused += 1
    try:
        yield
    finally:
        if mode is not None:
            mode._paused -= 1


def add_counts(counts: Counts, k: float = 1.0) -> None:
    """Add ``k * counts`` to the innermost active :class:`CostMode` (work
    counted apart, at another size, and scaled to this call's)."""
    if not _ACTIVE:
        return
    mode = _ACTIVE[-1]
    mode.counts = Counts.linear([(1.0, mode.counts), (k, counts)])


def _tensors(x) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_FREE = ("empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "lift_fresh_copy",
         "device", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_same_size")
# ops that read only the rows they pick (plus the indices)
_GATHERS = ("embedding", "index_select", "gather", "index", "take",
            "_embedding_bag")
# ops that write only the rows they are given (plus the indices)
_SCATTERS = ("index_put_", "_index_put_impl_", "index_copy_", "scatter_",
             "scatter_add_", "index_add_", "masked_scatter_")
_FILLS = ("fill_", "zero_", "zeros", "ones", "full", "arange", "scalar_tensor",
          "zeros_like", "ones_like", "full_like")


class CostMode:
    """Counts what runs under it (see the module docstring) and tracks the
    bytes of the storages its ops create, live and at their peak.

    Use as a context manager; a ``DTensor`` op is passed on (``DTensor``
    runs it on its local shards, which come back through this mode), so
    only local work is counted.  ``counts`` holds the tally, ``peak_bytes``
    the most bytes that ops created and that were alive at once."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        owner = self
        self.counts = Counts()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}
        self._flops = flop_registry

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return owner._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()

    def __enter__(self):
        _ACTIVE.append(self)
        self._paused = 0
        self._unpatch = _pause_in_sharding_propagation(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._unpatch()
        _ACTIVE.remove(self)
        return False

    # -- memory ---------------------------------------------------------
    def _track(self, outs, seen: set) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    # -- the tally ------------------------------------------------------
    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._paused:
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        seen = {_sid(t) for t in ins}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._count(func, args, kwargs, ins, outs, seen)
        self._track(outs, seen)
        return out

    def _count(self, func, args, kwargs, ins, outs, seen) -> None:
        c = self.counts
        pkt = func.overloadpacket
        name = pkt.__name__
        ns = func.namespace
        if ns == "_c10d_functional":
            if name == "wait_tensor":
                return
            kind = KIND_OF.get(name.rstrip("_"))
            if kind == "all-to-all" and _is_permute(args):
                kind = "collective-permute"
            b = sum(_nbytes(t) for t in outs)
            c.collectives.append({"op": name, "kind": kind, "bytes": b,
                                  "in_entry": True})
            c.bytes += sum(_nbytes(t) for t in ins) + b
            return
        if name in _FREE or ns == "prim":
            return
        mutable = func._schema.is_mutable
        if not mutable and outs and all(_sid(t) in seen for t in outs):
            return  # a view: metadata only
        if pkt in self._flops:
            fl = float(self._flops[pkt](*args, **kwargs, out_val=outs[0]
                                        if len(outs) == 1 else outs))
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "float32"
            c.matmul_flops[dt] = c.matmul_flops.get(dt, 0.0) + fl
        else:
            if name in _GATHERS:
                n = sum(t.numel() for t in outs)
            elif name in _SCATTERS:
                n = sum(t.numel() for t in ins[1:])
            else:
                n = max((t.numel() for t in ins + outs), default=0)
            if any(t.is_floating_point() or t.is_complex()
                   for t in ins + outs):
                c.float_ops += n
            else:
                c.int_ops += n
        wrote = sum(_nbytes(t) for t in outs)
        if name in _GATHERS:
            read = wrote + sum(_nbytes(t) for t in ins
                               if not t.is_floating_point())
        elif name in _SCATTERS:
            src = [t for t in ins[1:]]
            read = sum(_nbytes(t) for t in src)
            wrote = sum(_nbytes(t) for t in src if t.is_floating_point()
                        or t.dtype == ins[0].dtype)
        elif name in _FILLS:
            read = 0
        else:
            outarg = kwargs.get("out")
            skip = {_sid(t) for t in _tensors(outarg)} if outarg is not None \
                else set()
            read = sum(_nbytes(t) for t in ins if _sid(t) not in skip)
        c.bytes += read + wrote


def _pause_in_sharding_propagation(mode: "CostMode"):
    """``DTensor`` works out an op's output shape by running it once on
    whole-size fake tensors (cached per op and layout); that run is not the
    program's, so ``mode`` counts nothing while it lasts.  Returns the undo."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        orig = ShardingPropagator.__dict__.get(name)
        if orig is not None:
            break
    else:
        raise RuntimeError("this torch's DTensor has no tensor-meta "
                           "propagation method to pause the count in")

    def paused(self, *a, **kw):
        mode._paused += 1
        try:
            return orig(self, *a, **kw)
        finally:
            mode._paused -= 1

    setattr(ShardingPropagator, name, paused)
    return lambda: setattr(ShardingPropagator, name, orig)


def _is_permute(args) -> bool:
    """``all_to_all_single(input, output_split_sizes, input_split_sizes,
    group)`` sending to one rank and receiving from one."""
    try:
        outs, ins = args[1], args[2]
    except IndexError:
        return False
    return (outs is not None and ins is not None
            and sum(1 for s in outs if s) == 1
            and sum(1 for s in ins if s) == 1)


# ---------------------------------------------------------------------------
# the summaries
# ---------------------------------------------------------------------------
def parse_collectives(records: List[Dict],
                      loop_multiplier: float = 1.0) -> List[Dict]:
    """The recorded collectives as the reference's ops: ``kind``, result-
    shard ``bytes`` and ``wire_bytes``, scaled by ``loop_multiplier`` where
    a record is not ``in_entry`` (it ran once per trip of a loop)."""
    out = []
    for r in records:
        kind = r.get("kind") or KIND_OF[r["op"].rstrip("_")]
        in_entry = r.get("in_entry", True)
        mult = 1.0 if in_entry else loop_multiplier
        b = r["bytes"]
        out.append({"kind": kind, "bytes": b * mult,
                    "wire_bytes": b * _WIRE_FACTOR[kind] * mult,
                    "in_entry": in_entry})
    return out


def collective_summary(records: List[Dict],
                       loop_multiplier: float = 1.0) -> Dict:
    ops = parse_collectives(records, loop_multiplier)
    by_kind: Dict[str, Dict] = {}
    for op in ops:
        e = by_kind.setdefault(op["kind"], {"count": 0, "bytes": 0,
                                            "wire_bytes": 0})
        e["count"] += 1
        e["bytes"] += op["bytes"]
        e["wire_bytes"] += op["wire_bytes"]
    return {
        "ops": by_kind,
        "total_bytes": sum(o["bytes"] for o in ops),
        "total_wire_bytes": sum(o["wire_bytes"] for o in ops),
        "count": len(ops),
    }


def _matmul_rate(dtype: str) -> float:
    return PEAK_FLOPS if dtype in ("bfloat16", "float16") else F32_FLOPS


def roofline(counts: Counts, *, model_flops: float = 0.0, chips: int = 1,
             multiplier: float = 1.0) -> Dict:
    """Three-term roofline of one device's ``counts``.

    model_flops: analytic 6*N*D (or 6*N_active*D) *global* FLOPs — compared
    against per-device flops x chips for the usefulness ratio.
    multiplier: scale for a cost probe that ran one trip of a loop (one
    client chunk of n_chunks).
    """
    k = multiplier
    mm = {dt: f * k for dt, f in counts.matmul_flops.items()}
    float_ops, int_ops = counts.float_ops * k, counts.int_ops * k
    flops = sum(mm.values()) + float_ops + int_ops
    bytes_accessed = counts.bytes * k
    coll = collective_summary(counts.collectives)
    if k != 1.0:
        coll = {**coll, "total_bytes": coll["total_bytes"] * k,
                "total_wire_bytes": coll["total_wire_bytes"] * k}
    terms_c = {"matmul_s": sum(f / _matmul_rate(dt) for dt, f in mm.items()),
               "float_s": float_ops / F32_FLOPS,
               "integer_s": int_ops / INT_OPS_PER_S}
    t_compute = sum(terms_c.values())
    t_memory = bytes_accessed / HBM_BW
    t_collective = coll["total_wire_bytes"] / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    dominant = max(terms, key=terms.get)
    out = {
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collectives": coll,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_time_s": max(terms.values()),
        "compute_terms": {**terms_c, "matmul_flops": mm,
                          "float_ops": float_ops, "int_ops": int_ops},
    }
    if counts.kernels:
        out["kernels"] = {n: {key: v * k for key, v in e.items()}
                          for n, e in counts.kernels.items()}
    if model_flops > 0:
        total = flops * chips
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / total if total else 0.0
    return out


@dataclass
class MemoryCounts:
    """Bytes of one device's step: its arguments (params, optimizer state,
    batch, cache), its outputs, and the peak of everything alive at once
    while it ran (arguments included)."""

    argument_bytes: int
    output_bytes: int
    peak_bytes: int


def memory_summary(peak_tracker: MemoryCounts) -> Dict:
    """The reference's keys that torch can fill.  ``temp`` is what the step
    held at its peak beyond its arguments and outputs, so
    ``peak_bytes_est = args + temp + outputs`` as the reference sums XLA's
    memory analysis (no aliasing: the port's eager step has none to
    report)."""
    args = int(peak_tracker.argument_bytes)
    outs = int(peak_tracker.output_bytes)
    temp = max(int(peak_tracker.peak_bytes) - args - outs, 0)
    return {"argument_size_in_bytes": args, "output_size_in_bytes": outs,
            "temp_size_in_bytes": temp,
            "peak_bytes_est": args + temp + outs}


def fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} PiB"


def fmt_time(s: float) -> str:
    if s >= 1.0:
        return f"{s:.3f} s"
    if s >= 1e-3:
        return f"{s * 1e3:.3f} ms"
    return f"{s * 1e6:.1f} us"



# ---------------------------------------------------------------------------
# abstract calls of the hand-written kernels on DTensor shards
# ---------------------------------------------------------------------------
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def local(t):
    """The local shard of a ``DTensor`` (``t`` itself otherwise)."""
    if type(t) is torch.Tensor or not isinstance(t, _dtensor_type()):
        return t
    return t.to_local()


def shard_like(out: torch.Tensor, ref, dim_map: Dict[int, Optional[int]],
               *, reduce_over=()) -> torch.Tensor:
    """A kernel's local result ``out`` laid out as its input ``ref``: each
    mesh dimension that splits ``ref``'s dimension ``d`` splits ``out``'s
    ``dim_map[d]``; where ``dim_map[d]`` is None (the kernel sums over
    ``d``) and for the mesh dimensions in ``reduce_over``, the partial
    results are summed by an all-reduce over that mesh dimension (issued,
    so the count records it) and ``out`` is replicated there.  A plain
    ``ref`` returns ``out``."""
    DTensor = _dtensor_type()
    if not isinstance(ref, DTensor):
        return out
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    mesh = ref.device_mesh
    placements = []
    for i, pl in enumerate(ref.placements):
        d = pl.dim if isinstance(pl, Shard) else None
        if i in reduce_over or (d is not None and dim_map.get(d) is None):
            out = funcol.wait_tensor(funcol.all_reduce(out, "sum", (mesh, i)))
            placements.append(Replicate())
        elif d is not None:
            placements.append(Shard(dim_map[d]))
        else:
            placements.append(Replicate())
    return DTensor.from_local(out, mesh, placements, run_check=False)


def split_mesh_dims(t, dim: int) -> tuple:
    """The mesh dimensions over which ``DTensor`` ``t`` splits ``dim``."""
    if not isinstance(t, _dtensor_type()):
        return ()
    from torch.distributed.tensor import Shard
    return tuple(i for i, pl in enumerate(t.placements)
                 if isinstance(pl, Shard) and pl.dim == dim)
