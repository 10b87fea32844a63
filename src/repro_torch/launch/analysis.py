"""A step's counted work, the H100's roofline, and a cell's analysis.

Port of ``repro/launch/analysis.py``.  ``repro`` compiles a cell with
XLA and reads ``memory_analysis``, ``cost_analysis`` and the collectives
of the optimized HLO.  PyTorch has no SPMD compiler, so the port runs the
step itself, eagerly, and counts what it does (:func:`count_step`):

* FLOPs: ``torch.utils.flop_counter``'s formulas, the table that
  ``FlopCounterMode`` counts by (the matrix products and attention ops;
  element-wise ops count none, as in that table), and 2·N·D for a
  matrix-vector product (``aten.mv``, which that table lacks:
  retrieval's candidate scores, the reference executor's meters),
  applied to every op that reaches the dispatch mode.  The kernels B6 and B7 are custom ops
  (``torch.ops.repro_torch``) whose formulas their modules register
  there (B6's adds, B7's products); the dispatch mode sees one call a
  launch, and never the ops of the plain version inside it.
* Bytes: a ``TorchDispatchMode`` adds up every op's operand and result
  bytes, a view's none, and each kernel's bytes by its formula
  (:data:`KERNELS`).  A gather (indexing, ``embedding``,
  ``index_select``, ``gather``) reads the rows it selects, the bytes of
  its output, and not its whole source; an indexed write in place
  (``index_put_``, ``index_copy_``, ``index_add_``, ``scatter_``,
  ``scatter_add_``) reads its indices and values and writes the values'
  bytes, reading as many of the destination first where it accumulates.
  This is an unfused count: an intermediate that a fused kernel would
  keep on chip is counted once written and once per read.
* Collectives: a c10d ``allreduce_``, the one c10d op the port issues
  (another raises), adds no HBM bytes: it is counted by kind, its
  calls and the bytes of the tensors it carries (the *wire* bytes, what
  the port's program issues), and whether its group holds one rank.  Beside it, each collective of
  ``dist/collectives.py`` notes itself to the counter (its
  ``note_collective``, found on the dispatch-mode stack) under
  ``repro``'s HLO kind (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``) with its *result* bytes, as
  ``repro``'s ``collective_bytes`` reads them: the *logical* bytes, which
  a native NCCL collective of that kind would produce.  The port rides
  every collective on ``all_reduce``, so its wire bytes are n times the
  logical ones for a gather or an all-to-all.  A collective over a
  one-rank group is noted apart and adds no logical bytes.
* Peak: the largest sum of live bytes of the storages the step made,
  its arguments' excluded (a storage is live from the op that makes it
  until the last tensor on it dies, autograd's saved ones included).

A meta op computes only its outputs' shapes, strides and dtypes, and
many of PyTorch's meta functions are Python references that cost 50-300
µs a call, so an LM step of ~10^6 ops would take many minutes.  The mode
therefore keeps a cache of meta results: an op that makes new tensors
from meta inputs (no view, no in-place write, no aliased return) is run
once per key (the op, each tensor input's shape, strides, offset and
dtype, every other argument's value) and answered from the cache
afterwards with new empty meta tensors of the same layout, as
``FakeTensorMode``'s dispatch cache does.  One count is one rank's
program, so the cache never holds two ranks' ops.

On meta tensors this runs no arithmetic and allocates nothing, which is
how ``launch/dryrun.py`` evaluates a cell at its full shapes, a rank's
program under a ``fake`` process group (``launch/mesh.py``); on CUDA
tensors it counts the same step as it runs on the card.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power
limit, the data sheet's dense rates: 989 TFLOP/s on the tensor cores
(bf16, fp16), 67 TFLOP/s for float32 outside them (the port's runs keep
TF32 off), 3.35 TB/s of HBM, NVLink 450 GB/s each way.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.decode_attn import decode_attn
from repro_torch.kernels.embedbag import embedbag
from repro_torch.training.tree import leaves

PEAK_FLOPS = 989e12  # bf16 / fp16 on the tensor cores, dense
PEAK_FLOPS_F32 = 67e12  # float32 outside the tensor cores
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s each way over NVLink

_TENSOR_CORE = (torch.bfloat16, torch.float16)
# ops that move no bytes: allocation without a write, and host reads
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten._local_scalar_dense.default,
}
# ops that read the rows their output holds from their first argument
_GATHERS = {
    torch.ops.aten.index.Tensor, torch.ops.aten.embedding.default,
    torch.ops.aten.index_select.default, torch.ops.aten.gather.default,
}
# indexed writes in place into their first argument, the values last of
# their tensors: whether each accumulates (reads the rows it writes)
_INDEX_WRITES = {
    torch.ops.aten.index_put_.default: None,  # its ``accumulate`` argument decides
    torch.ops.aten._index_put_impl_.default: None,
    torch.ops.aten.index_copy_.default: False,
    torch.ops.aten.scatter_.src: False,
    torch.ops.aten.index_add_.default: True,
    torch.ops.aten.scatter_add_.default: True,
}
# the kernels' custom ops: name and work formula (flops, bytes, n,
# tensor_core) of the op's arguments, which charges its bytes
KERNELS = {
    torch.ops.repro_torch.embedding_bag_sorted.default: ("embedding_bag_sorted", embedbag.bag_work),
    torch.ops.repro_torch.flash_decode_gqa.default: ("flash_decode_gqa", decode_attn.decode_work),
    torch.ops.repro_torch.flash_decode_gqa_partials.default: ("flash_decode_gqa_partials",
                                                             decode_attn.partials_work),
    torch.ops.repro_torch.flash_decode_combine.default: ("flash_decode_combine", decode_attn.combine_work),
}
# FLOP formulas of the ops that torch.utils.flop_counter's table lacks
_FLOPS = {torch.ops.aten.mv: lambda a, v, **_: 2 * a.shape[0] * a.shape[1]}
# the c10d ops the port issues (every collective rides on all_reduce), by
# the argument that holds the tensors each carries; another raises
_C10D = {torch.ops.c10d.allreduce_.default: 0}
# repro's HLO kinds that the port's collectives note, as repro's
# collective_bytes reports them
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dictionaries, lists and tuples, in
    ``training.tree.leaves`` order."""
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_tensors(args, kwargs):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (x for x in a if isinstance(x, torch.Tensor))
    for a in kwargs.values():
        if isinstance(a, torch.Tensor):
            yield a


@dataclasses.dataclass
class StepCount:
    """What :func:`count_step` counted.  ``flops`` and ``bytes`` include
    the kernels' (``kernels``: one (name, flops, bytes, n) a call);
    ``tensor_core_flops`` is the part on bf16/fp16 operands;
    ``argument_bytes`` the arguments' bytes; ``peak_bytes`` the peak of
    live bytes beyond them; ``output`` the step's return value.
    ``collectives``: per ``repro`` kind the calls over
    more than one rank and their logical (result) bytes, and the calls
    over one rank; ``wire``: per c10d op the calls, the bytes of the
    tensors they carried and the calls over one rank.  Both empty when
    the step issued no collective."""

    flops: float
    tensor_core_flops: float
    bytes: float
    argument_bytes: int
    peak_bytes: int
    kernels: list
    output: object
    collectives: dict = dataclasses.field(default_factory=dict)
    wire: dict = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float | None:
        """The logical bytes of every collective, or None when the step
        issued none."""
        if not (self.collectives or self.wire):
            return None
        return float(sum(c["bytes"] for c in self.collectives.values()))

    def roofline(self) -> "Roofline":
        """The step's roofline: its own work on one device (a rank's count
        is that rank's)."""
        return Roofline(self.flops, self.bytes, 1, tensor_core_flops_per_device=self.tensor_core_flops,
                        collective_bytes_per_device=self.collective_bytes)


_CACHEABLE: dict = {}  # op -> whether its meta results can be cached


def _cacheable(func) -> bool:
    """An op that returns new tensors only: no view, no mutated argument,
    no aliased or non-tensor return."""
    ok = _CACHEABLE.get(func)
    if ok is None:
        schema = func._schema
        ok = _CACHEABLE[func] = (
            not func.is_view and not schema.is_mutable and len(schema.returns) > 0
            and all(r.alias_info is None and isinstance(r.type, torch.TensorType) for r in schema.returns)
        )
    return ok


def _key(x):
    """A hashable key of one argument; None where a tensor is not meta."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            return None
        return (tuple(x.shape), x.stride(), x.storage_offset(), x.dtype)
    if isinstance(x, (list, tuple)):
        parts = tuple(_key(v) for v in x)
        return None if any(p is None and v is not None for p, v in zip(parts, x)) else ("seq", parts)
    return (type(x), x)


class _StepCounter(TorchDispatchMode):
    """:func:`count_step`'s dispatch mode: every op's FLOPs by
    ``torch.utils.flop_counter``'s formulas, its operand and result
    bytes, the live storages, the kernels' calls by formula, the c10d
    ops by kind; and the logical collectives that ``dist/collectives.py``
    notes (:meth:`note_collective`)."""

    def __init__(self, arg_storages: set[int]):
        super().__init__()
        self.args = arg_storages
        self.flops = self.tc_flops = 0.0
        self.bytes = 0.0
        self.kernels: list[tuple[str, float, float, int]] = []
        self.kernel_tc_flops = 0.0
        self.collectives: dict[str, dict] = {}
        self.wire: dict[str, dict] = {}
        self.live = self.peak = 0
        self._storages: dict[int, int] = {}
        self._meta_cache: dict = {}

    # -- dist/collectives.py's record of each logical collective --------------

    def note_collective(self, kind: str, nbytes: int, wire_bytes: int, n_ranks: int) -> None:
        """One collective of ``repro``'s ``kind`` over ``n_ranks`` ranks,
        whose result holds ``nbytes`` and whose ``all_reduce`` carries
        ``wire_bytes``."""
        c = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0, "wire_bytes": 0, "one_rank_calls": 0})
        c["wire_bytes"] += wire_bytes
        if n_ranks > 1:
            c["calls"] += 1
            c["bytes"] += nbytes
        else:
            c["one_rank_calls"] += 1

    # -- the dispatch mode -----------------------------------------------------

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.args or key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``, from the meta cache where it can be."""
        if not _cacheable(func):
            return func(*args, **kwargs)
        key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        if None in key:
            return func(*args, **kwargs)
        hit = self._meta_cache.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else (out,)
            if all(isinstance(t, torch.Tensor) and t.is_meta for t in outs):
                layouts = tuple((tuple(t.shape), t.stride(), t.dtype) for t in outs)
                self._meta_cache[key] = (isinstance(out, (list, tuple)), layouts)
            return out
        is_seq, layouts = hit
        outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                for shape, stride, dtype in layouts]
        return tuple(outs) if is_seq else outs[0]

    def _kernel(self, func, args, kwargs, out) -> None:
        """One call of a kernel's custom op: its FLOPs by the formula its
        module registered with ``torch.utils.flop_counter``, its bytes by
        :data:`KERNELS`' formula."""
        name, work = KERNELS[func]
        _, nbytes, n, tensor_core = work(*args, **kwargs)
        flops = flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        self.kernels.append((name, flops, nbytes, n))
        if tensor_core:
            self.kernel_tc_flops += flops

    def _c10d(self, func, args) -> None:
        """One c10d op: its calls, the bytes it carries, and its group's
        size; no HBM bytes."""
        carried = args[_C10D[func]]
        tensors = [t for t in (carried if isinstance(carried, (list, tuple)) else [carried])
                   for t in (t if isinstance(t, (list, tuple)) else [t])]
        group = next(a for a in args if isinstance(a, torch.ScriptObject))
        w = self.wire.setdefault(func._schema.name.split("::")[-1], {"calls": 0, "bytes": 0, "one_rank_calls": 0})
        w["calls"] += 1
        w["bytes"] += sum(_nbytes(t) for t in tensors)
        w["one_rank_calls"] += dist.ProcessGroup.unbox(group).size() == 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor):
                self._track(t)
        if func in KERNELS:
            self._kernel(func, args, kwargs, out)
            return out
        if func in _C10D:
            self._c10d(func, args)
            return out
        if func.namespace == "c10d":
            raise NotImplementedError(f"count_step counts no {func}: the port's collectives ride on all_reduce")
        if func.is_view or func in _NO_TRAFFIC:
            return out
        ins = list(_op_tensors(args, kwargs))
        self.bytes += _traffic(func, args, kwargs, ins, outs)
        formula = _FLOPS.get(func._overloadpacket) or flop_registry.get(func._overloadpacket)
        if formula is not None:
            flops = formula(*args, **kwargs, out_val=out)
            self.flops += flops
            if ins and ins[0].dtype in _TENSOR_CORE:
                self.tc_flops += flops
        return out


def _traffic(func, args, kwargs, ins: list, outs) -> int:
    """The bytes one op moves (see the module docstring)."""
    written = sum(_nbytes(t) for t in outs if isinstance(t, torch.Tensor))
    if func in _GATHERS:
        return sum(_nbytes(t) for t in ins[1:]) + 2 * written
    if func in _INDEX_WRITES:
        accumulate = _INDEX_WRITES[func]
        if accumulate is None:
            accumulate = bool(kwargs.get("accumulate", args[3] if len(args) > 3 else False))
        values = _nbytes(ins[-1])
        return sum(_nbytes(t) for t in ins[1:]) + values * (2 if accumulate else 1)
    return sum(_nbytes(t) for t in ins) + written


def count_step(fn, args: tuple) -> StepCount:
    """Run ``fn(*args)`` once and count its FLOPs, bytes, peak live bytes
    and collectives (see the module docstring).  ``args`` is a tuple of
    trees of tensors; on meta tensors nothing is computed or allocated."""
    arg_tensors = tensor_leaves(args)
    counter = _StepCounter({t.untyped_storage()._cdata for t in arg_tensors})
    with counter:
        out = fn(*args)
    return StepCount(
        flops=counter.flops + sum(k[1] for k in counter.kernels),
        tensor_core_flops=float(counter.tc_flops + counter.kernel_tc_flops),
        bytes=counter.bytes + sum(k[2] for k in counter.kernels),
        argument_bytes=sum(_nbytes(t) for t in arg_tensors),
        peak_bytes=counter.peak,
        kernels=counter.kernels,
        output=out,
        collectives=counter.collectives,
        wire=counter.wire,
    )


@dataclasses.dataclass
class Roofline:
    """``repro``'s three-term roofline at the H100's rates.  The compute
    term takes the tensor-core FLOPs at :data:`PEAK_FLOPS` and the rest
    at :data:`PEAK_FLOPS_F32`; the collective term the logical collective
    bytes at :data:`LINK_BW`, the least time a native collective over
    NVLink could take (``None`` for a program that issues no
    collective); ``bottleneck`` is taken over the terms that exist."""

    flops_per_device: float
    hbm_bytes_per_device: float
    n_devices: int
    tensor_core_flops_per_device: float | None = None  # None: every FLOP on the tensor cores
    collective_bytes_per_device: float | None = None  # None: no collective issued

    @property
    def compute_s(self) -> float:
        tc = self.flops_per_device if self.tensor_core_flops_per_device is None else (
            self.tensor_core_flops_per_device)
        return tc / PEAK_FLOPS + (self.flops_per_device - tc) / PEAK_FLOPS_F32

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float | None:
        if self.collective_bytes_per_device is None:
            return None
        return self.collective_bytes_per_device / LINK_BW

    def _terms(self) -> dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_s is not None:
            terms["collective"] = self.collective_s
        return terms

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    def roofline_fraction(self) -> float:
        """bound_s over the sum of the terms: the overlap headroom."""
        total = sum(self._terms().values())
        return self.bound_s / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "bound_s": self.bound_s,
            "overlap_headroom": self.roofline_fraction(),
        }


def model_flops(family: str, kind: str, n_params: int, n_active: int, tokens: int) -> float:
    """MODEL_FLOPS: 6·N·D for training (forward and backward), 2·N_active·D
    for serving."""
    if kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


def _shards(layout, placement) -> int:
    """How many pieces ``placement`` cuts a tensor into on ``layout``."""
    sizes = layout.shape
    n = 1
    for entry in placement:
        for name in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            n *= sizes[name]
    return n


def _placed(args, placements) -> list[tuple[torch.Tensor, tuple]]:
    """(tensor, fitted placement) for every argument leaf, in
    :func:`tensor_leaves` order."""
    if isinstance(args, torch.Tensor):
        return [(args, placements)]
    if isinstance(args, dict):
        return [p for k in sorted(args) for p in _placed(args[k], placements[k])]
    return [p for a, s in zip(args, placements) for p in _placed(a, s)]


def argument_bytes(plan, layout) -> int:
    """The plan's argument bytes on one device of ``layout``: each leaf's
    bytes over the shard count of its fitted placement."""
    return sum(_nbytes(t) // _shards(layout, p) for t, p in _placed(plan.args, plan.in_placements))


def collectives_record(count: StepCount) -> dict | None:
    """A count's collectives as the dry run reports them: per ``repro``
    kind the calls over more than one rank, their logical bytes, the
    port's wire bytes and the calls over one rank; ``n_ops``, ``bytes``
    and ``wire_bytes`` over every kind; ``wire``, per c10d op.  None when
    the program issued no collective."""
    if count.collective_bytes is None:
        return None
    out: dict = {k: dict(count.collectives.get(k, {"calls": 0, "bytes": 0, "wire_bytes": 0,
                                                   "one_rank_calls": 0})) for k in KINDS}
    for k, c in count.collectives.items():
        out.setdefault(k, dict(c))
    kinds = list(out.values())
    out.update({"n_ops": sum(c["calls"] for c in kinds), "bytes": sum(c["bytes"] for c in kinds),
                "wire_bytes": sum(c["wire_bytes"] for c in kinds), "wire": count.wire})
    return out


def even_split(count: StepCount, one_card: StepCount, n_devices: int) -> dict:
    """The one-card program's counts, its FLOPs and bytes split evenly
    over ``n_devices``, and the ratio of the rank's FLOPs to that split."""
    even_flops = one_card.flops / n_devices
    return {
        "flops": one_card.flops,
        "tensor_core_flops": one_card.tensor_core_flops,
        "bytes": one_card.bytes,
        "kernel_calls": _kernel_calls(one_card.kernels),
        "flops_per_device": even_flops,
        "bytes_per_device": one_card.bytes / n_devices,
        "flops_ratio": count.flops / even_flops if even_flops else None,
    }


def analyze_cell(plan, layout, count: StepCount | None = None, one_card: StepCount | None = None) -> dict:
    """One cell on one layout.  ``count`` is the rank's program
    (default: :func:`count_step` of ``plan.rank``, or of the one-card
    program where the plan has none, as on a described layout),
    ``one_card`` the one-card program at the global shapes (``None``: no
    even split is reported).  Reports per device: ``repro``'s argument
    bytes from its placements, the rank's argument, output and peak
    bytes, its FLOPs, bytes and collectives, its three-term roofline, the
    one-card program's even split over the layout's devices with the
    ratio of the rank's FLOPs to it, and the model FLOPs."""
    if count is None:
        count = count_step(plan.fn, plan.args) if plan.rank is None else count_step(plan.rank.fn, plan.rank.args)
    n_devices = layout.size
    roof = count.roofline()
    mf = model_flops("", plan.kind, plan.n_params, plan.n_active, plan.tokens)
    return {
        "memory": {
            "argument_bytes": argument_bytes(plan, layout),
            "output_bytes": sum(_nbytes(t) for t in tensor_leaves(count.output)),
            "program_peak_bytes": count.peak_bytes,
        },
        "cost": {
            "flops": count.flops,
            "tensor_core_flops": count.tensor_core_flops,
            "bytes": count.bytes,
            "flops_per_device": roof.flops_per_device,
            "bytes_per_device": roof.hbm_bytes_per_device,
            "kernel_calls": _kernel_calls(count.kernels),
            "rank_argument_bytes": count.argument_bytes,
            "even_split": None if one_card is None else even_split(count, one_card, n_devices),
        },
        "collectives": collectives_record(count),
        "roofline": roof.as_dict(),
        "model_flops": mf,
        "useful_flops_ratio": (mf / (count.flops * n_devices)) if count.flops else None,
    }


def _kernel_calls(kernels) -> dict[str, dict]:
    out: dict[str, dict] = {}
    for name, flops, nbytes, _ in kernels:
        k = out.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
    return out


FIELDS = {
    "memory.argument_bytes": "bytes of the arguments on one device under repro's placements: each "
    "leaf's bytes over the shard count of its fitted placement",
    "memory.output_bytes": "bytes of the rank's outputs (a leaf updated in place is the rank's "
    "own block)",
    "memory.program_peak_bytes": "the rank's program's peak of live bytes beyond its arguments "
    "(the schema keeps memory to these three keys: the rank's argument bytes are "
    "cost.rank_argument_bytes)",
    "cost.flops": "FLOPs of the program that rank 0 runs at the layout: torch.utils.flop_counter's "
    "formulas plus the kernels' by formula (element-wise ops count none)",
    "cost.tensor_core_flops": "the part of cost.flops on bf16/fp16 operands",
    "cost.bytes": "the rank's bytes, unfused: every op's operands and results (a gather's source "
    "by the rows it reads, an indexed write by its values), plus the kernels' by formula; "
    "collectives move none",
    "cost.flops_per_device": "cost.flops: the rank's own work",
    "cost.bytes_per_device": "cost.bytes: the rank's own work",
    "cost.kernel_calls": "the rank's kernel calls, FLOPs and bytes by kernel",
    "cost.rank_argument_bytes": "bytes of the arguments the rank's program holds: its own blocks "
    "under the placements the program reads, and what it takes whole",
    "cost.even_split": "the one-card program at the cell's global shapes (flops, bytes, "
    "kernel_calls), its FLOPs and bytes over the device count, and flops_ratio, the rank's "
    "FLOPs over that even split (above 1: work a rank repeats)",
    "collectives": "per repro HLO kind (all-reduce, all-gather, reduce-scatter, all-to-all): calls over more than one rank, bytes (logical: the collective's result, "
    "as repro's collective_bytes reads it), wire_bytes (what the port's all_reduce carries) and "
    "one_rank_calls; n_ops, bytes and wire_bytes over the kinds; wire, per c10d op (calls, bytes, "
    "one_rank_calls); null when the rank's program issues no collective",
    "roofline": "compute (tensor-core FLOPs at 989 TFLOP/s, the rest at 67), memory (3.35 TB/s) "
    "and collective (the logical bytes at NVLink's 450 GB/s; null without a collective) terms of "
    "the rank on one NVIDIA H100 80GB HBM3 at 700 W",
    "model_flops": "6·N_active·tokens for training, 2·N_active·tokens for serving",
    "useful_flops_ratio": "model_flops over cost.flops times the device count",
}
