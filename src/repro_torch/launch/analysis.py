"""A step's counted work, the H100's roofline, and a cell's analysis.

Port of ``repro/launch/analysis.py``.  ``repro`` compiles a cell with
XLA and reads ``memory_analysis``, ``cost_analysis`` and the collectives
of the optimized HLO.  PyTorch has no SPMD compiler, so the port runs the
step itself, eagerly, and counts what it does (:func:`count_step`):

* FLOPs: ``torch.utils.flop_counter``'s formulas, the table that
  ``FlopCounterMode`` counts by (the matrix products and attention ops;
  element-wise ops count none, as in that table), applied to every op
  that reaches the dispatch mode, plus the kernels' work by formula
  (``kernels/work.py``: B6's adds, B7's products).  The ops inside a
  kernel wrapper (its plain version on a CPU tensor) are the kernel's
  and are not counted again.
* Bytes: a ``TorchDispatchMode`` adds up every op's operand and result
  bytes, a view's none, plus each kernel's bytes by formula.  A gather
  (indexing, ``embedding``, ``index_select``, ``gather``) reads the rows
  it selects, the bytes of its output, and not its whole source; an
  indexed write in place (``index_put_``, ``index_copy_``, ``index_add_``,
  ``scatter_``, ``scatter_add_``) reads its indices and values and writes
  the values' bytes, reading as many of the destination first where it
  accumulates.  This is an unfused count: an intermediate that a fused
  kernel would keep on chip is counted once written and once per read.
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
``FakeTensorMode``'s dispatch cache does.

On meta tensors this runs no arithmetic and allocates nothing, which is
how ``launch/dryrun.py`` evaluates a cell at its full shapes; on CUDA
tensors it counts the same step as it runs on the card.

``collective_bytes`` is not ported: it parses XLA's optimized HLO text,
which the port never produces, and the one-card program a cell runs has
no collective.  ``Roofline.collective_s`` is ``None`` until the port has
``torch.distributed`` calls of its own to count (ROADMAP item 4).

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W power
limit, the data sheet's dense rates: 989 TFLOP/s on the tensor cores
(bf16, fp16), 67 TFLOP/s for float32 outside them (the port's runs keep
TF32 off), 3.35 TB/s of HBM, NVLink 450 GB/s each way.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work
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
    live bytes beyond them; ``output`` the step's return value, and
    ``output_args`` for each of its tensors (:func:`tensor_leaves` order)
    the index of the argument leaf it shares storage with (an update in
    place), or None."""

    flops: float
    tensor_core_flops: float
    bytes: float
    argument_bytes: int
    peak_bytes: int
    kernels: list
    output: object
    output_args: list

    def roofline(self, n_devices: int = 1) -> "Roofline":
        """The step's roofline with its work split evenly over ``n_devices``."""
        return Roofline(self.flops / n_devices, self.bytes / n_devices, n_devices,
                        tensor_core_flops_per_device=self.tensor_core_flops / n_devices)


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
    bytes, the live storages; and the counter that ``kernels/work.py``
    reports to."""

    def __init__(self, arg_storages: set[int]):
        super().__init__()
        self.args = arg_storages
        self.flops = self.tc_flops = 0.0
        self.bytes = 0.0
        self.kernels: list[tuple[str, float, float, int]] = []
        self.kernel_tc_flops = 0.0
        self.live = self.peak = 0
        self._storages: dict[int, int] = {}
        self._meta_cache: dict = {}

    # -- kernels/work.py's counter interface ---------------------------------

    def add_kernel(self, name: str, flops: float, nbytes: float, n: int, tensor_core: bool) -> None:
        self.kernels.append((name, flops, nbytes, n))
        if tensor_core:
            self.kernel_tc_flops += flops

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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor):
                self._track(t)
        if work.hidden() or func.is_view or func in _NO_TRAFFIC:
            return out
        ins = list(_op_tensors(args, kwargs))
        self.bytes += _traffic(func, args, kwargs, ins, outs)
        formula = flop_registry.get(func._overloadpacket)
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
    """Run ``fn(*args)`` once and count its FLOPs, bytes and peak live
    bytes (see the module docstring).  ``args`` is a tuple of trees of
    tensors; on meta tensors nothing is computed or allocated."""
    arg_tensors = tensor_leaves(args)
    counter = _StepCounter({t.untyped_storage()._cdata for t in arg_tensors})
    with work.counting(counter), counter:
        out = fn(*args)
    arg_index = {t.untyped_storage()._cdata: i for i, t in enumerate(arg_tensors)}
    return StepCount(
        flops=counter.flops + sum(k[1] for k in counter.kernels),
        tensor_core_flops=float(counter.tc_flops + counter.kernel_tc_flops),
        bytes=counter.bytes + sum(k[2] for k in counter.kernels),
        argument_bytes=sum(_nbytes(t) for t in arg_tensors),
        peak_bytes=counter.peak,
        kernels=counter.kernels,
        output=out,
        output_args=[arg_index.get(t.untyped_storage()._cdata) for t in tensor_leaves(out)],
    )


@dataclasses.dataclass
class Roofline:
    """``repro``'s roofline at the H100's rates.  The compute term takes
    the tensor-core FLOPs at :data:`PEAK_FLOPS` and the rest at
    :data:`PEAK_FLOPS_F32`; the collective term is ``None`` (no
    collective is counted yet), and ``bottleneck`` is taken over the
    terms that exist."""

    flops_per_device: float
    hbm_bytes_per_device: float
    n_devices: int
    tensor_core_flops_per_device: float | None = None  # None: every FLOP on the tensor cores

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
        return None

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


def analyze_cell(plan, layout, count: StepCount | None = None) -> dict:
    """One cell on one layout: per-device argument and output bytes from
    the placements, the one-card program's counted work (``count``, or
    :func:`count_step` of the plan), its roofline with the work split
    evenly over the layout's devices, and the model FLOPs."""
    if count is None:
        count = count_step(plan.fn, plan.args)
    n_devices = layout.size
    arg_shards = [_shards(layout, p) for _, p in _placed(plan.args, plan.in_placements)]
    out_bytes = 0
    for t, i in zip(tensor_leaves(count.output), count.output_args):
        out_bytes += _nbytes(t) // (1 if i is None else arg_shards[i])  # in place: the argument's placement
    roof = count.roofline(n_devices)
    mf = model_flops("", plan.kind, plan.n_params, plan.n_active, plan.tokens)
    return {
        "memory": {
            "argument_bytes": argument_bytes(plan, layout),
            "output_bytes": out_bytes,
            "program_peak_bytes": count.peak_bytes,
        },
        "cost": {
            "flops": count.flops,
            "tensor_core_flops": count.tensor_core_flops,
            "bytes": count.bytes,
            "flops_per_device": roof.flops_per_device,
            "bytes_per_device": roof.hbm_bytes_per_device,
            "kernel_calls": _kernel_calls(count.kernels),
        },
        "collectives": None,
        "roofline": roof.as_dict(),
        "model_flops": mf,
        "useful_flops_ratio": (mf / count.flops) if count.flops else None,
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
    "memory.argument_bytes": "bytes of the arguments on one device: each leaf's bytes over the "
    "shard count of its fitted placement",
    "memory.output_bytes": "bytes of the outputs on one device: an output updated in place "
    "keeps its argument's placement, any other is counted whole (no output placement is "
    "declared)",
    "memory.program_peak_bytes": "the one-card program's peak of live bytes beyond its "
    "arguments, at the cell's global shapes; not divided by the device count",
    "cost.flops": "the one-card program's FLOPs at the global shapes: torch.utils.flop_counter's "
    "formulas plus the kernels' by formula (element-wise ops count none)",
    "cost.tensor_core_flops": "the part of cost.flops on bf16/fp16 operands",
    "cost.bytes": "the one-card program's bytes, unfused: every op's operands and results "
    "(a gather's source by the rows it reads, an indexed write by its values), plus the "
    "kernels' by formula",
    "cost.flops_per_device": "cost.flops over the device count (an even split)",
    "cost.bytes_per_device": "cost.bytes over the device count (an even split)",
    "collectives": "not counted: the one-card program has none (ROADMAP item 4)",
    "roofline": "compute (tensor-core FLOPs at 989 TFLOP/s, the rest at 67) and memory "
    "(3.35 TB/s) terms per device of one NVIDIA H100 80GB HBM3 at 700 W; no collective term",
    "model_flops": "6·N_active·tokens for training, 2·N_active·tokens for serving",
    "useful_flops_ratio": "model_flops over cost.flops",
}


