"""The reconfigurable-SIMD "ISA" — paper §2 mapped onto PyTorch on an H100.

The paper adds two instruction *types* to RV32IM:

  I'-type:  rd, rs1  +  vrs1, vrs2 (vector sources), vrd1, vrd2 (vector
            destinations) — up to 6 operands in one instruction.
  S'-type:  rd, rs1, rs2 (two scalar sources, e.g. base+index for vector
            load/store) + vrs1 / vrd1 and a small immediate.

and vector register v0 is hard-wired to 0 so unused operand slots alias
to it (optional operands).

Here an :class:`Instruction` is the software form of one reconfigurable
region: a named primitive with

  * an operand signature checked against the I'/S' limits,
  * ``ref``      — the torch-eager oracle ("the base RV32IM core runs it in
                   software"),
  * ``kernel``   — the hand-written GPU implementation ("the FPGA region"),
                   accepting ``interpret=`` to run its plain PyTorch
                   emulator instead,
  * ``pipeline_depth`` — the paper's ``c1_cycles`` metadata.

Dispatch modes: ``ref`` is the softcore *without* the SIMD unit,
``kernel`` is with it, ``interpret`` runs the kernel's plain PyTorch
emulator (same grid walk, any device), and ``auto`` picks by where the
caller put its tensors: ``kernel`` for CUDA tensors, ``ref`` for CPU
tensors. There is no hidden fallback: ``kernel`` on CPU tensors raises,
and a kernel that fails to build or launch raises.

Beyond single instructions, :meth:`Registry.fuse` compiles a linear
chain into one reconfigurable region (the P'-type encoding below) that
runs as ONE launch of the fused kernel. Graph tracing hooks into
dispatch via :func:`push_dispatch_hook`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence

import torch

from .stream import StreamConfig


def _on_cuda(operands) -> bool:
    return any(isinstance(o, torch.Tensor) and o.is_cuda for o in operands)


def check_grad(name: str, mode: str, operands: Sequence[Any],
               differentiable: bool = False) -> None:
    """No silent loss of a gradient: a ``kernel`` or ``interpret``
    dispatch of an instruction without a backward raises while grad mode
    is on and an operand requires grad (its output would come out
    detached). The oracle (``ref``) is differentiated by autograd."""
    if (mode in ("kernel", "interpret") and not differentiable
            and torch.is_grad_enabled()
            and any(isinstance(o, torch.Tensor) and o.requires_grad
                    for o in operands)):
        raise ValueError(
            f"{name}: its {mode} path has no backward, and an operand "
            f"requires grad; call it under torch.no_grad(), detach the "
            f"operand, or use mode='ref'")


def resolve_auto(mode: str, operands: Sequence[Any] = ()) -> str:
    """The single owner of the 'auto' dispatch rule: ``kernel`` iff the
    caller placed its tensors on a CUDA device, the oracle for CPU
    tensors. The device is the caller's explicit choice; nothing here
    falls back from a kernel to the oracle."""
    if mode == "auto":
        return "kernel" if _on_cuda(operands) else "ref"
    return mode


# Dispatch interception (LIFO). A hook is called as
# ``hook(registry, name, operands, kwargs)`` before normal dispatch and
# returns ``NotImplemented`` to decline; anything else short-circuits the
# dispatch (the graph tracer records symbolic operands this way).
_DISPATCH_HOOKS: list = []


def push_dispatch_hook(hook) -> None:
    _DISPATCH_HOOKS.append(hook)


def pop_dispatch_hook(hook) -> None:
    _DISPATCH_HOOKS.remove(hook)


# Operand ceilings from the encodings in Fig. 1 of the paper.
ITYPE_LIMITS = {
    # itype: (scalar_in, scalar_out, vector_in, vector_out, total)
    "I'": (1, 1, 2, 2, 6),
    "S'": (2, 1, 1, 1, 5),
    # P'-type: the widened encoding of a FUSED program. A fused chain is one
    # reconfigurable region, so it gets a double-width I' operand budget for
    # its merged external operand list (per-stage I'/S' limits still applied
    # at registration; see Registry.fuse / core/program.py).
    "P'": (2, 2, 4, 4, 12),
}


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """Operand signature of one instruction (paper Fig. 1)."""

    itype: str = "I'"
    scalar_in: int = 0
    scalar_out: int = 0
    vector_in: int = 1
    vector_out: int = 1

    def __post_init__(self):
        if self.itype not in ITYPE_LIMITS:
            raise ValueError(f"unknown instruction type {self.itype!r}; "
                             f"have {sorted(ITYPE_LIMITS)}")
        si, so, vi, vo, tot = ITYPE_LIMITS[self.itype]
        if self.scalar_in > si or self.scalar_out > so:
            raise ValueError(f"{self.itype}: at most {si} scalar sources / "
                             f"{so} scalar destinations")
        if self.vector_in > vi or self.vector_out > vo:
            raise ValueError(f"{self.itype}: at most {vi} vector sources / "
                             f"{vo} vector destinations")
        if self.n_operands > tot:
            raise ValueError(f"{self.itype}: {self.n_operands} operands "
                             f"exceed the {tot}-operand encoding budget")
        if min(self.scalar_in, self.scalar_out,
               self.vector_in, self.vector_out) < 0:
            raise ValueError("operand counts must be non-negative")

    @property
    def n_operands(self) -> int:
        return (self.scalar_in + self.scalar_out
                + self.vector_in + self.vector_out)

    @property
    def n_inputs(self) -> int:
        return self.scalar_in + self.vector_in

    @property
    def n_outputs(self) -> int:
        return self.scalar_out + self.vector_out


@dataclasses.dataclass
class Instruction:
    """One reconfigurable SIMD instruction (template instance, paper §2.2)."""

    name: str
    spec: OperandSpec
    ref: Callable[..., Any]
    kernel: Optional[Callable[..., Any]] = None
    pipeline_depth: int = 1          # paper's c*_cycles
    stream: StreamConfig = dataclasses.field(default_factory=StreamConfig)
    doc: str = ""
    # KernelTemplate whose Stage this instruction contributes to fused
    # programs (Registry.fuse). None → not fusable. The oracle convention
    # for fusion is ``ref(*vectors, *scalars)``.
    template: Optional[Any] = None
    # whether the kernel path carries gradients (a torch.autograd.Function
    # with a backward); without one, check_grad refuses operands that
    # require grad on the kernel and interpret paths
    differentiable: bool = False

    def __post_init__(self):
        if not callable(self.ref):
            raise TypeError(f"{self.name}: ref must be callable")

    def __call__(self, *operands, mode: Optional[str] = None, **kw):
        return _REGISTRY.dispatch(self.name, *operands, mode=mode, **kw)


def fuse_chain(instrs: Sequence[Instruction], name: Optional[str] = None,
               model: Any = None, smem_budget: Optional[int] = None):
    """Validate + compile one chain of registered instructions.

    Returns ``(Program, OperandSpec)``: the fused single-launch program
    and its merged P'-type operand spec. Raises ValueError on
    non-template instructions, incomposable chains (shape-changing or
    arity-mismatched stages) and P'-budget overflows.
    """
    from .program import Program      # deferred: program is isa-free
    instrs = tuple(instrs)
    if not instrs:
        raise ValueError("fuse_chain() needs at least one instruction")
    for instr in instrs:
        if instr.template is None:
            raise ValueError(
                f"{instr.name}: not fusable — no KernelTemplate "
                f"registered (template-backed instructions only)")
    kw: dict = {}
    if model is not None:
        kw["model"] = model
    if smem_budget is not None:
        kw["smem_budget"] = smem_budget
    prog = Program(tuple(i.template.stage() for i in instrs),
                   name=name or "+".join(i.name for i in instrs), **kw)
    # the merged external operand list IS the fused encoding: validate
    # it against the widened P' budget (raises ValueError on exceed).
    spec = OperandSpec(itype="P'", scalar_in=prog.n_scalar_in,
                       scalar_out=0, vector_in=prog.n_ext_vec_in,
                       vector_out=prog.n_vec_out)
    return prog, spec


@dataclasses.dataclass
class FusedProgram:
    """A chain of registered instructions fused into one kernel launch.

    Built by :meth:`Registry.fuse`. Dispatch honours the registry modes:
      * ``ref``       — function composition of the per-stage oracles (the
                        base core runs the whole chain in software);
      * ``kernel``    — the fused Program's single K1 launch (CUDA tensors);
      * ``interpret`` — the K1 emulator in plain PyTorch, same grid walk;
      * ``auto``      — kernel for CUDA tensors, else ref.

    Operand order: for each stage in chain order, its scalars then its
    non-chained vector operands (see ``core/program.py``).
    """

    name: str
    spec: OperandSpec                    # merged external list, P'-type
    instrs: tuple
    program: Any                         # repro_torch.core.program.Program
    registry: "Registry"

    def __call__(self, *operands, mode: Optional[str] = None):
        if len(operands) != self.spec.n_inputs:
            raise TypeError(
                f"{self.name}: expected {self.spec.n_inputs} operands "
                f"({self.spec.scalar_in} scalar + {self.spec.vector_in} "
                f"vector, per-stage order), got {len(operands)}")
        mode = mode or self.registry.mode
        if mode not in Registry.MODES:
            raise ValueError(f"mode must be one of {Registry.MODES}")
        mode = resolve_auto(mode, operands)
        check_grad(self.name, mode, operands)
        if mode == "ref":
            # ref composes oracles on the original shapes; reject exactly
            # the operand lists the kernel path (validated inside
            # Program.__call__) would reject.
            self.program.check_vector_operands(operands)
            return self._ref(*operands)
        return self.program(*operands, interpret=(mode == "interpret"))

    def _ref(self, *operands):
        """Compose the registered oracles — fused correctness for free."""
        per_stage = self.program.split_operands(operands)
        outs: tuple = ()
        for instr, (scalars, ext) in zip(self.instrs, per_stage):
            ins = tuple(outs) + tuple(ext)
            res = instr.ref(*ins, *scalars)
            outs = res if isinstance(res, tuple) else (res,)
        return outs[0] if len(outs) == 1 else outs

    def pipeline_depth(self) -> int:
        return self.program.pipeline_depth()


class Registry:
    """Instruction registry + dispatch ("binutils patch + decoder")."""

    MODES = ("ref", "kernel", "interpret", "auto")

    def __init__(self):
        self._instrs: dict[str, Instruction] = {}
        self._tls = threading.local()
        # fuse() results by (names, display name): a fused chain is
        # immutable once built, so repeated fuse() calls reuse the same
        # FusedProgram — and with it the Program's warm dispatch caches.
        self._fuse_cache: dict[tuple, "FusedProgram"] = {}

    # -- registration --------------------------------------------------------
    def register(self, instr: Instruction, *, overwrite: bool = False) -> Instruction:
        if instr.name in self._instrs and not overwrite:
            raise ValueError(f"instruction {instr.name!r} already registered")
        self._instrs[instr.name] = instr
        # a (re)registered instruction may change any chain containing it
        self._fuse_cache.clear()
        return instr

    def define(self, name: str, *, itype: str = "I'", scalar_in: int = 0,
               scalar_out: int = 0, vector_in: int = 1, vector_out: int = 1,
               pipeline_depth: int = 1, stream: Optional[StreamConfig] = None,
               doc: str = "", kernel: Optional[Callable] = None,
               differentiable: bool = False, overwrite: bool = False):
        """Decorator form: ``@isa.define("c2_sort", vector_in=1, ...)``.

        The decorated function becomes the instruction's oracle (``ref``);
        ``kernel`` (or a later :meth:`bind_kernel`) is its GPU path, called
        with ``interpret=``. The operand counts are checked against the
        I'/S' budgets here, before anything is registered."""
        spec = OperandSpec(itype=itype, scalar_in=scalar_in,
                           scalar_out=scalar_out, vector_in=vector_in,
                           vector_out=vector_out)

        def deco(ref_fn: Callable) -> Instruction:
            instr = Instruction(
                name=name, spec=spec, ref=ref_fn, kernel=kernel,
                pipeline_depth=pipeline_depth,
                stream=stream or StreamConfig(), doc=doc or ref_fn.__doc__ or "",
                differentiable=differentiable)
            return self.register(instr, overwrite=overwrite)

        return deco

    def bind_kernel(self, name: str, kernel: Callable) -> None:
        """Attach/replace the GPU implementation of an instruction."""
        self.get(name).kernel = kernel

    # -- fusion ---------------------------------------------------------------
    def fuse(self, *names: str, name: Optional[str] = None) -> FusedProgram:
        """Fuse registered instructions into one reconfigurable region.

        ``fuse("c0_scale", "c0_add")(s, x, b)`` lowers to a single K1
        launch computing ``add(scale(s, x), b)``. Raises ValueError at
        fuse() time if the chain doesn't compose (shape-changing stages,
        output/input arity mismatch) or if the merged external operand
        list exceeds the widened P'-type encoding budget.

        Repeated fuse() of the same chain returns the SAME FusedProgram
        (invalidated when any instruction is re-registered), so hot
        dispatch paths share the Program's warm caches. Treat the result
        as immutable.
        """
        if not names:
            raise ValueError("fuse() needs at least one instruction name")
        key = (tuple(names), name)
        cached = self._fuse_cache.get(key)
        if cached is not None:
            return cached
        instrs = tuple(self.get(n) for n in names)
        prog, spec = fuse_chain(instrs, name=name or "+".join(names))
        fused = FusedProgram(name=prog.name, spec=spec, instrs=instrs,
                             program=prog, registry=self)
        self._fuse_cache[key] = fused
        return fused

    # -- lookup ---------------------------------------------------------------
    def get(self, name: str) -> Instruction:
        try:
            return self._instrs[name]
        except KeyError as e:
            raise KeyError(
                f"unknown instruction {name!r}; registered: "
                f"{sorted(self._instrs)}") from e

    def __contains__(self, name: str) -> bool:
        return name in self._instrs

    def names(self) -> list[str]:
        return sorted(self._instrs)

    # -- dispatch -------------------------------------------------------------
    @property
    def mode(self) -> str:
        return getattr(self._tls, "mode", "auto")

    @contextlib.contextmanager
    def use(self, mode: str):
        """Select implementation: 'ref' (base core, no SIMD unit),
        'kernel' (GPU kernel, CUDA tensors), 'interpret' (the kernel's
        plain PyTorch emulator), 'auto' (kernel for CUDA tensors, else
        ref)."""
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}")
        prev = self.mode
        self._tls.mode = mode
        try:
            yield self
        finally:
            self._tls.mode = prev

    def _resolve(self, instr: Instruction, mode: Optional[str],
                 operands) -> str:
        requested = mode or self.mode
        mode = resolve_auto(requested, operands)
        if requested == "auto" and mode == "kernel" and instr.kernel is None:
            mode = "ref"                 # a ref-only instruction has no kernel
        if mode in ("kernel", "interpret") and instr.kernel is None:
            raise ValueError(f"{instr.name}: no GPU kernel bound "
                             f"(ref-only instruction)")
        return mode

    def dispatch(self, name: str, *operands, mode: Optional[str] = None, **kw):
        if _DISPATCH_HOOKS:
            for hook in reversed(_DISPATCH_HOOKS):
                res = hook(self, name, operands, dict(kw, mode=mode))
                if res is not NotImplemented:
                    return res
        instr = self.get(name)
        if len(operands) != instr.spec.n_inputs:
            raise TypeError(
                f"{name}: expected {instr.spec.n_inputs} input operands "
                f"({instr.spec.scalar_in} scalar + {instr.spec.vector_in} "
                f"vector), got {len(operands)}")
        m = self._resolve(instr, mode, operands)
        check_grad(name, m, operands, instr.differentiable)
        if m == "ref":
            return instr.ref(*operands, **kw)
        return instr.kernel(*operands, interpret=(m == "interpret"), **kw)

    call = dispatch


# The global ISA — the process-wide "decoder table".
_REGISTRY = Registry()

register = _REGISTRY.register
define = _REGISTRY.define
bind_kernel = _REGISTRY.bind_kernel
fuse = _REGISTRY.fuse
get = _REGISTRY.get
names = _REGISTRY.names
use = _REGISTRY.use
call = _REGISTRY.dispatch
registry = _REGISTRY


def current_mode() -> str:
    return _REGISTRY.mode
