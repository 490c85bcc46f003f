"""The Stripe IR (paper §3.2).

A ``Block`` is a parallel polyhedral block: a polyhedral iteration space
(named indices with ranges + affine constraints), a *single* statement list
(identical across iterations), explicitly declared I/O via ``Refinement``\\ s
(views of parent buffers with per-dimension affine offsets, shapes, strides,
an aggregation op for outputs, and an optional hardware ``Location``), and
free-form ``tags`` carrying pass-to-pass metadata with no semantic meaning.

Statements are: nested ``Block``\\ s, scalar ``Load``/``Store``/``Intrinsic``/
``Constant`` ops, or ``Special`` tensor functions (gather/scatter-like ops
that are inappropriate to express as scalar blocks).

Offsets in a refinement are expressed in the *parent view's* element
coordinates; chains of refinements therefore compose by addition, which is
what makes aliasing analysis tractable (§3.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

from .affine import Affine, aff
from .poly import Constraint, Index, Polyhedron

# --------------------------------------------------------------------------
# Aggregation operations (Def. 2's associative+commutative A_D, plus assign)
# --------------------------------------------------------------------------
AGG_OPS = ("assign", "add", "max", "min", "mul")

AGG_IDENTITY = {"add": 0.0, "max": float("-inf"), "min": float("inf"), "mul": 1.0}


class RefDir:
    NONE = "none"  # allocation only (temporary defined at this level)
    IN = "in"
    OUT = "out"
    INOUT = "inout"


@dataclasses.dataclass(frozen=True)
class Location:
    """Hardware placement of a buffer: memory unit name, optional bank
    (affine in the block indices) and address."""

    unit: str = ""
    bank: Optional[Affine] = None
    addr: Optional[int] = None

    def __str__(self) -> str:
        s = self.unit
        if self.bank is not None:
            s += f"[{self.bank}]"
        if self.addr is not None:
            s += f"@{self.addr:#x}"
        return s


@dataclasses.dataclass
class Refinement:
    dir: str  # RefDir
    from_buf: str  # name in the parent scope ("" => top-level/external)
    into: str  # name visible inside this block
    offsets: Tuple[Affine, ...]  # per-dim start, affine in parent+own idxs
    shape: Tuple[int, ...]  # view extent per dim
    dtype: str = "float32"
    strides: Optional[Tuple[int, ...]] = None  # element strides (layout)
    agg: Optional[str] = None  # aggregation for OUT refinements
    location: Optional[Location] = None
    tags: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        self.offsets = tuple(aff(o) for o in self.offsets)
        self.shape = tuple(int(s) for s in self.shape)
        if len(self.offsets) != len(self.shape):
            raise ValueError(f"refinement {self.into}: rank mismatch")
        if self.agg is not None and self.agg not in AGG_OPS:
            raise ValueError(f"unknown aggregation '{self.agg}'")

    @property
    def rank(self) -> int:
        return len(self.shape)

    def is_scalar_view(self) -> bool:
        return all(s == 1 for s in self.shape)

    def clone(self, **kw) -> "Refinement":
        out = dataclasses.replace(self)
        out.tags = set(self.tags)
        for k, v in kw.items():
            setattr(out, k, v)
        return out

    def __str__(self) -> str:
        off = ", ".join(str(o) for o in self.offsets)
        shp = ", ".join(str(s) for s in self.shape)
        s = f"{self.dir} {self.into}[{off}] {self.dtype}({shp})"
        if self.strides:
            s += ":(" + ", ".join(str(x) for x in self.strides) + ")"
        if self.agg:
            s += f":{self.agg}"
        if self.location:
            s += f" @{self.location}"
        if self.from_buf and self.from_buf != self.into:
            s += f" <- {self.from_buf}"
        return s


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Load:
    """``into = load(buf)`` — reads the element the refinement points at
    (requires a scalar view) into a block-local scalar."""

    buf: str
    into: str

    def __str__(self) -> str:
        return f"${self.into} = load({self.buf})"


@dataclasses.dataclass
class Store:
    """``store(buf, scalar)`` — writes/aggregates a scalar into the element
    the refinement points at."""

    buf: str
    scalar: str

    def __str__(self) -> str:
        return f"{self.buf} = store(${self.scalar})"


@dataclasses.dataclass
class Intrinsic:
    """Scalar computation: ``into = op(args...)``."""

    op: str
    args: Tuple[str, ...]
    into: str

    def __str__(self) -> str:
        return f"${self.into} = {self.op}(" + ", ".join(f"${a}" for a in self.args) + ")"


@dataclasses.dataclass
class Constant:
    value: float
    into: str

    def __str__(self) -> str:
        return f"${self.into} = {self.value}"


@dataclasses.dataclass
class Special:
    """Complex tensor op on whole refinements (gather/scatter/...)."""

    op: str
    ins: Tuple[str, ...]
    outs: Tuple[str, ...]
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __str__(self) -> str:
        return f"{','.join(self.outs)} = special.{self.op}({', '.join(self.ins)})"


Statement = Union["Block", Load, Store, Intrinsic, Constant, Special]


# --------------------------------------------------------------------------
# Block
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Block:
    name: str
    idxs: List[Index] = dataclasses.field(default_factory=list)
    constraints: List[Constraint] = dataclasses.field(default_factory=list)
    refs: List[Refinement] = dataclasses.field(default_factory=list)
    stmts: List[Statement] = dataclasses.field(default_factory=list)
    tags: set = dataclasses.field(default_factory=set)
    comments: str = ""
    # Parent indices explicitly passed into this block (paper §3.2:
    # "requiring any parent index used to be explicitly passed").
    passed: List[str] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------- queries
    @property
    def poly(self) -> Polyhedron:
        return Polyhedron(self.idxs, self.constraints)

    def ref(self, name: str) -> Refinement:
        for r in self.refs:
            if r.into == name:
                return r
        raise KeyError(f"block {self.name}: no refinement '{name}'")

    def has_ref(self, name: str) -> bool:
        return any(r.into == name for r in self.refs)

    def idx(self, name: str) -> Index:
        for i in self.idxs:
            if i.name == name:
                return i
        raise KeyError(f"block {self.name}: no index '{name}'")

    def idx_ranges(self) -> Dict[str, int]:
        return {i.name: i.range for i in self.idxs if not i.is_passthrough()}

    def sub_blocks(self) -> List["Block"]:
        return [s for s in self.stmts if isinstance(s, Block)]

    def walk(self) -> Iterator["Block"]:
        yield self
        for s in self.stmts:
            if isinstance(s, Block):
                yield from s.walk()

    def depth(self) -> int:
        subs = self.sub_blocks()
        return 1 + (max(b.depth() for b in subs) if subs else 0)

    # ----------------------------------------------------------- mutation
    def clone(self, deep: bool = True) -> "Block":
        import copy

        return copy.deepcopy(self) if deep else dataclasses.replace(self)

    def add_tag(self, *tags: str) -> "Block":
        self.tags.update(tags)
        return self

    # ------------------------------------------------------------ display
    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        hdr = f"{pad}block"
        if self.name:
            hdr += f" <{self.name}>"
        if self.tags:
            hdr += " #" + " #".join(sorted(self.tags))
        hdr += " [" + ", ".join(str(i) for i in self.idxs) + "]"
        lines = [hdr + " ("]
        for c in self.constraints:
            lines.append(f"{pad}    {c}")
        for r in self.refs:
            lines.append(f"{pad}    {r}")
        lines.append(f"{pad}) {{")
        for n, s in enumerate(self.stmts):
            if isinstance(s, Block):
                body = s.pretty(indent + 1)
                body = body[: len(pad) + 2] + f"{n}: " + body[len(pad) + 2 :]
                lines.append(body)
            else:
                lines.append(f"{pad}  {n}: {s}")
        lines.append(pad + "}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.pretty()


# --------------------------------------------------------------------------
# Program: top-level buffer declarations + entry block
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TensorDecl:
    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def rank(self) -> int:
        return len(self.shape)

    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass
class Program:
    """A list of top-level parallel polyhedral blocks over declared buffers
    (the paper: 'a network can be represented as a list of polyhedra')."""

    buffers: Dict[str, TensorDecl]
    entry: Block  # entry.stmts is the top-level list of op blocks
    inputs: List[str] = dataclasses.field(default_factory=list)
    outputs: List[str] = dataclasses.field(default_factory=list)
    # Pristine pre-optimization program (kept by the pass manager): the jnp
    # reference backend lowers from this semantic form, the Pallas backend
    # from the optimized form.
    source: Optional["Program"] = None

    def decl(self, name: str) -> TensorDecl:
        return self.buffers[name]

    def pretty(self) -> str:
        lines = [
            f"program (in: {', '.join(self.inputs)}; out: {', '.join(self.outputs)})"
        ]
        for b in self.buffers.values():
            lines.append(f"  buffer {b.name} {b.dtype}({', '.join(map(str, b.shape))})")
        lines.append(self.entry.pretty())
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.pretty()


# --------------------------------------------------------------------------
# Access composition
# --------------------------------------------------------------------------
def compose_access(chain: Sequence[Refinement]) -> Tuple[Affine, ...]:
    """Absolute per-dim offsets of the innermost refinement w.r.t. the root
    buffer: refinement offsets compose by addition (same rank throughout)."""
    if not chain:
        raise ValueError("empty refinement chain")
    rank = chain[0].rank
    total = [aff(0)] * rank
    for r in chain:
        if r.rank != rank:
            raise ValueError("rank change along refinement chain")
        total = [t + o for t, o in zip(total, r.offsets)]
    return tuple(total)


def row_major_strides(shape: Sequence[int]) -> Tuple[int, ...]:
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    return tuple(strides)


DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "float16": 2, "float64": 8,
    "int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8, "bool": 1,
}


def dtype_bytes(dtype: str) -> int:
    return DTYPE_BYTES[dtype]


# --------------------------------------------------------------------------
# Stable content hashing (compilation-cache keys)
# --------------------------------------------------------------------------
def _canon_ref(r: Refinement):
    return [
        "ref", r.dir, r.from_buf, r.into,
        [str(o) for o in r.offsets], list(r.shape), r.dtype,
        list(r.strides) if r.strides else None, r.agg,
        str(r.location) if r.location else None, sorted(r.tags),
    ]


def _canon_stmt(s: Statement):
    if isinstance(s, Block):
        return _canon_block(s)
    if isinstance(s, Load):
        return ["load", s.buf, s.into]
    if isinstance(s, Store):
        return ["store", s.buf, s.scalar]
    if isinstance(s, Intrinsic):
        return ["intr", s.op, list(s.args), s.into]
    if isinstance(s, Constant):
        return ["const", repr(s.value), s.into]
    if isinstance(s, Special):
        return ["special", s.op, list(s.ins), list(s.outs),
                sorted((k, str(v)) for k, v in s.attrs.items())]
    raise TypeError(f"unknown statement {s!r}")


def _canon_block(b: Block):
    # ``comments`` is excluded: free-form notes carry no semantics.
    return [
        "block", b.name,
        [[i.name, i.range, str(i.affine) if i.affine is not None else None] for i in b.idxs],
        [str(c.expr) for c in b.constraints],
        [_canon_ref(r) for r in b.refs],
        sorted(b.tags), list(b.passed),
        [_canon_stmt(s) for s in b.stmts],
    ]


def canonical_ir(obj: Union[Program, Block]):
    """Canonical (JSON-able) form of a program or block: deterministic
    across processes and insensitive to non-semantic state — tag/set
    insertion order, buffer-dict insertion order, comments, and the
    pristine ``source`` back-pointer."""
    if isinstance(obj, Block):
        return _canon_block(obj)
    return [
        "program",
        sorted([d.name, list(d.shape), d.dtype] for d in obj.buffers.values()),
        list(obj.inputs), list(obj.outputs),
        _canon_block(obj.entry),
    ]


def ir_fingerprint(obj: Union[Program, Block]) -> str:
    """sha256 content hash of :func:`canonical_ir` — the IR component of a
    compilation-cache key."""
    from .cache import stable_hash

    return stable_hash(canonical_ir(obj))
