"""Render graph: declarative pass I/O, automatic ordering, lifetimes — the
port's copy of the JAX package's `graph/frame_graph.py` (same API and rules).

The re-expression of `Engine/Source/Renderer/FrameGraph.cpp` +
`FrameGraphResource.h`:

* `ResourceRegistry` — the FGResourceIDs name<->id table (:69-102).
* `RenderPass.reads/writes` — the declared input/output id sets
  (IRenderPass::ReadResource/WriteResource, IPipeline.h:188-218).
* `compile()` — FGExecutionParser::Parse (:191-311): dependency edges from
  read/write overlap, reverse DFS from the present pass with cycle detection,
  unused-pass rejection, and per-resource [first_write, last_read] lifetimes.

Where the reference then places transient textures into aliased GPU heap
ranges (FGResourceAllocator + TLSF), passes here are plain functions and the
lifetime intervals are surfaced so the executor drops dead-after-use
intermediates; PyTorch's caching allocator reuses their memory.

`execute()` runs the sorted passes over a dict environment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


class ResourceRegistry:
    """Name <-> id registry (FGResourceIDs)."""

    def __init__(self):
        self._name_to_id: dict[str, int] = {}
        self._id_to_name: list[str] = []

    def name_to_id(self, name: str) -> int:
        if name not in self._name_to_id:
            self._name_to_id[name] = len(self._id_to_name)
            self._id_to_name.append(name)
        return self._name_to_id[name]

    def id_to_name(self, rid: int) -> str:
        return self._id_to_name[rid]


@dataclass(frozen=True)
class ResourceDesc:
    """Transient-resource description (FGResourceDescriptionTable entry,
    FrameGraphResource.h:191-209): the declared shape/dtype contract between
    the producing and consuming passes."""

    shape: tuple[int, ...]
    dtype: str


@dataclass
class RenderPass:
    """A pass: declared reads/writes + a pure function over the environment.

    fn(env: dict[str, Any]) -> dict[str, Any] of produced resources. A pass
    may also read and re-write the same name (e.g. bloom merging into the
    shading RT, matching WriteResource on an existing id).

    `declares` optionally binds resource names to ResourceDescs. Like the
    reference's CreateResource/CheckResourceDescription, a name declared by
    two passes must carry an identical description (validated at compile),
    and the array a pass actually produces must match its declaration
    (validated at run time) — producer/consumer shape mismatches become
    named graph errors."""

    name: str
    reads: tuple[str, ...]
    writes: tuple[str, ...]
    fn: Callable[[dict], dict]
    declares: dict[str, ResourceDesc] = field(default_factory=dict)


@dataclass
class CompiledGraph:
    order: list[RenderPass]
    lifetimes: dict[str, tuple[int, int]]  # name -> (first pass idx, last pass idx)
    donatable: dict[int, tuple[str, ...]]  # pass idx -> names dead after it
    descriptions: dict[str, ResourceDesc] = field(default_factory=dict)


class GraphError(RuntimeError):
    pass


def compile_graph(passes: list[RenderPass], present: str) -> CompiledGraph:
    """Topologically order passes so every read is produced first, starting
    from the pass named `present` and walking dependencies backwards
    (FGExecutionParser::Parse semantics, including its asserts)."""
    by_name = {p.name: p for p in passes}
    if present not in by_name:
        raise GraphError(f"present pass {present!r} not registered")

    # description table: re-declarations must agree
    # (FGResourceDescriptionTable / CheckResourceDescription)
    descriptions: dict[str, ResourceDesc] = {}
    declared_by: dict[str, str] = {}
    for p in passes:
        for rname, desc in p.declares.items():
            if rname in descriptions and descriptions[rname] != desc:
                raise GraphError(
                    f"resource {rname!r} re-declared with a mismatched "
                    f"description: pass {declared_by[rname]!r} declared "
                    f"{descriptions[rname]}, pass {p.name!r} declared {desc}"
                )
            descriptions.setdefault(rname, desc)
            declared_by.setdefault(rname, p.name)

    # producer map: resource -> passes that write it, in registration order
    producers: dict[str, list[RenderPass]] = {}
    for p in passes:
        for w in p.writes:
            producers.setdefault(w, []).append(p)

    def depends_on(a: RenderPass) -> list[RenderPass]:
        """Passes that must run before `a` (IsDependsOn, FrameGraph.cpp:292-311):
        producers of a's reads, plus earlier writers of a's writes (write-write
        order follows registration order, like command order in the reference)."""
        deps: list[RenderPass] = []
        for r in a.reads:
            for w in producers.get(r, ()):  # all writers of an input run first
                if w is not a and w not in deps:
                    deps.append(w)
        idx = passes.index(a)
        for wname in a.writes:
            for w in producers.get(wname, ()):
                if w is not a and passes.index(w) < idx and w not in deps:
                    deps.append(w)
        return deps

    order: list[RenderPass] = []
    state: dict[str, int] = {}  # 0 = unvisited, 1 = visiting, 2 = done

    def visit(p: RenderPass):
        st = state.get(p.name, 0)
        if st == 1:
            raise GraphError(f"cycle detected at pass {p.name!r}")
        if st == 2:
            return
        state[p.name] = 1
        for d in depends_on(p):
            visit(d)
        state[p.name] = 2
        order.append(p)

    visit(by_name[present])

    unused = [p.name for p in passes if state.get(p.name, 0) != 2]
    if unused:
        raise GraphError(f"passes not reachable from present: {unused}")

    # lifetimes (FGExecutionParser lifetime computation, FrameGraph.cpp:252-289)
    lifetimes: dict[str, tuple[int, int]] = {}
    for i, p in enumerate(order):
        for name in (*p.writes, *p.reads):
            if name in lifetimes:
                s, _ = lifetimes[name]
                lifetimes[name] = (s, i)
            else:
                lifetimes[name] = (i, i)

    donatable: dict[int, tuple[str, ...]] = {}
    for name, (_, end) in lifetimes.items():
        if end < len(order) - 1:  # dead before present -> aliasable
            donatable.setdefault(end, ())
            donatable[end] = (*donatable[end], name)
    return CompiledGraph(order, lifetimes, donatable, descriptions)


def execute(graph: CompiledGraph, env: dict[str, Any]) -> dict[str, Any]:
    """Run passes in order over the environment. Each pass returns its
    outputs, merged into env."""
    env = dict(env)
    for i, p in enumerate(graph.order):
        missing = [r for r in p.reads if r not in env]
        if missing:
            raise GraphError(f"pass {p.name!r} reads undeclared {missing}")
        out = p.fn(env)
        bad = set(out) - set(p.writes)
        if bad:
            raise GraphError(f"pass {p.name!r} wrote undeclared {sorted(bad)}")
        for rname, val in out.items():
            desc = graph.descriptions.get(rname)
            if desc is None or not hasattr(val, "shape"):
                continue
            if tuple(val.shape) != tuple(desc.shape) or str(val.dtype) != desc.dtype:
                raise GraphError(
                    f"pass {p.name!r} produced {rname!r} as "
                    f"{tuple(val.shape)}/{val.dtype}, declared {desc}"
                )
        env.update(out)
        # lifetime-based cleanup: drop dead intermediates after their last use
        # (the allocator then reuses their memory — the transient-aliasing role)
        for dead in graph.donatable.get(i, ()):
            env.pop(dead, None)
    return env
