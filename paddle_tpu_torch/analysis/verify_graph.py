"""Lazy-graph verifier (``FLAGS_lazy_verify``; port of
``paddle_tpu/analysis/verify_graph.py``).

A structural pass over the pending ``_Graph`` of ``core/lazy.py``, run
just before a flush executes it. The graph's wiring descriptors, leaf
table and signature parts are built incrementally at record time: fast,
but one bookkeeping slip there serves a wrong CUDA graph from the graph
cache, or replays a graph against a leaf that moved. This pass re-derives
every incremental structure from the nodes and their inputs and
cross-checks:

* **acyclicity / topological wiring**: every ``("n", gix, out_ix)``
  descriptor names a strictly earlier node and an ``out_ix`` below its
  output count, and a live input LazyArray points back at that output;
* **leaf-table consistency**: ``leaves``, ``leaf_pos`` and ``leaf_avals``
  agree, every ``("l", j)`` descriptor is in range and names the object the
  node recorded, ``direct_uses`` matches a recount (the donation test's
  reference budget is built from it), and every written leaf index is a
  leaf;
* **donation soundness**: a leaf counted as donated is referenced by
  nothing outside the pending graph;
* **signature determinism**: the signature re-derived from the wired graph
  equals the memoized ``keyparts`` and ``leaf_avals``;
* **deferred-check bookkeeping**: the async runtime's queued NaN/Inf
  checks and census entries are well formed;
* **bound addresses** (the card's rule): before a captured graph replays,
  every leaf it binds by address is still at the address the graph holds.

A violation raises :class:`GraphInvariantError` naming the node (index and
op) and the rule. With the flag off, a flush pays one flag probe.
"""
from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["GraphInvariantError", "verify_before_dispatch", "verify_graph"]


class GraphInvariantError(RuntimeError):
    """A lazy-graph invariant does not hold. Carries the rule and, where it
    can be attributed, the node's index and op name."""

    def __init__(self, rule: str, message: str,
                 node_index: Optional[int] = None,
                 op_name: Optional[str] = None):
        loc = ""
        if node_index is not None:
            loc = f" [node {node_index}" + (f" ({op_name})" if op_name
                                            else "") + "]"
        super().__init__(
            f"lazy-graph invariant violated: {rule}{loc}: {message}")
        self.rule = rule
        self.node_index = node_index
        self.op_name = op_name


def _fail(rule, message, node_index=None, op_name=None):
    raise GraphInvariantError(rule, message, node_index, op_name)


def _op_name(node) -> str:
    try:
        return str(node.key[0])
    except Exception:  # lint: ok(oom-handler) — naming a corrupt node, nothing launches
        return "?"


def verify_graph(g) -> None:
    """Check the wiring, leaf-table and signature invariants of a pending
    ``_Graph`` (donation and the deferred queue are flush-scoped: see
    :func:`verify_before_dispatch`)."""
    from ..core import lazy as lazy_mod

    nodes = g.nodes
    n_nodes = len(nodes)
    leaves = g.leaves
    n_leaves = len(leaves)
    if not (len(g.descs) == len(g.keyparts) == n_nodes):
        _fail("wiring",
              f"per-node tables out of step: {n_nodes} nodes, "
              f"{len(g.descs)} descriptors, {len(g.keyparts)} signature "
              "parts")
    if not (len(g.leaf_avals) == n_leaves == len(g.leaf_pos)):
        _fail("leaf-table",
              f"{n_leaves} leaves vs {len(g.leaf_avals)} leaf avals vs "
              f"{len(g.leaf_pos)} leaf positions")
    for j in range(n_leaves):
        if g.leaf_pos.get(id(leaves[j])) != j:
            _fail("leaf-table",
                  f"leaf {j} is not indexed at its own position (leaf_pos "
                  f"says {g.leaf_pos.get(id(leaves[j]))!r})")
    recount: dict = {}
    for i, node in enumerate(nodes):
        name = _op_name(node)
        if node.gix != i:
            _fail("wiring", f"node.gix={node.gix} disagrees with position",
                  i, name)
        if node.graph is not g:
            _fail("wiring", "node does not belong to this graph epoch", i,
                  name)
        if node.out_refs is None or len(node.out_refs) != node.n_out:
            _fail("wiring",
                  f"{0 if node.out_refs is None else len(node.out_refs)} "
                  f"output refs for n_out={node.n_out}", i, name)
        descs = g.descs[i]
        inputs = node.inputs
        if len(descs) != len(inputs):
            _fail("wiring", f"{len(descs)} descriptors for {len(inputs)} "
                  "inputs", i, name)
        for d, x in zip(descs, inputs):
            if d[0] == "n":
                _, gix, out_ix = d
                if not 0 <= gix < i:
                    _fail("acyclicity",
                          f"input references node {gix}: not strictly "
                          "earlier in the append-only order (cycle or "
                          "dangling wire)", i, name)
                if not 0 <= out_ix < nodes[gix].n_out:
                    _fail("wiring",
                          f"input output-index {out_ix} out of range for "
                          f"node {gix} (n_out={nodes[gix].n_out})", i, name)
                la = x() if callable(x) else x
                if la is None:
                    continue  # the input died; its value lives in the replay
                if not (isinstance(la, lazy_mod.LazyArray)
                        and la._concrete is None):
                    _fail("wiring",
                          f"descriptor says node-output {gix}:{out_ix} but "
                          "the stored input is not a pending LazyArray", i,
                          name)
                if la._node is not nodes[gix] or la._idx != out_ix:
                    _fail("wiring",
                          f"pending input wired to node {gix}:{out_ix} but "
                          "the LazyArray points elsewhere", i, name)
            elif d[0] == "l":
                j = d[1]
                if not 0 <= j < n_leaves:
                    _fail("leaf-table",
                          f"input references leaf {j} of {n_leaves} "
                          "(dangling leaf)", i, name)
                if leaves[j] is not x:
                    _fail("leaf-table",
                          f"leaf {j} in the table is not the object this "
                          "node recorded as its input", i, name)
                recount[id(x)] = recount.get(id(x), 0) + 1
            else:
                _fail("wiring", f"unknown descriptor kind {d[0]!r}", i, name)
    tracked = {k: v for k, v in g.direct_uses.items() if v}
    if recount != tracked:
        bad = next(k for k in (set(recount) | set(tracked))
                   if recount.get(k, 0) != tracked.get(k, 0))
        jx = next((j for j in range(n_leaves) if id(leaves[j]) == bad), None)
        _fail("leaf-table",
              f"direct_uses for leaf {'?' if jx is None else jx} says "
              f"{tracked.get(bad, 0)} occurrence(s) but a recount of the "
              f"wiring gives {recount.get(bad, 0)}: the donation refcount "
              "budget would be wrong")
    for j in g.written:
        if not 0 <= j < n_leaves:
            _fail("leaf-table", f"written leaf {j} of {n_leaves}")
    for i, node in enumerate(nodes):
        if g.keyparts[i] != (node.key, tuple(g.descs[i])):
            _fail("signature",
                  "memoized signature part disagrees with the wired graph: "
                  "the graph cache would key this program incorrectly", i,
                  _op_name(node))
    for j in range(n_leaves):
        if g.leaf_avals[j] != lazy_mod._leaf_sig(leaves[j]):
            _fail("signature",
                  f"memoized signature part of leaf {j} disagrees with the "
                  f"live leaf ({g.leaf_avals[j]!r} vs "
                  f"{lazy_mod._leaf_sig(leaves[j])!r})")


def _verify_donation(g, donate_ix: Sequence[int]) -> None:
    """A donated leaf must be referenced by nothing but the pending graph:
    re-run the frame-isolated reference count from the live tables."""
    import torch

    from ..core import lazy as lazy_mod

    leaves = g.leaves
    for j in donate_ix:
        if not 0 <= j < len(leaves):
            _fail("donation", f"donated leaf index {j} of {len(leaves)}")
        if not isinstance(leaves[j], torch.Tensor):
            _fail("donation", f"donated leaf {j} is not a tensor "
                  f"({type(leaves[j]).__name__})")
    if donate_ix:
        recheck = lazy_mod._donation_mask(
            leaves, {id(leaves[j]) for j in donate_ix}, g.direct_uses)
        stale = set(donate_ix) - set(recheck)
        if stale:
            j = sorted(stale)[0]
            _fail("donation",
                  f"leaf {j} is marked as donated but something outside "
                  "the pending graph still references it (reference count "
                  "above the graph-only budget)")


def _verify_deferred(deferred) -> None:
    """The async runtime's deferred queue: each entry is ``(span, payload,
    census, results)``, the payload None (census only) or ``(names,
    tensors, flags)`` of the fused finite check."""
    if not deferred:
        return
    for k, entry in enumerate(deferred):
        if not (isinstance(entry, tuple) and len(entry) == 4):
            _fail("deferred",
                  f"queued entry {k} is not a (span, payload, census, "
                  f"results) tuple ({type(entry).__name__})")
        payload = entry[1]
        if payload is None:
            continue
        if not (isinstance(payload, tuple) and len(payload) == 3):
            _fail("deferred",
                  f"entry {k} carries a malformed NaN-scan payload (len "
                  f"{len(payload) if isinstance(payload, tuple) else '?'}, "
                  "want 3: names/tensors/flags)")
        names, tensors, flags = payload
        if len(names) != len(tensors):
            _fail("deferred", f"entry {k}: {len(names)} names vs "
                  f"{len(tensors)} tensors")
        if flags is not None and flags.numel() != len(tensors):
            _fail("deferred", f"entry {k}: {flags.numel()} finite flags for "
                  f"{len(tensors)} tensors")


def verify_bound_addresses(entry, leaves) -> None:
    """Before a captured graph replays: every leaf it binds by address
    is where the graph reads and writes it."""
    for j, ptr in entry.ptrs.items():
        if not 0 <= j < len(leaves):
            _fail("bound-address", f"bound leaf {j} of {len(leaves)}")
        now = leaves[j].data_ptr()
        if now != ptr:
            _fail("bound-address",
                  f"leaf {j} is bound by address to a captured graph at "
                  f"0x{ptr:x} but now lives at 0x{now:x}: the replay would "
                  "read and write the old storage")


def verify_before_dispatch(g, donate_ix: Sequence[int] = (),
                           deferred=None) -> None:
    """The pre-flush pass under ``FLAGS_lazy_verify``: the graph's
    structure, this flush's donation, the deferred queue. Counts
    ``lazy_verify_passes``."""
    from .. import profiler

    verify_graph(g)
    _verify_donation(g, donate_ix)
    _verify_deferred(deferred)
    profiler.counter_inc("lazy_verify_passes")
