"""Static graph container and the conv-BN fusion pass.

Counterpart of ``bigdl_tpu/nn/graph.py``: ``layer.inputs(node, ...)`` wraps
a layer in a :class:`ModuleNode` wired to its predecessors; ``Input()`` is a
graph input placeholder; ``Graph(input, output)`` sorts the DAG once
(Kahn's algorithm from the outputs back, ready nodes by creation order, as
JAX's ``_topo_sort``) and runs it in that order, feeding each module its
predecessor's output, or a ``Table`` of its predecessors' outputs when it
has several. Several graph inputs take a ``Table`` (element i to input i);
several outputs give a ``Table``. The executable nodes' modules are the
graph's children ``"0"``, ``"1"``, ... in that order, so parameter paths are
JAX's. The backward is autograd's.

``fuse_conv_bn`` (``:255``) rewrites conv → BN (→ ReLU) chains of the
module tree, in Sequentials and in a Graph's DAG (``_fuse_graph``, ``:209``),
into ``kernels.conv_bn.FusedConvBNReLU``.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Union

from bigdl_tpu_torch.nn.abstractnn import AbstractModule, Container, child_state
from bigdl_tpu_torch.utils.table import T, Table

logger = logging.getLogger(__name__)


class ModuleNode:
    """A node in the module DAG: wraps a module plus its predecessor nodes."""

    _counter = 0

    def __init__(self, module: Optional[AbstractModule],
                 prev_nodes: Sequence["ModuleNode"] = ()):
        ModuleNode._counter += 1
        self.id = ModuleNode._counter
        self.module = module
        self.prev_nodes: list[ModuleNode] = list(prev_nodes)

    def __repr__(self):
        return f"Node({self.module!r})"


def Input() -> ModuleNode:
    """Create a graph input placeholder node (reference ``Input()``)."""
    return ModuleNode(None, ())


def make_node(module: AbstractModule, nodes: Sequence) -> ModuleNode:
    """``layer.inputs(nodeA, nodeB)`` → new node wiring nodeA/nodeB into
    this layer."""
    flat: list[ModuleNode] = []
    for n in nodes:
        if isinstance(n, (list, tuple)):
            flat.extend(n)
        else:
            flat.append(n)
    return ModuleNode(module, flat)


class Graph(Container):
    """DAG of modules run in topological order.

    ``Graph(input_nodes, output_nodes)``: either may be a single node or a
    list. Several graph inputs consume a ``Table`` input (element i → input
    node i); several outputs produce a ``Table``.
    """

    def __init__(self,
                 input: Union[ModuleNode, Sequence[ModuleNode]],
                 output: Union[ModuleNode, Sequence[ModuleNode]]):
        super().__init__()
        self.input_nodes = (list(input) if isinstance(input, (list, tuple))
                            else [input])
        self.output_nodes = (list(output) if isinstance(output, (list, tuple))
                             else [output])
        self.sorted_nodes = self._topo_sort()
        # children = executable nodes in topological order
        self.exec_nodes = [n for n in self.sorted_nodes
                           if n.module is not None]
        self._child_name = {}
        for n in self.exec_nodes:
            self._child_name[n.id] = str(len(self._modules))
            self.add(n.module)

    def _topo_sort(self) -> list:
        """Kahn's algorithm from output nodes back through prev edges."""
        seen: dict = {}
        stack = list(self.output_nodes)
        while stack:
            n = stack.pop()
            if n.id in seen:
                continue
            seen[n.id] = n
            stack.extend(n.prev_nodes)
        for inp in self.input_nodes:
            if inp.id not in seen:
                raise ValueError(
                    "Graph input node is not connected to any output")
        indeg = {nid: 0 for nid in seen}
        succs: dict = {nid: [] for nid in seen}
        for n in seen.values():
            for p in n.prev_nodes:
                indeg[n.id] += 1
                succs[p.id].append(n)
        ready = sorted([n for n in seen.values() if indeg[n.id] == 0],
                       key=lambda n: n.id)
        order: list = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in succs[n.id]:
                indeg[s.id] -= 1
                if indeg[s.id] == 0:
                    ready.append(s)
        if len(order) != len(seen):
            raise ValueError("Graph contains a cycle")
        return order

    def run(self, input, state=None):
        values: dict = {}
        if len(self.input_nodes) == 1:
            values[self.input_nodes[0].id] = input
        else:
            xs = input.values() if isinstance(input, Table) else list(input)
            if len(xs) != len(self.input_nodes):
                raise ValueError(f"graph expects {len(self.input_nodes)} "
                                 f"inputs, got {len(xs)}")
            for node, x in zip(self.input_nodes, xs):
                values[node.id] = x
        new_state = None if state is None else {}
        for node in self.sorted_nodes:
            if node.module is None:
                if node.id not in values:
                    raise ValueError("unbound Input() node in graph")
                continue
            if node.prev_nodes:
                preds = [values[p.id] for p in node.prev_nodes]
                x = preds[0] if len(preds) == 1 else T(*preds)
            elif node.id in values:
                # a module node used directly as a graph input
                x = values[node.id]
            else:
                raise ValueError(f"{node} has no predecessors and is not a "
                                 f"graph input")
            name = self._child_name[node.id]
            out, s = node.module.run(x, child_state(state, name))
            values[node.id] = out
            if new_state is not None and s is not None:
                new_state[name] = s
        outs = [values[n.id] for n in self.output_nodes]
        return (outs[0] if len(outs) == 1 else T(*outs)), new_state

    def node(self, name: str) -> Optional[ModuleNode]:
        for n in self.exec_nodes:
            if n.module.name == name:
                return n
        return None

    def extra_repr(self):
        return (f"inputs={len(self.input_nodes)}, "
                f"outputs={len(self.output_nodes)}, "
                f"nodes={len(self.exec_nodes)}")


# Reference alias: StaticGraph is the concrete eager-plan graph class.
StaticGraph = Graph


def _fusible_conv(m) -> bool:
    from bigdl_tpu_torch.nn.convolution import SpatialConvolution
    return isinstance(m, SpatialConvolution)


def _fusible_bn(conv, m) -> bool:
    from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
    return (isinstance(m, SpatialBatchNormalization)
            and m.n_output == conv.n_output_plane)


def _is_relu(m) -> bool:
    from bigdl_tpu_torch.nn.activation import ReLU
    return type(m) is ReLU


def _fuse_sequential(seq) -> int:
    """Collapse adjacent conv → bn (→ relu) children of a Sequential into
    ``FusedConvBNReLU`` modules, in place; the fused module keeps the index
    of its convolution, so the children are renumbered as JAX's list is.
    Returns the number of pairs fused."""
    from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
    mods = list(seq._modules.values())
    out, fused, i = [], 0, 0
    while i < len(mods):
        m = mods[i]
        if (_fusible_conv(m) and i + 1 < len(mods)
                and _fusible_bn(m, mods[i + 1])):
            relu = i + 2 < len(mods) and _is_relu(mods[i + 2])
            out.append(FusedConvBNReLU(m, mods[i + 1], relu=relu))
            fused += 1
            i += 3 if relu else 2
        else:
            out.append(m)
            i += 1
    if fused:
        seq._modules.clear()
        for m in out:
            seq.add(m)
    return fused


def _fuse_graph(g: Graph) -> tuple:
    """Merge conv → bn (→ relu) chains of a module DAG into single fused
    nodes (the bn/relu must be the conv's only consumer). Rewires the node
    graph in place and rebuilds the Graph container around it."""
    from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU

    succs: dict = {}
    for n in g.sorted_nodes:
        for p in n.prev_nodes:
            succs.setdefault(p.id, []).append(n)

    def sole_successor(node):
        s = succs.get(node.id, [])
        return s[0] if len(s) == 1 else None

    fused = 0
    outputs = list(g.output_nodes)
    for node in g.sorted_nodes:
        conv = node.module
        if conv is None or not _fusible_conv(conv):
            continue
        bn_node = sole_successor(node)
        if bn_node is None or bn_node.module is None \
                or not _fusible_bn(conv, bn_node.module) \
                or len(bn_node.prev_nodes) != 1:
            continue
        relu_node = sole_successor(bn_node)
        if relu_node is not None and (relu_node.module is None
                                      or not _is_relu(relu_node.module)
                                      or len(relu_node.prev_nodes) != 1):
            relu_node = None
        tail = relu_node if relu_node is not None else bn_node
        node.module = FusedConvBNReLU(conv, bn_node.module,
                                      relu=relu_node is not None)
        fused += 1
        # consumers of the absorbed tail now read the fused node
        for consumer in succs.get(tail.id, []):
            consumer.prev_nodes = [node if p is tail else p
                                   for p in consumer.prev_nodes]
        succs[node.id] = succs.pop(tail.id, [])
        outputs = [node if o is tail else o for o in outputs]
    if not fused:
        return g, 0
    return Graph(g.input_nodes, outputs), fused


def fuse_conv_bn(model):
    """Walk the module tree (and any :class:`Graph` DAG) and replace each
    adjacent ``SpatialConvolution → SpatialBatchNormalization (→ ReLU)`` by
    one ``kernels.conv_bn.FusedConvBNReLU`` that owns the same modules
    (parameters and running statistics carry over untouched). Rewrites
    containers in place and returns the model (a new one for a root
    Graph with a chain in its own DAG)."""
    from bigdl_tpu_torch.kernels.conv_bn import FusedConvBNReLU
    from bigdl_tpu_torch.nn.containers import Sequential

    total = 0

    def walk(m):
        nonlocal total
        if isinstance(m, FusedConvBNReLU):
            return m
        if isinstance(m, Graph):
            for node in m.exec_nodes:
                node.module = walk(node.module)
                m._modules[m._child_name[node.id]] = node.module
            m, n = _fuse_graph(m)
            total += n
            return m
        if isinstance(m, Container):
            for name, c in list(m._modules.items()):
                m._modules[name] = walk(c)
            if isinstance(m, Sequential):
                total += _fuse_sequential(m)
        return m

    model = walk(model)
    if total:
        logger.info("conv-bn fusion pass: %d conv-bn(-relu) chains fused",
                    total)
    return model
