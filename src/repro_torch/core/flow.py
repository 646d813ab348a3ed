"""Design-flow graphs and their executor.

Paper §III: "The architecture of the design-flow is depicted as a cyclic
directed graph where nodes symbolize tasks and edges signify dependencies
between tasks" and "each connection defines a unidirectional flow between a
source and a target task" (Fig. 1).

Execution model: token passing.  Every edge carries a FIFO of model-space
names.  A node *fires* when every incoming edge holds at least one token; it
consumes one token per edge (in edge-creation order) as its inputs, runs the
task against the shared :class:`MetaModel`, and pushes its outputs to every
outgoing edge whose ``condition(meta, outputs)`` evaluates true.  Source
nodes (``n_in == 0``, e.g. MODEL-GEN) fire exactly once at the start.

Cycles are first-class: a back edge with a condition implements the paper's
iterative optimization loops; the executor bounds total firings with
``max_steps`` so an ill-conditioned flow terminates deterministically.

Contract: within one dispatch, a node's outgoing edge conditions are
evaluated in edge-creation order.  Conditions may rely on this — e.g. a
back-edge condition recording a decision in the MetaModel that a
later-created exit-edge condition reads (examples/custom_flow.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from repro_torch.core.metamodel import MetaModel
from repro_torch.core.task import PipeTask, TaskError

Condition = Callable[[MetaModel, list[str]], bool]


@dataclasses.dataclass
class _Edge:
    src: int
    dst: int
    condition: Condition | None
    tokens: list[str] = dataclasses.field(default_factory=list)


class FlowError(RuntimeError):
    pass


class DesignFlow:
    """A cyclic directed graph of pipe tasks."""

    def __init__(self, name: str = "flow"):
        self.name = name
        self.tasks: list[PipeTask] = []
        self.edges: list[_Edge] = []

    # ------------------------------------------------------- construction
    def add(self, task: PipeTask) -> int:
        self.tasks.append(task)
        return len(self.tasks) - 1

    def connect(self, src: int | PipeTask, dst: int | PipeTask,
                condition: Condition | None = None) -> None:
        s = self._node_id(src)
        d = self._node_id(dst)
        self.edges.append(_Edge(s, d, condition))

    def chain(self, *tasks: PipeTask) -> list[int]:
        """Convenience: add tasks and connect them linearly."""
        ids = [self.add(t) for t in tasks]
        for a, b in zip(ids, ids[1:]):
            self.connect(a, b)
        return ids

    def _node_id(self, node: int | PipeTask) -> int:
        if isinstance(node, int):
            if not 0 <= node < len(self.tasks):
                raise FlowError(f"node id {node} out of range")
            return node
        try:
            return self.tasks.index(node)
        except ValueError:
            raise FlowError(f"task {node!r} not in flow") from None

    # ----------------------------------------------------------- checking
    def validate(self) -> None:
        """Static multiplicity check (paper Table I's multiplicity column).

        A task needs at least ``n_in`` incoming edges; MORE are allowed —
        alternative paths / cyclic back-edges feed the same port (the task
        consumes ``n_in`` tokens per firing from whichever edges hold
        them)."""
        for i, task in enumerate(self.tasks):
            n_in = sum(1 for e in self.edges if e.dst == i)
            if task.n_in > 0 and n_in < task.n_in:
                raise FlowError(
                    f"{self.name}: task {task.name} (node {i}) declares "
                    f"{task.n_in} inputs but has {n_in} incoming edges")
            if task.n_in == 0 and n_in != 0:
                raise FlowError(
                    f"{self.name}: source task {task.name} must have no "
                    f"incoming edges, has {n_in}")

    # ---------------------------------------------------------- execution
    def execute(self, meta: MetaModel | None = None,
                max_steps: int = 256) -> MetaModel:
        meta = meta if meta is not None else MetaModel()
        self.validate()
        for e in self.edges:
            e.tokens.clear()
        meta.record("flow.start", flow=self.name,
                    tasks=[t.name for t in self.tasks])

        fired_source = set()
        steps = 0
        while steps < max_steps:
            node = self._ready_node(fired_source)
            if node is None:
                break
            steps += 1
            task = self.tasks[node]
            inputs = self._consume_inputs(node, task)
            if task.n_in == 0:
                fired_source.add(node)
            outputs = task.run(meta, inputs)
            self._dispatch(meta, node, outputs)
        else:
            raise FlowError(
                f"{self.name}: exceeded max_steps={max_steps}; "
                "a cyclic flow is probably missing a terminating condition")

        meta.record("flow.done", flow=self.name, steps=steps)
        return meta

    def _ready_node(self, fired_source: set[int]) -> int | None:
        for i, task in enumerate(self.tasks):
            if task.n_in == 0:
                if i not in fired_source:
                    return i
                continue
            available = sum(len(e.tokens) for e in self.edges
                            if e.dst == i)
            if available >= task.n_in:
                return i
        return None

    def _consume_inputs(self, node: int, task: PipeTask) -> list[str]:
        inputs: list[str] = []
        for e in self.edges:
            if e.dst == node:
                while e.tokens and len(inputs) < task.n_in:
                    inputs.append(e.tokens.pop(0))
        if len(inputs) != task.n_in:
            raise TaskError(
                f"{task.name}: consumed {len(inputs)} tokens, needs "
                f"{task.n_in}")
        return inputs

    def _dispatch(self, meta: MetaModel, node: int,
                  outputs: list[str]) -> None:
        # Conditions run exactly once per edge, in edge-creation order
        # (module-docstring contract) — side-effecting conditions must not
        # be re-evaluated even for n_out > 1 nodes.
        live: list[_Edge] = []
        for e in self.edges:
            if e.src != node:
                continue
            if e.condition is not None and not e.condition(meta, outputs):
                meta.record("flow.edge_skipped", src=self.tasks[e.src].name,
                            dst=self.tasks[e.dst].name)
                continue
            live.append(e)
        # n_out == 1: the single output fans out to every live edge.
        # n_out > 1: outputs are distributed to live edges in order.
        if self.tasks[node].n_out <= 1:
            for e in live:
                for out in outputs:
                    e.tokens.append(out)
        else:
            for idx, e in enumerate(live):
                if idx < len(outputs):
                    e.tokens.append(outputs[idx])

    # ------------------------------------------------------------- export
    def to_dot(self) -> str:
        """Graphviz rendering of the flow (paper Fig. 2-style)."""
        lines = [f'digraph "{self.name}" {{', "  rankdir=LR;"]
        for i, t in enumerate(self.tasks):
            shape = "box" if t.kind == "λ" else "ellipse"
            lines.append(f'  n{i} [label="{t.name}\\n({t.kind})" '
                         f'shape={shape}];')
        for e in self.edges:
            style = ' [style=dashed label="cond"]' if e.condition else ""
            lines.append(f"  n{e.src} -> n{e.dst}{style};")
        lines.append("}")
        return "\n".join(lines)


def run_linear(tasks: Sequence[PipeTask],
               meta: MetaModel | None = None,
               name: str = "linear-flow") -> MetaModel:
    """Build and execute a simple linear pipeline."""
    flow = DesignFlow(name)
    flow.chain(*tasks)
    return flow.execute(meta)
