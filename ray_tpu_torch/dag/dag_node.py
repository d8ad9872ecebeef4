"""Lazy task/actor DAGs.

Analog of the reference's ray.dag (python/ray/dag/dag_node.py:23 DAGNode,
function_node.py / class_node.py / input_node.py): ``f.bind(x)`` builds a
graph without executing; ``dag.execute(*inputs)`` walks it, submitting each
function node as a task and each class node as an actor, passing ObjectRefs
straight through as downstream arguments so intermediate results flow through
the object store without a driver-side get.

Used by Serve's deployment graphs and by the workflow library's durable
executor.
"""

from __future__ import annotations

import threading


class DAGNode:
    """Abstract node. Holds bound args/kwargs which may contain other nodes."""

    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs)

    # -- traversal ---------------------------------------------------------
    def _children(self):
        out = []

        def scan(v):
            if isinstance(v, DAGNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in self._bound_args:
            scan(a)
        for a in self._bound_kwargs.values():
            scan(a)
        return out

    def topological_order(self):
        """Deterministic post-order over the graph reachable from self."""
        seen = {}
        order = []

        def visit(node):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for c in node._children():
                visit(c)
            order.append(node)

        visit(self)
        return order

    def _resolve(self, value, results):
        if isinstance(value, DAGNode):
            return results[id(value)]
        if isinstance(value, list):
            return [self._resolve(v, results) for v in value]
        if isinstance(value, tuple):
            return tuple(self._resolve(v, results) for v in value)
        if isinstance(value, dict):
            return {k: self._resolve(v, results) for k, v in value.items()}
        return value

    def _resolved_args(self, results):
        args = tuple(self._resolve(a, results) for a in self._bound_args)
        kwargs = {k: self._resolve(v, results) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _execute_impl(self, resolved_args, resolved_kwargs, ctx):
        raise NotImplementedError

    def experimental_compile(self, **kwargs):
        """Compile this static DAG of actor-method nodes for repeated
        zero-RPC dispatch over pre-allocated shm channels; returns a
        :class:`~ray_tpu_torch.dag.compiled.CompiledDAG` (see dag/compiled.py)."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, **kwargs)

    def execute(self, *input_args, **input_kwargs):
        """Execute the DAG rooted at this node. Returns this node's result
        (an ObjectRef for function/method nodes, an ActorHandle for class
        nodes, a list for MultiOutputNode)."""
        ctx = {"input_args": input_args, "input_kwargs": input_kwargs}
        results = {}
        ctx["_results"] = results
        order = self.topological_order()
        if sum(1 for n in order if isinstance(n, InputNode)) > 1:
            raise RuntimeError("a DAG can have at most one InputNode")
        for node in order:
            args, kwargs = node._resolved_args(results)
            results[id(node)] = node._execute_impl(args, kwargs, ctx)
        return results[id(self)]


class FunctionNode(DAGNode):
    """A bound @remote function call (reference: dag/function_node.py)."""

    def __init__(self, remote_fn, args, kwargs, options=None):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn
        self._options = dict(options or {})

    def options(self, **opts):
        return FunctionNode(self._remote_fn, self._bound_args, self._bound_kwargs, {**self._options, **opts})

    def _execute_impl(self, args, kwargs, ctx):
        fn = self._remote_fn.options(**self._options) if self._options else self._remote_fn
        return fn.remote(*args, **kwargs)

    def __str__(self):
        return f"FunctionNode({self._remote_fn.underlying_function.__name__})"


class ClassNode(DAGNode):
    """A bound actor construction (reference: dag/class_node.py). The actor
    is created ONCE per ClassNode and cached: repeated ``dag.execute()``
    calls reuse the gang instead of spawning fresh actors per call (and
    ``experimental_compile()`` resolves the same cache, so a DAG compiled
    after a classic run binds the same actors). Only constructors whose
    bound args contain other DAG nodes — i.e. truly per-execution actors —
    keep the old create-per-execute behavior."""

    def __init__(self, actor_cls, args, kwargs, options=None):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._options = dict(options or {})
        self._cached_handle = None

    def options(self, **opts):
        return ClassNode(self._actor_cls, self._bound_args, self._bound_kwargs, {**self._options, **opts})

    def resolve_actor_handle(self, args=None, kwargs=None):
        """The per-DAG actor cache: create the actor on first resolution,
        return the same handle afterwards. Shared by classic execute() and
        the compiled-graph planner."""
        if self._cached_handle is None:
            cls = self._actor_cls.options(**self._options) if self._options else self._actor_cls
            self._cached_handle = cls.remote(
                *(self._bound_args if args is None else args),
                **(self._bound_kwargs if kwargs is None else kwargs),
            )
        return self._cached_handle

    def _execute_impl(self, args, kwargs, ctx):
        if self._children():
            # Constructor args flow from other DAG nodes: a fresh actor per
            # execution is the only correct reading — no cache.
            cls = self._actor_cls.options(**self._options) if self._options else self._actor_cls
            return cls.remote(*args, **kwargs)
        return self.resolve_actor_handle(args, kwargs)

    def __getattr__(self, method_name):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        return _UnboundClassMethod(self, method_name)


class _UnboundClassMethod:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs):
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    """A bound actor method call on a ClassNode's actor."""

    def __init__(self, class_node, method_name, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method_name = method_name

    def _children(self):
        return [self._class_node] + super()._children()

    def _execute_impl(self, args, kwargs, ctx):
        # topological_order guarantees the class node ran first; its handle
        # is what _resolve would give us, but the class node is not a bound
        # arg, so fetch it from ctx-scoped results via the resolved parent.
        handle = ctx["_results"][id(self._class_node)]
        return getattr(handle, self._method_name).remote(*args, **kwargs)

    def __str__(self):
        return f"ClassMethodNode({self._method_name})"


class InputNode(DAGNode):
    """The runtime input placeholder (reference: dag/input_node.py). Use as a
    context manager::

        with InputNode() as inp:
            dag = f.bind(inp)
        ray_tpu_torch.get(dag.execute(5))
    """

    _local = threading.local()

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        if getattr(InputNode._local, "current", None) is not None:
            raise RuntimeError(
                "a DAG can have at most one InputNode; close the previous "
                "`with InputNode()` block first"
            )
        InputNode._local.current = self
        return self

    def __exit__(self, *exc):
        InputNode._local.current = None

    def _execute_impl(self, args, kwargs, ctx):
        in_args = ctx["input_args"]
        if len(in_args) == 1 and not ctx["input_kwargs"]:
            return in_args[0]
        return _DAGInputData(in_args, ctx["input_kwargs"])

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def __getitem__(self, key):
        return InputAttributeNode(self, key)


class _DAGInputData:
    def __init__(self, args, kwargs):
        self.args = args
        self.kwargs = kwargs

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.args[key]
        return self.kwargs[key]


class InputAttributeNode(DAGNode):
    """``inp[0]`` / ``inp.key`` — a projection of the runtime input."""

    def __init__(self, input_node: InputNode, key):
        super().__init__((input_node,), {})
        self._key = key

    def _execute_impl(self, args, kwargs, ctx):
        value = args[0]
        if isinstance(value, _DAGInputData):
            return value[self._key]
        # single positional input: subscript it, falling back to attribute
        try:
            return value[self._key]
        except (TypeError, KeyError, IndexError):
            if isinstance(self._key, str):
                return getattr(value, self._key)
            raise


class MultiOutputNode(DAGNode):
    """Groups several terminal nodes; execute() returns a list."""

    def __init__(self, outputs):
        super().__init__((list(outputs),), {})

    def _execute_impl(self, args, kwargs, ctx):
        return args[0]
