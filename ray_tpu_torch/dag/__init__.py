"""ray_tpu_torch.dag — lazy task/actor DAGs (reference: python/ray/dag/) plus
compiled execution graphs over shm channels (dag/compiled.py)."""

from ray_tpu_torch.dag.compiled import CompiledDAG, CompiledDAGRef  # noqa: F401
from ray_tpu_torch.dag.dag_node import (  # noqa: F401
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGNode",
    "FunctionNode",
    "ClassNode",
    "ClassMethodNode",
    "InputNode",
    "InputAttributeNode",
    "MultiOutputNode",
]
