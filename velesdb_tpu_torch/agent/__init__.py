"""Agent memory SDK (``velesdb-core/src/agent/`` counterpart, SURVEY.md §2.3),
over the port's ``Database``."""

from velesdb_tpu_torch.agent.memory import AgentMemory, MemoryKind

__all__ = ["AgentMemory", "MemoryKind"]
