"""Agent memory SDK demo: remember/recall/reinforce/snapshot.

The port's copy of ``examples/agent_memory_demo.py``. Run:
``python -m velesdb_tpu_torch.examples.agent_memory_demo`` (on the card;
``--device cpu`` on the CPU).
"""

import tempfile

import numpy as np

from velesdb_tpu_torch.agent import AgentMemory, MemoryKind
from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.examples import device_args


def embed(text: str) -> np.ndarray:
    r = np.random.default_rng(abs(hash(text)) % (2**32))
    return r.standard_normal(64).astype(np.float32)


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv,
                       path=(str, None, "data directory (default: a new temporary one)"))
    db = Database.open(args.path or tempfile.mkdtemp(prefix="agent-"), device=args.device)
    mem = AgentMemory(db, dim=64, agent_id="demo")

    # semantic facts, weighted by importance
    mem.remember_fact(embed("paris is the capital of france"), "capital(france)=paris", 0.9)
    mem.remember_fact(embed("the sky is blue"), "sky=blue", 0.3)

    # episodic events with TTL
    mem.remember_event(embed("user asked about pricing"), "pricing question", ttl_s=3600)

    # procedural skills + reinforcement
    skill = mem.remember_procedure(embed("how to restart the server"), "restart-runbook")
    mem.reinforce(skill, success=True)
    mem.reinforce(skill, success=True)

    print("recall:", mem.recall(MemoryKind.SEMANTIC, embed("paris is the capital of france"),
                                k=1))
    print("window:", mem.recall_window(since=0))
    print("stats:", mem.stats())

    snap = mem.snapshot("before-cleanup")
    mem.forget(MemoryKind.SEMANTIC, 1)
    mem.rollback(snap)
    print("after rollback:", mem.stats())
    db.close()


if __name__ == "__main__":
    main()
