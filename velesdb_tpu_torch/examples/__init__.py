"""The five examples of the repo's ``examples/``, on the port.

Each runs on the card with ``python -m velesdb_tpu_torch.examples.<name>``
and on the CPU with ``--device cpu``; its ``main(argv)`` runs it in process.
They import only ``velesdb_tpu_torch`` (its ``integrations`` among them),
numpy and the standard library, and print the reference scripts' result
lines:

- ``quickstart``: collections, search, filters, VelesQL, text, hybrid, graph.
- ``agent_memory_demo``: remember / recall / reinforce / snapshot.
- ``ecommerce_demo``: vector + graph + columns on 5,000 products
  (``build_shop``, ``q1_vector`` ... ``q4_combined``).
- ``graph_rag``: the graph retriever and the chat and fact memories.
- ``sharded_scale``: exact, graph ANN, SQ8 and multi-host search on
  ``velesdb_tpu_torch.parallel`` in a ``torch.distributed`` world
  (``--world N``).
"""

import argparse


def device_args(description: str, argv=None, **extra):
    """``argv`` parsed for ``--device`` (default ``cuda``) and each
    ``extra`` option ``name=(type, default, help)``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    for name, (kind, default, text) in extra.items():
        p.add_argument(f"--{name.replace('_', '-')}", type=kind, default=default, help=text)
    return p.parse_args(argv)
