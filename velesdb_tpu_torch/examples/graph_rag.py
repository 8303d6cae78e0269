"""Graph-RAG on the port: seed-and-expand retrieval + agent memory.

The port's copy of ``examples/graph_rag.py``: a document collection with
typed citation edges, the LangChain-compatible graph retriever of
``velesdb_tpu_torch.integrations`` (works standalone: no langchain install
required), and chat / semantic memories. Run:
``python -m velesdb_tpu_torch.examples.graph_rag`` (on the card;
``--device cpu`` on the CPU; ``--path`` the data directory, by default
``./graph_rag_data``).
"""

import numpy as np

from velesdb_tpu_torch import Database
from velesdb_tpu_torch.examples import device_args
from velesdb_tpu_torch.integrations.langchain_velesdb_graph import (
    VelesChatMemory,
    VelesGraphRetriever,
    VelesSemanticMemory,
)

DIM = 64

# toy embedding: stable hash -> gaussian (swap for a real model)
_cache: dict[str, np.ndarray] = {}


def embed(text: str) -> np.ndarray:
    if text not in _cache:
        r = np.random.default_rng(abs(hash(text)) % (2**32))
        _cache[text] = r.standard_normal(DIM).astype(np.float32)
    return _cache[text]


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv,
                       path=(str, "./graph_rag_data", "data directory"))
    path, device = args.path, args.device
    db = Database(path, device=device)
    docs = db.get_or_create_collection("papers", DIM)

    corpus = {
        0: "attention is all you need",
        1: "bert pretraining of deep bidirectional transformers",
        2: "language models are few shot learners",
        3: "chain of thought prompting elicits reasoning",
        4: "an unrelated paper about fluid dynamics",
    }
    for pid, title in corpus.items():
        docs.upsert(pid, embed(title), {"text": title, "year": 2017 + pid})

    # citation graph: 0 <- 1 <- 2 <- 3 (each cites the previous)
    for a, b in [(1, 0), (2, 1), (3, 2)]:
        docs.add_edge(a, b, "CITES")

    retriever = VelesGraphRetriever(
        docs, embedding=embed, seed_k=1, expand_k=4, max_depth=2,
        rel_types=["CITES"], direction="out", text_field="text",
    )
    print("query: 'few shot learners' ->")
    for d in retriever.get_relevant_documents("language models are few shot learners"):
        print(f"  depth={d.metadata['hop_depth']} score={d.metadata['score']:.3f} "
              f"{d.page_content!r}")

    # conversation + fact memory
    chat = VelesChatMemory(path=f"{path}/chat", embedding=embed, dimension=DIM, device=device)
    chat.save_context({"input": "what did we discuss?"},
                      {"output": "transformer papers and their citations"})
    print("\nchat history:", chat.load_memory_variables({})["history"])

    facts = VelesSemanticMemory(path=f"{path}/facts", embedding=embed, dimension=DIM, k=2,
                                device=device)
    facts.remember("attention is all you need", importance=0.9)
    print("recalled facts:",
          facts.load_memory_variables({"q": "attention is all you need"})["facts"])

    db.close()


if __name__ == "__main__":
    main()
