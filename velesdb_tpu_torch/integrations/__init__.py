"""Client adapters over the port: LangChain, LlamaIndex and graph-RAG.

The port's copies of the repo's root ``integrations/`` modules, importing
only ``velesdb_tpu_torch``, numpy and the standard library:

- ``langchain_velesdb``: ``VelesDBVectorStore`` (LangChain ``VectorStore``).
- ``llamaindex_velesdb``: ``VelesDBLlamaStore`` (LlamaIndex vector store).
- ``langchain_velesdb_graph``: ``VelesGraphRetriever`` (seed, then bounded
  BFS expansion), ``VelesChatMemory`` and ``VelesSemanticMemory`` on the
  port's ``AgentMemory``.
- ``graph_toolkit``: chunking, entity / relation extraction, graph loading.

LangChain and LlamaIndex are optional: without them each adapter keeps the
same surface on small stand-in classes. An adapter that opens a database
takes ``device="cuda"`` and passes it to ``Database.open``; the CPU is used
only where the caller passes ``device="cpu"``. Rows keep the reference
adapters' payloads and ids, so a directory written by either package's
adapter reads back through the other's.
"""
