"""Migration toolkit (``velesdb-migrate`` counterpart, SURVEY.md §2.6): a copy
of ``velesdb_tpu/migrate/``, writing into the port's collections."""

from velesdb_tpu_torch.migrate.connectors import (
    CONNECTORS,
    ChromaConnector,
    ConnectorError,
    CsvConnector,
    ElasticsearchConnector,
    JsonConnector,
    JsonlConnector,
    MilvusConnector,
    MongoConnector,
    NumpyConnector,
    PineconeConnector,
    PgvectorConnector,
    QdrantConnector,
    RedisConnector,
    WeaviateConnector,
)
from velesdb_tpu_torch.migrate.pipeline import MigrationPipeline, MigrationReport

__all__ = [
    "CONNECTORS",
    "ConnectorError",
    "JsonlConnector",
    "JsonConnector",
    "CsvConnector",
    "NumpyConnector",
    "QdrantConnector",
    "ChromaConnector",
    "PgvectorConnector",
    "ElasticsearchConnector",
    "WeaviateConnector",
    "MilvusConnector",
    "PineconeConnector",
    "RedisConnector",
    "MongoConnector",
    "MigrationPipeline",
    "MigrationReport",
]
