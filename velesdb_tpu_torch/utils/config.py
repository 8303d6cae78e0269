"""Configuration system: TOML file + ``VELESDB_*`` environment overlay.

Counterpart of ``VelesConfig`` via figment (``config.rs:49-432``): sections
SearchConfig / GraphConfig (HnswConfig analog) / StorageConfig / LimitsConfig /
ServerConfig / LoggingConfig / QuantizationConfig with validation, TOML file
loading (stdlib ``tomllib``) and ``VELESDB_<SECTION>_<FIELD>`` env overrides.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib

__all__ = ["VelesConfig", "ConfigError"]


class ConfigError(ValueError):
    pass


@dataclasses.dataclass
class SearchConfig:
    default_quality: str = "balanced"  # fast|balanced|accurate|perfect
    ef_search: int | None = None
    timeout_s: float = 30.0
    batch_size: int = 256

    def validate(self) -> None:
        if self.default_quality not in ("fast", "balanced", "accurate", "perfect"):
            raise ConfigError(f"bad search.default_quality {self.default_quality!r}")
        if self.ef_search is not None and not 1 <= self.ef_search <= 10000:
            raise ConfigError("search.ef_search must be in [1, 10000]")
        if self.timeout_s <= 0:
            raise ConfigError("search.timeout_s must be > 0")


@dataclasses.dataclass
class GraphIndexConfig:
    """ANN graph build knobs (HnswConfig analog)."""

    degree: int | None = None  # None = auto (GraphParams.auto)
    knn_k: int | None = None
    alpha: float = 1.2
    min_rows: int = 4096  # brute force below this

    def validate(self) -> None:
        if self.degree is not None and not 4 <= self.degree <= 256:
            raise ConfigError("graph_index.degree must be in [4, 256]")
        if self.alpha < 1.0 or self.alpha > 2.0:
            raise ConfigError("graph_index.alpha must be in [1.0, 2.0]")


@dataclasses.dataclass
class StorageConfig:
    initial_capacity: int = 4096
    flush_every: int = 0  # 0 = explicit flush only
    compress_payload_snapshots: bool = True

    def validate(self) -> None:
        if self.initial_capacity < 1:
            raise ConfigError("storage.initial_capacity must be >= 1")


@dataclasses.dataclass
class LimitsConfig:
    max_dim: int = 8192
    max_k: int = 4096
    max_batch: int = 8192
    max_match_depth: int = 16
    max_match_bindings: int = 100_000
    rate_per_s: float = 0.0  # 0 = rate limiting disabled

    def validate(self) -> None:
        for f in dataclasses.fields(self):
            if f.name == "rate_per_s":
                if self.rate_per_s < 0:
                    raise ConfigError("limits.rate_per_s must be >= 0")
                continue
            if getattr(self, f.name) < 1:
                raise ConfigError(f"limits.{f.name} must be >= 1")


@dataclasses.dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 7333
    enable_metrics: bool = True
    cors: bool = False

    def validate(self) -> None:
        if not 1 <= self.port <= 65535:
            raise ConfigError("server.port must be in [1, 65535]")


@dataclasses.dataclass
class LoggingConfig:
    level: str = "info"

    def validate(self) -> None:
        if self.level not in ("debug", "info", "warning", "error"):
            raise ConfigError(f"bad logging.level {self.level!r}")


@dataclasses.dataclass
class QuantizationConfig:
    default_mode: str = "full"  # full|f16|bf16|sq8|binary
    rerank: bool = True
    oversample: float = 4.0

    def validate(self) -> None:
        if self.default_mode not in ("full", "f16", "bf16", "sq8", "binary"):
            raise ConfigError(f"bad quantization.default_mode {self.default_mode!r}")
        if not 1.0 <= self.oversample <= 64.0:
            raise ConfigError("quantization.oversample must be in [1, 64]")


_SECTIONS = {
    "search": SearchConfig,
    "graph_index": GraphIndexConfig,
    "storage": StorageConfig,
    "limits": LimitsConfig,
    "server": ServerConfig,
    "logging": LoggingConfig,
    "quantization": QuantizationConfig,
}


@dataclasses.dataclass
class VelesConfig:
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    graph_index: GraphIndexConfig = dataclasses.field(default_factory=GraphIndexConfig)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    limits: LimitsConfig = dataclasses.field(default_factory=LimitsConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    quantization: QuantizationConfig = dataclasses.field(
        default_factory=QuantizationConfig
    )

    @classmethod
    def load(
        cls, path: str | None = None, env: dict | None = None
    ) -> "VelesConfig":
        """TOML file (optional) -> ``VELESDB_*`` env overlay -> validate."""
        cfg = cls()
        if path is not None:
            with open(path, "rb") as f:
                data = tomllib.load(f)
            for section, values in data.items():
                if section not in _SECTIONS:
                    raise ConfigError(f"unknown config section {section!r}")
                if not isinstance(values, dict):
                    raise ConfigError(f"section {section!r} must be a table")
                cfg._apply(section, values)
        cfg._apply_env(env if env is not None else os.environ)
        cfg.validate()
        return cfg

    def _apply(self, section: str, values: dict) -> None:
        target = getattr(self, section)
        fields = {f.name: f for f in dataclasses.fields(target)}
        for key, value in values.items():
            if key not in fields:
                raise ConfigError(f"unknown config key {section}.{key}")
            setattr(target, key, value)

    def _apply_env(self, env) -> None:
        """``VELESDB_<SECTION>_<FIELD>`` overrides (``config.rs`` env overlay)."""
        for section, typ in _SECTIONS.items():
            target = getattr(self, section)
            for f in dataclasses.fields(typ):
                var = f"VELESDB_{section.upper()}_{f.name.upper()}"
                if var in env:
                    setattr(target, f.name, _coerce(env[var], f, var))

    def validate(self) -> None:
        for section in _SECTIONS:
            getattr(self, section).validate()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _coerce(raw: str, field: dataclasses.Field, var: str):
    t = field.type
    try:
        if t in ("int", "int | None"):
            return int(raw)
        if t in ("float", "float | None"):
            return float(raw)
        if t == "bool":
            if raw.lower() in ("1", "true", "yes", "on"):
                return True
            if raw.lower() in ("0", "false", "no", "off"):
                return False
            raise ValueError(raw)
        return raw
    except ValueError as e:
        raise ConfigError(f"bad value for {var}: {raw!r}") from e
