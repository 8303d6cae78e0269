"""REST surface (``velesdb-server`` counterpart, SURVEY.md §2.6), over the
port's ``Database``."""

from velesdb_tpu_torch.server.app import VelesServer, make_server, serve

__all__ = ["VelesServer", "make_server", "serve"]
