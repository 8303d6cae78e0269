"""velesdb_tpu_torch — the PyTorch / CUDA port of velesdb_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``velesdb_tpu``: the same public
API (``Database`` -> ``Collection`` -> exact search) and the same on-disk
format, with plain tensor code in PyTorch and every TPU kernel on the served
path rewritten by hand for Hopper (``csrc/``). Devices are explicit:
``Database.open(path, device="cuda")`` is the default and the CPU is used only
when a caller passes ``device="cpu"``. What is not ported yet raises
``NotImplementedError`` (ROADMAP.md). This package never imports JAX.
"""

__version__ = "0.1.0"

from velesdb_tpu_torch.collection import Collection
from velesdb_tpu_torch.database import Database
from velesdb_tpu_torch.ops.distance import DistanceMetric
from velesdb_tpu_torch.ops.quantization import StorageMode

__all__ = ["Database", "Collection", "DistanceMetric", "StorageMode", "__version__"]
