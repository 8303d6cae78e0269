"""The reference's recall-suite model (``benchmark_recall.py:27-50``):
``data.clusters`` Gaussian centers scaled by ``data.center_scale``, each
row a center plus ``data.noise`` times a standard normal; queries drawn the
same way from the same centers by a stream of their own.

A configuration with a ``text`` group also gets ``exp_hybrid.py``'s
payload: ``text`` is the row's topic word (its cluster's, ``cluster mod
len(vocab)``) ``topic_repeat`` times and then ``extra_words`` uniform
words; ``price`` is uniform over ``price_range``. A query's text is its
cluster's topic word where the traffic says ``query_text: topic``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.data import Dataset, QueryPool, generator, make_ids, make_order


def _draw(seed, n, d, data, centers, stream, device):
    g = generator(seed, stream, device)
    assign = torch.randint(0, data["clusters"], (n,), generator=g, device=device)
    rows = centers[assign] + torch.randn((n, d), generator=g, device=device) * data["noise"]
    return rows, assign


def make_dataset(cfg: dict, seed: int, device) -> Dataset:
    n, d, data = int(cfg["rows"]), int(cfg["collection"]["dim"]), cfg["data"]
    centers = torch.randn((data["clusters"], d), generator=generator(seed, "centers", device),
                          device=device) * data["center_scale"]
    rows, assign = _draw(seed, n, d, data, centers, "rows", device)
    fields = {}
    text = cfg.get("text")
    if text is not None:
        vocab = np.asarray(text["vocab"])
        g = generator(seed, "payload", device)
        extra = torch.randint(0, len(vocab), (n, text["extra_words"]), generator=g,
                              device=device).cpu().numpy()
        lo, hi = text["price_range"]
        price = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
                 * (hi - lo) + lo).cpu().numpy()
        topic = vocab[(assign % len(vocab)).cpu().numpy()]
        words = [topic] * text["topic_repeat"] + [vocab[extra[:, j]] for j in range(extra.shape[1])]
        fields = {"text": [" ".join(parts) for parts in zip(*(w.tolist() for w in words))],
                  "price": price}
    return Dataset(rows, make_ids(n, seed, device), fields, {"centers": centers})


def make_pool(cfg: dict, traffic: dict, seed: int, ds: Dataset, device) -> QueryPool:
    p, d = int(cfg["queries"]), int(cfg["collection"]["dim"])
    vectors, assign = _draw(seed, p, d, cfg["data"], ds.aux["centers"], "pool", device)
    texts = None
    if traffic.get("query_text") == "topic":
        vocab = np.asarray(cfg["text"]["vocab"])
        texts = vocab[(assign % len(vocab)).cpu().numpy()].tolist()
    return QueryPool(vectors, texts, make_order(p, seed, device))
