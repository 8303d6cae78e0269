"""Full-text layer: tokenizer, BM25 device scoring, trigram LIKE index."""

from velesdb_tpu_torch.text.bm25 import Bm25Index
from velesdb_tpu_torch.text.tokenizer import extract_text, tokenize
from velesdb_tpu_torch.text.trigram import TrigramIndex, like_to_regex, trigrams

__all__ = [
    "Bm25Index",
    "TrigramIndex",
    "tokenize",
    "extract_text",
    "trigrams",
    "like_to_regex",
]
