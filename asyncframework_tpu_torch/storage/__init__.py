"""Embedded persistent key/value store (``storage/kvstore.py``)."""

from asyncframework_tpu_torch.storage.kvstore import KVStore, string_hash_code

__all__ = ["KVStore", "string_hash_code"]
