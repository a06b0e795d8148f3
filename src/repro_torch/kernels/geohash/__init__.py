from .ops import geohash_encode, geohash_encode_plain

__all__ = ["geohash_encode", "geohash_encode_plain"]
