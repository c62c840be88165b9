"""JOSE parsing, JWKs and the batched GPU keyset."""
