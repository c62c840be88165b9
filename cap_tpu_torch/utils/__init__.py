"""Host utilities: the pooled HTTP client (GET and form POST), the
redacting secret strings, base62 ids and string-list helpers."""

from .base62 import random_base62
from .strutils import str_list_contains, remove_duplicates_stable

__all__ = ["random_base62", "str_list_contains", "remove_duplicates_stable"]
