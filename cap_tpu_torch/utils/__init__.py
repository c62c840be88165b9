"""Host utilities: the pooled HTTP client (GET and form POST), the
redacting secret strings, base62 ids and string-list helpers."""
