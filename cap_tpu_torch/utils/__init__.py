"""Host utilities: the pooled HTTP client of the CPU keysets."""
