"""Fed2's core: structure groups and fusion."""
