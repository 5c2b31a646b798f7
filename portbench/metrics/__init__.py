"""Per-layer metric readers, one file each, loaded by path by name."""
