"""The fused (type × bid × seed) spot sweep: ``ref`` / ``kernel`` / ``ops``."""
