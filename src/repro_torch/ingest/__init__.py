"""Stream sources and the two-stage filter."""
