"""Device-resident property-graph store."""
