"""Algorithms 1-3 of the paper: transformation, compression, edge table, buffer control, ingestor."""
