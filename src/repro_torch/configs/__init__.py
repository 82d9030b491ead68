"""Ingestion configuration (copy of the reference's `repro.configs.paper_ingest`)."""
