"""Span timers and histograms (copy of the reference's `repro.telemetry.spans`)."""
