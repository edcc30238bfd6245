"""Wideband ingest formats."""
