"""Wideband ingest formats, GSMTAP and TUN egress."""
