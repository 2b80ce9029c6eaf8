"""Sealing of KV pages for the host swap tier (port of ``repro.enclave``)."""
