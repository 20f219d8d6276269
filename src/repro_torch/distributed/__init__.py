"""Serving steps of the port (counterpart of ``repro.distributed``; the port
runs on one card, so there is no sharding here)."""
