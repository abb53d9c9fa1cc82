"""Observability: spans and the streaming pipeline's occupancy ledger."""
