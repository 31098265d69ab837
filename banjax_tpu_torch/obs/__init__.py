"""Observability helpers the port needs so far."""
