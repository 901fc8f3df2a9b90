"""Serving runtime: native stream pool and the streaming engine."""
