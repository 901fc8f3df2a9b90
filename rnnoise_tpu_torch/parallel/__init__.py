"""Streams and batches split across devices and processes."""
