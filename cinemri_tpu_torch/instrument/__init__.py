"""Measurement helpers of the port (``opstats``: device time by kernel kind)."""
