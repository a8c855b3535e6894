"""Numerics core of the port: Complex pairs, matrix DFTs, coil combination, padding."""
