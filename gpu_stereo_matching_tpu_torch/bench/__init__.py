"""Measurement harnesses of the port."""
