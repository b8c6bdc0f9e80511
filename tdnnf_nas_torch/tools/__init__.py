"""Diagnostic tools of the port that run on the GPU."""
