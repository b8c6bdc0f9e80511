"""Data-preparation recipes."""
