"""Synthetic datasets."""
