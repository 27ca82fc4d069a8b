"""Synthetic stand-ins for the paper's vector datasets."""
