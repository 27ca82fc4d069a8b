"""Synthetic data: the LM token stream and the paper's vector sets."""
