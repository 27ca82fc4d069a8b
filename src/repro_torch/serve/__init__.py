"""Serving on torch (port of ``repro.serve``): the batched engine and the
kNN-LM hook over a BrePartition datastore."""
