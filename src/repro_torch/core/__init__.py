"""Index build and exact batched search (the port of ``repro.core``)."""
