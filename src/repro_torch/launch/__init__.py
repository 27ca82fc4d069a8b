"""Launch layer (port of ``repro.launch``): the block-size autotuner and
the serving launcher."""
