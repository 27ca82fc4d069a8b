"""Training substrate (port of ``repro.train``): the optimizer, the chunked
loss, the train step, checkpointing and the straggler monitor, for the
dense decoder family on one device."""
