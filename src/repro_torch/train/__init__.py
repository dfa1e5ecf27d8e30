"""Training substrate: data, optimizer, train step, checkpointing, fault
tolerance (the reference's ``repro.train``), on one device."""
