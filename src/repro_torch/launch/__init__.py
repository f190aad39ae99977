"""Drivers and steps of the port (``repro.launch``): the train, prefill,
decode and attribution steps and their sharding trees (:mod:`.steps`),
the meshes (:mod:`.mesh`), the training driver (:mod:`.train`) and the
serving driver (:mod:`.serve`)."""
