"""Step builders of the port (``repro.launch``): only the LM attribution
step so far (:mod:`.steps`)."""
