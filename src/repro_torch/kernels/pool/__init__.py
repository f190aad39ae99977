"""2x2 max-pool + 2-bit argmax: kernel wrapper (``pool``), its int16 entry
point (``fxp``) and plain versions (``ref``)."""
