"""2x2 max-pool + 2-bit argmax: kernel wrapper (``pool``) and plain
versions (``ref``)."""
