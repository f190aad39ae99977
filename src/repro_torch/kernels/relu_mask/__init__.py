"""ReLU + 1-bit mask: kernel wrapper (``relu_mask``) and plain version
(``ref``)."""
