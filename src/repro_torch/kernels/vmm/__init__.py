"""FC matmul: kernel wrappers (``vmm``, int16 ``fxp``) and plain versions
(``ref``)."""
