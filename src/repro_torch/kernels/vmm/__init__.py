"""FC matmul: kernel wrappers (``vmm``) and plain versions (``ref``)."""
