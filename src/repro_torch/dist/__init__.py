"""Distribution layer (``repro.dist``): logical-axis placements and the
data-parallel row collectives (:mod:`.sharding`), and name-based parameter
specs (:mod:`.params`)."""
from repro_torch.dist import params, sharding  # noqa: F401
