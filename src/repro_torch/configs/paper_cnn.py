"""The paper's own Table III CNN for CIFAR-10 (the reproduction target), as
``repro.configs.paper_cnn`` has it."""
from repro_torch.models.cnn import CNNConfig

FULL = CNNConfig()                       # exact Table III: 591,274 params

# Table-III-literal variant: ReLU only after FC1 (matches the paper's
# 24.7 Kb residual accounting exactly; core/residuals.py).
TABLE_III_LITERAL = CNNConfig(conv_relu=False)

SMOKE = CNNConfig(in_hw=(16, 16), channels=(8, 8), fc=(32,))
