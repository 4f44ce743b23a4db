"""Field networks: the NGP field with its fused heads kernel (K4)."""
