"""Core ops: the marcher (K2), hash encoder (K1), compositor (K3) and
the plain ops around them."""
