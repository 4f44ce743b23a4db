"""Marching cubes (native C++ core) and PLY/OBJ export."""
