"""Ray generation and the Blender/colmap dataset provider."""
