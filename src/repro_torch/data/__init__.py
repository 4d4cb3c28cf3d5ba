"""Problem specifications (the quadratic family of this slice)."""
