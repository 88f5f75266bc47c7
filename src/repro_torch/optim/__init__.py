"""Weight-only int8 deployment."""
