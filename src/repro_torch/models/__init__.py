"""The student CNN zoo, eval mode."""
