"""Step functions of the LM stack (serving only, so far)."""
